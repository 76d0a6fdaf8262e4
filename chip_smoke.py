#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --compare 3 [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --gang
    python3 chip_smoke.py --cards [check]

The second form builds the kernels, runs only the serve phase's rounds
(3 rounds of both layouts in turn) and times the serving kernels'
wrappers at the serving shape, both decodes also in fp32
(``compare_kernels``); --src drives another checkout's package with this
script.  Run parent, change, change, parent in one call to compare two
trees on one card.  The third builds the kernels and runs only the gang
phase: on a machine with two or more cards, its ranks on distinct cards
over NCCL.  The fourth needs a machine of at least CARDS (4) cards and
refuses to run on fewer; it prints ``nvidia-smi topo -m`` (its error
where the machine does not let it run) and which cards reach which by
peer access, builds the kernels and runs these parts, each printing one
JSON line (``cards_*``); a part that fails fails the run once the others
have run:

  check  (a) in a fresh process, the five tensor-core kernels launched on
         card 0 at shapes whose dynamic shared memory exceeds 48 KB, then
         the same on card 1 with card 1 current (the cap belongs to each
         card's context); (b) every wrapper of the seven kernels and the
         paged scatter on tensors on card 1, called from a thread whose
         current card is card 0; each against its plain version on the
         same card (``elem_limit``, the hash and the scatter bitwise).
         ``--cards check`` runs this part alone (with ``--src``: on
         another checkout's package, its kernels built from its sources).
  mesh   ``tests/torch_dist_ranks.py``'s ``card`` scenario as 4 NCCL ranks,
         rank r on card r: the dataframe at 2^26 rows (2^24 a rank)
         against a 4-shard logical mesh on each rank's card, kernel 7
         1 / 0 / 2 / 1 / 0 a rank; tinyllama-1.1b's whole gradient tree
         from a B 2 x S 512 backward a rank (flash 2 x 22 a rank) through
         the fp32 all-reduce and compressed_grad_sync, the ranks bitwise
         equal, error feedback over 8 syncs; GPipe of 4 stages; on a
         (data 2, pipe 2) mesh the int8 sync along data and GPipe along
         pipe; every op on NCCL with tensors on the rank's own card; four
         distinct cards (UUIDs, and PCI bus ids where the CUDA driver
         gives them).
  gang   the gang phase at 4 ranks on cards 0-3 over NCCL, the 2^26-row
         tables, rank 0's result against a 4-shard logical mesh.
  pods   ``launch.train.run --kind-pods`` (the runtime phase's settings):
         preprocess on the data pod's card, train and postprocess on
         another card of the DL pod; the loss falls; flash exactly 80
         times, every launch on the train stage's card, no other kernel.

Its last line is the contract line of the default run.

Phases, each printing one JSON line per layout or run; any failure exits
non-zero:

1. build    compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc for
            sm_90a (one nvcc per source, all at once) into build/kernels/;
            count the tensor-core instructions (HMMA for mma.sync, HGMMA
            for wgmma) in the SASS of the four serving libraries redesigned
            for the tensor cores (cuobjdump).
2. kernels  each of the seven kernels against its plain PyTorch version on
            the card.  The five attention kernels at full tinyllama-1.1b
            shapes and at the smoke shapes, fp32 and bf16: ragged, empty,
            full and past-the-end lengths, a scalar length, a window, an S
            that is not a power of two, sentinel table entries,
            page-straddling chunks, inert rows and chunks whose tokens run
            past the end of the cache; flash attention causal and full at
            the training shape, an S that is not a multiple of the tile,
            S = 1, D 16 and 128, and G = 1.  Both decodes and both
            prefills at the shapes tinyllama-1.1b's serving path gives
            them (``serving_shape_cases``: get_config and the serve
            engine's settings).  Head dim 96 (phi3-mini) in all five
            attention kernels at KV 2, G 1 and 8: flash causal and full,
            both prefills and both decodes with ragged lengths.  rmsnorm at [4096, 2048],
            [4, 17, 256] and [1, 5120] in fp32 and bf16 (RMS_TOL); the
            hash-partition histogram bitwise at n 1, 2047, 2048, 2049 and
            2^23 keys (negatives and the int32 extremes among them) for 4,
            8, 16, 64 and 4096 buckets.  The five kernels redesigned for
            the tensor cores also over sweeps: flash attention at S 1, 63,
            64, 65, 127, 512 and 1000, D 16 to 128, G 1 and 8, causal and
            full; both prefills at chunks of 1 to 64 tokens, bases 0 to
            500; the contiguous decode at lengths 0 to S + 5 across the
            16-key tile, windows 0, 8, 64 and 100 and a scalar length, G 1
            to 32, D 16 to 128, S 32, 512 (one launch) and 4096 (the
            combine pass), and bf16 off the 16-byte boundary (the CUDA-core
            body); the paged decode at pages of 8, 16, 64 and 128, rows of
            one page, 512 positions (one launch) and 4096 (the combine
            pass), lengths across the tile and page edges, S - 1, S and
            past it, windows 0, 1, 100 and past every length, a scalar
            length, G 1 to 32, D 16 to 128, sentinels in every table, and
            bf16 off the 16-byte boundary.  The paged cache scatter bitwise against the plain one
            on tests/paged_scatter_cases.py; both prefill wrappers, both
            decodes and the decode append once under sync-debug "error" (a
            host sync fails the phase).  Last, on draws after all the
            others (theirs stay the parent commit's), the contiguous decode
            at head dim 24 (minicpm3's smoke MLA decode) at its serving
            shapes and over the contiguous sweep's S, G, lengths and
            windows, and the paged prefill at the widths the fleet's
            prefill-only engines give it (tinyllama's H, KV, D; B 8, T 128,
            256 and 512 at base 0, ragged chunk lengths across page and
            tile edges, an empty row), and the contiguous decode at
            recurrentgemma-9b's ring decode (B 8, H 16, KV 1, head dim 256,
            a ring of 2048 slots: lengths 0, 1, 15-17, 511-513, 1023-1025,
            2047 and a full ring, and scalar lengths; ring_decode_cases);
            then flash and the contiguous decode at whisper-medium's
            shapes (flash full over 1500 frames and causal over 187
            tokens, H 16, KV 16, D 64; kernel 2 over the [4, 1500, 16, 64]
            cross cache at scalar lengths 1, 511-513, 1024, 1499, 1500 and
            the [4, 448, 16, 64] self cache at 0, 1, 15-17, 447, 448;
            encdec_shape_cases) and at qwen2-vl-72b's (H 64, KV 8, D 128:
            flash causal at S 512 and 319, kernel 2 over 512 positions;
            mrope_shape_cases).
            Each element of a kernel's output is
            held to its plain version within 1e-4 (fp32) or the larger of
            2e-2 and one bf16 ulp of the plain value (bf16; TOL_NOTE).
            Then torch.profiler's device time
            per launch of rmsnorm and the hash at their paths' shapes
            (taken here: windows opened late in the run came back without
            device events).  Once tinyllama-1.1b's serving weights exist
            (before the serve phase), its warm decode step and chunk step
            at full width, on both layouts, run under sync-debug "error"
            beside the host-sync pass's verdict on the same roots
            (``repro_torch.analysis.host_sync``, the ``jit`` pass): both
            must be clean (check_step_syncs).
3. serve    full-width tinyllama-1.1b (random weights from a seeded
            torch.Generator, bf16 compute) serves 16 greedy requests shaped
            like the repo's mixed workload through ``submit`` +
            ``run_until_drained`` on the paged KV cache and on the
            contiguous slot cache, SERVE_ROUNDS rounds of both layouts in
            turn; one line per run, then each layout's tokens/s, TTFT p50
            and step p50 per round with their median, min and max.  Every
            launch counter is zeroed just before each run and read just
            after: the layout's two kernels (and on the paged layout the
            cache scatter, once per prefill call and decode append) must
            have launched, no other kernel may have.
4. timing   each kernel's wrapper at the shapes of its path against its
            plain version and a PyTorch SDPA yardstick (CUDA events), with
            its roofline bound and SDPA's device time per call
            (torch.profiler); for both prefills and both decodes also the
            device time of their kernels, for the paged prefill the
            scatter kernel alone, for both decodes also their fp32 call
            (the CUDA-core body) at the same shape.  Kernel 2 also at
            recurrentgemma-9b's ring decode, every row a full ring of 2048
            (ring_decode_row: bf16 and fp32, SDPA over K/V expanded to its
            16 heads beside).
5. profile  torch.profiler over PROFILE_WINDOW decode steps of a separate
            serving run per layout, once its 8 requests all decode (a
            whole run's trace took ~75 s to process): device
            busy and idle share, kernels and host ops per engine step, the
            port's kernels' device time per launch, top kernels; neither
            layout may launch a combine pass.
6. stream   the same engines in fp32: on each layout the kernel path and
            the plain path, and the two layouts' kernel paths, must emit
            token-identical greedy streams.
   sampling seeded sampling on full-width tinyllama-1.1b: the threefry
            split keys, random bits and uniforms of 64 seeds (half >= 2^32)
            over the vocabulary, computed on the card, bitwise against a
            numpy threefry written in this script; on an fp32 paged engine
            one seed twice gives one stream, another seed another, top_k=1
            equals greedy, and a stream checkpointed, released and restored
            mid-decode resumes the uninterrupted one; then the serve
            phase's 16 requests greedy and sampled (temperature 1), their
            tokens/s side by side, and a profile of a window of
            PROFILE_WINDOW decode steps of each (the profile phase's line).
   fleet    the serving fleet (``serve.build_fleet``, ``EngineRouter``) on
            full-width tinyllama-1.1b, two engines of the serve settings
            sharing its weights (phase_fleet): in fp32, a disaggregated
            1 + 1 fleet (a prefill-only engine handing KV pages to a
            decode engine), a colocated fleet of 2 through a rolling
            restart, and one through an injected engine crash under a
            FailurePolicy (eject, probe, re-admit), each serving
            FLEET_REQUESTS requests with every greedy stream equal to one
            colocated paged engine's; the disaggregated run's counters
            zeroed just before and read just after: only the paged kernels,
            kernel 5 exactly 22 x the prefill engine's chunks, kernel 3
            exactly 22 x the decode engine's steps, the handoffs exactly
            the owned pages.  Then bf16 tokens/s, TTFT p50 and handoff ms
            a request of FLEET_RATE_REQUESTS requests through the colocated
            and the disaggregated fleet, FLEET_ROUNDS rounds each (medians,
            min, max); ``launch.serve.run --fleet 2 --disaggregate``; and
            kernel 5 timed at the fleet's prefill widths (fleet_prefill_rows).
   phi3     phi3-mini-3.8b at its published widths (32 layers, d_model
            3072, 32 heads, 32 KV heads, head_dim 96, d_ff 8192, vocab
            32064): first both decodes and both prefills against their
            plain versions at the shapes its serving path gives them (B 8,
            H 32, KV 32, D 96, S 512, T 64, page 16; fp32 and bf16,
            ``serving_shape_cases``); then, tinyllama's parameters freed,
            random weights from a seeded torch.Generator and bf16 compute,
            it serves 4 greedy requests of the mixed workload on each KV
            layout, on the serve phase's engine settings; counters as in
            the serve phase: the layout's kernels launched, no other.
   mla_moe  minicpm3-4b (MLA) at its published widths and 16 of its 62
            layers (MLA_LAYERS; d_model 2560, 40 heads padded to 48,
            q_lora 768, kv_lora 256, nope 64, rope 32, v 64, vocab 73448;
            fp32 parameters)
            and then moonshot-v1-16b-a3b (MoE) at its (48 layers, d_model
            2048, 16 heads, head_dim 128, 64 experts top-6, d_ff 1408, the
            first layer dense with d_ff 11264, vocab 163840; bf16
            parameters, 27.57 B, 55.1 GB), each freed before the next
            loads: the kernels its serving path reaches held against their
            plain versions at the shapes the path gives them, fp32 and
            bf16 (serving_shape_cases: MLA the contiguous decode alone at
            H 48, KV 48, D 96; moonshot all four at H 16, KV 16, D 128);
            4 greedy requests per layout, counters zeroed just before and
            read just after each run: the path's kernels launched and no
            other (MLA: the contiguous decode alone, on either layout);
            minicpm3's fp32 streams, kernel path against plain path, token
            for token (the stream phase's checks); a profile of a window of
            PROFILE_WINDOW paged decode steps each (the profile phase's
            line).  Then arctic-480b the same way at ARCTIC_LAYERS (2) of
            its 35 layers (d_model 7168, 128 experts top-2 with the dense
            residual through its published gather dispatch, 56 heads
            padded to 64, KV 8, D 128, bf16 parameters, 55.8 GB): its four
            kernels at H 64, KV 8, D 128, 4 requests per layout, tokens/s
            and step p50 recorded.  Then kernel 2 timed at
            the MLA serving shape and kernels 3 and 5 at moonshot's, in the
            timing rows' format with SDPA beside (each row's
            ``at_other_shapes``).
7. train    full-width tinyllama-1.1b (random weights from a seeded
            torch.Generator, fp32 parameters, bf16 compute, the default
            RunConfig: AdamW, remat per layer, clip 1.0, lr 3e-4) takes 20
            steps on B 8 x S 512 batches of the synthetic corpus (labels:
            the tokens rolled by -1).  Counters zeroed just before, read
            just after: flash attention launches 44 times per step (22
            layers, and again in each layer's recompute under remat), the
            serving kernels never.  The mean loss of the last 5 steps must
            be below that of the first 5.  Then one profiled step, and the
            state, cut to its first 4 layers (CKPT_LAYERS, 3.7 GB of the
            13.2), saved with AsyncCheckpointer and restored into a fresh
            state of that depth, bitwise.
   dryrun   ``repro_torch.launch.dryrun`` on the meta device, no card: the
            train phase's own step (tinyllama-1.1b, B 8 x S 512, fp32
            parameters, bf16 compute, AdamW, remat) run once through the
            plain ops; its FLOPs with and without remat, the attention
            share, the peak of live storages, and beside them the train
            phase's step p50 and peak memory; the step's share of the bf16
            peak (model FLOPs / p50 / 989e12) with the card's name and
            power limit.  The card's peak above what was allocated before
            the train state must lie within DRYRUN_BAND of the estimate.
            Then tinyllama-1.1b's full-width train_4k and decode_32k cells
            on both production meshes (DRYRUN_CELLS), every roofline term
            finite and ``dominant`` set; the phase under DRYRUN_LIMIT_S.
8. parity   fp32 training (TF32 off) from one initial state: 3 steps on
            the kernel path and 3 on the plain path (``decode_impl="ref"``);
            loss and grad-norm must agree at every step within TRAIN_TOL.
   runtime  the two main paths through the port's pilot runtime.  The
            training entry point ``repro_torch.launch.train.run``: its stage
            graph (preprocess >> train >> postprocess) under a Session over
            the card, tinyllama-1.1b at full width and 4 of its 22 layers
            (RUNTIME_LAYERS: the driver's config cut in depth, so its final
            checkpoint write is 3.7 GB, not 13.2), B 8 x S 512,
            RUNTIME_STEPS steps, its checkpoint written to a temporary
            directory removed afterwards.  Counters zeroed just before and
            read just after: flash attention exactly 8 launches a step, no
            other kernel;
            the loss falls (postprocess ``improved``); the train stage's
            overheads (queue, communicator, execute) and placement are
            printed.  Then a paged fp32 ServeEngine on the serve phase's
            settings as a service stage (``session.serve``):
            RUNTIME_REQUESTS greedy requests through the ServiceHandle,
            then drain; every request's tokens equal the same engine's
            ``run_until_drained`` on the same weights, and only the paged
            decode, the paged prefill and the scatter launch.  Rows 1, 3
            and 5 of the kernel table count these launches too.
   exec     the cross-process runtime (``repro_torch.core.exec``): a
            SubprocessTransport of EXEC_WORKERS worker processes, each
            with its own CUDA context on the card: their boot seconds and
            card, the longest heartbeat gap against the timeout, the echo
            round trip (median of EXEC_ECHOS), a tensor of EXEC_WIRE_MB MB
            out and back (MB/s, bitwise); kernels 5 and 3 at tinyllama's
            serving shapes and kernel 7 at the pipeline's, launched by a
            worker and held there to their plain versions; the pipeline (a
            Session on transport="subprocess": a hash shuffle of an
            EXEC_ROWS-row table over EXEC_SHARDS logical shards, then its
            reduction, each in a worker; run twice) bitwise equal to the
            same graph in-process, kernel 7 counted in the worker, the
            per-task overheads of both; the service stage in a worker
            (fp32 tinyllama-1.1b at full width, EXEC_REQUESTS requests of
            the mixed workload): the worker's weights' checksum equal to
            the parent's, then every stream equal to an in-process
            engine's with every token, kernels 3 and 5 launched in the
            worker exactly as in-process, tokens/s of both; a service on
            the pool preempted mid-decode and resumed from the state that
            crossed the wire (its bytes and seconds), streams equal; the
            disaggregated 1 + 1 fleet in bf16 with its KV handoffs shipped
            through a worker (every one) against the in-process fleet
            (streams equal; bytes and ms a handoff); faults: a worker
            SIGKILLed mid-task, a checkpointed task retried on the
            respawned pool with its resume step, a heartbeat stall and a
            dropped reply (each planned fault fires); no worker compiled a
            library; every worker reaped.  The launches counted in the
            workers join rows 3, 5 and 7.
   distributed  ``repro_torch.distributed`` and the dataframe on a process
            mesh (phase_distributed): DIST_RANKS rank processes on the one
            card, each with its own CUDA context, in a gloo group meeting
            through a TCP store on 127.0.0.1 (NCCL refuses two ranks on
            one device, "Duplicate GPU detected"; gloo takes the card's
            tensors in every collective, and its point-to-point send of
            one aborts the process, so the pipeline's messages go through
            host copies), then one NCCL rank in this process, where every
            collective must be the identity (tests/torch_dist_ranks.py
            ``card``).  The dataframe over DIST_ROWS rows in all (an int32
            key uniform in [0, 2^20), an fp32 value; the 2^20-row right
            table): shuffle, sort, join, groupby_sum, reduce_sum on the
            process mesh equal to the same table on a logical mesh of as
            many shards in the rank (columns, masks and drops bitwise,
            groupby sums within DF_PAIR_ATOL), kernel 7 exactly 1 / 0 / 2
            / 1 / 0 times per rank, counted in the ranks; tinyllama-1.1b's
            whole gradient tree (fp32, 1.1 B elements) from one B 2 x S
            512 backward per rank on its own batch, synced with
            ``compressed_grad_sync`` within INT8_REL_TOL of the fp32
            all_reduce mean, bitwise the same on every rank, bytes handed
            to the wire and ms of both; error feedback over DIST_EF_SYNCS
            syncs of the embedding's gradient (each rank's own, and its
            mean, which every rank holds, as in JAX's check) no further
            from the truth than EF_RATIO x the plain syncs; GPipe over the ranks of
            DIST_MICRO microbatches of [8, 512, 2048] (JAX's stage x * 2 +
            w_i) equal to the sequential result within PIPE_RTOL on every
            rank, ms per microbatch.  Each op's backend, world size and
            tensor device are printed.  The ranks' launches join row 7.
   gang     a task ganged over worker processes (phase_gang): a
            RemoteAgent on a SubprocessTransport of GANG_RANKS workers of
            one card each, over a pilot that lists the one card twice
            (cards 0 and 1 on a machine with two or more), runs one
            dataframe task at num_devices=2; the agent leases 2 devices,
            wider than a worker holds, so the transport runs it as a gang
            of 2 gloo ranks (NCCL ranks on distinct cards) meeting in a
            ProcessMesh
            (tests/torch_exec_tasks.py ``gang_dataframe``: shuffle, join,
            groupby, reduce over DIST_ROWS rows, an int32 key uniform in
            [0, 2^20), an fp32 value, the 2^20-row right table).  Rank 0's
            result (every rank's result rows gathered to it) is held
            against the same table on a 2-shard logical mesh here:
            columns, masks and drops bitwise, groupby sums within
            DF_PAIR_ATOL, reduce within DF_REDUCE_RTOL; kernel 7 exactly 1
            / 2 / 1 / 0 times per rank, counted in the ranks.  Worker boot
            and rendezvous seconds, ms per operator per rank against the
            logical mesh and the backend are printed; on a one-card
            machine, where NCCL between distinct cards cannot run, an
            earlier line says so.  The ranks' launches join row 7.
9. dataframe  a 2^26-row table (int32 keys uniform in [0, 2^20), float32
            v, x1, x2 and y = 3 x1 - 2 x2 + noise, from numpy at SEED) on 8
            logical shards of the card: shuffle, sort, join with a 2^20-row
            table (w = 10 k), groupby_sum (2^18 groups per shard) and
            reduce_sum.  Counters zeroed just before, read just after: the
            hash kernel launches exactly 4 times (shuffle 1, join 2,
            groupby 1).  Nothing dropped; the results pass numpy checks on
            the host; the same operators with impl="ref" give the same
            columns, masks and drops bitwise (groupby sums within
            DF_PAIR_ATOL: index_add_ adds with atomics on the card).
10. pipeline  the paper's preprocess -> bridge -> train -> postprocess as
            a Pipeline of a cylon_stage and two dl_stages under the port's
            run_pipelines on a pilot over the card: filter |x1| < 3 on that
            table, a shuffled ZeroCopyLoader (data_bridge) at global batch
            65536, PIPE_STEPS SGD steps of a linear model (w_err < 0.2,
            loss falling), then HostPrefetcher over host batches (arrive
            equal; GB/s).
11. rmsnorm   the fused norm's entry point ``ops.rmsnorm`` on [4096, 2048]
            bf16 activations once per tinyllama layer (22 launches, counted
            as above); then the timing rows of kernels 6 and 7.
12. paper   the paper's tables (``repro_torch.launch.paper_tables``) at
            the JAX package's default sizes, on the card under a
            PilotManager over torch.cuda: Table 3 (the 11 forecasting
            models, 60 SGD steps each, bare-metal and as a RemoteAgent
            task: train seconds, Deep RC total, overhead, MAE, MSE, MAPE),
            Tables 1-2 (the hydrology LSTM, 150 steps on 2000 days:
            per-target train and validation MSE and NNSE, the overhead
            decomposition), Table 4 (11 pipelines of a cylon_stage sort and
            a dl_stage inference against sequential: bm_s, rc_s, saved_s).
            Every task DONE, every metric finite, validation NNSE above 0.5
            for mean_temperature and streamflow, no port kernel launched.
            Then Fig. 4 (``bench_scaling_ops``, not ``full``): sort and
            join over 1, 2, 4 and 8 logical shards of the card, strong and
            weak scaling, one row each; nothing dropped; only the hash
            kernel launches (the join's exchanges; its launches join row
            7).
            The seeded draws are JAX's: ``make_ett_series`` on the card
            against a numpy reference from threefry_np's bits (ETT_TOL).
            Then torch.profiler over PAPER_PROFILE_STEPS SGD steps of the
            GRU and of the LSTM: device idle share, kernels per step.
13. recurrent  the recurrent families at their published widths (random
            weights from a seeded torch.Generator).  xlstm-125m (12 layers,
            d_model 768, 4 heads, mLSTM and sLSTM blocks) through the
            training driver with no --arch (its default), B 8 x S 512,
            XLSTM_STEPS (6) steps: the loss falls and no port kernel launches (JAX's xlstm
            path runs no Pallas kernel); 3 fp32 steps at
            B 2 x S 64 from one state on the card and on the host CPU, loss
            and grad-norm within TRAIN_TOL.  recurrentgemma-9b (38 layers,
            d_model 4096, 12 local layers of H 16, KV 1, head dim 256 over
            a 2048-slot ring, RG-LRU width 4096, vocab 256000) with fp32
            parameters (38.3 GB) and compute, B 2: the no-cache prefill's
            last logits at S 64 against the decode replay's at position 63
            within 1e-3 of their max abs, then 32 greedy tokens, the kernel
            path's stream equal to the plain path's; then with bf16
            parameters at 6 of its 38 layers (two units: 2 RG-LRU, 1
            local each), B 4 decoded through 2112 positions (the ring
            wraps): kernel 2 exactly twice a step and nothing else, every logit finite, the last step's next tokens equal to
            the plain path's on a clone of the cache (a near-tie recorded
            with its gap); tokens/s, step p50, seconds.  Last,
            recurrentgemma-9b trains under its published remat policy
            (save_block_outputs) at full width and 3 of its 38 layers (one
            unit: 2 RG-LRU, 1 local), fp32 parameters: GEMMA_TRAIN_STEPS
            steps of B 2 x S 4096 in bf16 through the training driver
            (``launch.train.run``; its final checkpoint write of the 32.2
            GB state replaced by a stand-in: GEMMA_CKPT_NOTE), the loss
            falling (postprocess ``improved``), no port kernel launched
            (JAX's path for these blocks has no Pallas kernel); then
            GEMMA_PARITY_STEPS fp32 steps (Adafactor: GEMMA_PARITY_OPTIMIZER)
            from one state under no remat, "full" and "save_block_outputs",
            loss and grad-norm within TRAIN_TOL, peak memory and step ms of
            each and the memory its forward and backward hold.
14. encdec  whisper-medium at its published widths (24 + 24 layers,
            d_model 1024, 16 heads, head dim 64, d_ff 4096 GELU, vocab
            51865; 0.81 B parameters in fp32, random from a seeded
            torch.Generator): 10 train steps of B 8 x 1500 frames (seeded
            normal: the stubbed conv front end) and 187 decoder tokens of
            the corpus (bf16 compute, AdamW, remat): the loss falls, flash
            launches exactly 96 times a step (the encoder's full and the
            decoder's causal self-attention, twice under remat) and
            nothing else; one more step profiled; 3 fp32 steps at B 2 on
            the kernel path and the plain path within TRAIN_TOL.  Then B 4 x 1500 frames encoded
            (24 flash launches), the cross cache precomputed and 64
            greedy tokens decoded from the start token: in fp32 the
            kernel path's stream equals the plain path's and the no-cache
            prefill's last logits equal the replay's within 1e-3 of their
            max abs; in bf16 kernel 2 launches exactly 48 times a step
            (self and cross), nothing else; tokens/s, step p50, two more
            steps profiled.  Then
            flash timed at the encoder's shape (B 8, S 1500, full) and
            kernel 2 at the cross decode (B 4, S 1500: split spans and the
            combine pass), SDPA beside.
15. mrope   qwen2-vl-72b at its published widths (d_model 8192, H 64, KV
            8, D 128, d_ff 29568 SwiGLU, vocab 152064) and 4 of its 80
            layers (6.0 B parameters, 24 GB in fp32), on embedding inputs
            with M-RoPE positions (32 text tokens, a 16 x 16 image grid,
            32 text tokens: t, h and w differ): in fp32 the no-cache
            forward's last logits equal the empty-cache prefill of S - 1
            positions (flash exactly 4 launches) plus one decode step at
            (p, p, p) (kernel 2 exactly 4) within 1e-3 of their max abs;
            a loss and its gradient's norm at 2 layers on B 1 x S 512,
            kernel path against plain path within TRAIN_TOL; then bf16
            parameters, B 4 prefilled (flash exactly 4) and 32 greedy
            steps (kernel 2 exactly 4 a step, nothing else); tokens/s,
            step p50, two more steps profiled; kernel 2 timed at its
            decode shape.  Both phases'
            launches and timings join rows 1 and 2 of the kernel table
            (``launches_by_phase``, ``at_other_shapes``).

Each phase's wall seconds are printed on one line (``"phase": "wall"``).

The last lines are the card (nvidia-smi name and power limit), the kernel
table ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent


# the cards the multi-card mode needs
CARDS = 4


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    ap.add_argument("--compare", type=int, default=0, metavar="R",
                    help="run only R rounds of the serve phase on both layouts "
                         "and time the serving kernels' wrappers")
    ap.add_argument("--gang", action="store_true",
                    help="build the kernels and run only the gang phase (on "
                         "distinct cards over NCCL where the machine has two)")
    ap.add_argument("--cards", nargs="?", const="all", choices=("all", "check"),
                    help="on a machine of at least 4 cards: build the kernels and "
                         "run the multi-card mode (--cards check: its first part "
                         "alone)")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the package to drive (another checkout's src/)")
    return ap.parse_args(argv)


ARGS = parse_args(sys.argv[1:])
sys.path.insert(0, str(ARGS.src.resolve()))
sys.path.insert(0, str(ROOT / "tests"))  # the scatter's edge cases

from repro_torch.bridge.loader import HostPrefetcher  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.params import Param, init_params, map_tree, tree_leaves  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.dataframe import ops_dist as dfo  # noqa: E402
from repro_torch.dataframe.ops_local import filter_rows  # noqa: E402
from repro_torch.dataframe.table import Table  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import hash_partition as hp  # noqa: E402
from repro_torch.kernels import prefill_attention as pf  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import make_corpus  # noqa: E402
from repro_torch.models.lm import lm_paged_cache_specs  # noqa: E402
from repro_torch.serve import Request, RequestState, ServeEngine  # noqa: E402
from repro_torch.train.state import (abstract_train_state, init_train_state,  # noqa: E402
                                     model_specs)
from repro_torch.train.step import (make_loss_fn, make_prefill_chunk_step,  # noqa: E402
                                    make_train_step)
import paged_scatter_cases  # noqa: E402
import torch_dist_ranks as DR  # noqa: E402
import torch_exec_tasks as XT  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# kernel vs plain, per element: fp32 sums in another order (~1e-6 seen),
# 1e-4; bf16 outputs may round one bf16 ulp of the plain value apart, so
# max(2e-2, that ulp) (2e-2 below |x| = 4, one ulp at and above it)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_NOTE = {torch.float32: "1e-4", torch.bfloat16: "max(2e-2, 1 bf16 ulp of |plain|)"}
ARCH = "tinyllama-1.1b"
# the second dense config, at full width: head dim 96, G 1
PHI3, PHI3_REQUESTS = "phi3-mini-3.8b", 4
# the MLA and the MoE config, at full width, and the requests each serves
# per layout; moonshot's parameters are bf16 (fp32 would be 110 GB)
MLA, MOE, MLA_MOE_REQUESTS = "minicpm3-4b", "moonshot-v1-16b-a3b", 4
MOE_PARAM_DTYPE = torch.bfloat16
# minicpm3 serves at MLA_LAYERS of its 62 layers (cut in depth for the
# 1200 s limit: at 62 the phase took 106-179 s, PERF.md section 7; the
# kernel's shape does not depend on the depth)
MLA_LAYERS = 16
# arctic-480b (its published gather MoE dispatch, bf16 parameters) serves
# at ARCTIC_LAYERS of its 35 layers: 55.8 GB, about moonshot's 55.1
ARCTIC, ARCTIC_LAYERS = "arctic-480b", 2
# the sampling phase: seeds of the threefry check (64, half >= 2^32), and
# the temperature of the sampled serving run
SAMPLE_SEEDS, SAMPLE_TEMPERATURE = 64, 1.0
# engine steps of the decode windows the profile, sampling and mla_moe
# phases profile (2 since the recurrent phase joined the run, 4 before:
# processing a trace costs ~0.5 ms an event, ~10^4 events a step)
PROFILE_WINDOW = 2
# the fleet phase: requests of its stream checks (fp32), of its rate runs
# (bf16) and rounds of those; the chunk widths a prefill-only engine gives
# kernel 5 (whole prompts up to max_len), checked and timed at B 8
FLEET_REQUESTS, FLEET_RATE_REQUESTS, FLEET_ROUNDS = 8, 16, 3
FLEET_T = (128, 256, 512)
PAGE = 16
MAX_LEN = 512
# the serve engine's settings, for every served config; the kernels are
# checked at the shapes they give (serving_shape_cases)
SERVE = {"max_slots": 8, "max_len": MAX_LEN, "page_size": PAGE,
         "prefill_chunk_tokens": 64}
# rounds of the serve phase per layout: tokens/s is read as a median and
# a spread, never from one run
SERVE_ROUNDS = 3
SEED = 0
LAYOUTS = ("paged", "contiguous")
# each wrapper's launch counter, and the kernels each path runs
COUNTED = {"decode_attention_paged": dec.decode_attention_paged_kernel,
           "prefill_attention_paged": pf.prefill_attention_paged_kernel,
           "paged_scatter": pf.write_chunk_paged_kernel,
           "decode_attention": dec.decode_attention_kernel,
           "prefill_attention": pf.prefill_attention_kernel,
           "flash_attention": fa.flash_attention_kernel,
           "rmsnorm": rms.rmsnorm_kernel,
           "hash_partition_histogram": hp.hash_partition_histogram_kernel}
# (the paged cache scatter is the second entry point of kernel 5's
# library: the prefill and every decode append launch it)
PATH_KERNELS = {"paged": ("decode_attention_paged", "prefill_attention_paged", "paged_scatter"),
                "contiguous": ("decode_attention", "prefill_attention"),
                "train": ("flash_attention",),
                "dataframe": ("hash_partition_histogram",),
                "rmsnorm": ("rmsnorm",)}
# each kernel's device symbols on its path (torch.profiler event names):
# the bf16 bodies that serving and training run (the fp32 bodies of
# kernels 1, 2, 4 and 5 are flash_fwd_kernel, contig_decode_split_kernel,
# contig_prefill_kernel and prefill_kernel; the paged decode's fp32 body
# is decode_split_kernel); neither decode launches a combine pass at
# S <= 512
SYMBOLS = {"decode_attention_paged": ("paged_decode_mma_kernel",),
           "prefill_attention_paged": ("prefill_paged_wgmma_kernel",),
           "paged_scatter": ("paged_scatter_kernel",),
           "decode_attention": ("contig_decode_mma_kernel",),
           "prefill_attention": ("chunk_scatter_kernel", "contig_prefill_wgmma_kernel"),
           "flash_attention": ("flash_fwd_wgmma_kernel",),
           "rmsnorm": ("rmsnorm_kernel",),
           "hash_partition_histogram": ("hash_hist_kernel",)}
# the libraries of the serving kernels redesigned for the tensor cores,
# and the instruction their SASS must hold (HMMA: mma.sync; HGMMA: wgmma)
TC_SASS = {"decode_attention": "HMMA", "decode_attention_paged": "HMMA",
           "prefill_attention": "HGMMA", "prefill_attention_paged": "HGMMA"}
# the train phase: B x S tokens per step, as many steps; the kernel path
# and the plain path in fp32 must agree in loss and grad-norm within
# TRAIN_TOL (relative) at each of PARITY_STEPS steps: both are fp32 with
# TF32 off, but they sum in other orders (and the embedding gather's
# backward adds with atomics), which AdamW's normalised steps carry on
TRAIN_B, TRAIN_S, TRAIN_STEPS, PARITY_STEPS = 8, 512, 20, 3
# the train phase's checkpoint round trip holds the trained state cut to
# its first CKPT_LAYERS layers (the whole 13.2 GB state took 118-133 s to
# write of the 1200 s limit, PERF.md section 7; the runtime phase's
# driver writes its own state whole)
CKPT_LAYERS = 4
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3}
# the dryrun phase: the card's train-step peak over the meta run's estimate
# must lie in DRYRUN_BAND; the full-width cells it dry-runs on both
# production meshes; its time limit (the meta runs stay on the host)
DRYRUN_BAND = (0.8, 1.25)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "decode_32k"))
DRYRUN_LIMIT_S = 30.0
# rmsnorm, kernel vs plain, as atol = rtol (tests/test_kernels.py's
# tolerances): fp32 sums in another order; bf16 one ulp of the cast,
# which is 2^-7 of the value's power of two, so it grows with the value
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RMS_SHAPE = (4096, 2048)  # tinyllama's training activations, B 8 x S 512
# the dataframe phase: rows of the left table on DF_SHARDS logical shards,
# keys uniform in [0, DF_KEYS), a right table of DF_KEYS rows, groupby
# slots per shard; the hash kernel launches once per hash exchange
DF_ROWS, DF_SHARDS, DF_KEYS, DF_GROUPS = 1 << 26, 8, 1 << 20, 1 << 18
DF_LAUNCHES = {"shuffle": 1, "sort": 0, "join": 2, "groupby": 1, "reduce": 0}
# float sums, host float64 vs the card's float32 (groupby: absolute, a
# group holds ~64 values; reduce: relative)
DF_SUM_TOL = 1e-3
# the standardized ETT series on the card against its numpy reference
# (the repo's parity limit for it against JAX's)
ETT_TOL = 1e-5
# groupby sums, kernel run vs impl="ref" run (absolute): the same float32
# sums of ~64 values in another order (index_add_ adds with atomics)
DF_PAIR_ATOL = 1e-4
PIPE_BATCH, PIPE_STEPS = 65536, 1024
# the runtime phase: the training entry point's stage graph for RUNTIME_STEPS
# steps of B x S tokens (TRAIN_B, TRAIN_S), then RUNTIME_REQUESTS greedy
# requests through a service stage
RUNTIME_STEPS, RUNTIME_REQUESTS = 10, 4
# the paper phase: validation NNSE above 0.5 (NSE > 0, better than the
# mean) for these hydrology targets; steps of the profiled windows
NNSE_TARGETS, PAPER_PROFILE_STEPS = ("mean_temperature", "streamflow"), 5
# the recurrent phase.  xlstm-125m through the training driver's default
# arch (B x S tokens a step, as many steps), then fp32 steps at B x S on
# the card and on the host CPU (loss and grad-norm within TRAIN_TOL);
# 6 steps since the exec phase joined the run (10 before: 65 s of the
# 1200 s limit, PERF.md section 7): the driver's postprocess holds the
# mean of the last 5 losses below that of the first 5, which needs 6.
# No step is profiled since the distributed phase joined (the profiler
# took 29.8 s over one step's 142,672 kernels; PERF.md section 5 keeps
# the earlier profile, the xlstm code unchanged since).
# recurrentgemma-9b with fp32 parameters and compute: the no-cache
# prefill's last logits against the decode replay's at the same position
# within GEMMA_PREFILL_TOL of their max abs, then GEMMA_GEN greedy tokens
# on the kernel path and the plain path; then with bf16 parameters, B
# GEMMA_RING_B decoded token by token through GEMMA_RING_STEPS positions,
# past the 2048-slot ring of its local layers, at GEMMA_RING_LAYERS of its
# 38 layers (two units, 2 local layers: the 38-layer run took 141.6 s of
# the 1200 s limit, PERF.md section 7; the ring and kernel 2's shape do
# not depend on the depth)
XLSTM, GEMMA = "xlstm-125m", "recurrentgemma-9b"
XLSTM_B, XLSTM_S, XLSTM_STEPS = 8, 512, 6
XLSTM_PARITY_B, XLSTM_PARITY_S, XLSTM_PARITY_STEPS = 2, 64, 3
GEMMA_B, GEMMA_PREFILL_S, GEMMA_GEN, GEMMA_PREFILL_TOL = 2, 64, 32, 1e-3
GEMMA_RING_B, GEMMA_RING_STEPS, GEMMA_RING_LAYERS = 4, 2112, 6
# kernel 2 at recurrentgemma's ring decode: B rows over a full ring of S
# slots (the checks' lengths in ring_decode_cases)
RING_B, RING_S = 8, 2048
# the encdec phase: whisper-medium trains on WHISPER_B x WHISPER_FRAMES
# frames (the stubbed conv front end's output, seeded normal) and
# frames // dec_len_ratio decoder tokens of the corpus for WHISPER_STEPS
# steps (fp32 parameters, bf16 compute), then WHISPER_PARITY_STEPS fp32
# steps at WHISPER_PARITY_B on the kernel path and the plain path
# (TRAIN_TOL); it decodes WHISPER_DEC_B rows of WHISPER_GEN greedy tokens
# from a start token over a self cache of WHISPER_MAX_LEN positions (the
# model's text context) and the cross cache of its encoded frames: fp32
# streams kernel == plain, the no-cache prefill's last logits against the
# decode replay's within WHISPER_PREFILL_TOL of their max abs, then bf16
WHISPER = "whisper-medium"
WHISPER_B, WHISPER_FRAMES, WHISPER_STEPS = 8, 1500, 10
WHISPER_PARITY_B, WHISPER_PARITY_STEPS = 2, 3
WHISPER_DEC_B, WHISPER_GEN, WHISPER_MAX_LEN, WHISPER_PREFILL_TOL = 4, 64, 448, 1e-3
# the start-of-transcript token the decodes begin from (whisper's <|startoftranscript|>)
WHISPER_START = 50258
# the mrope phase: qwen2-vl-72b at its published widths with its depth cut
# to QWEN_LAYERS of 80; embedding inputs of QWEN_TEXT text tokens, a
# QWEN_GRID image and QWEN_TEXT text tokens with M-RoPE positions; the fp32
# no-cache forward against the empty-cache prefill plus one decode step
# (QWEN_PREFILL_TOL of the max abs logit); a loss and its grads at
# QWEN_PARITY_LAYERS layers on B 1 x QWEN_PARITY_S, kernel path against
# plain path (TRAIN_TOL); then bf16 parameters, QWEN_DEC_B rows prefilled
# and decoded QWEN_GEN greedy tokens
QWEN = "qwen2-vl-72b"
QWEN_LAYERS, QWEN_PARITY_LAYERS, QWEN_PARITY_S = 4, 2, 512
QWEN_TEXT, QWEN_GRID, QWEN_B, QWEN_PREFILL_TOL = 32, (16, 16), 2, 1e-3
QWEN_DEC_B, QWEN_GEN = 4, 32
# the runtime phase trains tinyllama-1.1b through the driver at this many
# of its 22 layers: its final checkpoint write of the full 13.2 GB state
# took ~107 s of the phase (PERF.md section 5), 3.7 GB at 4 layers
RUNTIME_LAYERS = 4
# the exec phase: a pool of EXEC_WORKERS worker processes of one card each;
# EXEC_ECHOS echo round trips and a tensor of EXEC_WIRE_MB MB out and back;
# the pipeline's table of EXEC_ROWS rows on EXEC_SHARDS logical shards;
# EXEC_REQUESTS fp32 requests through the service stage in a worker, and
# EXEC_PREEMPT_REQUESTS through a service preempted and resumed across the
# wire; the disaggregated 1 + 1 fleet's EXEC_FLEET_REQUESTS bf16 requests
# of EXEC_FLEET_GEN tokens on engines of EXEC_FLEET_SLOTS slots, prompts of
# 9-16 tokens (one chunk width, so both fleets run one set of shapes); the
# attempt deadline that recovers a dropped reply
EXEC_WORKERS, EXEC_ECHOS, EXEC_WIRE_MB = 2, 50, 256
EXEC_ROWS, EXEC_SHARDS = 1 << 24, 8
EXEC_REQUESTS, EXEC_PREEMPT_REQUESTS = 8, 4
EXEC_FLEET_REQUESTS, EXEC_FLEET_GEN, EXEC_FLEET_SLOTS = 4, 6, 2
EXEC_ATTEMPT_S = 5.0
# the distributed phase: DIST_RANKS gloo rank processes on the one card,
# then one NCCL rank in this process; tables of DIST_ROWS rows in all
# (groupby slots for every key on a shard); tinyllama's whole gradient
# tree from one backward of B DIST_GRAD_B x S TRAIN_S per rank; DIST_EF_SYNCS syncs of
# the embedding's gradient with error feedback; GPipe of DIST_MICRO
# microbatches of [TRAIN_B, TRAIN_S, d_model]; the quantized sync within
# INT8_REL_TOL of the exact mean (max abs error over max abs, per leaf:
# JAX's bound), error feedback no worse than EF_RATIO x the plain syncs
# (JAX's check), GPipe within PIPE_RTOL of the sequential result
DIST_RANKS, DIST_ROWS, DIST_GRAD_B, DIST_EF_SYNCS, DIST_MICRO = 2, 1 << 25, 2, 8, 8
DIST_TIMEOUT_S = 400
# the gang phase: GANG_RANKS worker processes of one card each, ganged by
# the agent over a pilot that lists the one card twice, or distinct cards
# where the machine has them (the distributed phase's tables); the
# attempt's deadline
GANG_RANKS, GANG_ATTEMPT_S = 2, 600.0
# the multi-card mode (--cards): the mesh scenario's and the gang's tables
# of CARDS_ROWS rows (2^24 a rank), the (data, pipe) mesh over the ranks
CARDS_ROWS, CARDS_GRID = 1 << 26, (2, 2)
# the five kernels that raise their dynamic shared-memory cap past 48 KB
TC_KERNELS = ("decode_attention", "decode_attention_paged", "prefill_attention",
              "prefill_attention_paged", "flash_attention")
INT8_REL_TOL, EF_RATIO, PIPE_RTOL, DF_REDUCE_RTOL = 0.02, 1.05, 1e-5, 1e-5
# recurrentgemma-9b trained under its published remat policy: 3 of its 38
# layers (one unit), B x S in bf16 through the driver for as many steps,
# then fp32 steps at GEMMA_PARITY_B x S under each remat mode
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_B, GEMMA_TRAIN_S, GEMMA_TRAIN_STEPS = 3, 2, 4096, 6
GEMMA_PARITY_B, GEMMA_PARITY_STEPS = 1, 2
# the fp32 steps' optimizer: Adafactor's factored moments, so that three
# runs of the 2.69 B-parameter model stay on the card beside what this
# process holds by then (AdamW's two moments and its temporaries on the
# 4.2 GB embedding peaked at 72.4 GB alone and ran out of memory in the
# whole script); the remat policy is a property of the forward and
# backward, which the optimizer does not touch
GEMMA_PARITY_OPTIMIZER = "adafactor"
GEMMA_CKPT_NOTE = ("the driver's final checkpoint of the 32.2 GB train state (the "
                   "untied 256000 x 4096 embedding and head, AdamW's moments) would "
                   "take ~250 s at the ~127 MB/s the train phase's write runs; the "
                   "stand-in records the step the driver saves; the runtime phase "
                   "writes the driver's checkpoint for real")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_lines() -> list:
    """nvidia-smi's name and power limit of every card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()


def gpu_line() -> str:
    return gpu_lines()[0]


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotate(items):
    """A function returning the next of ``items`` on each call: one input
    set per layer, so repeated timing does not run out of L2."""
    cyc = itertools.cycle(items)
    return lambda: next(cyc)


# -- inputs ------------------------------------------------------------------


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def paged_pool(gen, B, KV, D, max_pages, lens, dtype, page=PAGE):
    """Pools with spare pages and a scrambled table giving each row exactly
    the pages ``lens`` need (at most max_pages); every other entry is a
    sentinel (>= num_pages)."""
    need = [min(-(-max(int(n), 0) // page), max_pages) for n in lens]
    num_pages = sum(need) + 3
    ids = torch.randperm(num_pages, generator=gen, device="cuda").tolist()
    bt = torch.full((B, max_pages), num_pages, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n], dtype=torch.int32)
        bt[b, n:] += b  # sentinels past num_pages too
        ids = ids[n:]
    kp = randn(gen, (num_pages, page, KV, D), dtype)
    vp = randn(gen, (num_pages, page, KV, D), dtype)
    return kp, vp, bt.cuda()


def i32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")


def decode_case(gen, H, KV, D, max_pages, lens, dtype, page=PAGE):
    B = len(lens)
    kp, vp, bt = paged_pool(gen, B, KV, D, max_pages, lens, dtype, page)
    return randn(gen, (B, H, D), dtype), kp, vp, bt, i32(lens)


def prefill_case(gen, T, H, KV, D, max_pages, base, clens, dtype):
    B = len(base)
    kp, vp, bt = paged_pool(gen, B, KV, D, max_pages,
                            [max(b + c, 1) for b, c in zip(base, clens)], dtype)
    return (randn(gen, (B, T, H, D), dtype), randn(gen, (B, T, KV, D), dtype),
            randn(gen, (B, T, KV, D), dtype), kp, vp, bt, i32(base), i32(clens))


def contig_decode_case(gen, H, KV, D, S, lens, dtype):
    """q and contiguous caches for ``lens`` (a list: one row each; an
    int: three rows sharing one scalar length)."""
    B = len(lens) if isinstance(lens, list) else 3
    return (randn(gen, (B, H, D), dtype), randn(gen, (B, S, KV, D), dtype),
            randn(gen, (B, S, KV, D), dtype), i32(lens))


def contig_prefill_case(gen, T, H, KV, D, S, base, clens, dtype):
    B = len(base)
    return (randn(gen, (B, T, H, D), dtype), randn(gen, (B, T, KV, D), dtype),
            randn(gen, (B, T, KV, D), dtype), randn(gen, (B, S, KV, D), dtype),
            randn(gen, (B, S, KV, D), dtype), i32(base), i32(clens))


def elem_limit(want: torch.Tensor) -> torch.Tensor:
    """Each element's limit against the plain value ``want``: TOL for
    fp32; for bf16 the larger of 2e-2 and one bf16 ulp of |want|
    (2^(e - 8) for |want| = m 2^e, m in [0.5, 1))."""
    if want.dtype != torch.bfloat16:
        return torch.full_like(want, TOL[want.dtype], dtype=torch.float32)
    _, e = torch.frexp(want.float().abs())
    return torch.clamp(torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8),
                       min=TOL[torch.bfloat16])


def vs_plain(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, every element within elem_limit of the plain)."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= elem_limit(want)).all())


def check_contig_decode(args, window=0):
    """(max abs error vs plain, every element within its limit and empty
    rows exactly zero)."""
    got = dec.decode_attention_kernel(*args, window=window)
    want = dec.decode_attention_plain(*args, window=window)
    empty = args[3].expand(got.shape[0]) == 0
    err, within = vs_plain(got, want)
    return err, within and bool((got[empty] == 0).all())


def check_contig_prefill(args):
    """(max abs error vs plain, every element within its limit, caches
    equal and padding rows exactly zero); each side writes its own copy
    of the caches."""
    q, kn, vn, kc, vc, base, clens = args
    got, gk, gv = pf.prefill_attention_kernel(q, kn, vn, kc.clone(), vc.clone(),
                                              base, clens)
    want, wk, wv = pf.prefill_attention_plain(q, kn, vn, kc.clone(), vc.clone(),
                                              base, clens)
    pad = torch.arange(q.shape[1], device=q.device)[None, :] >= clens[:, None]
    err, within = vs_plain(got, want)
    return err, (within and torch.equal(gk, wk) and torch.equal(gv, wv)
                 and bool((got[pad] == 0).all()))


def check_decode(args, window=0):
    """(max abs error vs plain, every element within its limit and empty
    rows exactly zero)."""
    got = dec.decode_attention_paged_kernel(*args, window=window)
    want = dec.decode_attention_paged_plain(*args, window=window)
    empty = args[4].expand(got.shape[0]) == 0
    err, within = vs_plain(got, want)
    return err, within and bool((got[empty] == 0).all())


def check_prefill(args):
    """(max abs error vs plain, every element within its limit, pools
    equal and padding rows exactly zero); each side writes its own copy
    of the pools."""
    q, kn, vn, kp, vp, bt, base, clens = args
    got, gk, gv = pf.prefill_attention_paged_kernel(
        q, kn, vn, kp.clone(), vp.clone(), bt, base, clens)
    want, wk, wv = pf.prefill_attention_paged_plain(
        q, kn, vn, kp.clone(), vp.clone(), bt, base, clens)
    pad = torch.arange(q.shape[1], device=q.device)[None, :] >= clens[:, None]
    err, within = vs_plain(got, want)
    return err, (within and torch.equal(gk, wk) and torch.equal(gv, wv)
                 and bool((got[pad] == 0).all()))


def flash_case(gen, B, H, KV, S, D, dtype):
    """q, k, v as the model hands them over: [B, S, heads, D] activations
    viewed as [B, heads, S, D]."""
    return tuple(randn(gen, (B, S, n, D), dtype).transpose(1, 2)
                 for n in (H, KV, KV))


def check_flash(args, causal=True):
    """(max abs error vs plain, every element within its limit and the
    output shaped and typed like q)."""
    got = fa.flash_attention_kernel(*args, causal=causal)
    want = fa.flash_attention_plain(*args, causal=causal)
    err, within = vs_plain(got, want)
    return err, within and got.shape == args[0].shape and got.dtype == args[0].dtype


# -- phases ------------------------------------------------------------------


def tc_instructions(name: str, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of library ``name``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                          check=True, capture_output=True, text=True).stdout
    return sum(1 for ln in sass.splitlines() if f" {opcode}." in ln)


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "registers", "spill"))]
             for name, log in logs.items()}
    sass = {name: {opcode: tc_instructions(name, opcode)}
            for name, opcode in TC_SASS.items()}
    if not all(n for counts in sass.values() for n in counts.values()):
        raise AssertionError(f"a redesigned kernel has no tensor-core instruction: {sass}")
    emit({"phase": "build", "ok": True, "seconds": secs, "gpu": gpu_line(),
          "nvcc": " ".join(build.NVCC_FLAGS), "ptxas": ptxas,
          "tensor_core_sass": sass})


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    shapes = {"full": (32, 4, 64, 32, 64),   # H, KV, D, max_pages, chunk T
              "smoke": (8, 2, 16, 8, 8)}
    for dtype in (torch.float32, torch.bfloat16):
        for sname, (H, KV, D, mp, T) in shapes.items():
            S = PAGE * mp
            # empty row, one token, page edges, half, nearly full, full
            lens = [0, 1, PAGE - 1, PAGE, PAGE + 1, S // 2 + 3, S - 1, S]
            err, ok = check_decode(decode_case(gen, H, KV, D, mp, lens, dtype))
            cases.append({"kernel": "decode_attention_paged", "shape": sname,
                          "dtype": str(dtype), "max_abs_err": err,
                          "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
                raise AssertionError(f"decode kernel disagrees: {cases[-1]}")
            # full chunk at 0, inside one page, inert row, straddling and
            # deep chunks, one ending on the last page, one token, one
            # straddling the first page edge
            base = [0, 5, 13, 100 % (S - T), 37 % (S - T), S - T, 0, PAGE - 4]
            clens = [T, 3, 0, T, T // 2 + 1, T, 1, T - 1]
            err, ok = check_prefill(prefill_case(gen, T, H, KV, D, mp, base,
                                                 clens, dtype))
            cases.append({"kernel": "prefill_attention_paged", "shape": sname,
                          "dtype": str(dtype), "max_abs_err": err,
                          "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
                raise AssertionError(f"prefill kernel disagrees: {cases[-1]}")
            # contiguous decode: empty row, one token, S-1, S, past S; a
            # scalar length; a window; an S that is not a power of two
            for case, S2, lens, window in (
                    ("lengths", S, [0, 1, 37, S // 2 + 3, S - 1, S, S + 5], 0),
                    ("scalar", S, S // 2 + 1, 0),
                    ("window", S, [5, 40, S // 2, S], 40),
                    ("S=200", 200, [0, 1, 100, 199, 200], 0)):
                err, ok = check_contig_decode(
                    contig_decode_case(gen, H, KV, D, S2, lens, dtype), window)
                cases.append({"kernel": "decode_attention", "shape": sname,
                              "case": case, "dtype": str(dtype),
                              "max_abs_err": err, "tol": TOL_NOTE[dtype],
                              "ok": ok})
                if not ok:
                    raise AssertionError(f"contiguous decode kernel disagrees: "
                                         f"{cases[-1]}")
            # contiguous prefill: a full chunk at 0, a partial chunk, an
            # inert row, a chunk ending exactly at S with padding past it,
            # a chunk whose valid tokens run past S (they drop), a row
            # wholly past S
            base = [0, 37, 5, S - T // 2, S - 3, S + 2]
            clens = [T, T // 2 + 1, 0, T // 2, T, 4]
            err, ok = check_contig_prefill(contig_prefill_case(
                gen, T, H, KV, D, S, base, clens, dtype))
            cases.append({"kernel": "prefill_attention", "shape": sname,
                          "dtype": str(dtype), "max_abs_err": err,
                          "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
                raise AssertionError(f"contiguous prefill kernel disagrees: "
                                     f"{cases[-1]}")
        # flash attention: the training shape, an S that is not a multiple
        # of the tile, S = 1, D 16 and 128, G = 1; causal and full
        for causal in (True, False):
            for B, H, KV, S, D in ((TRAIN_B, 32, 4, TRAIN_S, 64), (2, 32, 4, 200, 64),
                                   (3, 8, 2, 1, 64), (2, 8, 2, 77, 16),
                                   (1, 8, 8, 130, 128)):
                err, ok = check_flash(flash_case(gen, B, H, KV, S, D, dtype), causal)
                cases.append({"kernel": "flash_attention", "causal": causal,
                              "shape": [B, H, KV, S, D], "dtype": str(dtype),
                              "max_abs_err": err, "tol": TOL_NOTE[dtype],
                              "ok": ok})
                if not ok:
                    raise AssertionError(f"flash kernel disagrees: {cases[-1]}")
        cases += serving_shape_cases(gen, ARCH, dtype)
        cases += head_dim_96_cases(gen, dtype)
        cases += redesigned_sweeps(gen, dtype)
        # rmsnorm: the training activations, the shapes of
        # tests/test_kernels.py, a block per row (d 5120)
        for shape in (RMS_SHAPE, (4, 17, 256), (1, 5120)):
            x, w = randn(gen, shape, dtype), randn(gen, shape[-1:], dtype)
            out = rms.rmsnorm_kernel(x, w)
            got, want = out.float(), rms.rmsnorm_plain(x, w).float()
            tol = RMS_TOL[dtype]
            diff = (got - want).abs()
            cases.append({"kernel": "rmsnorm", "shape": list(shape), "dtype": str(dtype),
                          "max_abs_err": diff.max().item(),
                          "max_err_over_tol": (diff / (tol + tol * want.abs())).max().item(),
                          "atol_rtol": tol})
            if not (cases[-1]["max_err_over_tol"] <= 1 and out.dtype == dtype
                    and out.shape == x.shape):
                raise AssertionError(f"rmsnorm kernel disagrees: {cases[-1]}")
    # the hash histogram: counts are integers, so bitwise
    for n in (1, 2047, 2048, 2049, 1 << 23):
        keys = hash_keys(gen, n)
        for P in (4, 8, 16, 64, 4096):
            got = hp.hash_partition_histogram_kernel(keys, num_buckets=P)
            ok = torch.equal(got, hp.hash_partition_histogram_plain(keys, num_buckets=P))
            cases.append({"kernel": "hash_partition_histogram", "n": n, "buckets": P,
                          "blocks": got.shape[0], "bitwise_equal": ok})
            if not ok:
                raise AssertionError(f"hash kernel disagrees: {cases[-1]}")
    cases += scatter_cases(gen)
    cases.append(check_no_host_sync(gen))
    cases += head_dim_24_cases(gen)
    cases += fleet_prefill_cases(gen)
    cases += ring_decode_cases(gen)
    cases += encdec_shape_cases(gen)
    cases += mrope_shape_cases(gen)
    emit({"phase": "kernels", "ok": True, "kernels": list(COUNTED),
          "cases": cases})


def fleet_chunk_lens(T, B):
    """A prefill-only engine's chunk of width T: whole prompts at base 0 --
    a full row, one a token short, rows across the middle page and 64-row
    tile edges, 65 and 17 tokens (just past a tile and a page), one token
    and an empty row."""
    return ([T, T - 1, T // 2 + 1, T // 2 - 1, 65, 17, 1, 0] * B)[:B]


def fleet_prefill_cases(gen):
    """Kernel 5 at the widths the fleet's prefill-only engines give it
    (tinyllama-1.1b's H, KV, D; the serve engine's B 8, max_len 512, page
    16; T 128, 256, 512, base 0, fleet_chunk_lens), fp32 and bf16: pools
    bitwise, padding and the empty row exactly zero.  Drawn after every
    other case of the phase, whose inputs stay those of the parent."""
    from repro_torch.models.lm import serving_attention_shapes

    H, KV, D = serving_attention_shapes(get_config(ARCH))["prefill_attention_paged"]
    B, S = SERVE["max_slots"], SERVE["max_len"]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for T in FLEET_T:
            base, clens = [0] * B, fleet_chunk_lens(T, B)
            err, ok = check_prefill(prefill_case(gen, T, H, KV, D, S // PAGE, base, clens,
                                                 dtype))
            out.append({"kernel": "prefill_attention_paged", "shape": f"{ARCH} fleet prefill",
                        "B": B, "T": T, "H": H, "KV": KV, "head_dim": D, "S": S,
                        "page": PAGE, "base": base, "chunk_lens": clens,
                        "dtype": str(dtype), "max_abs_err": err, "tol": TOL_NOTE[dtype],
                        "ok": ok})
            if not ok:
                raise AssertionError(f"paged prefill kernel disagrees at the fleet's "
                                     f"shapes: {out[-1]}")
    return out


def ring_shape():
    """(H, KV, D) of recurrentgemma's ring decode (lm.serving_attention_shapes:
    16, 1, 256 at full width)."""
    from repro_torch.models.lm import serving_attention_shapes

    return serving_attention_shapes(get_config(GEMMA))["decode_attention"]


def ring_decode_cases(gen):
    """Kernel 2 at recurrentgemma's ring decode (B 8, H 16, KV 1, D 256, a
    ring of 2048 slots: four 512-position spans and the combine pass),
    fp32 and bf16: [B] lengths 0, 1, 15-17, 511-513, 1023-1025, 2047 and
    a full ring, and scalar lengths (a full ring, and 1025); empty rows
    exactly zero.  Drawn after every other case of the phase, whose
    inputs stay those of the parent commit."""
    H, KV, D = ring_shape()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for lens in ([0, 1, 15, 16, 17, 511, 512, 513],
                     [1023, 1024, 1025, 2047, RING_S, RING_S, RING_S, RING_S],
                     RING_S, 1025):
            rows = lens if isinstance(lens, list) else [lens] * RING_B
            q, k, v, cl = contig_decode_case(gen, H, KV, D, RING_S, rows, dtype)
            err, ok = check_contig_decode((q, k, v, cl if rows is lens else i32(lens)))
            out.append({"kernel": "decode_attention", "shape": f"{GEMMA} ring decode",
                        "B": RING_B, "H": H, "KV": KV, "head_dim": D, "S": RING_S,
                        "cache_len": lens, "dtype": str(dtype), "max_abs_err": err,
                        "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
                raise AssertionError(f"contiguous decode kernel disagrees at the ring "
                                     f"decode shape: {out[-1]}")
    return out


def ring_decode_row(launches):
    """Kernel 2 at recurrentgemma's ring decode, every row a full ring (B
    8, H 16, KV 1, D 256, S 2048, bf16; one input set per local layer), in
    the kernel table's format with SDPA over K/V expanded to every head
    beside, and the fp32 call (the CUDA-core body) at the same shape;
    ``launches``: the recurrent phase's (filled in after it runs)."""
    H, KV, D = ring_shape()
    dt, esz, B, S, L = torch.bfloat16, 2, RING_B, RING_S, 12
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    lens = [S] * B
    cases = [contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)]
    err = max(check_contig_decode(a)[0] for a in cases[:2])
    lib = [contig_sdpa_inputs(
        q[:, :, None], k, v,
        (torch.arange(S, device="cuda")[None, :] < cl[:, None])[:, None, None, :], H, KV)
        for q, k, v, cl in cases]
    nxt, lib_nxt = rotate(cases), rotate(lib)
    fn, plain = dec.decode_attention_kernel, dec.decode_attention_plain
    live = sum(lens)
    bytes_ = 2 * live * KV * D * esz + 2 * B * H * D * esz + 4 * B
    row = kernel_row(
        "decode_attention", "src/repro/kernels/decode_attention.py:114", launches, err,
        cuda_ms(lambda: fn(*nxt())), cuda_ms(lambda: plain(*nxt())), bytes_,
        4 * H * D * live, cuda_ms(lambda: sdpa(*lib_nxt())), CONTIG_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "S": S, "cache_len": lens, "arch": GEMMA,
         "ring": True, "dtype": str(dt)},
        lib_us=device_us_per_call(lambda: sdpa(*lib_nxt()))[0])
    us, by_kernel = device_us_per_call(lambda: fn(*nxt()), reps=2 * L)
    if us is None:  # the profiler window came back empty: not measured
        row["device_us_per_launch"] = None
    else:
        redesigned(row, us, by_kernel, design="mma.sync m16n8k16, GQA-packed; D 256: Q "
                   "staged in shared memory, 2 tiles in flight", header="decode_tc.cuh")
    row["fp32"] = fp32_timing(cases, fn, plain, check_contig_decode, bytes_, esz, live, KV,
                              B, H, D, L, "contig_decode_split_kernel + "
                              "decode_combine_kernel (CUDA cores)")
    del cases, lib
    emit({"phase": "timing", "ok": True, "arch": GEMMA, "ring_decode": True, "rows": [row]})
    return row


def decode_step_shape(arch):
    """(H, KV, D) of ``arch``'s decode step (lm.serving_attention_shapes:
    whisper 16, 16, 64; qwen2-vl 64, 8, 128 at full width)."""
    from repro_torch.models.lm import serving_attention_shapes

    return serving_attention_shapes(get_config(arch))["decode_attention"]


def shape_case_checks(kind, shape, runs):
    """Run ``runs`` (``[(fields, thunk)]``, each thunk returning (max abs
    error, ok)) and raise on the first disagreement."""
    out = []
    for fields, thunk in runs:
        err, ok = thunk()
        out.append({**fields, "shape": shape, "max_abs_err": err,
                    "tol": TOL_NOTE[fields["dtype"]], "ok": ok})
        out[-1]["dtype"] = str(fields["dtype"])
        if not ok:
            raise AssertionError(f"{fields['kernel']} disagrees at {kind} shapes: {out[-1]}")
    return out


def encdec_shape_cases(gen):
    """The two kernels at the shapes whisper-medium's paths give them, fp32
    and bf16: flash full over the encoder's 1500 frames (B 2, H 16, KV 16,
    D 64) and causal over the decoder's 187 tokens; kernel 2 over the
    cross cache [B 4, 1500, 16, 64] at scalar lengths 1, 511-513, 1024,
    1499 and 1500 (past 512 positions: split spans and the combine pass)
    and over the self cache [B 4, 448, 16, 64] at scalar lengths 0, 1,
    15-17, 447 and 448.  Drawn after every other case of the phase, whose
    inputs stay those of the parent commit."""
    H, KV, D = decode_step_shape(WHISPER)
    dec_len = WHISPER_FRAMES // get_config(WHISPER).dec_len_ratio
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        for S, causal in ((WHISPER_FRAMES, False), (dec_len, True)):
            args = flash_case(gen, 2, H, KV, S, D, dtype)
            runs.append(({"kernel": "flash_attention", "B": 2, "H": H, "KV": KV, "S": S,
                          "head_dim": D, "causal": causal, "dtype": dtype},
                         lambda a=args, c=causal: check_flash(a, c)))
        for S, lens in ((WHISPER_FRAMES, (1, 511, 512, 513, 1024, 1499, 1500)),
                        (WHISPER_MAX_LEN, (0, 1, 15, 16, 17, 447, 448))):
            q, k, v, _ = contig_decode_case(gen, H, KV, D, S, [0] * WHISPER_DEC_B, dtype)
            for n in lens:
                runs.append(({"kernel": "decode_attention", "B": WHISPER_DEC_B, "H": H,
                              "KV": KV, "S": S, "head_dim": D, "cache_len": n, "dtype": dtype},
                             lambda a=(q, k, v, i32(n)): check_contig_decode(a)))
    return shape_case_checks("whisper", f"{WHISPER} encoder-decoder", runs)


def mrope_shape_cases(gen):
    """The two kernels at the shapes qwen2-vl-72b's paths give them (H 64,
    KV 8, D 128), fp32 and bf16: flash causal at S 512 and at a ragged S
    (the mrope phase's prefills); kernel 2 over [B 4, 512, 8, 128] at
    [B] lengths across the 16-key tile and the row's end and at scalar
    lengths.  Drawn after every other case of the phase."""
    H, KV, D = decode_step_shape(QWEN)
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        for S in (512, 2 * QWEN_TEXT + QWEN_GRID[0] * QWEN_GRID[1] - 1):
            args = flash_case(gen, 2, H, KV, S, D, dtype)
            runs.append(({"kernel": "flash_attention", "B": 2, "H": H, "KV": KV, "S": S,
                          "head_dim": D, "causal": True, "dtype": dtype},
                         lambda a=args: check_flash(a)))
        for lens in ([0, 1, 17, 512], [15, 16, 319, 511], 320, 512):
            rows = lens if isinstance(lens, list) else [lens] * QWEN_DEC_B
            q, k, v, cl = contig_decode_case(gen, H, KV, D, 512, rows, dtype)
            runs.append(({"kernel": "decode_attention", "B": QWEN_DEC_B, "H": H, "KV": KV,
                          "S": 512, "head_dim": D, "cache_len": lens, "dtype": dtype},
                         lambda a=(q, k, v, cl if rows is lens else i32(lens)):
                         check_contig_decode(a)))
    return shape_case_checks("qwen2-vl", f"{QWEN} M-RoPE", runs)


def head_dim_24_cases(gen):
    """The contiguous decode at head dim 24, which it alone takes
    (minicpm3's MLA decode at smoke width; the tensor-core body stages and
    multiplies it padded to 32), fp32 and bf16: at the shapes that path
    gives it (serving_shape_cases), and over the contiguous decode sweep's
    S, G, lengths and windows.  Drawn after every other case of the
    phase, whose inputs stay those of the parent commit."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        out += serving_shape_cases(gen, MLA, dtype, smoke=True)
        worst, n = 0.0, 0
        for S, G in itertools.product((32, MAX_LEN, 4096), (1, 4, 8, 16, 32)):
            lens = [0, 1, 7, 8, 15, 16, 17, 63, 64, 65, S - 1, S, S + 5]
            q, k, v, cl = contig_decode_case(gen, 2 * G, 2, 24, S, lens, dtype)
            for c, window in ((cl, 0), (cl, 8), (cl, 64), (cl, 100), (i32(S // 2 + 3), 0)):
                err, ok = check_contig_decode((q, k, v, c), window)
                n, worst = n + 1, max(worst, err)
                if not ok:
                    raise AssertionError(f"contiguous decode kernel disagrees at S {S} D 24 "
                                         f"G {G} window {window} {dtype}: {err}, empty rows "
                                         f"zero: {ok}")
        out.append({"kernel": "decode_attention", "sweep": "S x G x lengths x window at D 24",
                    "cases": n, "dtype": str(dtype), "max_abs_err": worst,
                    "tol": TOL_NOTE[dtype], "empty_rows_zero": True})
    return out


def serving_shape_cases(gen, arch, dtype, smoke: bool = False):
    """The attention kernels ``arch``'s serving path reaches, at the shapes
    it gives them (``serving_attention_shapes``: H and KV after padded_gqa
    and the head dim per kernel, from get_config(arch); B, S, T and the
    page from the serve engine's settings, SERVE): a GQA stack's both
    decodes and both prefills, an MLA stack's contiguous decode alone
    (its latents expanded per head: KV = H, D = nope + rope).  The decodes
    over batches of B rows whose lengths hold an empty row, the 16-key
    (tensor-core) and 32-position (CUDA-core) tile edges, the page edges,
    the 64-key edge and a full row; the prefills with full, partial,
    one-token and empty chunks, at base 0, inside a page, on the 64-key
    edge and across page edges, one ending on the row's last position
    (the contiguous one also a partial chunk running past S: its tail
    drops).  Caches bitwise, padding and empty rows exactly zero."""
    from repro_torch.models.lm import serving_attention_shapes

    shapes = serving_attention_shapes(get_config(arch, smoke=smoke))
    B, S, T, page = (SERVE[k] for k in ("max_slots", "max_len", "prefill_chunk_tokens",
                                        "page_size"))
    mp = S // page
    edges = [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 255, S - 17, S - 1, S]
    edges += [S] * (-len(edges) % B)
    checks = []
    for i in range(0, len(edges), B):
        lens = edges[i:i + B]
        if "decode_attention" in shapes:
            checks.append(("decode_attention", lens, *check_contig_decode(
                contig_decode_case(gen, *shapes["decode_attention"], S, lens, dtype))))
        if "decode_attention_paged" in shapes:
            checks.append(("decode_attention_paged", lens, *check_decode(
                decode_case(gen, *shapes["decode_attention_paged"], mp, lens, dtype))))
    base = ([0, 5, 64, 200, S - T, 13, 100, 3] * B)[:B]
    clens = ([T, 3, T, 0, T, 1, T // 2 + 8, T] * B)[:B]
    if "prefill_attention_paged" in shapes:
        checks.append(("prefill_attention_paged", list(zip(base, clens)), *check_prefill(
            prefill_case(gen, T, *shapes["prefill_attention_paged"], mp, base, clens,
                         dtype))))
    base[-2] = S - T // 2  # its last 8 tokens fall past S and drop
    if "prefill_attention" in shapes:
        checks.append(("prefill_attention", list(zip(base, clens)), *check_contig_prefill(
            contig_prefill_case(gen, T, *shapes["prefill_attention"], S, base, clens,
                                dtype))))
    name = f"{arch}{' smoke' if smoke else ''} serving"
    out = [{"kernel": kernel, "shape": name, "B": B, "H": shapes[kernel][0],
            "KV": shapes[kernel][1], "head_dim": shapes[kernel][2], "S": S, "T": T,
            "page": page, "rows": rows, "dtype": str(dtype), "max_abs_err": err,
            "tol": TOL_NOTE[dtype], "ok": ok}
           for kernel, rows, err, ok in checks]
    if {c["kernel"] for c in out} != set(shapes):
        raise AssertionError(f"{arch}: kernels checked {[c['kernel'] for c in out]}, "
                             f"path reaches {sorted(shapes)}")
    for c in out:
        if not c["ok"]:
            raise AssertionError(f"{c['kernel']} disagrees at {name} shapes: {c}")
    return out


def head_dim_96_cases(gen, dtype):
    """phi3-mini's head dim in all five attention kernels at a small KV 2,
    G 1 and 8 (its serving shapes are serving_shape_cases'): flash causal
    and full, both decodes (the contiguous one also a row past S) and both
    prefills with full, partial and empty chunks and one running past the
    cache.  Caches bitwise, padding and empty rows exactly zero."""
    out = []
    D, KV, mp, S = 96, 2, 16, 256
    for G in (1, 8):
        H = KV * G
        checks = [("flash_attention", *check_flash(flash_case(gen, 2, H, KV, 130, D, dtype),
                                                   causal)) for causal in (True, False)]
        lens = [0, 1, 15, 16, 17, 100, 255, 256]
        checks.append(("decode_attention_paged",
                       *check_decode(decode_case(gen, H, KV, D, mp, lens, dtype))))
        checks.append(("decode_attention", *check_contig_decode(
            contig_decode_case(gen, H, KV, D, S, lens + [300], dtype))))
        base, clens = [0, 5, 30, 200, 250], [17, 3, 17, 0, 6]
        checks.append(("prefill_attention_paged", *check_prefill(
            prefill_case(gen, 17, H, KV, D, mp, base, clens, dtype))))
        checks.append(("prefill_attention", *check_contig_prefill(contig_prefill_case(
            gen, 17, H, KV, D, S, [0, 5, 30, 250, 300], [17, 3, 17, 17, 4], dtype))))
        for kernel, err, ok in checks:
            out.append({"kernel": kernel, "head_dim": D, "G": G, "dtype": str(dtype),
                        "max_abs_err": err, "tol": TOL_NOTE[dtype], "ok": ok})
            if not ok:
                raise AssertionError(f"{kernel} disagrees at head dim 96: {out[-1]}")
    return out


def redesigned_sweeps(gen, dtype):
    """The five kernels redesigned for the tensor cores, on their edges:
    flash attention at every S around the 128-row block and 64-key tile,
    the training S and a long ragged one, D 16 to 128, G 1 and 8, causal
    and full, on [B, S, H, D] views; both prefills at chunks of 1 to 64
    tokens, bases 0 to 500 (a chunk running past max_pages or past the
    row), sentinels in every table, caches bitwise, padding rows zero; the
    contiguous decode at lengths across the 16-key tile and the row's end,
    windows and a scalar length, G 1 to 32, D 16 to 128, S 32 (one block
    a row on both bodies), 512 (one block a row on the tensor cores) and
    4096 (the combine pass), and bf16 off the 16-byte boundary (the
    CUDA-core body) at S 32 and 512, empty rows zero; the paged decode
    at pages of 8, 16, 64 and 128 (a 16-key tile spans pages, or a page
    tiles), rows of one page, 512 positions (one block a row on the
    tensor cores) and 4096 (the combine pass), lengths across the tile
    and page edges, S - 1, S and past S, windows 0, 1, 100 and past every
    length, a scalar length, G 1 to 32, D 16 to 128, sentinels in every
    table, and bf16 off the 16-byte boundary (the CUDA-core body, split
    and one block a row), empty rows zero.  One summary per kernel; any
    case past the tolerance fails the phase."""
    worst, n = 0.0, 0
    for S, D, G, causal in itertools.product((1, 63, 64, 65, 127, 512, 1000),
                                             build.HEAD_DIMS, (1, 8), (True, False)):
        err, ok = check_flash(flash_case(gen, 2, 2 * G, 2, S, D, dtype), causal)
        n, worst = n + 1, max(worst, err)
        if not ok:
            raise AssertionError(f"flash kernel disagrees at S {S} D {D} G {G} "
                                 f"causal {causal} {dtype}: {err}")
    out = [{"kernel": "flash_attention", "sweep": "S x D x G x causal", "cases": n,
            "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype]}]
    worst, n = 0.0, 0
    base = [0, 5, 16, 447, 500, 3]
    for T in (1, 15, 16, 17, 64):
        clens = [T, max(T - 3, 0), T, T, T, 0]
        err, ok = check_prefill(sweep_prefill_case(gen, T, base, clens, dtype))
        n, worst = n + 1, max(worst, err)
        if not ok:
            raise AssertionError(f"paged prefill kernel disagrees at T {T} {dtype}: "
                                 f"{err}, pools equal and padding zero: {ok}")
    out.append({"kernel": "prefill_attention_paged", "sweep": "T x base", "cases": n,
                "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "pools_equal_pad_zero": True})
    worst, n = 0.0, 0
    for T in (1, 15, 16, 17, 64):
        clens = [T, max(T - 3, 0), T, T, T, 0]
        err, ok = check_contig_prefill(contig_prefill_case(gen, T, 32, 4, 64, MAX_LEN, base,
                                                           clens, dtype))
        n, worst = n + 1, max(worst, err)
        if not ok:
            raise AssertionError(f"contiguous prefill kernel disagrees at T {T} {dtype}: "
                                 f"{err}, caches equal and padding zero: {ok}")
    out.append({"kernel": "prefill_attention", "sweep": "T x base", "cases": n,
                "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "caches_equal_pad_zero": True})
    worst, n = 0.0, 0
    for S, D, G in itertools.product((32, MAX_LEN, 4096), build.HEAD_DIMS, (1, 4, 8, 16, 32)):
        lens = [0, 1, 7, 8, 15, 16, 17, 63, 64, 65, S - 1, S, S + 5]
        q, k, v, cl = contig_decode_case(gen, 2 * G, 2, D, S, lens, dtype)
        for c, window in ((cl, 0), (cl, 8), (cl, 64), (cl, 100), (i32(S // 2 + 3), 0)):
            err, ok = check_contig_decode((q, k, v, c), window)
            n, worst = n + 1, max(worst, err)
            if not ok:
                raise AssertionError(f"contiguous decode kernel disagrees at S {S} D {D} "
                                     f"G {G} window {window} {dtype}: {err}, empty rows "
                                     f"zero: {ok}")
    if dtype == torch.bfloat16:  # off the 16-byte boundary: the CUDA-core body
        for S in (32, MAX_LEN):
            args = tuple(unaligned(t) for t in contig_decode_case(
                gen, 32, 4, 64, S, [0, 1, 17, S - 1, S, S + 5], dtype)[:3])
            for window in (0, 8):
                err, ok = check_contig_decode(args + (i32([0, 1, 17, S - 1, S, S + 5]),),
                                              window)
                n, worst = n + 1, max(worst, err)
                if not ok:
                    raise AssertionError(f"contiguous decode kernel disagrees on unaligned "
                                         f"bf16 at S {S} window {window}: {err}, empty "
                                         f"rows zero: {ok}")
    out.append({"kernel": "decode_attention",
                "sweep": "S x D x G x lengths x window (+ unaligned bf16)",
                "cases": n, "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "empty_rows_zero": True})
    worst, n = 0.0, 0
    for page, S, D, G in itertools.product((8, 16, 64, 128), (None, MAX_LEN, 4096),
                                           build.HEAD_DIMS, (1, 4, 8, 16, 32)):
        S = S or page  # None: one page a row
        lens = paged_decode_lens(S, page)
        q, kp, vp, bt, cl = decode_case(gen, 2 * G, 2, D, S // page, lens, dtype, page)
        for c, window in ((cl, 0), (cl, 1), (cl, 100), (cl, S + 5), (i32(S // 2 + 3), 0)):
            err, ok = check_decode((q, kp, vp, bt, c), window)
            n, worst = n + 1, max(worst, err)
            if not ok:
                raise AssertionError(f"paged decode kernel disagrees at page {page} S {S} "
                                     f"D {D} G {G} window {window} {dtype}: {err}, empty "
                                     f"rows zero: {ok}")
    if dtype == torch.bfloat16:  # off the 16-byte boundary: the CUDA-core body
        for page, max_pages in ((PAGE, MAX_LEN // PAGE), (64, 1)):
            S = page * max_pages
            lens = [0, 1, 17, S - 1, S, S + 5]
            q, kp, vp, bt, cl = decode_case(gen, 32, 4, 64, max_pages, lens, dtype, page)
            args = tuple(unaligned(t) for t in (q, kp, vp)) + (bt, cl)
            for window in (0, 8):
                err, ok = check_decode(args, window)
                n, worst = n + 1, max(worst, err)
                if not ok:
                    raise AssertionError(f"paged decode kernel disagrees on unaligned bf16 "
                                         f"at page {page} window {window}: {err}, empty "
                                         f"rows zero: {ok}")
    out.append({"kernel": "decode_attention_paged",
                "sweep": "page x S x D x G x lengths x window (+ unaligned bf16)",
                "cases": n, "dtype": str(dtype), "max_abs_err": worst, "tol": TOL_NOTE[dtype],
                "empty_rows_zero": True})
    return out


def paged_decode_lens(S, page):
    """An empty row, one token, the 16-key tile edges, the page edges, S - 1,
    S and a length past S."""
    return [0, 1, 15, 16, 17, page - 1, page, page + 1, 2 * page + 1, S - 1, S, S + 5]


def unaligned(x):
    """A contiguous copy of ``x`` whose data starts 2 bytes past a 16-byte
    boundary (so either decode takes its CUDA-core body)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def sweep_prefill_case(gen, T, base, clens, dtype, H=32, KV=4, D=64, max_pages=32):
    """Full tinyllama widths; each row gets the pages its prefix needs
    (capped at max_pages), every other entry a sentinel up to 1000 * row
    past num_pages."""
    need = [min(-(-(b + c) // PAGE), max_pages) for b, c in zip(base, clens)]
    num_pages = sum(need) + 2
    ids = torch.randperm(num_pages, generator=gen, device="cuda").tolist()
    bt = torch.full((len(base), max_pages), num_pages, dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n], dtype=torch.int32)
        bt[b, n:] += 1000 * b
        ids = ids[n:]
    B = len(base)
    return (randn(gen, (B, T, H, D), dtype), randn(gen, (B, T, KV, D), dtype),
            randn(gen, (B, T, KV, D), dtype), randn(gen, (num_pages, PAGE, KV, D), dtype),
            randn(gen, (num_pages, PAGE, KV, D), dtype), bt.cuda(), i32(base), i32(clens))


def scatter_cases(gen):
    """The scatter entry point bitwise against the plain write_chunk_paged
    on tests/paged_scatter_cases.py's edge cases, fp32 and bf16."""
    out = []
    sc = paged_scatter_cases
    for dtype in (torch.float32, torch.bfloat16):
        for case, (num_pages, (base, clens, bt)) in sorted(sc.SCATTER_CASES.items()):
            kp, vp = (randn(gen, (num_pages, sc.PAGE, 2, 16), dtype) for _ in range(2))
            kn, vn = (randn(gen, (sc.B, sc.T, 2, 16), dtype) for _ in range(2))
            bt, bs, cl = i32(bt), i32(base), i32(clens)
            gk, gv = pf.write_chunk_paged_kernel(kp.clone(), vp.clone(), bt, kn, vn, bs, cl)
            ok = (torch.equal(gk, pf.write_chunk_paged(kp.clone(), bt, kn, bs, cl))
                  and torch.equal(gv, pf.write_chunk_paged(vp.clone(), bt, vn, bs, cl)))
            out.append({"kernel": "paged_scatter", "case": case, "dtype": str(dtype),
                        "bitwise_equal": ok})
            if not ok:
                raise AssertionError(f"paged scatter kernel disagrees: {out[-1]}")
    return out


def check_no_host_sync(gen):
    """Both prefill wrappers (scatter + attention), both decodes and the
    decode append on the kernel, once each at the serving shape under
    sync-debug "error": a host sync raises and fails the phase."""
    q, kn, vn, kp, vp, bt, bs, cl = sweep_prefill_case(
        gen, 64, [64, 0, 0, 0], [64, 0, 5, 0], torch.bfloat16, max_pages=8)
    idx = i32([5, 17, -1, 127])
    kr, vr = randn(gen, (4, 4, 64), torch.bfloat16), randn(gen, (4, 4, 64), torch.bfloat16)
    contig = contig_prefill_case(gen, 64, 32, 4, 64, MAX_LEN, [64, 0, 0, 0], [64, 0, 5, 0],
                                 torch.bfloat16)
    qd, kc, vc, lens = contig_decode_case(gen, 32, 4, 64, MAX_LEN, [128, 1, 5, 0],
                                          torch.bfloat16)
    dec_args = decode_case(gen, 32, 4, 64, 8, [128, 1, 5, 0], torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pf.prefill_attention_paged_kernel(q, kn, vn, kp, vp, bt, bs, cl)
        ops.paged_append(kp, vp, bt, idx, kr, vr)
        dec.decode_attention_paged_kernel(*dec_args)
        pf.prefill_attention_kernel(*contig)
        dec.decode_attention_kernel(qd, kc, vc, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"kernel": "serving kernels", "check": "no host sync",
            "calls": ["prefill_attention_paged_kernel", "ops.paged_append",
                      "decode_attention_paged_kernel", "prefill_attention_kernel",
                      "decode_attention_kernel"],
            "sync_debug_mode": "error", "ok": True}


def hash_keys(gen, n):
    """n int32 keys over the whole int32 range, the extremes first."""
    keys = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    ext = torch.tensor([-1, 0, 1, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32)[:n]
    keys[:len(ext)] = ext.cuda()
    return keys


def mixed_requests(n: int, vocab: int, seed: int):
    """The repo's mixed workload shape (benchmarks/workload.py) at the real
    vocabulary: ~80% prompts of 4-16 tokens, ~20% of 96-160 (at least two),
    16-32 new tokens each."""
    rng = np.random.default_rng(seed)
    is_long = rng.random(n) < 0.2
    is_long[: max(2, n // 16)] = True
    lens = np.where(is_long, rng.integers(96, 161, n), rng.integers(4, 17, n))
    gens = rng.integers(16, 33, n)
    prompts = [rng.integers(1, vocab, int(l)).astype(np.int32) for l in lens]
    return list(zip(prompts, gens.tolist()))


def serve_engine(cfg, params, **kw):
    return ServeEngine(cfg, params=params, **SERVE, **kw)


def zero_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


def path_kernels(cfg, layout):
    """The kernels the serving path of ``cfg`` launches on ``layout``: a
    GQA stack the layout's decode and prefill (and, paged, the scatter);
    an MLA stack the contiguous decode alone on either layout (its latent
    writes and gathers are plain PyTorch, as JAX's are plain jnp)."""
    if cfg.attention == "mla":
        return ("decode_attention",)
    return PATH_KERNELS[layout]


def phase_serve(cfg, params, layout, n: int = 16, round_: int = 0, temperature=0.0):
    """The main path on one KV layout, ``n`` requests (sampled at
    ``temperature`` when > 0, each from its own seed): every counter
    zeroed just before the run and read just after."""
    work = mixed_requests(n, cfg.vocab_size, SEED)
    path = path_kernels(cfg, layout)
    sampling = dict(temperature=temperature) if temperature > 0 else {}
    warm = serve_engine(cfg, params, kv_layout=layout)  # cuBLAS, libraries
    for p, _ in work[:2]:
        warm.submit(p, max_new_tokens=4)
    warm.run_until_drained()
    del warm

    eng = serve_engine(cfg, params, kv_layout=layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=g, seed=SEED + i, **sampling)
            for i, (p, g) in enumerate(work)]
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    bad = [r.rid for r in reqs
           if r.state is not RequestState.DONE or len(r.tokens) != r.max_new_tokens
           or not all(0 <= t < cfg.padded_vocab for t in r.tokens)]
    if bad:
        raise AssertionError(f"requests not served in full: {bad}")
    dec_name, pf_name = (path + (None,))[:2]
    if min(launches[n] for n in path) <= 0:
        raise AssertionError(f"a kernel never launched on the {layout} path: "
                             f"{launches}")
    if "paged_scatter" in path and \
            launches["paged_scatter"] != launches[dec_name] + launches[pf_name]:
        raise AssertionError(f"the paged scatter launched {launches['paged_scatter']} "
                             f"times, not once per prefill call and decode append")
    others = {n: c for n, c in launches.items() if n not in path}
    if any(others.values()):
        raise AssertionError(f"the {layout} path launched another layout's "
                             f"kernels: {others}")
    stats = eng.stats()
    if stats["kv_layout"] != layout:
        raise AssertionError(f"engine reports layout {stats['kv_layout']}")
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    gaps = np.array([g for r in reqs for g in r.inter_token_s]) * 1e3
    tokens = sum(len(r.tokens) for r in reqs)
    out = {"phase": "serve", "ok": True, "kv_layout": layout, "round": round_,
           "arch": cfg.name, "temperature": temperature, "path_kernels": list(path),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "compute_dtype": str(cfg.compute_dtype), "requests": len(reqs),
           "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p95": float(np.percentile(ttft, 95)),
           # one decode step emits one token per decoding slot, so the gap
           # between a request's tokens is one engine step (with its
           # prefill chunk, when one ran)
           "step_ms_p50": float(np.percentile(gaps, 50)),
           "step_ms_p95": float(np.percentile(gaps, 95)),
           "decode_steps": stats["decode_steps"],
           "prefill_chunks": stats["prefill_chunks"],
           "launches": launches,
           "launches_per_decode_step": launches[dec_name] / stats["decode_steps"],
           "launches_per_prefill_chunk": (launches[pf_name] / stats["prefill_chunks"]
                                          if pf_name else None),
           "kv_cache_capacity_bytes": stats["kv_cache_capacity_bytes"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    # the widest buckets the run used, and the first eight requests' final
    # lengths, shape the timing inputs
    shapes = {"lens": [len(p) + g for p, g in work[:8]]}
    if layout == "paged":
        shapes["decode_mb"] = max(mb for mb, _ in eng._seen_shapes["decode"])
        shapes["prefill_T_mb"] = max(eng._seen_shapes["prefill"])
    return out, shapes


def kernel_row(name, replaces, launches, err, ms, plain_ms, bytes_, flops,
               lib_ms, lib_note, at, source=None, flops_per_s=BF16_FLOPS_PER_S,
               lib_us=None):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "library_note": lib_note,
            "library_device_us": lib_us,
            "bytes": bytes_, "flops": flops, "at": at}


def device_window(fn, reps: int, tries: int = 3):
    """``{kernel name: [device ms, launches]}`` of ``reps`` runs of ``fn``
    under torch.profiler (the device's own time, free of host dispatch).
    A window that comes back without a single device event (CUPTI drops
    whole windows now and then; PERF.md section 7) is opened again, up to
    ``tries`` times, each empty one noted on stderr."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = device_kernels(prof)[1]
        if by_name:
            return by_name
        print(f"chip_smoke: profiler window {attempt + 1} of {tries} had no device "
              f"events", file=sys.stderr, flush=True)
    return {}


def device_us_per_call(fn, reps: int = 10):
    """Device us per call of ``fn``: every device kernel its call launches,
    in all and by kernel name; (None, {}) (not measured) when the window
    came back without device events."""
    by_name = device_window(fn, reps)
    if not by_name:
        return None, {}
    by_kernel = {}
    for name, (ms, _) in by_name.items():
        short = name.replace("void ", "").replace("(anonymous namespace)::", "")
        short = short.split("(")[0][:80]
        by_kernel[short] = by_kernel.get(short, 0.0) + 1e3 * ms / reps
    return sum(by_kernel.values()), by_kernel


PAGED_SDPA = ("SDPA over K/V pre-gathered to contiguous [B,H,S,D]: no table "
              "gather, no cache write")
CONTIG_SDPA = ("SDPA over the cache with K/V pre-expanded to [B,H,S,D] and a "
               "length (decode) or causal (prefill) mask: no cache write")


def sdpa_inputs(q, kp, vp, bt, mask, H, KV):
    """The library yardstick's inputs: K/V gathered through the table and
    repeated to every head ahead of time, so its call does less work."""
    k = ref._gather_pages(kp, bt).repeat_interleave(H // KV, 2).transpose(1, 2)
    v = ref._gather_pages(vp, bt).repeat_interleave(H // KV, 2).transpose(1, 2)
    return q, k.contiguous(), v.contiguous(), mask


def sdpa(q, k, v, mask):
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def contig_sdpa_inputs(q, k, v, mask, H, KV):
    """The library yardstick's inputs over a contiguous cache: K/V repeated
    to every head ahead of time, so its call does less work."""
    k = k.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    return q, k, v, mask


def causal_mask(base, T, S):
    """[B, 1, T, S]: key position <= the query's position base + t."""
    qpos = base[:, None] + torch.arange(T, device="cuda")[None, :]
    kpos = torch.arange(S, device="cuda")
    return (kpos[None, None, :] <= qpos[:, :, None])[:, None]


def prefill_bytes(base, clens, T, B, H, KV, D, esz, index_bytes):
    valid_q = sum(clens)
    prefix = sum(b + c for b, c in zip(base, clens))
    return (2 * 2 * valid_q * KV * D * esz   # fresh K/V read, written to cache
            + 2 * prefix * KV * D * esz      # each row's prefix read
            + valid_q * H * D * esz          # valid queries read
            + B * T * H * D * esz            # out written, padding rows too
            + index_bytes)                   # table, base, lengths


def prefill_flops(base, clens, H, D):
    return 4 * H * D * sum(b + i + 1 for b, c in zip(base, clens) for i in range(c))


def phase_timing(cfg, launches, shapes):
    """Each wrapper at the serving shapes, rotating over one input set per
    layer so the pools are not served from L2 (as on the real path)."""
    dt = cfg.compute_dtype
    H, KV, D, L, B = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers, 8
    esz = torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []

    mb = shapes["decode_mb"]
    lens = [min(n, mb * PAGE) for n in shapes["lens"]]
    cases = [decode_case(gen, H, KV, D, mb, lens, dt) for _ in range(L)]
    err = max(check_decode(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: dec.decode_attention_paged_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: dec.decode_attention_paged_plain(*nxt()))
    split = profiled_us(lambda: dec.decode_attention_paged_kernel(*nxt()),
                        SYMBOLS["decode_attention_paged"])
    lib = rotate([sdpa_inputs(q[:, :, None], kp, vp, bt,
                              (torch.arange(mb * PAGE, device="cuda")[None, :]
                               < cl[:, None])[:, None, None, :], H, KV)
                  for q, kp, vp, bt, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    live = sum(lens)
    bytes_ = (2 * live * KV * D * esz          # live K and V, read once
              + 2 * B * H * D * esz            # q read, out written
              + 4 * B * (mb + 1))              # table and lengths
    rows.append(kernel_row(
        "decode_attention_paged", "src/repro/kernels/decode_attention.py:199",
        launches, err, ms, plain_ms, bytes_, 4 * H * D * live, lib_ms, PAGED_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mb,
         "cache_len": lens, "window": 0, "dtype": str(dt)}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split, design="mma.sync m16n8k16, GQA-packed",
               header="decode_tc.cuh")
    # the same call in fp32: the CUDA-core body with its ~264-block split-K spans
    rows[-1]["fp32"] = fp32_timing(
        cases, dec.decode_attention_paged_kernel, dec.decode_attention_paged_plain,
        check_decode, bytes_, esz, live, KV, B, H, D, L,
        "decode_split_kernel + decode_combine_kernel (CUDA cores)")

    # a 64-token chunk of a long prompt at base 64 while the other rows
    # decode (inert in this call): the widest chunk the main path runs
    T, mbp = shapes["prefill_T_mb"]
    base, clens = [64] + [0] * (B - 1), [T] + [0] * (B - 1)
    cases = [prefill_case(gen, T, H, KV, D, mbp, base, clens, dt) for _ in range(L)]
    err = max(check_prefill(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: pf.prefill_attention_paged_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: pf.prefill_attention_paged_plain(*nxt()))

    def scatter():  # the wrapper's cache write alone: the scatter kernel
        q, kn, vn, kp, vp, bt, bs, cl = nxt()
        pf.write_chunk_paged_kernel(kp, vp, bt, kn, vn, bs, cl)

    scatter_ms = cuda_ms(scatter)
    split = profiled_us(lambda: pf.prefill_attention_paged_kernel(*nxt()),
                        SYMBOLS["paged_scatter"] + SYMBOLS["prefill_attention_paged"])
    lib = rotate([sdpa_inputs(q.transpose(1, 2).contiguous(), kp, vp, bt,
                              causal_mask(bs, T, mbp * PAGE), H, KV)
                  for q, kn, vn, kp, vp, bt, bs, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    rows.append(kernel_row(
        "prefill_attention_paged", "src/repro/kernels/prefill_attention.py:222",
        launches, err, ms, plain_ms,
        prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * (mbp + 2)),
        prefill_flops(base, clens, H, D), lib_ms, PAGED_SDPA,
        {"B": B, "T": T, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mbp,
         "base": base, "chunk_lens": clens, "dtype": str(dt),
         "scatter_ms": scatter_ms, "scatter": "paged_scatter_kernel"}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split)

    # the contiguous slot cache: each slot owns a [MAX_LEN, KV, D] row
    S = MAX_LEN
    lens = [min(n, S) for n in shapes["lens"]]
    cases = [contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)]
    err = max(check_contig_decode(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: dec.decode_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: dec.decode_attention_plain(*nxt()))
    split = profiled_us(lambda: dec.decode_attention_kernel(*nxt()),
                        SYMBOLS["decode_attention"])
    lib = rotate([contig_sdpa_inputs(
        q[:, :, None], k, v,
        (torch.arange(S, device="cuda")[None, :] < cl[:, None])[:, None, None, :],
        H, KV) for q, k, v, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    live = sum(lens)
    bytes_ = (2 * live * KV * D * esz          # live K and V, read once
              + 2 * B * H * D * esz            # q read, out written
              + 4 * B)                         # lengths
    rows.append(kernel_row(
        "decode_attention", "src/repro/kernels/decode_attention.py:114",
        launches, err, ms, plain_ms, bytes_, 4 * H * D * live, lib_ms, CONTIG_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "S": S, "cache_len": lens,
         "window": 0, "dtype": str(dt)}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split, design="mma.sync m16n8k16, GQA-packed",
               header="decode_tc.cuh")
    # the same call in fp32: the CUDA-core body with its ~264-block split-K spans
    rows[-1]["fp32"] = fp32_timing(
        cases, dec.decode_attention_kernel, dec.decode_attention_plain, check_contig_decode,
        bytes_, esz, live, KV, B, H, D, L,
        "contig_decode_split_kernel + decode_combine_kernel (CUDA cores)")

    cases = [contig_prefill_case(gen, T, H, KV, D, S, base, clens, dt)
             for _ in range(L)]
    err = max(check_contig_prefill(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: pf.prefill_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: pf.prefill_attention_plain(*nxt()))
    split = profiled_us(lambda: pf.prefill_attention_kernel(*nxt()),
                        SYMBOLS["prefill_attention"])
    lib = rotate([contig_sdpa_inputs(q.transpose(1, 2).contiguous(), kc, vc,
                                     causal_mask(bs, T, S), H, KV)
                  for q, kn, vn, kc, vc, bs, cl in cases])
    lib_ms = cuda_ms(lambda: sdpa(*lib()))
    lib_us = device_us_per_call(lambda: sdpa(*lib()))[0]
    rows.append(kernel_row(
        "prefill_attention", "src/repro/kernels/prefill_attention.py:162",
        launches, err, ms, plain_ms,
        prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * 2),
        prefill_flops(base, clens, H, D), lib_ms, CONTIG_SDPA,
        {"B": B, "T": T, "H": H, "KV": KV, "D": D, "S": S, "base": base,
         "chunk_lens": clens, "dtype": str(dt)}, lib_us=lib_us))
    redesigned(rows[-1], sum(split.values()), split)
    emit({"phase": "timing", "ok": True, "rows": rows})
    return rows


def fp32_timing(cases, kernel, plain, check, bytes_, esz, live, KV, B, H, D, L, body):
    """A decode's timing-shape call in fp32 (its CUDA-core body): the bf16
    ``cases`` cast, held to the plain version, timed by CUDA events and by
    device time per call, with its bound (``bytes_`` of the bf16 call at
    4 bytes an element)."""
    cases = [tuple(t.float() if t.is_floating_point() else t for t in a) for a in cases]
    err = max(check(a)[0] for a in cases[:2])
    if err > TOL[torch.float32]:
        raise AssertionError(f"fp32 {kernel.__name__} disagrees at the timing shape: {err}")
    nxt = rotate(cases)
    us, by_kernel = device_us_per_call(lambda: kernel(*nxt()), reps=2 * L)
    t_bytes = (bytes_ + 2 * (live * KV + B * H) * D * (4 - esz)) / HBM_BYTES_PER_S * 1e3
    return {"body": body, "max_abs_err": err, "tol": TOL[torch.float32],
            "ms": cuda_ms(lambda: kernel(*nxt())), "plain_ms": cuda_ms(lambda: plain(*nxt())),
            "device_us_per_launch": us, "device_us_by_kernel": by_kernel,
            "bound_ms": max(t_bytes, 4 * H * D * live / FP32_FLOPS_PER_S * 1e3)}


def redesigned(row, device_us, split=None, design="wgmma", header="attn_tc.cuh"):
    """The fields of a kernel redesigned for the tensor cores: its design,
    its device time per call at the row's shape and the share of the
    bound that time and the wrapper's time reach."""
    row.update({"design": design, "header": f"src/repro_torch/kernels/csrc/{header}",
                "device_us_per_launch": device_us,
                "bound_share_device": row["bound_ms"] * 1e3 / device_us,
                "bound_share_wrapper": row["bound_ms"] / row["ms"]})
    if split:
        row["device_us_by_kernel"] = split


def device_kernels(prof):
    """The profiler's device kernels and ``{name: [device ms, launches]}``."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    return kernels, by_name


def phase_profile(cfg, params, layout, n: int = 8, temperature: float = 0.0,
                  window=None):
    """Where a serving run's time goes on one layout: torch.profiler over
    the first ``n`` requests of the workload, sampled at ``temperature``
    when > 0 (a separate, unmeasured run; the profiler's own host cost
    inflates the wall time and the idle share).  With ``window``, only
    that many engine steps are profiled, once every prompt is in and all
    ``n`` requests decode (the profiler over a 62-layer model's whole run
    takes minutes).  Returns the device time per launch of the path's
    kernels that ran."""
    from torch.profiler import ProfilerActivity, profile

    work = mixed_requests(16, cfg.vocab_size, SEED)[:n]
    path = path_kernels(cfg, layout)
    sampling = dict(temperature=temperature) if temperature > 0 else {}
    eng = serve_engine(cfg, params, kv_layout=layout)
    before = 0
    if window:
        for i, (p, g) in enumerate(work):
            eng.submit(p, max_new_tokens=g, seed=SEED + i, **sampling)
        while eng.queue or (eng.prefill_pos >= 0).any():
            eng.step()
        stats = eng.stats()
        before = stats.get("decode_steps", 0) + stats.get("prefill_chunks", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if window:
            for _ in range(window):
                eng.step()
        else:
            for i, (p, g) in enumerate(work):
                eng.submit(p, max_new_tokens=g, seed=SEED + i, **sampling)
            eng.run_until_drained()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, by_name = device_kernels(prof)
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # the port's own kernels: device time per launch, free of the host
    # cost that the CUDA-event timing of back-to-back wrapper calls carries
    # a decode window runs no prefill chunk
    ran = [k for k in path if not (window and k.startswith("prefill"))]
    ours = {}
    for kernel in ran:
        for name in SYMBOLS[kernel]:
            hits = [v for k, v in by_name.items() if f"::{name}<" in k]
            ms, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
            if not launches:
                raise AssertionError(f"the profiler saw no {name} launch")
            ours[name] = {"ms": ms, "launches": launches,
                          "us_per_launch": 1e3 * ms / launches}
    combine = sum(v[1] for k, v in by_name.items() if "decode_combine_kernel" in k)
    if combine:
        raise AssertionError(f"the {layout} decode ran {combine} combine passes at "
                             f"S {MAX_LEN}: it must be one launch")
    stats = eng.stats()
    steps = stats["decode_steps"] + stats["prefill_chunks"] - before
    if window:
        eng.run_until_drained()
    cpu_ops = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::") and e.cpu_parent is None)
    emit({"phase": "profile", "ok": True, "arch": cfg.name, "kv_layout": layout,
          "requests": n, "temperature": temperature, "window_steps": window,
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "gpu_kernels": len(kernels), "engine_steps": steps,
          "gpu_kernels_per_step": len(kernels) / steps,
          "top_level_aten_ops_per_step": cpu_ops / steps,
          "port_kernels": ours, "combine_launches": combine,
          "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                          for k, v in top]})
    return {kernel: sum(ours[name]["us_per_launch"] for name in SYMBOLS[kernel])
            for kernel in ran}


def top2_gap(cfg, params, prompt, prefix):
    """Top-2 logit gap of the plain path where two streams part."""
    cfg = cfg.with_overrides(decode_impl="ref")
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    pages = -(-len(toks) // PAGE)
    cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                     lm_paged_cache_specs(cfg, pages, PAGE))
    _, last, _ = make_prefill_chunk_step(cfg)(
        params, i32(toks[None]), i32([0]), i32([len(toks)]), cache,
        i32([list(range(pages))]))
    top = torch.topk(last[0].float(), 2).values
    return float(top[0] - top[1])


def serve_rounds(cfg, params, rounds: int):
    """The serve phase: ``rounds`` rounds of phase_serve on both layouts in
    turn, on the same engine settings and requests, then one line with
    each layout's tokens/s, TTFT p50 and step p50 per round and their
    median, min and max.  Returns the paged layout's kernel launches (first
    round), the contiguous layout's, and the first paged run's shapes."""
    keys = ("tokens_per_s", "ttft_ms_p50", "step_ms_p50")
    runs = {layout: {key: [] for key in keys} for layout in LAYOUTS}
    launches, shapes = {}, None
    for r in range(rounds):
        for layout in LAYOUTS:
            out, layout_shapes = phase_serve(cfg, params, layout, round_=r)
            for key in keys:
                runs[layout][key].append(out[key])
            if r == 0:
                launches.update({n: out["launches"][n] for n in PATH_KERNELS[layout]})
                shapes = shapes or layout_shapes  # the paged run's buckets
    spread = {layout: {key: {"runs": v, "median": float(np.median(v)), "min": min(v),
                             "max": max(v)} for key, v in by_key.items()}
              for layout, by_key in runs.items()}
    spread["paged_over_contiguous_tokens_per_s_median"] = (
        spread["paged"]["tokens_per_s"]["median"]
        / spread["contiguous"]["tokens_per_s"]["median"])
    emit({"phase": "serve_spread", "ok": True, "arch": cfg.name, "rounds": rounds,
          "requests": 16, "src": str(ARGS.src.resolve()), **spread})
    return launches, shapes


def compare_kernels(cfg, shapes):
    """The serving kernels' wrappers at the timing rows' shapes, with only
    the public wrappers, so another checkout's package runs it too: CUDA
    events per call and the device us per call by kernel name (every
    device kernel the call launches, under torch.profiler).  The bf16
    serving calls, and both decodes in fp32 (their CUDA-core bodies)."""
    H, KV, D, L, B = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers, 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S, mb = MAX_LEN, shapes["decode_mb"]
    T, mbp = shapes["prefill_T_mb"]
    base, clens = [64] + [0] * (B - 1), [T] + [0] * (B - 1)
    calls = {}
    for dt in (torch.bfloat16, torch.float32):
        lens = [min(n, S) for n in shapes["lens"]]
        calls[f"decode_attention {dt}"] = (dec.decode_attention_kernel, [
            contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)])
    dt = torch.bfloat16
    calls["prefill_attention"] = (pf.prefill_attention_kernel, [
        contig_prefill_case(gen, T, H, KV, D, S, base, clens, dt) for _ in range(L)])
    lens = [min(n, mb * PAGE) for n in shapes["lens"]]
    for dt in (torch.bfloat16, torch.float32):
        calls[f"decode_attention_paged {dt}"] = (dec.decode_attention_paged_kernel, [
            decode_case(gen, H, KV, D, mb, lens, dt) for _ in range(L)])
    dt = torch.bfloat16
    calls["prefill_attention_paged"] = (pf.prefill_attention_paged_kernel, [
        prefill_case(gen, T, H, KV, D, mbp, base, clens, dt) for _ in range(L)])
    out = {}
    for name, (fn, cases) in calls.items():
        nxt = rotate(cases)
        total, by_kernel = device_us_per_call(lambda: fn(*nxt()), reps=2 * L)
        out[name] = {"ms": cuda_ms(lambda: fn(*nxt())), "device_us": total,
                     "device_us_by_kernel": by_kernel}
    return out


def phase_compare(rounds: int):
    """One tree's serve spread and serving kernel times (see the module
    docstring's second form)."""
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    cfg = get_config(ARCH)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         model_specs(cfg), "cuda")
    _, shapes = serve_rounds(cfg, params, rounds)
    emit({"phase": "compare", "ok": True, "src": str(ARGS.src.resolve()),
          "build_s": build_s, "gpu": gpu_line(),
          "shape": {"B": 8, "H": cfg.num_heads, "KV": cfg.num_kv_heads, "D": cfg.head_dim,
                    "S": MAX_LEN, "cache_len": shapes["lens"],
                    "decode_max_pages": shapes["decode_mb"],
                    "prefill_T_max_pages": shapes["prefill_T_mb"]},
          "kernels": compare_kernels(cfg, shapes)})


def phase_stream(cfg, params, n: int = 4):
    """fp32 greedy streams, token for token: on each layout the kernel
    path equals the plain path, and the contiguous kernel path equals the
    paged one."""
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    work = mixed_requests(n, cfg.vocab_size, SEED + 2)
    streams = {}
    for layout in LAYOUTS:
        for impl in ("auto", "ref"):
            eng = serve_engine(cfg32, params, decode_impl=impl, kv_layout=layout)
            reqs = [eng.submit(p, max_new_tokens=g) for p, g in work]
            eng.run_until_drained()
            streams[layout, impl] = [r.tokens for r in reqs]
    pairs = ((("paged", "auto"), ("paged", "ref")),
             (("contiguous", "auto"), ("contiguous", "ref")),
             (("contiguous", "auto"), ("paged", "auto")))
    for x, y in pairs:
        for i, (a, b) in enumerate(zip(streams[x], streams[y])):
            if a != b:
                step = next(j for j, (s, t) in enumerate(zip(a, b)) if s != t)
                emit({"phase": "stream", "ok": False, "request": i,
                      "streams": ["/".join(x), "/".join(y)],
                      "first_diverging_step": step, "tokens": [a[step], b[step]],
                      "plain_top2_logit_gap": top2_gap(cfg32, params, work[i][0],
                                                       streams["paged", "ref"][i][:step])})
                raise AssertionError(f"greedy streams {x} and {y} diverge")
    emit({"phase": "stream", "ok": True, "arch": cfg.name, "requests": n,
          "path_kernels": {layout: list(path_kernels(cfg, layout)) for layout in LAYOUTS},
          "tokens": sum(len(s) for s in streams["paged", "auto"]),
          "compute_dtype": str(cfg32.compute_dtype),
          "identical": ["paged kernel == paged plain",
                        "contiguous kernel == contiguous plain",
                        "contiguous kernel == paged kernel"]})


def phase_phi3():
    """phi3-mini-3.8b at its published widths (head dim 96, G 1): both
    decodes and both prefills held against their plain versions at the
    shapes its serving path gives them, fp32 and bf16 (one line); then it
    serves PHI3_REQUESTS greedy requests on each KV layout, through the
    layout's kernels alone (phase_serve's checks; one serve line per
    layout)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cases = [c for dtype in (torch.float32, torch.bfloat16)
             for c in serving_shape_cases(gen, PHI3, dtype)]
    emit({"phase": "phi3_kernels", "ok": True, "arch": PHI3, "cases": cases})
    cfg = get_config(PHI3)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         model_specs(cfg), "cuda")
    for layout in LAYOUTS:
        phase_serve(cfg, params, layout, n=PHI3_REQUESTS)
    del params
    torch.cuda.empty_cache()


# -- seeded sampling ------------------------------------------------------------


def threefry_np(k1, k2, x1, x2):
    """threefry2x32 in numpy uint32 (wrapping) arithmetic, written from the
    cipher's definition (Salmon et al. 2011, 20 rounds): the reference the
    port's int64 torch version is held to on the card."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x1 = x1 + x2
            x2 = ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r))) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def threefry_reference(seeds, n):
    """numpy split keys [len(seeds), 2, 2], random bits [len(seeds), n] and
    the uniforms in [tiny, 1) of the bits, as jax.random computes them with
    partitionable threefry: counter i is (i >> 32, i & 0xffffffff)."""
    keys = np.stack([np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32)
                     for s in seeds])
    k1, k2 = keys[:, :1], keys[:, 1:]
    w1, w2 = threefry_np(k1, k2, np.zeros((1, 2), np.uint32),
                         np.arange(2, dtype=np.uint32)[None])
    split = np.stack([w1, w2], axis=-1)
    w1, w2 = threefry_np(k1, k2, np.zeros((1, n), np.uint32),
                         np.arange(n, dtype=np.uint32)[None])
    bits = w1 ^ w2
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    tiny = np.finfo(np.float32).tiny
    uniform = np.maximum(np.float32(tiny),
                         floats * (np.float32(1) - np.float32(tiny)) + np.float32(tiny))
    return keys, split, bits, uniform


def phase_sampling(cfg, params):
    """Seeded sampling on the card (tinyllama-1.1b at full width): the
    threefry split keys, random bits and uniforms of SAMPLE_SEEDS seeds
    (half >= 2^32) over the vocabulary bitwise against numpy; on an fp32
    paged engine the same seed twice gives one stream and another seed
    another, top_k=1 is greedy, and a stream checkpointed, released and
    restored mid-decode goes on as the uninterrupted one; then the serve
    phase's 16 requests in bf16, greedy and sampled, with tokens/s each."""
    from repro_torch.serve import sampling

    rng = np.random.default_rng(SEED)
    half = SAMPLE_SEEDS // 2
    seeds = ([0, 1, 2**31, 2**32 - 1] + [int(x) for x in rng.integers(0, 2**32, half - 4)]
             + [2**32, 2**63 - 1] + [int(x) for x in rng.integers(2**32, 2**63 - 1, half - 2,
                                                                   dtype=np.int64)])
    V = cfg.padded_vocab
    keys, want_split, want_bits, want_u = threefry_reference(seeds, V)
    tkeys = torch.from_numpy(keys.astype(np.int64)).cuda()
    got_split = sampling.split(tkeys, 2).cpu().numpy().astype(np.uint32)
    got_bits = sampling.random_bits(tkeys, V).cpu().numpy().astype(np.uint32)
    tiny = float(np.finfo(np.float32).tiny)
    got_u = sampling.uniform(tkeys, V, tiny, 1.0).cpu().numpy()
    bitwise = {"split": bool(np.array_equal(got_split, want_split)),
               "bits": bool(np.array_equal(got_bits, want_bits)),
               "uniform": bool(np.array_equal(got_u.view(np.uint32), want_u.view(np.uint32)))}
    if not all(bitwise.values()):
        raise AssertionError(f"threefry on the card differs from numpy: {bitwise}")

    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    prompt = mixed_requests(1, cfg.vocab_size, SEED + 4)[0][0]

    def engine():
        return serve_engine(cfg32, params, kv_layout="paged")

    eng = engine()
    a, b, c = (eng.submit(prompt, max_new_tokens=16, temperature=SAMPLE_TEMPERATURE, seed=s)
               for s in (123, 123, 2**32 + 123))
    greedy = eng.submit(prompt, max_new_tokens=16)
    top1 = eng.submit(prompt, max_new_tokens=16, temperature=3.0, top_k=1, seed=7)
    eng.run_until_drained()
    checks = {"same_seed_same_stream": a.tokens == b.tokens,
              "other_seed_other_stream": a.tokens != c.tokens,
              "top_k_1_is_greedy": top1.tokens == greedy.tokens}
    eng = engine()
    resumed = eng.submit(prompt, max_new_tokens=16, temperature=SAMPLE_TEMPERATURE, seed=123)
    for _ in range(6):
        eng.step()
    state = eng.checkpoint()
    eng._release_state()
    eng.restore(state)
    eng.run_until_drained()
    checks["restored_stream_resumes"] = resumed.tokens == a.tokens
    del eng, state
    if not all(checks.values()):
        raise AssertionError(f"seeded sampling on the card: {checks}")
    runs = {name: phase_serve(cfg, params, "paged", temperature=t)[0]
            for name, t in (("greedy", 0.0), ("sampled", SAMPLE_TEMPERATURE))}
    for t in (0.0, SAMPLE_TEMPERATURE):  # one decode window each, side by side
        phase_profile(cfg, params, "paged", temperature=t, window=PROFILE_WINDOW)
    emit({"phase": "sampling", "ok": True, "arch": cfg.name, "seeds": len(seeds),
          "seeds_at_or_above_2^32": sum(x >= 2**32 for x in seeds), "vocab": V,
          "bitwise": bitwise, "checks": checks, "compute_dtype_checks": "float32",
          "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
          "step_ms_p50": {k: r["step_ms_p50"] for k, r in runs.items()},
          "sampled_over_greedy_tokens_per_s":
              runs["sampled"]["tokens_per_s"] / runs["greedy"]["tokens_per_s"]})


# -- MLA and MoE serving at full width -----------------------------------------------


def serve_family(arch, param_dtype=torch.float32, stream=False, layers=None):
    """``arch`` at its published widths and ``layers`` of its layers (all
    by default; random weights from a seeded torch.Generator, stored in
    ``param_dtype``): its path's kernels held
    against their plain versions at the shapes its serving path gives
    them (fp32 and bf16); MLA_MOE_REQUESTS greedy requests per layout,
    the layout's path kernels launched and no other (phase_serve); with
    ``stream``, the fp32 streams of the kernel and plain paths token for
    token (phase_stream).  Returns each layout's launches and the paged
    run's shapes; the parameters are freed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cases = [c for dtype in (torch.float32, torch.bfloat16)
             for c in serving_shape_cases(gen, arch, dtype)]
    cfg = get_config(arch).with_overrides(param_dtype=param_dtype)
    if layers:
        cfg = cfg.with_overrides(num_layers=layers)
    specs = map_tree(lambda p: Param(p.shape, p.axes, param_dtype, p.init, p.scale),
                     model_specs(cfg))
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), specs, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    launches, shapes = {}, {}
    for layout in LAYOUTS:
        out, layout_shapes = phase_serve(cfg, params, layout, n=MLA_MOE_REQUESTS)
        launches[layout] = out["launches"]
        shapes[layout] = layout_shapes
    phase_profile(cfg, params, "paged", n=MLA_MOE_REQUESTS, window=PROFILE_WINDOW)
    emit({"phase": f"{arch}_kernels", "ok": True, "arch": arch, "params": n_params,
          "param_dtype": str(param_dtype), "param_gb": n_params * (torch.finfo(
              param_dtype).bits // 8) / 1e9, "layers": cfg.num_layers,
          "path_kernels": {layout: list(path_kernels(cfg, layout)) for layout in LAYOUTS},
          "cases": cases})
    if stream:
        phase_stream(cfg, params, n=MLA_MOE_REQUESTS)
    del params
    torch.cuda.empty_cache()
    return cfg, launches, shapes

def fleet(cfg, params, prefix, **kw):
    """A started EngineRouter over two engines of the serve phase's
    settings on the card, sharing ``params``."""
    from repro_torch.serve import build_fleet

    return build_fleet(cfg, num_engines=2, params=params, name_prefix=prefix,
                       device="cuda", **SERVE, **kw).start()


def fleet_streams_equal(name, cfg32, params, work, reqs, want):
    """Every request DONE with its full budget, and its greedy stream the
    undisturbed engine's, token for token (else the first diverging step
    and the plain path's top-2 logit gap there)."""
    bad = [r.rid for (p, g), r in zip(work, reqs)
           if r.state is not RequestState.DONE or len(r.tokens) != g]
    if bad:
        raise AssertionError(f"fleet {name}: requests lost, failed or duplicated: {bad}")
    for i, (r, w) in enumerate(zip(reqs, want)):
        if r.tokens != w:
            step = next(j for j, (a, b) in enumerate(zip(r.tokens, w)) if a != b)
            emit({"phase": f"fleet_{name}", "ok": False, "request": i,
                  "first_diverging_step": step, "tokens": [r.tokens[step], w[step]],
                  "plain_top2_logit_gap": top2_gap(cfg32, params, work[i][0], w[:step])})
            raise AssertionError(f"fleet {name}: greedy stream {i} differs from one engine's")


def timed_handoffs(router):
    """Wrap every engine's handoff export and import in a synchronized
    timer; returns the list of seconds they append to."""
    secs = []

    def timed(fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            return out
        return call

    for m in router.members:
        m.engine._export_slot = timed(m.engine._export_slot)
        m.engine._import_handoff = timed(m.engine._import_handoff)
    return secs


def phase_fleet(cfg, params):
    """The fleet slice on full-width tinyllama-1.1b (page 16, max_len 512, 8
    slots an engine).  fp32 greedy streams of FLEET_REQUESTS requests,
    each equal to one colocated paged engine's: (1) a disaggregated 1 + 1
    fleet, every counter zeroed just before and read just after: only the
    paged kernels, kernel 5 exactly 22 x the prefill engine's chunks,
    kernel 3 exactly 22 x the decode engine's steps and never on the
    prefill engine, the scatter once a layer per chunk and per decode
    step; the handoffs exactly the owned pages; (2) a colocated fleet of 2
    through rolling_restart(0) mid-stream; (3) FaultPlan.crash_engine on
    engine 0 under a FailurePolicy: ejected, probed, re-admitted, zero
    requests lost or duplicated.  Then (4) bf16 rates of FLEET_RATE_REQUESTS
    requests through the colocated and the disaggregated fleet,
    FLEET_ROUNDS rounds each: tokens/s, TTFT p50 and handoff ms a request
    (export + import, synchronized), medians, min and max; and (5)
    ``launch.serve.run --fleet 2 --disaggregate``.  Returns the
    disaggregated run's launches."""
    from repro_torch.core.resilience import FailurePolicy, FaultPlan, set_fault_injector
    from repro_torch.launch import serve as launch_serve

    t_phase = time.perf_counter()
    L = cfg.num_layers
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    work = mixed_requests(FLEET_REQUESTS, cfg.vocab_size, SEED + 13)
    eng = serve_engine(cfg32, params)
    ref = [eng.submit(p, max_new_tokens=g) for p, g in work]
    eng.run_until_drained()
    want = [r.tokens for r in ref]
    del eng

    # (1) disaggregated: the main path of this slice
    router = fleet(cfg32, params, "chip", disaggregate=True)
    torch.cuda.synchronize()
    zero_counts()
    reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in work]
    drained = router.drain(timeout=600)
    torch.cuda.synchronize()
    launches = read_counts()
    stats = router.stats()
    pre_eng, dec_eng = (m.engine for m in router.members)
    widths = sorted({T for T, _ in pre_eng._seen_shapes["prefill"]})
    page_bytes, pool_bytes = dec_eng._page_bytes, dec_eng._page_bytes * dec_eng.num_pages
    router.close()
    if not drained:
        raise AssertionError("the disaggregated fleet did not drain")
    fleet_streams_equal("disaggregated", cfg32, params, work, reqs, want)
    pre, dec_ = stats["engines"]
    owned = sum(-(-len(p) // PAGE) for p, _ in work)
    path = PATH_KERNELS["paged"]
    want_launches = {"prefill_attention_paged": L * pre["prefill_chunks"],
                     "decode_attention_paged": L * dec_["decode_steps"],
                     "paged_scatter": L * (pre["prefill_chunks"] + dec_["decode_steps"])}
    checks = {
        "launches_exact": all(launches[k] == v for k, v in want_launches.items()),
        "only_paged_kernels": all(v == 0 for k, v in launches.items() if k not in path),
        "prefill_engine_never_decodes": pre.get("decode_steps", 0) == 0,
        "decode_engine_never_prefills": dec_.get("prefill_chunks", 0) == 0,
        "handoffs": stats["handoffs_routed"] == len(work),
        "handoff_pages_owned": stats["handoff_pages"] == owned,
        "handoff_bytes_owned": stats["handoff_bytes"] == owned * page_bytes < pool_bytes}
    emit({"phase": "fleet_disaggregated", "ok": all(checks.values()), "arch": cfg.name,
          "compute_dtype": "torch.float32", "requests": len(work), "checks": checks,
          "launches": launches, "expected_launches": want_launches,
          "prefill_chunks": pre["prefill_chunks"], "decode_steps": dec_["decode_steps"],
          "prefill_widths": widths, "handoff_pages": stats["handoff_pages"],
          "handoff_bytes": stats["handoff_bytes"], "page_bytes": page_bytes,
          "pool_bytes": pool_bytes, "streams_equal_one_engine": True})
    if not all(checks.values()):
        raise AssertionError(f"fleet disaggregated checks failed: {checks}")

    # (2) rolling restart mid-stream
    router = fleet(cfg32, params, "chiprr")
    reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in work]
    t0 = time.time()
    while router.members[0].engine.occupancy() == 0 and time.time() - t0 < 120:
        time.sleep(0.002)
    busy = router.members[0].engine.occupancy()
    router.rolling_restart(0)
    drained = router.drain(timeout=600)
    stats = router.stats()
    router.close()
    if not (drained and busy):
        raise AssertionError(f"rolling restart: drained {drained}, engine 0 held {busy}")
    fleet_streams_equal("rolling_restart", cfg32, params, work, reqs, want)
    resumes = sum(e.get("resumes", 0) for e in stats["engines"])
    if not (stats["restarts"] == 1 and resumes >= 1):
        raise AssertionError(f"rolling restart: restarts {stats['restarts']}, resumes {resumes}")
    emit({"phase": "fleet_rolling_restart", "ok": True, "requests": len(work),
          "restarts": stats["restarts"], "resumes": resumes, "bound_at_restart": busy,
          "rerouted": stats.get("rerouted", 0), "streams_equal_one_engine": True})

    # (3) the breaker: crash, eject, probe, re-admit
    plan = FaultPlan(seed=SEED).crash_engine(engine="chipbk.eng0", at_step=3)
    inj = plan.injector()
    set_fault_injector(inj)
    try:
        router = fleet(cfg32, params, "chipbk",
                       router_kwargs={"policy": FailurePolicy(eject_after=1, probation_s=0.2)})
        reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in work]
        drained = router.drain(timeout=600)
        rng = np.random.default_rng(SEED + 14)
        deadline = time.time() + 60
        while time.time() < deadline:
            st = router.stats()
            if st.get("readmissions", 0) >= st.get("ejections", 0):
                break
            router.submit(Request(rng.integers(1, cfg.vocab_size, 4).astype(np.int32),
                                  max_new_tokens=2))
            router.drain(timeout=60)
            time.sleep(0.02)
        stats = router.stats()
        router.close()
    finally:
        set_fault_injector(None)
    if not drained:
        raise AssertionError("the breaker fleet did not drain")
    fleet_streams_equal("breaker", cfg32, params, work, reqs, want)
    snap = stats["breakers"]["chipbk.eng0"]
    checks = {"one_crash": stats.get("engine_crashes") == 1,
              "ejected_once": stats.get("ejections") == 1,
              "readmitted_by_probe": stats.get("readmissions") == 1
              and stats.get("probes_routed", 0) >= 1,
              "breaker_cycle": [t for t, _ in snap["transitions"]]
              == ["open", "half_open", "closed"],
              "one_fault_fired": len(inj.trace()) == 1}
    emit({"phase": "fleet_breaker", "ok": all(checks.values()), "checks": checks,
          "requests": len(work), "requests_recovered": stats.get("requests_recovered"),
          "recoveries": stats.get("recoveries"), "trace": [list(map(str, e))
                                                          for e in inj.trace()],
          "zero_lost_or_duplicated": True, "streams_equal_one_engine": True})
    if not all(checks.values()):
        raise AssertionError(f"fleet breaker checks failed: {checks}")

    # (4) rates in bf16
    rate_work = mixed_requests(FLEET_RATE_REQUESTS, cfg.vocab_size, SEED)
    rates = {}
    for kind, disaggregate in (("colocated", False), ("disaggregated", True)):
        runs = {"tokens_per_s": [], "ttft_ms_p50": [], "handoff_ms_per_request": []}
        for _ in range(FLEET_ROUNDS):
            router = fleet(cfg, params, f"rate{kind[0]}", disaggregate=disaggregate)
            for p, _ in rate_work[:2]:  # warm-up: cuBLAS, the first shapes
                router.submit(Request(p, max_new_tokens=4))
            router.drain(timeout=600)
            secs = timed_handoffs(router)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [router.submit(Request(p, max_new_tokens=g)) for p, g in rate_work]
            drained = router.drain(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            router.close()
            if not drained or any(r.state is not RequestState.DONE for r in reqs):
                raise AssertionError(f"fleet {kind} rate run: requests not served")
            runs["tokens_per_s"].append(sum(len(r.tokens) for r in reqs) / wall)
            runs["ttft_ms_p50"].append(float(np.median([r.ttft_s for r in reqs])) * 1e3)
            runs["handoff_ms_per_request"].append(sum(secs) * 1e3 / len(reqs)
                                                  if disaggregate else None)
        rates[kind] = {k: {"runs": v, "median": float(np.median(v)), "min": min(v),
                           "max": max(v)} if v[0] is not None else None
                       for k, v in runs.items()}
    emit({"phase": "fleet_rates", "ok": True, "arch": cfg.name, "gpu": gpu_line(),
          "compute_dtype": str(cfg.compute_dtype), "requests": FLEET_RATE_REQUESTS,
          "rounds": FLEET_ROUNDS, **rates})

    # (5) the serving driver's fleet gateway
    res = launch_serve.run(launch_serve.build_parser().parse_args(
        ["--arch", ARCH, "--fleet", "2", "--disaggregate", "--batch", "8", "--quiet"]))
    if not (res["handoffs"] == 8 and res["generated_tokens"] == 8 * 16):
        raise AssertionError(f"launch.serve --fleet 2 --disaggregate: {res}")
    emit({"phase": "fleet_launch_serve", "ok": True, "tokens_per_s": res["tokens_per_s"],
          "ttft_p50_s": res["ttft_p50_s"], "handoffs": res["handoffs"],
          "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()
    return launches


def fleet_prefill_rows(cfg, launches):
    """Kernel 5 at the fleet's prefill widths (T 128, 256, 512; B 8 whole
    prompts at base 0, fleet_chunk_lens; bf16; one input set per layer),
    with its bound and SDPA beside, in the kernel table's format; its
    launches are the fleet phase's."""
    from repro_torch.models.lm import serving_attention_shapes

    dt = cfg.compute_dtype
    esz = torch.finfo(dt).bits // 8
    L, B, mp = cfg.num_layers, SERVE["max_slots"], MAX_LEN // PAGE
    H, KV, D = serving_attention_shapes(cfg)["prefill_attention_paged"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    out = []
    for T in FLEET_T:
        base, clens = [0] * B, fleet_chunk_lens(T, B)
        cases = [prefill_case(gen, T, H, KV, D, mp, base, clens, dt) for _ in range(L)]
        err = max(check_prefill(a)[0] for a in cases[:2])
        lib = [sdpa_inputs(q.transpose(1, 2).contiguous(), kp, vp, bt,
                           causal_mask(bs, T, mp * PAGE), H, KV)
               for q, kn, vn, kp, vp, bt, bs, cl in cases]
        nxt, lib_nxt = rotate(cases), rotate(lib)
        fn, plain = pf.prefill_attention_paged_kernel, pf.prefill_attention_paged_plain
        row = kernel_row(
            "prefill_attention_paged", "src/repro/kernels/prefill_attention.py:222",
            launches, err, cuda_ms(lambda: fn(*nxt())), cuda_ms(lambda: plain(*nxt())),
            prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * (mp + 2)),
            prefill_flops(base, clens, H, D), cuda_ms(lambda: sdpa(*lib_nxt())), PAGED_SDPA,
            {"B": B, "T": T, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mp,
             "base": base, "chunk_lens": clens, "arch": cfg.name, "dtype": str(dt)},
            lib_us=device_us_per_call(lambda: sdpa(*lib_nxt()))[0])
        row["device_us_per_launch"] = device_us_per_call(lambda: fn(*nxt()), reps=2 * L)[0]
        out.append(row)
        del cases, lib
    emit({"phase": "timing", "ok": True, "arch": cfg.name, "fleet_prefill": True,
          "rows": out})
    return out


def shape_rows(cfg, launches, shapes, kernels):
    """Rows of the kernel table's format for ``kernels`` at the serving
    shapes ``cfg``'s path gives them (the timing phase's inputs: B 8, the
    run's lengths and page buckets, one input set per layer), with SDPA
    beside: these are further launch shapes of rows already in the
    table."""
    from repro_torch.models.lm import serving_attention_shapes

    dt = cfg.compute_dtype
    esz = torch.finfo(dt).bits // 8
    L, B = cfg.num_layers, 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    at_shape = serving_attention_shapes(cfg)
    out = []
    for kernel in kernels:
        H, KV, D = at_shape[kernel]
        # the run's requests in the first slots, the other slots empty (as
        # the decode step gives them: length 0, nothing read)
        run_lens = (shapes["contiguous"]["lens"] + [0] * B)[:B]
        if kernel == "decode_attention":
            S = MAX_LEN
            lens = [min(n, S) for n in run_lens]
            cases = [contig_decode_case(gen, H, KV, D, S, lens, dt) for _ in range(L)]
            err = max(check_contig_decode(a)[0] for a in cases[:2])
            fn, plain = dec.decode_attention_kernel, dec.decode_attention_plain
            lib = [contig_sdpa_inputs(
                q[:, :, None], k, v,
                (torch.arange(S, device="cuda")[None, :] < cl[:, None])[:, None, None, :],
                H, KV) for q, k, v, cl in cases]
            live = sum(lens)
            bytes_ = 2 * live * KV * D * esz + 2 * B * H * D * esz + 4 * B
            flops, note, replaces = 4 * H * D * live, CONTIG_SDPA, "decode_attention.py:114"
            at = {"B": B, "H": H, "KV": KV, "D": D, "S": S, "cache_len": lens}
        elif kernel == "decode_attention_paged":
            mb = shapes["paged"]["decode_mb"]
            lens = [min(n, mb * PAGE) for n in run_lens]
            cases = [decode_case(gen, H, KV, D, mb, lens, dt) for _ in range(L)]
            err = max(check_decode(a)[0] for a in cases[:2])
            fn, plain = dec.decode_attention_paged_kernel, dec.decode_attention_paged_plain
            lib = [sdpa_inputs(q[:, :, None], kp, vp, bt,
                               (torch.arange(mb * PAGE, device="cuda")[None, :]
                                < cl[:, None])[:, None, None, :], H, KV)
                   for q, kp, vp, bt, cl in cases]
            live = sum(lens)
            bytes_ = 2 * live * KV * D * esz + 2 * B * H * D * esz + 4 * B * (mb + 1)
            flops, note, replaces = 4 * H * D * live, PAGED_SDPA, "decode_attention.py:199"
            at = {"B": B, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mb,
                  "cache_len": lens}
        else:  # prefill_attention_paged: a 64-token chunk at base 64, the rest inert
            T, mbp = shapes["paged"]["prefill_T_mb"]
            base, clens = [64] + [0] * (B - 1), [T] + [0] * (B - 1)
            cases = [prefill_case(gen, T, H, KV, D, mbp, base, clens, dt) for _ in range(L)]
            err = max(check_prefill(a)[0] for a in cases[:2])
            fn, plain = pf.prefill_attention_paged_kernel, pf.prefill_attention_paged_plain
            lib = [sdpa_inputs(q.transpose(1, 2).contiguous(), kp, vp, bt,
                               causal_mask(bs, T, mbp * PAGE), H, KV)
                   for q, kn, vn, kp, vp, bt, bs, cl in cases]
            bytes_ = prefill_bytes(base, clens, T, B, H, KV, D, esz, 4 * B * (mbp + 2))
            flops = prefill_flops(base, clens, H, D)
            note, replaces = PAGED_SDPA, "prefill_attention.py:222"
            at = {"B": B, "T": T, "H": H, "KV": KV, "D": D, "page": PAGE, "max_pages": mbp,
                  "base": base, "chunk_lens": clens}
        nxt, lib_nxt = rotate(cases), rotate(lib)
        row = kernel_row(
            kernel, f"src/repro/kernels/{replaces}", launches, err,
            cuda_ms(lambda: fn(*nxt())), cuda_ms(lambda: plain(*nxt())), bytes_, flops,
            cuda_ms(lambda: sdpa(*lib_nxt())), note,
            {**at, "arch": cfg.name, "dtype": str(dt)},
            lib_us=device_us_per_call(lambda: sdpa(*lib_nxt()))[0])
        row["device_us_per_launch"] = device_us_per_call(lambda: fn(*nxt()), reps=2 * L)[0]
        out.append(row)
        del cases, lib
    emit({"phase": "timing", "ok": True, "arch": cfg.name, "rows": out})
    return out


def phase_mla_moe():
    """minicpm3-4b (MLA, fp32 parameters, fp32 streams held kernel path
    to plain path), moonshot-v1-16b-a3b (MoE, bf16 parameters) and
    arctic-480b (MoE through its gather dispatch, bf16, ARCTIC_LAYERS
    layers) served at their published widths, one after the other
    (serve_family); kernel 2 timed at the MLA serving shape and kernels
    3 and 5 at moonshot's (shape_rows).  Returns each config's launches
    per kernel and the rows."""
    cfg, launches, shapes = serve_family(MLA, stream=True, layers=MLA_LAYERS)
    mla_launches = {k: sum(launches[layout][k] for layout in LAYOUTS) for k in COUNTED}
    rows = shape_rows(cfg, mla_launches, shapes, ("decode_attention",))
    cfg, launches, shapes = serve_family(MOE, param_dtype=MOE_PARAM_DTYPE)
    moe_launches = {k: sum(launches[layout][k] for layout in LAYOUTS) for k in COUNTED}
    rows += shape_rows(cfg, moe_launches, shapes,
                       ("decode_attention_paged", "prefill_attention_paged"))
    torch.cuda.empty_cache()
    cfg, launches, _ = serve_family(ARCTIC, param_dtype=torch.bfloat16, layers=ARCTIC_LAYERS)
    if cfg.moe_impl != "gather":
        raise AssertionError(f"arctic-480b served through {cfg.moe_impl!r}, not its gather "
                             "dispatch")
    arctic_launches = {k: sum(launches[layout][k] for layout in LAYOUTS) for k in COUNTED}
    torch.cuda.empty_cache()
    return {"mla": mla_launches, "moe": moe_launches, "arctic": arctic_launches}, rows


def corpus_batches(cfg, steps: int):
    """``steps`` batches of B x S tokens of the synthetic corpus, labels
    the tokens rolled by -1, as the JAX package's launch/train.py builds them."""
    corpus = make_corpus(cfg.vocab_size, TRAIN_B * TRAIN_S * (steps + 8), SEED)
    rows = corpus[: len(corpus) // TRAIN_S * TRAIN_S].reshape(-1, TRAIN_S)
    out = []
    for i in range(steps):
        lo = (i * TRAIN_B) % max(rows.shape[0] - TRAIN_B, 1)
        tokens = torch.from_numpy(rows[lo:lo + TRAIN_B]).cuda()
        out.append({"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)})
    return out


def profile_train_step(step_fn, state, batch):
    """One train step under torch.profiler: device busy and idle share,
    time by kernel class, the flash kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, by_name = device_kernels(prof)
    busy_ms = sum(v[0] for v in by_name.values())
    (flash_symbol,) = SYMBOLS["flash_attention"]
    hits = [v for k, v in by_name.items() if flash_symbol in k]
    flash_ms, flash_n = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not flash_n:
        raise AssertionError(f"the profiler saw no {flash_symbol} launch")
    classes = {"matmul": ("gemm", "nvjet", "xmma", "cutlass", "sm90_"),
               "flash_attention": (flash_symbol,),
           "rmsnorm": ("rmsnorm_kernel",),
           "hash_partition_histogram": ("hash_hist_kernel",)}
    by_class = {c: sum(v[0] for k, v in by_name.items()
                       if any(t in k for t in subs)) for c, subs in classes.items()}
    by_class["other"] = busy_ms - sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "gpu_kernels": len(kernels),
           "device_ms_by_class": by_class,
           "flash_launches": flash_n, "flash_us_per_launch": 1e3 * flash_ms / flash_n,
           "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                           for k, v in top]}
    return state, out


def cut_depth(state, layers: int):
    """``state`` with every stacked leaf under a ``"unit"`` key (the
    parameters' and the optimizer's) cut to its first ``layers`` layers."""
    def walk(t, in_unit):
        if isinstance(t, dict):
            return {k: walk(v, in_unit or k == "unit") for k, v in t.items()}
        return t[:layers] if in_unit else t
    return walk(state, False)


def phase_train(cfg):
    """The training path at full width: 20 steps with every counter zeroed
    just before and read just after, one profiled step, then a checkpoint
    round trip of the trained state cut to CKPT_LAYERS layers.  Returns
    the flash launches and device us per launch."""
    t_phase = time.perf_counter()
    run_cfg = RunConfig()
    torch.cuda.synchronize()
    before_state = torch.cuda.memory_allocated()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                             run_cfg)
    step_fn = make_train_step(cfg, run_cfg)
    batches = corpus_batches(cfg, TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, norms, step_ms = [], [], []
    for batch in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(metrics["grad_norm"].item())
    launches = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9
    if launches["flash_attention"] != 2 * cfg.num_layers * TRAIN_STEPS:
        raise AssertionError(f"flash launches {launches['flash_attention']}, "
                             f"expected {2 * cfg.num_layers} per step")
    others = {n: c for n, c in launches.items() if n not in PATH_KERNELS["train"]}
    if any(others.values()):
        raise AssertionError(f"the train path launched serving kernels: {others}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad-norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: first 5 {first}, last 5 {last}")
    steady = step_ms[1:]  # the first step also loads cuBLAS and the kernel
    out = {"phase": "train", "ok": True, "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "param_dtype": str(cfg.param_dtype),
           "compute_dtype": str(cfg.compute_dtype), "optimizer": run_cfg.optimizer,
           "remat": run_cfg.remat, "batch": TRAIN_B, "seq": TRAIN_S,
           "steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
           "first5_mean_loss": first, "last5_mean_loss": last,
           "first_step_ms": step_ms[0],
           "step_ms_p50": float(np.percentile(steady, 50)),
           "step_ms_p95": float(np.percentile(steady, 95)),
           "tokens_per_s": TRAIN_B * TRAIN_S * len(steady) / (sum(steady) / 1e3),
           "peak_memory_gb": peak_gb, "peak_memory_bytes": peak_bytes,
           "allocated_before_state_bytes": before_state, "launches": launches,
           "flash_launches_per_step": launches["flash_attention"] / TRAIN_STEPS}

    state, prof = profile_train_step(step_fn, state, batches[TRAIN_STEPS])
    out["profile"] = prof

    # checkpoint round trip of the trained state's first CKPT_LAYERS layers:
    # snapshot + background write, then restore into a fresh state of that
    # depth, every leaf bitwise
    state = cut_depth(state, CKPT_LAYERS)
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt = store.AsyncCheckpointer(str(ckdir), keep=1)
    ckpt.save(int(state["step"]), state)
    snapshot_s = time.perf_counter() - t0
    ckpt.close()
    save_s = time.perf_counter() - t0
    fresh = init_train_state(torch.Generator(device="cuda").manual_seed(SEED + 1),
                             cfg.with_overrides(num_layers=CKPT_LAYERS), run_cfg)
    t0 = time.perf_counter()
    restored = store.restore(str(ckdir), fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    disk_bytes = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file())
    shutil.rmtree(ckdir)
    leaves = list(zip(tree_leaves(state), tree_leaves(restored)))
    bad = [i for i, (a, b) in enumerate(leaves)
           if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"restored leaves differ: {bad}")
    out["checkpoint"] = {"layers": CKPT_LAYERS, "leaves": len(leaves), "bitwise_equal": True,
                         "state_bytes": sum(a.numel() * a.element_size()
                                            for a, _ in leaves),
                         "disk_bytes": disk_bytes, "snapshot_s": snapshot_s,
                         "save_s": save_s, "restore_s": restore_s}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return launches["flash_attention"], prof["flash_us_per_launch"], out


def phase_dryrun(cfg, train):
    """The train phase's own step dry-run on the meta device (the plain
    ops, as the dry run runs every step), held to what the train phase
    measured on the card; then DRYRUN_CELLS through ``dryrun.run_cell`` on
    both production meshes."""
    t_phase = time.perf_counter()
    run_cfg = RunConfig()
    c = cfg.with_overrides(decode_impl="ref")
    batch = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    got = dryrun.count_step(c, run_cfg, "train", (abstract_train_state(c, run_cfg), batch))
    got.pop("outputs")
    p50_s = train["step_ms_p50"] / 1e3
    card_peak = train["peak_memory_bytes"] - train["allocated_before_state_bytes"]
    ratio = card_peak / got["peak_live_bytes"]
    out = {"phase": "dryrun", "arch": cfg.name, "batch": TRAIN_B, "seq": TRAIN_S,
           "gpu": gpu_line(), "flops": got["flops"], "model_flops": got["model_flops"],
           "matmul_flops": got["matmul_flops"], "attention_flops": got["attention_flops"],
           "model_matmul_flops": got["model_matmul_flops"],
           "peak_live_bytes_estimate": got["peak_live_bytes"],
           "argument_bytes": got["argument_bytes"], "host_bytes": got["host_bytes"],
           "meta_run_s": got["seconds"],
           "train_step_ms_p50": train["step_ms_p50"],
           "max_memory_allocated_bytes": train["peak_memory_bytes"],
           "allocated_before_state_bytes": train["allocated_before_state_bytes"],
           "card_peak_bytes": card_peak, "card_peak_over_estimate": ratio,
           "band": DRYRUN_BAND,
           "step_share_of_bf16_peak": got["model_flops"] / p50_s / BF16_FLOPS_PER_S,
           "step_flops_share_of_bf16_peak": got["flops"] / p50_s / BF16_FLOPS_PER_S,
           "flop_rule": dryrun.FLOP_RULE, "cells": {}}
    problems = []
    if not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
        problems.append(f"card peak {card_peak} is {ratio:.3f}x the estimate "
                        f"{got['peak_live_bytes']}, outside {DRYRUN_BAND}")
    if got["host_bytes"]:
        problems.append(f"the meta run wrote {got['host_bytes']} bytes to the host")
    for arch, shape in DRYRUN_CELLS:
        for mesh in ("single", "multi"):
            r = dryrun.run_cell(arch, shape, mesh)
            terms = [r["roofline"][k] for k in ("compute_s", "memory_s", "collective_s")]
            nums = terms + [r[k] for k in ("flops", "model_flops", "attention_flops")] \
                + [r["memory"]["peak_live_bytes_per_device_estimate"]]
            if not all(math.isfinite(x) and x >= 0 for x in nums) \
                    or r["roofline"].get("dominant") not in r["roofline"]:
                problems.append(f"{arch} {shape} {mesh}: roofline {r['roofline']}")
            out["cells"][f"{arch}/{shape}/{mesh}"] = {
                "kind": r["kind"], "n_chips": r["n_chips"], "flops": r["flops"],
                "model_flops": r["model_flops"], "attention_flops": r["attention_flops"],
                "bytes": r["bytes"], "memory": r["memory"],
                "collective_bytes_per_device": r["collective_bytes_per_device"],
                "roofline": r["roofline"], "run_s": r["run_s"]}
    out["seconds"] = time.perf_counter() - t_phase
    if out["seconds"] > DRYRUN_LIMIT_S:
        problems.append(f"the phase took {out['seconds']:.1f} s, over {DRYRUN_LIMIT_S}")
    out["ok"], out["problems"] = not problems, problems
    emit(out)
    if problems:
        raise AssertionError(f"dryrun: {problems}")


def phase_train_parity(cfg):
    """fp32 (TF32 off, set in main): PARITY_STEPS steps on the kernel path
    and on the plain path from one initial state and the same batches."""
    t_phase = time.perf_counter()
    run_cfg = RunConfig()
    batches = corpus_batches(cfg, PARITY_STEPS)
    runs = {}
    for impl in ("auto", "ref"):
        c = cfg.with_overrides(compute_dtype=torch.float32, decode_impl=impl)
        state = init_train_state(torch.Generator(device="cuda").manual_seed(SEED), c,
                                 run_cfg)
        step_fn = make_train_step(c, run_cfg)
        zero_counts()
        metrics = []
        for batch in batches:
            state, m = step_fn(state, batch)
            metrics.append({k: v.item() for k, v in m.items()})
        runs[impl] = {"metrics": metrics, "flash_launches": read_counts()["flash_attention"]}
        del state
        torch.cuda.empty_cache()
    if runs["auto"]["flash_launches"] != 2 * cfg.num_layers * PARITY_STEPS \
            or runs["ref"]["flash_launches"] != 0:
        raise AssertionError(f"flash launches: kernel path "
                             f"{runs['auto']['flash_launches']}, plain path "
                             f"{runs['ref']['flash_launches']}")
    rel = max_rel(runs["auto"]["metrics"], runs["ref"]["metrics"])
    out = {"phase": "train_parity", "ok": all(rel[k] <= TRAIN_TOL[k] for k in TRAIN_TOL),
           "compute_dtype": "torch.float32", "tf32": False, "steps": PARITY_STEPS,
           "kernel_path": runs["auto"], "plain_path": runs["ref"],
           "max_rel_diff": rel, "tol_rel": TRAIN_TOL,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if not out["ok"]:
        raise AssertionError("fp32 kernel and plain training paths disagree")


def flash_row(cfg, launches, device_us, lib_us):
    """The flash kernel's timing row at the training shape, rotating over
    one input set per layer; ``lib_us``: SDPA's device us per call at that
    shape (profile_new_kernels)."""
    dt = cfg.compute_dtype
    B, S, H, KV, D = TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    esz = torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [flash_case(gen, B, H, KV, S, D, dt) for _ in range(cfg.num_layers)]
    err = max(check_flash(a)[0] for a in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: fa.flash_attention_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(*nxt()))
    lib = rotate([(q, k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1))
                  for q, k, v in cases])
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*lib(), is_causal=True))
    bytes_ = esz * (2 * B * H * S * D + 2 * B * KV * S * D)  # q, out; k, v once
    flops = 4 * B * H * D * S * (S + 1) // 2                 # the causal triangle
    row = kernel_row("flash_attention", "src/repro/kernels/flash_attention.py:85",
                     launches, err, ms, plain_ms, bytes_, flops, lib_ms,
                     "SDPA (is_causal) with K/V pre-expanded to [B,H,S,D]",
                     {"B": B, "H": H, "KV": KV, "S": S, "D": D, "causal": True,
                      "layout": "[B,S,H,D] viewed as [B,H,S,D]", "dtype": str(dt)},
                     lib_us=lib_us)
    redesigned(row, device_us)
    return row


def df_tables(mesh):
    """The dataframe phase's tables on the card, from numpy at SEED."""
    rng = np.random.default_rng(SEED)
    x1 = rng.standard_normal(DF_ROWS, dtype=np.float32)
    x2 = rng.standard_normal(DF_ROWS, dtype=np.float32)
    cols = {"k": rng.integers(0, DF_KEYS, DF_ROWS, dtype=np.int32),
            "v": rng.standard_normal(DF_ROWS, dtype=np.float32), "x1": x1, "x2": x2,
            "y": 3 * x1 - 2 * x2 + np.float32(0.1) * rng.standard_normal(
                DF_ROWS, dtype=np.float32)}
    rk = np.arange(DF_KEYS, dtype=np.int32)
    right = {"k": rk, "w": (10 * rk).astype(np.float32)}
    return (cols, Table.from_columns(cols, mesh),
            Table.from_columns(right, mesh))


def df_calls(t, r, impl):
    """The five operators, each returning (result, dropped)."""
    return {"shuffle": lambda: dfo.shuffle(t, "k", impl=impl),
            "sort": lambda: dfo.sort(t, "k"),
            "join": lambda: dfo.join(t, r, "k", impl=impl),
            "groupby": lambda: dfo.groupby_sum(t, "k", ["v"],
                                               groups_cap_per_shard=DF_GROUPS, impl=impl),
            "reduce": lambda: (dfo.reduce_sum(t, ["v"]), 0)}


def timed(call):
    """(result, dropped, ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res, dropped = call()
    end.record()
    end.synchronize()
    return res, dropped, start.elapsed_time(end)


def hash_u32_np(k):
    h = k.astype(np.uint32) * np.uint32(2654435761)  # wraps mod 2^32
    return h ^ (h >> np.uint32(16))


def check_df_on_host(cols, runs):
    """tests/spawn/dataframe_ops.py's checks at full size, in numpy."""
    keys, vals = cols["k"], cols["v"]
    counts = np.bincount(keys, minlength=DF_KEYS)
    checks = {}
    # shuffle: every row arrived, each key on the shard its hash names
    sh = runs["shuffle"][0]
    k, valid = sh.col("k").cpu().numpy(), sh.valid.cpu().numpy()
    shard = np.arange(len(k)) // (len(k) // DF_SHARDS)
    checks["shuffle"] = bool(
        np.array_equal(np.bincount(k[valid], minlength=DF_KEYS), counts)
        and np.array_equal(hash_u32_np(k[valid]) % DF_SHARDS, shard[valid]))
    # sort: every shard sorted, the shards in splitter order, every row there
    st = runs["sort"][0]
    k, valid = st.col("k").cpu().numpy(), st.valid.cpu().numpy()
    per = len(k) // DF_SHARDS
    segs = [k[i * per:(i + 1) * per][valid[i * per:(i + 1) * per]] for i in range(DF_SHARDS)]
    checks["sort"] = bool(
        all(np.all(np.diff(g) >= 0) for g in segs)
        and all(a.max() <= b.min() for a, b in zip(segs, segs[1:]) if len(a) and len(b))
        and np.array_equal(np.bincount(np.concatenate(segs), minlength=DF_KEYS), counts))
    # join: every left row matched, w == 10 k on each
    jn = runs["join"][0].to_numpy()
    checks["join"] = bool(len(jn["k"]) == DF_ROWS and np.array_equal(jn["w"], 10 * jn["k"]))
    # groupby: one slot per key, float64 sums and counts
    gb = runs["groupby"][0].to_numpy()
    want = np.bincount(keys, weights=vals.astype(np.float64), minlength=DF_KEYS)
    gb_err = float(np.abs(gb["v"] - want[gb["k"]]).max())
    checks["groupby"] = bool(
        len(np.unique(gb["k"])) == len(gb["k"]) == np.count_nonzero(counts)
        and np.array_equal(gb["_count"], counts[gb["k"]]) and gb_err <= DF_SUM_TOL)
    want_sum = float(vals.astype(np.float64).sum())
    reduce_rel = abs(runs["reduce"][0]["v"] - want_sum) / abs(want_sum)
    checks["reduce"] = bool(reduce_rel <= DF_SUM_TOL)
    return checks, {"groupby_max_abs_err": gb_err, "reduce_rel_err": reduce_rel}


def same_result(a, b, name):
    """Kernel run vs impl="ref" run of one operator: (equal, max abs
    difference of the groupby sums)."""
    (ra, da, _), (rb, db, _) = a, b
    if name == "reduce":
        return ra == rb and da == db, 0.0
    sums = ("v",) if name == "groupby" else ()
    ok = da == db and torch.equal(ra.valid, rb.valid) and ra.column_names == rb.column_names
    diff = 0.0
    for col in ra.column_names:
        if col in sums:
            diff = (ra.col(col) - rb.col(col)).abs().max().item()
            ok = ok and diff <= DF_PAIR_ATOL
        else:
            ok = ok and torch.equal(ra.col(col), rb.col(col))
    return ok, diff


def profiled_us(fn, symbols, reps: int = 10):
    """Device us per launch of each of ``symbols`` over ``reps`` runs of
    ``fn`` (device_window); a symbol that never launched fails."""
    by_name = device_window(fn, reps)
    out = {}
    for symbol in symbols:
        hits = [v for k, v in by_name.items() if symbol in k]
        ms, n = sum(v[0] for v in hits), sum(v[1] for v in hits)
        if not n:
            raise AssertionError(f"the profiler saw no {symbol} launch; it saw "
                                 f"{[k[:100] for k in by_name][:20]}")
        out[symbol] = 1e3 * ms / n
    return out


def top_kernels(fn, n: int = 6):
    """Where one run of ``fn`` spends its device time: the ``n`` kernels of
    most device ms under torch.profiler, or None when the window came back
    without device events (it informs section 5 of PERF.md; nothing is
    checked on it)."""
    top = sorted(device_window(fn, 1).items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:90], "ms": v[0], "launches": v[1]} for k, v in top] or None


def profile_new_kernels():
    """Device us per launch of kernels 6 and 7 at their paths' shapes
    (rmsnorm on [4096, 2048] bf16; the hash on [8, 2^23] keys in
    [0, 2^20), 8 buckets), and the device us per call of the library
    yardsticks of kernels 1 and 6 at the rows' shapes (SDPA at the
    training shape, F.rms_norm), early in the run: windows opened after
    the training, dataframe and pipeline phases came back without device
    events."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    (x, w), = rms_cases(gen, 1)
    keys = torch.randint(0, DF_KEYS, (DF_SHARDS, DF_ROWS // DF_SHARDS), generator=gen,
                         device="cuda", dtype=torch.int32)
    (rms_symbol,), (hash_symbol,) = SYMBOLS["rmsnorm"], SYMBOLS["hash_partition_histogram"]
    # the yardsticks rotate over four input sets, as their rows' timings
    # do, so their inputs are not served from L2
    cfg = get_config(ARCH)
    G = cfg.num_heads // cfg.num_kv_heads
    attn = rotate([(q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1))
                   for q, k, v in (flash_case(gen, TRAIN_B, cfg.num_heads, cfg.num_kv_heads,
                                              TRAIN_S, cfg.head_dim, cfg.compute_dtype)
                                   for _ in range(4))])
    norms = rotate(rms_cases(gen, 4))

    def norm():
        x, w = norms()
        return F.rms_norm(x, x.shape[-1:], w, eps=1e-5)

    return {"rmsnorm": profiled_us(lambda: rms.rmsnorm_kernel(x, w), (rms_symbol,))[rms_symbol],
            "hash_partition_histogram": profiled_us(
                lambda: hp.hash_partition_histogram_kernel(keys, num_buckets=DF_SHARDS),
                (hash_symbol,), reps=3)[hash_symbol],
            "flash_attention_library": device_us_per_call(
                lambda: F.scaled_dot_product_attention(*attn(), is_causal=True))[0],
            "rmsnorm_library": device_us_per_call(norm)[0]}


def phase_dataframe():
    """The dataframe path at 2^26 rows on 8 logical shards: every counter
    zeroed just before the kernel run and read just after; numpy checks;
    the impl="ref" run held to it.  Returns the host columns, the table
    and the hash launches."""
    t_phase = time.perf_counter()
    mesh = make_mesh((DF_SHARDS,), ("data",))
    t0 = time.perf_counter()
    cols, t, r = df_tables(mesh)
    setup_s = time.perf_counter() - t0
    table_gb = sum(c.numel() * c.element_size() for c in (*t.columns.values(), t.valid)) / 1e9
    for call in df_calls(t, r, "auto").values():  # warm-up: library, allocator
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    counter = COUNTED["hash_partition_histogram"]
    runs, op_launches = {}, {}
    for name, call in df_calls(t, r, "auto").items():
        before = counter.launches
        runs[name] = timed(call)
        op_launches[name] = counter.launches - before
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if op_launches != DF_LAUNCHES or \
            launches["hash_partition_histogram"] != sum(DF_LAUNCHES.values()):
        raise AssertionError(f"hash launches {op_launches}, expected {DF_LAUNCHES}")
    others = {n: c for n, c in launches.items() if n not in PATH_KERNELS["dataframe"]}
    if any(others.values()):
        raise AssertionError(f"the dataframe path launched other kernels: {others}")
    dropped = {n: int(d) for n, (_, d, _) in runs.items()}
    if any(dropped.values()):
        raise AssertionError(f"rows dropped: {dropped}")
    checks, errs = check_df_on_host(cols, runs)
    if not all(checks.values()):
        raise AssertionError(f"dataframe results wrong: {checks} {errs}")
    pairs = {}
    ref_calls = df_calls(t, r, "ref")
    for name in runs:  # the plain histogram path, one operator at a time
        ok, diff = same_result(runs[name], timed(ref_calls[name]), name)
        pairs[name] = {"equal": ok, "groupby_sum_max_abs_diff": diff}
        if not ok:
            raise AssertionError(f"{name}: kernel and impl='ref' runs differ: {pairs[name]}")
    if read_counts()["hash_partition_histogram"] != launches["hash_partition_histogram"]:
        raise AssertionError("the impl='ref' run launched the hash kernel")
    calls = df_calls(t, r, "auto")
    breakdown = {name: top_kernels(calls[name]) for name in ("shuffle", "sort", "groupby")}
    emit({"phase": "dataframe", "ok": True, "gpu": gpu_line(), "rows": DF_ROWS,
          "right_rows": DF_KEYS, "shards": DF_SHARDS, "table_gb": table_gb,
          "setup_s": setup_s,
          "ops": {n: {"ms": ms, "rows_per_s": DF_ROWS / (ms / 1e3), "dropped": d,
                      "hash_launches": op_launches[n], "host_check": checks[n]}
                  for n, (_, d, ms) in runs.items()},
          "host_errors": errs, "launches": launches, "peak_memory_gb": peak_gb,
          "ref_run": pairs, "top_kernels": breakdown,
          "ref_tolerance": (f"groupby sums {DF_PAIR_ATOL} abs: float32 index_add_ "
                            "adds with atomics in a run-dependent order; all else "
                            "bitwise"),
          "seconds": time.perf_counter() - t_phase})
    del runs
    return cols, t, launches["hash_partition_histogram"]


def phase_pipeline(t, host_cols):
    """tests/test_system.py's pipeline at 2^26 rows, as a Pipeline of a
    ``cylon_stage`` and two ``dl_stage``s under the port's run_pipelines on
    a pilot over the card: filter, the zero-copy loader (shuffled), SGD on
    a linear model, postprocess; then the host prefetcher over host
    batches."""
    from repro_torch.core.bridge import cylon_stage, data_bridge, dl_stage
    from repro_torch.core.pipeline import Pipeline, run_pipelines

    t_phase = time.perf_counter()

    def preprocess(comm, upstream):
        cols, valid = filter_rows(t.columns, t.valid, t.col("x1").abs() < 3.0)
        return t.with_columns({c: cols[c] for c in ("x1", "x2", "y")}, valid)

    def train(comm, upstream):
        loader = data_bridge(upstream["preprocess"], ["x1", "x2"], "y", PIPE_BATCH,
                             shuffle=True, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = sum(1 for _ in loader.epoch(0))
        torch.cuda.synchronize()
        loader_s = time.perf_counter() - t0
        w = torch.zeros(2, device=comm.device, requires_grad=True)
        b = torch.zeros((), device=comm.device, requires_grad=True)
        losses, epoch = [], 1
        t0 = time.perf_counter()
        while len(losses) < PIPE_STEPS:
            for feats, labels, mask in loader.epoch(epoch):
                err = torch.where(mask, feats @ w + b - labels, 0.0)
                loss = (err ** 2).sum() / mask.sum().clamp(min=1)
                gw, gb = torch.autograd.grad(loss, (w, b))
                with torch.no_grad():
                    w -= 0.1 * gw
                    b -= 0.1 * gb
                losses.append(loss.detach())
                if len(losses) == PIPE_STEPS:
                    break
            epoch += 1
        losses = torch.stack(losses).tolist()  # the one host sync of the loop
        return {"w": w.detach().cpu(), "b": float(b.detach()), "losses": losses,
                "loader_batches": batches, "loader_s": loader_s,
                "train_s": time.perf_counter() - t0,
                "valid_rows": int(upstream["preprocess"].valid.sum())}

    def postprocess(comm, upstream):
        r = upstream["train"]
        w_err = float((r["w"] - torch.tensor([3.0, -2.0])).abs().max())
        return {"w_err": w_err, "first10_mean_loss": float(np.mean(r["losses"][:10])),
                "last10_mean_loss": float(np.mean(r["losses"][-10:]))}

    pipe = Pipeline("pipeline", [
        cylon_stage("preprocess", preprocess),
        dl_stage("train", train, deps=("preprocess",)),
        dl_stage("postprocess", postprocess, deps=("train",), kind="inference")])
    out = run_pipelines([pipe], max_workers=2)
    if "_error" in out["pipeline"]:
        raise AssertionError(f"pipeline stage failed: {out['pipeline']['_error']}")
    r, post = out["pipeline"]["train"], out["pipeline"]["postprocess"]
    w_err, first, last = post["w_err"], post["first10_mean_loss"], post["last10_mean_loss"]
    if not (w_err < 0.2 and last < first and np.isfinite(r["losses"]).all()):
        raise AssertionError(f"pipeline did not learn: w_err {w_err}, loss {first} -> {last}")
    meta = out["_meta"]

    # host -> device: 16 batches of four 2^22-row host columns (64 MB each)
    step = DF_ROWS // 16
    host = [tuple(host_cols[c][i:i + step] for c in ("x1", "x2", "y", "v"))
            for i in range(0, DF_ROWS, step)]
    nbytes = sum(a.nbytes for item in host for a in item)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(HostPrefetcher(iter(host), depth=2))
    torch.cuda.synchronize()
    prefetch_s = time.perf_counter() - t0
    if not all(torch.equal(d, torch.from_numpy(h).cuda())
               for item, dev in zip(host, got) for h, d in zip(item, dev)) \
            or len(got) != len(host):
        raise AssertionError("prefetched batches differ from the host batches")
    emit({"phase": "pipeline", "ok": True, "gpu": gpu_line(), "rows": DF_ROWS,
          "runtime": "run_pipelines: cylon_stage >> dl_stage >> dl_stage",
          "runtime_overheads": meta["per_pipeline"]["pipeline"],
          "valid_rows": r["valid_rows"], "global_batch": PIPE_BATCH,
          "loader_batches": r["loader_batches"], "loader_s": r["loader_s"],
          "loader_rows_per_s": r["loader_batches"] * PIPE_BATCH / r["loader_s"],
          "train_steps": PIPE_STEPS, "train_s": r["train_s"],
          "train_steps_per_s": PIPE_STEPS / r["train_s"],
          "first10_mean_loss": first, "last10_mean_loss": last,
          "w": r["w"].tolist(), "b": r["b"], "w_err": w_err,
          "prefetch_batches": len(got), "prefetch_bytes": nbytes,
          "prefetch_s": prefetch_s, "prefetch_gb_per_s": nbytes / prefetch_s / 1e9,
          "seconds": time.perf_counter() - t_phase})


def phase_runtime(cfg):
    """The port's two main paths through its pilot runtime.  First the
    training entry point ``launch.train.run``, its stage graph (preprocess >>
    train >> postprocess) under a Session over the card at full width and
    RUNTIME_LAYERS of the 22 layers (the driver's config, cut in depth
    for this call), B 8 x S 512, RUNTIME_STEPS steps, its checkpoint in a
    temporary directory removed afterwards: every counter zeroed just
    before and read just after, flash attention exactly 2 x layers per
    step, no other kernel.  Then a paged fp32 ServeEngine as a service stage
    (``session.serve``), RUNTIME_REQUESTS greedy requests through the
    ServiceHandle, then drain: each request's tokens equal the same
    engine's ``run_until_drained`` on the same weights, and the paged
    kernels alone launch.  Returns the launches of both runs."""
    from repro_torch.core import Session, stage
    from repro_torch.core.task import TaskState
    from repro_torch.launch import train as launch_train
    from repro_torch.serve import Request

    t_phase = time.perf_counter()
    layers = RUNTIME_LAYERS
    full_config = launch_train.get_config
    launch_train.get_config = lambda arch, smoke=False: full_config(
        arch, smoke=smoke).with_overrides(num_layers=layers)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
            args = launch_train.build_parser().parse_args(
                ["--arch", ARCH, "--steps", str(RUNTIME_STEPS), "--batch", str(TRAIN_B),
                 "--seq", str(TRAIN_S), "--ckpt-dir", ckdir])
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res = launch_train.run(args)
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t0
            train_launches = read_counts()
            ckpt_step = store.latest_step(ckdir)
            ckpt_bytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*") if f.is_file())
    finally:
        launch_train.get_config = full_config
    want = 2 * layers * RUNTIME_STEPS
    if train_launches["flash_attention"] != want:
        raise AssertionError(f"the training entry point launched flash {train_launches['flash_attention']} "
                             f"times, expected {want}")
    others = {n: c for n, c in train_launches.items() if n not in PATH_KERNELS["train"]}
    if any(others.values()):
        raise AssertionError(f"the training entry point launched other kernels: {others}")
    if not (res["improved"] and np.isfinite([res["first_loss"], res["last_loss"]]).all()
            and res["steps"] == RUNTIME_STEPS and ckpt_step == RUNTIME_STEPS):
        raise AssertionError(f"the training entry point did not learn or save: {res}, "
                             f"checkpoint step {ckpt_step}")
    torch.cuda.empty_cache()

    # the service stage, fp32 compute, against the same engine run directly
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         model_specs(cfg32), "cuda")
    work = mixed_requests(RUNTIME_REQUESTS, cfg.vocab_size, SEED + 2)
    direct = serve_engine(cfg32, params, kv_layout="paged")
    direct_reqs = [direct.submit(p, max_new_tokens=g) for p, g in work]
    direct.run_until_drained()
    eng = serve_engine(cfg32, params, kv_layout="paged")

    @stage(kind="inference", service=True)
    def engine(ctx):
        return eng.run_service(ctx.control, resume_state=ctx.resume_state)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with Session() as session:
        handle = session.serve(engine, name="serve")
        reqs = [handle.submit_request(Request(p, max_new_tokens=g)) for p, g in work]
        drained = handle.stop(drain=True, timeout=600)
        task = handle.task
        placement = handle.pipeline.stage_placements()
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = read_counts()
    if not drained or task.state is not TaskState.DONE:
        raise AssertionError(f"the service stage ended {task.state}: {task.error}")
    bad = [r.rid for r, d in zip(reqs, direct_reqs)
           if r.state is not RequestState.DONE or r.tokens != d.tokens]
    if bad:
        raise AssertionError(f"service streams differ from the direct engine's: {bad}")
    paged = PATH_KERNELS["paged"]
    if min(serve_launches[n] for n in paged) <= 0 or any(
            c for n, c in serve_launches.items() if n not in paged):
        raise AssertionError(f"the service stage's launches: {serve_launches}")
    if serve_launches["paged_scatter"] != (serve_launches["decode_attention_paged"]
                                           + serve_launches["prefill_attention_paged"]):
        raise AssertionError("the paged scatter did not launch once per prefill call "
                             "and decode append")
    stats = task.result
    del params, direct, eng
    torch.cuda.empty_cache()
    emit({"phase": "runtime", "ok": True, "gpu": gpu_line(),
          "train": {"entry": "repro_torch.launch.train.run", "arch": cfg.name,
                    "layers": layers, "layers_published": cfg.num_layers,
                    "checkpoint_disk_bytes": ckpt_bytes, "batch": TRAIN_B, "seq": TRAIN_S,
                    "steps": res["steps"], "first_loss": res["first_loss"],
                    "last_loss": res["last_loss"], "improved": res["improved"],
                    "train_s": res["train_s"], "wall_s": train_wall,
                    "overheads_s": res["overheads"], "placement": res["placement"],
                    "checkpoint_step": ckpt_step, "launches": train_launches},
          "service": {"entry": "Session.serve(ServeEngine.run_service)",
                      "kv_layout": "paged", "compute_dtype": "torch.float32",
                      "requests": len(reqs), "tokens": sum(len(r.tokens) for r in reqs),
                      "equal_to_run_until_drained": True, "wall_s": serve_wall,
                      "task_state": task.state.value,
                      "overheads_s": {**task.overhead_s, "execute": task.duration_s},
                      "placement": placement, "completed": stats["completed"],
                      "decode_steps": stats["decode_steps"],
                      "prefill_chunks": stats["prefill_chunks"],
                      "launches": serve_launches},
          "seconds": time.perf_counter() - t_phase})
    return train_launches, serve_launches


def exec_pool_kernels(pool, cfg):
    """Kernels 5 and 3 (fp32, the service stage's dtype) at tinyllama's
    serving shapes (B 8, T 64 at bases 0-448, 512 positions in pages of
    16) and kernel 7 at the pipeline's ([8, 2^21] keys, 8 buckets), each
    launched by a worker process and held there to its plain version
    (comparison launches: not counted as the path's)."""
    rng = np.random.default_rng(SEED + 7)
    H, KV, D, B, T, mp = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 8, 64, MAX_LEN // PAGE
    num_pages = B * mp + 1
    bt = rng.permutation(num_pages)[:B * mp].reshape(B, mp).astype(np.int32)
    base = np.array([0, 15, 16, 17, 100, 255, 400, 448], np.int32)
    clens = np.array([64, 1, 33, 0, 64, 17, 64, 64], np.int32)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    case = {"q": randn(B, T, H, D), "k_new": randn(B, T, KV, D), "v_new": randn(B, T, KV, D),
            "k_pages": randn(num_pages, PAGE, KV, D), "v_pages": randn(num_pages, PAGE, KV, D),
            "block_table": torch.from_numpy(bt), "base": torch.from_numpy(base),
            "chunk_lens": torch.from_numpy(clens), "q_dec": randn(B, H, D),
            "lens": torch.from_numpy(base + clens)}
    paged = pool.submit(XT.run_paged_kernels, case).result(timeout=300)
    keys = torch.from_numpy(np.random.default_rng(SEED + 8).integers(
        0, DF_KEYS, (EXEC_SHARDS, EXEC_ROWS // EXEC_SHARDS)).astype(np.int32))
    hashed = pool.submit(XT.run_hash_kernel, keys, EXEC_SHARDS).result(timeout=300)
    tol = TOL[torch.float32]
    if not (paged["prefill_err"] <= tol and paged["decode_err"] <= tol and paged["pages_equal"]
            and hashed["equal"]):
        raise AssertionError(f"a kernel in a worker disagrees with its plain version: "
                             f"{paged}, hash equal {hashed['equal']}")
    want = {"prefill_attention_paged": 1, "paged_scatter": 1, "decode_attention_paged": 1}
    for res, w in ((paged, want), (hashed, {"hash_partition_histogram": 1})):
        if res["launches"] != {n: w.get(n, 0) for n in COUNTED} or res["pid"] == os.getpid():
            raise AssertionError(f"the worker's kernel check did not launch in a worker: {res}")
    return {"paged_prefill_max_abs_err": paged["prefill_err"],
            "paged_decode_max_abs_err": paged["decode_err"], "tolerance": tol,
            "pools_equal": paged["pages_equal"], "hash_bitwise": hashed["equal"],
            "pids": sorted({paged["pid"], hashed["pid"]}),
            "compiled": paged["compiled"] + hashed["compiled"]}


def exec_pipeline(spec):
    """The pipeline (a hash shuffle, then its reduction) as a Session
    graph on ``spec``'s transport over the card, twice in one session:
    the first run's results, and each task's overheads (queue,
    communicator, execute) in seconds in both runs (the first one's
    execute holds the workers' boot and first imports)."""
    from repro_torch.core import Session
    from repro_torch.core.pilot import PilotDescription

    graph = XT.shuffle_stage.bind(EXEC_ROWS, EXEC_SHARDS, SEED) >> XT.reduce_stage
    runs = []  # (results, overheads) of each run
    with Session(pods=[PilotDescription(num_devices=1, name="exec-pod")],
                 max_workers_per_pilot=EXEC_WORKERS, transport=spec,
                 transport_options={"worker_devices": 1}) as s:
        for run in ("cold", "warm"):
            pipe = s.start(graph, name=f"exec-{spec}-{run}")
            if not pipe.wait(600) or pipe.error is not None:
                raise AssertionError(f"the {spec} pipeline failed: {pipe.error}")
            runs.append((pipe.results, {n: {**t.overhead_s, "execute": t.duration_s}
                                        for n, t in pipe.tasks.items()}))
    (first, cold), (second, warm) = runs
    if not np.array_equal(first["shuffle"]["key_sums"], second["shuffle"]["key_sums"]):
        raise AssertionError(f"the {spec} pipeline's two runs differ")
    launches = {n: first["shuffle"]["launches"][n] + second["shuffle"]["launches"][n]
                for n in COUNTED}
    return first, launches, {"cold": cold, "warm": warm}


def exec_wait(reqs, what, task=None, timeout=600.0):
    """Wait for every request; a failed service task or the deadline
    raises."""
    deadline = time.time() + timeout
    for r in reqs:
        while not r.wait(0.5):
            if task is not None and task.finalized and task.error:
                raise AssertionError(f"{what}: the service failed: {task.error}")
            if time.time() > deadline:
                raise AssertionError(f"{what}: {r.rid} stalled at {len(r.tokens)} tokens")


def exec_streams_equal(what, reqs, work, want):
    """Every request DONE with its full count of tokens (a dropped last
    token fails here), and its stream the in-process engine's."""
    counts = [len(r.tokens) for r in reqs]
    if any(r.state is not RequestState.DONE for r in reqs) or \
            counts != [g for _, g in work]:
        raise AssertionError(f"{what}: requests not served in full: {counts} of "
                             f"{[g for _, g in work]}, states {[r.state.name for r in reqs]}")
    bad = [i for i, (r, w) in enumerate(zip(reqs, want)) if r.tokens != w]
    if bad:
        raise AssertionError(f"{what}: streams {bad} differ from the in-process engine's")
    return counts


def exec_service(pool, cfg):
    """The service stage in a worker (a Session on the subprocess
    transport) against an in-process engine on the same weights; then a
    service on the pool preempted mid-decode and resumed from the state
    that crossed the wire."""
    from repro_torch.core import Session
    from repro_torch.core.exec.protocol import dumps
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.core.task import ServiceControl, ServicePreempted

    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    kw = dict(arch=ARCH, smoke=False, overrides={"compute_dtype": torch.float32},
              engine_kw={**SERVE, "kv_layout": "paged"}, seed=SEED)
    dev = torch.device("cuda", 0)
    work = mixed_requests(EXEC_REQUESTS, cfg.vocab_size, SEED + 3)
    # both processes serve two short requests first, off the clock
    warm = [(p, 4) for p, _ in work[:2]]
    direct, params = XT.make_engine(dev, kw["arch"], False, kw["overrides"], kw["engine_kw"],
                                    SEED)
    checksum = XT.weights_checksum(params)
    XT.warm_up(direct, warm)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    direct_reqs = [direct.submit(p, max_new_tokens=g) for p, g in work]
    direct.run_until_drained()
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    direct_launches = read_counts()
    want = [list(r.tokens) for r in direct_reqs]
    del direct

    t0 = time.perf_counter()
    with Session(pods=[PilotDescription(num_devices=1, name="exec-serve-pod")],
                 max_workers_per_pilot=1, transport="subprocess",
                 transport_options={"worker_devices": 1}) as s:
        handle = s.serve(XT.engine_stage.bind(**kw, min_requests=len(work), warm=warm),
                         name="exec-serve")
        reqs = [handle.submit_request(Request(p, max_new_tokens=g)) for p, g in work]
        exec_wait(reqs, "the service stage", handle.task)
        if not handle.stop(drain=True, timeout=120):
            raise AssertionError("the service stage did not drain")
        task = handle.task
    wall = time.perf_counter() - t0
    if task.state.value != "done":
        raise AssertionError(f"the service stage ended {task.state}: {task.error}")
    res = task.result
    if res["weights_checksum"] != checksum:
        raise AssertionError(f"the worker's weights differ from the parent's: checksum "
                             f"{res['weights_checksum']} != {checksum}")
    counts = exec_streams_equal("the service stage", reqs, work, want)
    if res["launches"] != direct_launches:
        raise AssertionError(f"the worker launched {res['launches']}, the in-process "
                             f"engine {direct_launches}")
    paged = PATH_KERNELS["paged"]
    if min(res["launches"][n] for n in paged) <= 0 or any(
            c for n, c in res["launches"].items() if n not in paged):
        raise AssertionError(f"the service stage's launches: {res['launches']}")
    if res["pid"] == os.getpid():
        raise AssertionError("the service stage ran in the parent")
    tokens = sum(counts)
    service = {"entry": "Session(transport='subprocess').serve(ServeEngine.run_service)",
               "compute_dtype": "torch.float32", "requests": len(reqs),
               "tokens_per_request": counts, "weights_checksum": checksum,
               "streams_equal_in_process": True, "worker_pid": res["pid"],
               "launches_in_worker": res["launches"], "launches_in_process": direct_launches,
               "tokens_per_s_remote": tokens / res["serve_s"],
               "tokens_per_s_in_process": tokens / direct_s,
               "serve_s_remote": res["serve_s"], "serve_s_in_process": direct_s,
               "session_wall_s": wall,
               "overheads_s": {**task.overhead_s, "execute": task.duration_s},
               "worker_max_memory_allocated_gb": res["max_memory_allocated"] / 1e9,
               "compiled_in_worker": res["compiled"]}

    # preempted mid-decode, resumed from the state that crossed the wire
    work_p = mixed_requests(EXEC_PREEMPT_REQUESTS, cfg.vocab_size, SEED + 4)
    ref_eng = ServeEngine(cfg32, params=params, device=dev, seed=SEED, **kw["engine_kw"])
    ref_reqs = [ref_eng.submit(p, max_new_tokens=g) for p, g in work_p]
    ref_eng.run_until_drained()
    want_p = [list(r.tokens) for r in ref_reqs]
    del ref_eng
    ctl = ServiceControl()
    reqs_p = [ctl.submit_request(Request(p, max_new_tokens=g)) for p, g in work_p]
    fut = pool.submit(XT.serve, "cuda", **kw, min_requests=len(work_p), service_control=ctl)
    deadline = time.time() + 300
    while min(len(r.tokens) for r in reqs_p) < 2:
        if fut.done() or time.time() > deadline:
            raise AssertionError(f"the preempt run never decoded: {fut}")
        time.sleep(0.005)
    t0 = time.perf_counter()
    ctl.request_preempt()
    try:
        fut.result(timeout=300)
        raise AssertionError("the service was not preempted")
    except ServicePreempted as e:
        state = e.state
    preempt_s = time.perf_counter() - t0
    at_preempt = [len(r.tokens) for r in reqs_p]
    t0 = time.perf_counter()
    state_bytes = len(dumps(state))
    pickle_s = time.perf_counter() - t0
    resume_ctl = ServiceControl()
    resume_ctl.drain()
    t0 = time.perf_counter()
    fut2 = pool.submit(XT.serve, "cuda", **kw, resume_state=state, service_control=resume_ctl)
    while sum(len(r.tokens) for r in reqs_p) == sum(at_preempt) and not fut2.done():
        time.sleep(0.002)
    resume_s = time.perf_counter() - t0
    res2 = fut2.result(timeout=600)
    exec_wait(reqs_p, "the resumed service")
    counts_p = exec_streams_equal("the resumed service", reqs_p, work_p, want_p)
    if res2["stats"]["resumes"] != 1 or res2["stats"]["preemptions"] != 1:
        raise AssertionError(f"the resumed engine's stats: {res2['stats']}")
    del params
    torch.cuda.empty_cache()
    preempt = {"requests": len(reqs_p), "tokens_per_request": counts_p,
               "tokens_at_preemption": at_preempt, "streams_equal_in_process": True,
               "state_bytes": state_bytes, "state_pickle_s": pickle_s,
               "preempt_to_state_in_parent_s": preempt_s,
               "resume_submit_to_first_token_s": resume_s,
               "launches_in_resumed_worker": res2["launches"],
               "compiled_in_worker": res2["compiled"]}
    return service, preempt, res["launches"], res2["launches"]


def exec_fleet(pool, cfg):
    """The disaggregated 1 + 1 fleet in bf16 with its KV handoffs shipped
    through a worker of the pool, against the same fleet with the
    router's own threads."""
    from repro_torch.serve import build_fleet

    params = init_params(torch.Generator(device="cuda").manual_seed(SEED),
                         model_specs(cfg), "cuda")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(9, 17, EXEC_FLEET_REQUESTS)]

    def run(transport, prefix):
        kw = {"transport": transport} if transport is not None else {}
        router = build_fleet(cfg, num_engines=2, disaggregate=True, params=params,
                             name_prefix=prefix, device="cuda", seed=SEED,
                             **{**SERVE, "max_slots": EXEC_FLEET_SLOTS},
                             router_kwargs=kw).start()
        try:
            reqs = [router.submit(Request(p, max_new_tokens=EXEC_FLEET_GEN)) for p in prompts]
            if not router.drain(timeout=600):
                raise AssertionError(f"fleet {prefix} did not drain")
            return reqs, router.stats()
        finally:
            router.close()

    reqs, st = run(pool, "xwire")
    ref, st_in = run(None, "xin")
    work = [(p, EXEC_FLEET_GEN) for p in prompts]
    exec_streams_equal("the fleet over the pool", reqs, work, [list(r.tokens) for r in ref])
    n = st.get("handoff_wire_roundtrips", 0)
    if not (n == st.get("handoffs_routed", -1) >= 1) or st_in.get("handoff_wire_roundtrips", 0):
        raise AssertionError(f"the handoffs did not all cross the worker: {st}")
    del params
    torch.cuda.empty_cache()
    return {"compute_dtype": str(cfg.compute_dtype), "requests": len(reqs),
            "streams_equal_in_process_fleet": True,
            "handoffs_routed": st["handoffs_routed"], "handoff_wire_roundtrips": n,
            "handoff_bytes_per_request": st["handoff_wire_bytes"] / n,
            "handoff_wire_ms_per_request": st["handoff_wire_s"] * 1e3 / n}


def exec_faults(pool):
    """A worker SIGKILLed mid-task, a checkpointed task retried on the
    respawned pool with its resume step, a heartbeat stall caught by the
    backstop, a dropped reply recovered by the attempt deadline; every
    planned fault fires, and the pool serves a task after each."""
    import signal

    from repro_torch.core.agent import RemoteAgent
    from repro_torch.core.exec import WorkerCrashed
    from repro_torch.core.pilot import PilotDescription, PilotManager
    from repro_torch.core.resilience import FaultPlan, inject
    from repro_torch.core.task import TaskDescription, TaskState

    def crashed(fut, match, what):
        t0 = time.perf_counter()
        try:
            fut.result(timeout=120)
        except WorkerCrashed as e:
            if match not in str(e):
                raise AssertionError(f"{what}: {e}") from e
            return time.perf_counter() - t0
        raise AssertionError(f"{what}: the task returned")

    def serves():
        if pool.submit(XT.add_one, 1).result(timeout=300) != 2:
            raise AssertionError("the pool does not serve after a fault")

    out = {}
    fut = pool.submit(XT.sleep_for, 60)
    deadline = time.time() + 60
    busy = []
    while not busy and time.time() < deadline:
        busy = [w["pid"] for w in pool.worker_info().values() if w["state"] == "busy"]
        time.sleep(0.01)
    t0 = time.perf_counter()
    os.kill(busy[0], signal.SIGKILL)
    crashed(fut, "died while running", "SIGKILL")
    out["sigkill_to_exception_s"] = time.perf_counter() - t0
    serves()

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        pm = PilotManager()
        pilot = pm.submit_pilot(PilotDescription(num_devices=1))
        agent = RemoteAgent(pilot, transport=pool)
        try:
            t0 = time.perf_counter()
            task, = agent.submit([TaskDescription(
                name="train", fn=XT.train_then_die, args=(ckpt,), checkpoint_dir=ckpt,
                max_retries=2, group="g")])
        finally:
            agent.close()
            pm.cancel_pilot(pilot)
        if task.state is not TaskState.DONE or task.result[:2] != ("resumed", 7) \
                or task.attempts != 2:
            raise AssertionError(f"checkpoint retry: {task.state} {task.result} "
                                 f"{task.attempts} {task.error}")
        out["checkpoint_retry"] = {"result": list(task.result[:2]), "attempts": task.attempts,
                                   "seconds": time.perf_counter() - t0}

    with inject(FaultPlan(seed=SEED).stall_heartbeat(60.0, at_task=1)) as inj:
        fut = pool.submit(XT.sleep_for, 30)
        out["heartbeat_stall_to_exception_s"] = crashed(fut, "no heartbeat", "stall")
        if not inj.all_fired():
            raise AssertionError(f"stall_heartbeat did not fire: {inj.pending()}")
    serves()
    with inject(FaultPlan(seed=SEED).drop_reply(nth=1)) as inj:
        fut = pool.submit(XT.add_one, 1, attempt_timeout_s=EXEC_ATTEMPT_S)
        out["dropped_reply_to_exception_s"] = crashed(fut, "deadline", "drop")
        if not inj.all_fired():
            raise AssertionError(f"drop_reply did not fire: {inj.pending()}")
    serves()
    out["attempt_deadline_s"] = EXEC_ATTEMPT_S
    out["respawns"] = pool.stats()["respawns"]
    return out


def phase_exec(cfg):
    """The cross-process runtime (``repro_torch.core.exec``) on the card:
    the worker pool's boot, round trip and wire rate; the kernels of this
    path in a worker against their plain versions; the pipeline (a 2^24-row
    hash shuffle through kernel 7, then its reduction) in workers,
    bitwise the in-process run's; the service stage in a worker, fp32 at
    full width, streams and launches the in-process engine's, then a
    service preempted and resumed across the wire; the disaggregated 1 + 1
    fleet in bf16 with its handoffs through a worker; the faults.  Kernel
    launches are counted in the workers and returned by their tasks: the
    launches of the path's runs, summed per kernel."""
    from repro_torch.core.exec import SubprocessTransport

    t_phase = time.perf_counter()
    pool = SubprocessTransport(max_workers=EXEC_WORKERS, worker_devices=1)
    try:
        info = pool.wait_ready(timeout=300)
        if any(w["device_name"] != torch.cuda.get_device_name(0) for w in info.values()):
            raise AssertionError(f"a worker is not on the card: {info}")
        rtts = []
        for i in range(EXEC_ECHOS):
            t0 = time.perf_counter()
            pool.submit(XT.echo, i).result(timeout=60)
            rtts.append((time.perf_counter() - t0) * 1e3)
        x = torch.randn(EXEC_WIRE_MB << 18, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pool.submit(XT.echo, x).result(timeout=300)
        wire_s = time.perf_counter() - t0
        if not torch.equal(y, x.cpu()):
            raise AssertionError("the tensor came back different")
        del x, y
        kernels = exec_pool_kernels(pool, cfg)

        results, shuffle_launches, overheads = {}, {}, {}
        for spec in ("subprocess", "in-process"):
            zero_counts()
            results[spec], shuffle_launches[spec], overheads[spec] = exec_pipeline(spec)
        in_process_hash = read_counts()
        sub, inp = results["subprocess"], results["in-process"]
        for k in ("counts", "key_sums"):
            if not np.array_equal(sub["shuffle"][k], inp["shuffle"][k]):
                raise AssertionError(f"the pipeline's {k} differ from the in-process run's")
        if sub["reduce"] != {**inp["reduce"], "pid": sub["reduce"]["pid"]} \
                or sub["reduce"]["rows"] != EXEC_ROWS or sub["reduce"]["dropped"]:
            raise AssertionError(f"the pipeline's result: {sub['reduce']} vs {inp['reduce']}")
        if os.getpid() in (sub["shuffle"]["pid"], sub["reduce"]["pid"]) or \
                shuffle_launches["subprocess"] != {n: 2 * int(n == "hash_partition_histogram")
                                                   for n in COUNTED} \
                or in_process_hash != shuffle_launches["subprocess"]:
            raise AssertionError(f"the shuffle stage: pid {sub['shuffle']['pid']}, launches "
                                 f"in workers {shuffle_launches['subprocess']}, in process "
                                 f"{in_process_hash}")
        pipeline = {"rows": EXEC_ROWS, "shards": EXEC_SHARDS,
                    "rows_per_shard": sub["shuffle"]["counts"].tolist(),
                    "key_sum": sub["reduce"]["key_sum"], "equal_in_process": True,
                    "worker_pids": [sub["shuffle"]["pid"], sub["reduce"]["pid"]],
                    "shuffle_s_worker": sub["shuffle"]["seconds"],
                    "shuffle_s_in_process": inp["shuffle"]["seconds"],
                    "runs": 2, "launches_in_workers": shuffle_launches["subprocess"],
                    "launches_in_process": in_process_hash,
                    "overheads_s": overheads,
                    "compiled_in_worker": sub["shuffle"]["compiled"]}

        service, preempt, serve_launches, resumed_launches = exec_service(pool, cfg)
        fleet_out = exec_fleet(pool, cfg)
        heartbeat = {wid: w["max_heartbeat_gap_s"] for wid, w in pool.worker_info().items()}
        faults = exec_faults(pool)
        pids = pool.worker_pids()
    finally:
        pool.shutdown(wait=False)
    deadline = time.time() + 10
    while any(Path(f"/proc/{p}").exists() for p in pids) and time.time() < deadline:
        time.sleep(0.05)
    compiled = (kernels["compiled"] + pipeline["compiled_in_worker"]
                + service["compiled_in_worker"] + preempt["compiled_in_worker"])
    if compiled:
        raise AssertionError(f"a worker compiled kernel libraries: {compiled}")
    launches = {n: shuffle_launches["subprocess"][n] + serve_launches[n] + resumed_launches[n]
                for n in COUNTED}
    emit({"phase": "exec", "ok": True, "gpu": gpu_line(),
          "workers": {wid: {k: w[k] for k in ("pid", "device_name", "ready_s", "boot_s")}
                      for wid, w in info.items()},
          "heartbeat": {"max_gap_s": heartbeat, "timeout_s": pool.heartbeat_timeout_s},
          "echo_rtt_ms_p50": float(np.median(rtts)), "echo_rtt_ms_max": max(rtts),
          "wire": {"bytes": EXEC_WIRE_MB << 20, "round_trip_s": wire_s,
                   "mb_per_s": 2 * (EXEC_WIRE_MB << 20) / wire_s / 1e6, "bitwise": True},
          "kernels_in_worker": kernels, "pipeline": pipeline, "service": service,
          "preempt": preempt, "fleet": fleet_out, "faults": faults,
          "launches_in_workers": launches, "workers_reaped": True,
          "seconds": time.perf_counter() - t_phase})
    return launches


def dist_spec(cfg):
    """The card scenario's sizes (tests/torch_dist_ranks.py ``card``)."""
    return {"device": "cuda", "seed": SEED, "df_rows": DIST_ROWS, "df_keys": DF_KEYS,
            "df_atol": DF_PAIR_ATOL, "reduce_rtol": DF_REDUCE_RTOL,
            "arch": ARCH, "smoke": False,
            "grad_b": DIST_GRAD_B, "grad_s": TRAIN_S, "ef_syncs": DIST_EF_SYNCS,
            "pipe_micro": DIST_MICRO, "pipe_shape": [TRAIN_B, TRAIN_S, cfg.d_model]}


# the ops of the card scenario's (data, pipe) mesh, each on a subgroup
GRID_OPS = ("all_reduce", "send", "recv", "broadcast")


def dist_problems(res, backend, world, device="cuda:0"):
    """What fails in one rank's card scenario: the dataframe pairs and
    kernel 7's launches, flash's launches in the backward (2 a layer,
    under remat, as in the train phase's step), the int8 sync's error,
    error feedback, GPipe, and each op's backend, world and device (the
    pipeline's messages on the host under gloo, every other tensor on
    the rank's card ``device``; the grid's ops also on subgroups)."""
    bad = []
    if res["flash_launches"] != 2 * res["grads"]["layers"]:
        bad.append(f"flash launched {res['flash_launches']} times in the backward, "
                   f"expected {2 * res['grads']['layers']}")
    for name, row in res["dataframe"].items():
        if not row["equal"] or row["dropped"] or row["dropped_logical"]:
            bad.append(f"dataframe {name}: {row}")
        if row["hash_launches"] != DF_LAUNCHES[name]:
            bad.append(f"{name}: kernel 7 launched {row['hash_launches']}, "
                       f"expected {DF_LAUNCHES[name]}")
    g = res["grads"]
    if not g["max_rel_err"] < INT8_REL_TOL:
        bad.append(f"int8 sync error {g['max_rel_err']}")
    for what, e in (("own gradient", g), ("mean gradient", g["replicated"])):
        if not e["ef_err"] <= EF_RATIO * e["plain_err"]:
            bad.append(f"error feedback on the {what} {e['ef_err']} vs plain {e['plain_err']}")
    if not res["pipeline"]["max_rel_diff"] <= PIPE_RTOL:
        bad.append(f"pipeline {res['pipeline']}")
    grid = res.get("grid")
    sub = min(grid["shape"].values()) if grid else None
    for op, entries in res["wire"].items():
        host = backend == "gloo" and op in ("send", "recv")
        allowed = [{"backend": backend, "world": w, "device": "cpu" if host else device}
                   for w in [world] + ([sub] if grid and op in GRID_OPS else [])]
        if any(e not in allowed for e in entries):
            bad.append(f"{op} ran on {entries}, expected each of them in {allowed}")
    if grid:
        # every rank of a line takes part in its all-reduces and broadcast
        for op in ("all_reduce", "broadcast"):
            if sub not in {e["world"] for e in res["wire"].get(op, [])}:
                bad.append(f"{op} never ran on a subgroup of {sub}")
        if not grid["sync"]["max_rel_err"] < INT8_REL_TOL:
            bad.append(f"grid: int8 sync along data {grid['sync']['max_rel_err']}")
        if not grid["pipeline"]["max_rel_diff"] <= PIPE_RTOL:
            bad.append(f"grid: pipeline along pipe {grid['pipeline']}")
    if world == 1 and not (res["identity"] and g["identity"]):
        bad.append("a collective at world 1 was not the identity")
    return bad


def ranks_summary(ranks, spec) -> dict:
    """The card scenario's per-rank numbers, side by side: the dataframe's,
    the gradient syncs' and GPipe's (and the grid's, where it ran)."""
    per_rank = lambda key: [{n: row[key] for n, row in r["dataframe"].items()}  # noqa: E731
                            for r in ranks]
    g = [r["grads"] for r in ranks]
    out = {"dataframe": {"rows": spec["df_rows"], "rows_per_rank": spec["df_rows"] // len(ranks),
                         "right_rows": spec["df_keys"], "ms_process": per_rank("ms_process"),
                         "ms_logical": per_rank("ms_logical"),
                         "hash_launches": per_rank("hash_launches"),
                         "equal": per_rank("equal"),
                         "groupby_sum_max_abs_diff": [r["dataframe"]["groupby"][
                             "groupby_sum_max_abs_diff"] for r in ranks],
                         "tolerance": {"groupby sums abs": DF_PAIR_ATOL,
                                       "reduce rel": DF_REDUCE_RTOL, "else": "bitwise"}},
           "flash_launches_per_rank": [r["flash_launches"] for r in ranks],
           "grads": {"arch": ARCH, "layers": g[0]["layers"], "params": g[0]["params"],
                     "leaves": g[0]["leaves"], "batch_per_rank": [DIST_GRAD_B, TRAIN_S],
                     "fp32_ms": [x["fp32_ms"] for x in g],
                     "int8_ms": [x["int8_ms"] for x in g],
                     "fp32_bytes": g[0]["fp32_bytes"], "int8_bytes": g[0]["int8_bytes"],
                     "max_rel_err": [x["max_rel_err"] for x in g], "tol": INT8_REL_TOL,
                     "ranks_bitwise_equal": len({tuple(x["checksums"]) for x in g}) == 1,
                     "ef_err": [x["ef_err"] for x in g],
                     "plain_err": [x["plain_err"] for x in g], "ef_ratio_max": EF_RATIO,
                     "replicated_ef_err": [x["replicated"]["ef_err"] for x in g],
                     "replicated_plain_err": [x["replicated"]["plain_err"] for x in g],
                     "ef_ms_per_sync": [x["ef_ms_per_sync"] for x in g],
                     "embed_elems": g[0]["embed_elems"]},
           "pipeline": {"stages": ranks[0]["pipeline"]["stages"],
                        "microbatches": spec["pipe_micro"],
                        "microbatch_shape": spec["pipe_shape"],
                        "max_rel_diff": [r["pipeline"]["max_rel_diff"] for r in ranks],
                        "ms_per_microbatch": [r["pipeline"]["ms_per_microbatch"]
                                              for r in ranks],
                        "bytes_per_message": ranks[0]["pipeline"]["bytes_per_message"],
                        "tol_rel": PIPE_RTOL}}
    if "grid" in ranks[0]:
        out["grid"] = {
            "shape": ranks[0]["grid"]["shape"], "coords": [r["grid"]["coords"] for r in ranks],
            "int8_max_rel_err": [r["grid"]["sync"]["max_rel_err"] for r in ranks],
            "int8_ms": [r["grid"]["sync"]["int8_ms"] for r in ranks],
            "pipeline_max_rel_diff": [r["grid"]["pipeline"]["max_rel_diff"] for r in ranks],
            "pipeline_ms_per_microbatch": [r["grid"]["pipeline"]["ms_per_microbatch"]
                                           for r in ranks]}
    return out


def phase_distributed(cfg):
    """The process mesh, the collectives and GPipe on the card: DIST_RANKS
    gloo rank processes, then one NCCL rank in this process (every
    collective the identity), the same scenario in each (module
    docstring).  Every rank reaped on every exit path; a failed rank fails
    the phase.  Returns kernel 7's launches, counted in the ranks and
    here."""
    t_phase = time.perf_counter()
    spec = dist_spec(cfg)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        t0 = time.perf_counter()
        ranks = DR.launch("card", DIST_RANKS, workdir, spec=spec,
                          timeout=DIST_TIMEOUT_S, threads=4)
        ranks_s = time.perf_counter() - t0
    # world 1 on NCCL, in this process
    dist.init_process_group("nccl", store=DR.host_store(1), rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        one = DR.card(spec)
        one_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    bad = [f"rank {r['rank']}: {b}" for r in ranks for b in dist_problems(r, "gloo", DIST_RANKS)]
    bad += [f"nccl world 1: {b}" for b in dist_problems(one, "nccl", 1)]
    if len({tuple(r["grads"]["checksums"]) for r in ranks}) != 1:
        bad.append("the ranks' int8-synced gradients differ")
    wire = {"gloo_world_2": {op: e for r in ranks for op, e in r["wire"].items()},
            "nccl_world_1": one["wire"]}
    for world, ops_ in wire.items():
        for op, entries in sorted(ops_.items()):
            print(f"distributed: {world} {op}: " + ", ".join(
                f"backend {e['backend']}, world {e['world']}, tensors on {e['device']}"
                for e in entries), flush=True)
    launches = sum(row["hash_launches"] for r in ranks + [one]
                   for row in r["dataframe"].values())
    out = {"phase": "distributed", "ok": not bad, "gpu": gpu_line(),
           "torch": torch.__version__, "ranks": DIST_RANKS,
           "backends": {"world_2": "gloo (NCCL: 'Duplicate GPU detected' for two ranks "
                                   "on one device); the pipeline's send/recv through "
                                   "host copies (gloo's send of a card tensor aborts)",
                        "world_1": "nccl"},
           "wire": wire, **ranks_summary(ranks, spec),
           "nccl_world_1": {"identity": one["identity"], "grads_identity":
                            one["grads"]["identity"],
                            "dataframe_equal": {n: row["equal"] for n, row in
                                                one["dataframe"].items()},
                            "hash_launches": {n: row["hash_launches"] for n, row in
                                              one["dataframe"].items()},
                            "pipeline_max_rel_diff": one["pipeline"]["max_rel_diff"],
                            "seconds": one_s},
           "hash_launches": launches, "ranks_s": ranks_s, "problems": bad,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if bad:
        raise AssertionError(f"the distributed phase failed: {bad}")
    return launches


def check_step_syncs(cfg, params):
    """tinyllama's warm decode step and chunk step at full width on both
    layouts (the engine's own step closures, inputs built beforehand,
    after a few engine steps with every slot decoding), each called once
    under sync-debug "error", beside the host-sync pass's verdict on the
    same roots (``make_decode_step``, ``make_prefill_chunk_step``).  Both
    must be clean; a disagreement fails the phase, whichever side reports
    the sync."""
    from repro_torch.analysis import host_sync

    names = ("make_decode_step", "make_prefill_chunk_step")
    roots = [r for r in host_sync.ROOTS if r.name in names]
    static = [f.render() for f in host_sync.run(
        host_sync.src_modules(ARGS.src.resolve() / "repro_torch"), ROOT, roots=roots)]
    B, T = SERVE["max_slots"], 16
    runs = {}
    for layout in LAYOUTS:
        engine = serve_engine(cfg, params, kv_layout=layout)
        # long generations, so every slot still decodes when the steps run
        for prompt, _ in mixed_requests(B, cfg.vocab_size, SEED + 13):
            engine.submit(prompt, max_new_tokens=MAX_LEN // 2)
        for _ in range(400):  # until every slot decodes, then two more steps
            engine.step()
            if all(r is not None for r in engine.slots) and (engine.prefill_pos < 0).all():
                break
        engine.step()
        engine.step()
        lens = engine.lengths.astype(np.int32)
        t = engine._tensor
        bt = t(engine.block_table) if layout == "paged" else None
        dec_args = (engine._run_params, t(engine.last_tok)[:, None], engine.cache,
                    t(lens), bt)
        base = np.minimum(lens, MAX_LEN - T).astype(np.int32)
        chunk_args = (engine._run_params, t(np.ones((B, T), np.int32)), t(base),
                      t(np.full(B, T, np.int32)), engine.cache, bt)
        torch.cuda.synchronize()
        raised = {}
        for step, (fn, args) in (("decode_step", (engine._decode, dec_args)),
                                 ("chunk_step", (engine._prefill_chunk, chunk_args))):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*args)
            except RuntimeError as e:
                raised[step] = str(e).splitlines()[0][:300]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        runs[layout] = {"raised": raised, "slots_decoding": int((engine.lengths > 0).sum())}
        del engine, dec_args, chunk_args
        torch.cuda.empty_cache()
    ok = not static and not any(r["raised"] for r in runs.values())
    out = {"phase": "kernels", "check": "step host syncs", "ok": ok, "arch": cfg.name,
           "sync_debug_mode": "error", "runs": runs, "chunk_T": T,
           "host_sync_pass": {"roots": list(names), "findings": static}}
    emit(out)
    if not ok:
        raise AssertionError(f"a serving step syncs the host, or the pass and the card "
                             f"disagree: {out}")


def phase_gang(ranks: int = GANG_RANKS, rows: int = DIST_ROWS, phase: str = "gang"):
    """A task ganged over worker processes (module docstring): the agent
    leases ``ranks`` devices of a pilot that lists the one card ``ranks``
    times (distinct cards where the machine has them), wider than a
    worker of the pool holds, so the transport runs the task as a gang of
    gloo ranks (NCCL on distinct cards) over tables of ``rows`` rows;
    rank 0's result against the same tables on a logical mesh of
    ``ranks`` shards here.  Returns kernel 7's launches, counted in the
    ranks."""
    from repro_torch.core.agent import RemoteAgent
    from repro_torch.core.exec import SubprocessTransport
    from repro_torch.core.pilot import Pilot
    from repro_torch.core.task import TaskDescription, TaskState

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    distinct = n_cards >= ranks
    backend = "nccl" if distinct else "gloo"
    if distinct:
        print(f"gang: this machine has {n_cards} cards: the gang's {ranks} ranks "
              f"run on cards 0-{ranks - 1} over NCCL", flush=True)
    else:
        print(f"gang: this machine has {n_cards} card, so NCCL between distinct cards "
              f"cannot run here: the gang's {ranks} ranks share the card on gloo",
              flush=True)
    spec = {"seed": SEED, "rows": rows, "keys": DF_KEYS, "groups_cap": DF_KEYS,
            "warmup": True}
    pool = SubprocessTransport(max_workers=ranks, worker_devices=1)
    pids = []
    try:
        info = pool.wait_ready(timeout=300)
        pids = pool.worker_pids()
        pilot = Pilot("gang.0000", [torch.device("cuda", i if distinct else 0)
                                    for i in range(ranks)])
        with RemoteAgent(pilot, transport=pool) as agent:
            t0 = time.perf_counter()
            task, = agent.submit([TaskDescription(
                name="gang_dataframe", fn=XT.gang_dataframe, args=(spec,),
                num_devices=ranks, speculative=False, max_retries=0,
                timeout_s=GANG_ATTEMPT_S)])
            task_s = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=False)
    deadline = time.time() + 10
    while any(Path(f"/proc/{p}").exists() for p in pids) and time.time() < deadline:
        time.sleep(0.05)
    if task.state is not TaskState.DONE:
        raise AssertionError(f"the gang's attempt failed: {task.error}")
    out = task.result
    bad = []
    if out["world"] != ranks or out["backend"] != backend or out["device"] != "cuda:0":
        bad.append(f"gang of {out['world']} on {out['backend']}, {out['device']}")
    if sorted(out["pids"]) != sorted(pids) or os.getpid() in out["pids"]:
        bad.append(f"ranks ran in {out['pids']}, the pool's workers are {pids}")
    want = {n: DF_LAUNCHES[n] for n in XT.GANG_OPS}
    for r, got in enumerate(out["launches"]):
        if got != want:
            bad.append(f"rank {r}: kernel 7 launched {got}, expected {want}")
    # the same tables on a 2-shard logical mesh in this process
    left, right = XT.gang_tables(spec)
    mesh = make_mesh((ranks,), ("data",), device="cuda")
    calls = XT.gang_calls(Table.from_columns(left, mesh), Table.from_columns(right, mesh),
                          dfo, spec["groups_cap"])
    logical_ms, diffs = {}, {}
    for name in XT.GANG_OPS:
        calls[name]()  # warm-up, as in the ranks
        res, dropped, logical_ms[name] = timed(calls[name])
        got = out["results"][name]
        if name == "reduce":
            diffs[name] = abs(got["v"] - res["v"]) / abs(res["v"])
            if not diffs[name] <= DF_REDUCE_RTOL:
                bad.append(f"reduce: {got['v']} vs {res['v']}")
            continue
        ok = got["dropped"] == int(dropped) and got["dropped"] == 0 \
            and np.array_equal(got["valid"], res.valid.cpu().numpy()) \
            and sorted(got["cols"]) == sorted(res.column_names)
        diffs[name] = 0.0
        for col in res.column_names if ok else ():
            want_col = res.col(col).cpu().numpy()
            if name == "groupby" and col == "v":
                diffs[name] = float(np.abs(got["cols"][col] - want_col).max())
                ok = ok and diffs[name] <= DF_PAIR_ATOL
            else:
                ok = ok and np.array_equal(got["cols"][col], want_col)
        if not ok:
            bad.append(f"{name}: rank 0's result differs from the logical mesh's "
                       f"(dropped {got['dropped']} vs {int(dropped)})")
        del res
    del calls, mesh
    torch.cuda.empty_cache()
    result_mb = sum(a.nbytes for r in out["results"].values() if "cols" in r
                    for a in [*r["cols"].values(), r["valid"]]) / 1e6
    line = {"phase": phase, "ok": not bad, "gpu": gpu_line(), "ranks": ranks,
            "backend": out["backend"], "device": out["device"],
            "cards": n_cards,
            "nccl_between_cards": ("measured: ranks on distinct cards" if distinct
                                   else "not measured: one card on this machine"),
            "workers": {wid: {k: w[k] for k in ("pid", "ready_s", "boot_s")}
                        for wid, w in info.items()},
            "rendezvous_s": task.overhead_s.get("rendezvous"),
            "communicator_s": task.overhead_s.get("communicator"),
            "queue_s": task.overhead_s.get("queue"), "task_s": task_s,
            "rank_pids": out["pids"], "rows": rows, "right_rows": DF_KEYS,
            "ms_per_rank": out["ms"], "ms_logical": logical_ms,
            "hash_launches_per_rank": out["launches"], "diffs": diffs,
            "tolerance": {"groupby sums abs": DF_PAIR_ATOL, "reduce rel": DF_REDUCE_RTOL,
                          "else": "bitwise"},
            "result_mb_to_rank_0": result_mb, "problems": bad,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if bad:
        raise AssertionError(f"the {phase} phase failed: {bad}")
    return sum(sum(r.values()) for r in out["launches"])


# -- the multi-card mode (--cards) -------------------------------------------


def settle() -> str:
    """Synchronize every card; the error text where one fails, else ""."""
    try:
        for card in range(torch.cuda.device_count()):
            torch.cuda.synchronize(card)
        return ""
    except Exception as e:  # noqa: BLE001 — recorded: the check reports it
        return f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"


def check_rms(args):
    x, w = args
    got, want = rms.rmsnorm_kernel(x, w).float(), rms.rmsnorm_plain(x, w).float()
    diff = (got - want).abs()
    tol = RMS_TOL[x.dtype]
    return diff.max().item(), bool((diff <= tol + tol * want.abs()).all())


def check_hash(args):
    keys, = args
    got = hp.hash_partition_histogram_kernel(keys, num_buckets=8)
    ok = torch.equal(got, hp.hash_partition_histogram_plain(keys, num_buckets=8))
    return 0.0 if ok else float("nan"), ok


def check_scatter(args):
    kp, vp, bt, kn, vn, bs, cl = args
    gk, gv = pf.write_chunk_paged_kernel(kp.clone(), vp.clone(), bt, kn, vn, bs, cl)
    ok = (torch.equal(gk, pf.write_chunk_paged(kp.clone(), bt, kn, bs, cl))
          and torch.equal(gv, pf.write_chunk_paged(vp.clone(), bt, vn, bs, cl)))
    return 0.0 if ok else float("nan"), ok


def card_check_cases(gen):
    """name -> (check, args on card 0, G, D): every wrapper of the seven
    kernels and the paged scatter, bf16, at shapes of their paths;
    the five tensor-core kernels above 48 KB of dynamic shared memory
    (both decodes and flash at tinyllama's D 64, both prefills at
    moonshot's H 16, KV 16, D 128)."""
    bf = torch.bfloat16
    lens = [0, 1, 17, 255, 300, 511, 512, 64]
    base, clens = [0, 5, 100, 448, 0, 17, 200, 30], [64, 3, 64, 64, 0, 1, 33, 64]
    sc = paged_scatter_cases
    num_pages, (sbase, sclens, sbt) = sorted(sc.SCATTER_CASES.items())[0][1]
    return {
        "decode_attention": (check_contig_decode, contig_decode_case(
            gen, 32, 4, 64, MAX_LEN, lens, bf), 8, 64),
        "decode_attention_paged": (check_decode, decode_case(
            gen, 32, 4, 64, MAX_LEN // PAGE, lens, bf), 8, 64),
        "prefill_attention": (check_contig_prefill, contig_prefill_case(
            gen, 64, 16, 16, 128, MAX_LEN, base, clens, bf), 1, 128),
        "prefill_attention_paged": (check_prefill, prefill_case(
            gen, 64, 16, 16, 128, MAX_LEN // PAGE, base, clens, bf), 1, 128),
        "flash_attention": (check_flash, flash_case(gen, TRAIN_B, 32, 4, TRAIN_S, 64, bf),
                            8, 64),
        "rmsnorm": (check_rms, (randn(gen, RMS_SHAPE, bf), randn(gen, RMS_SHAPE[-1:], bf)),
                    None, None),
        "hash_partition_histogram": (check_hash, (hash_keys(gen, 1 << 23),), None, None),
        "paged_scatter": (check_scatter, (
            randn(gen, (num_pages, sc.PAGE, 2, 16), bf), randn(gen, (num_pages, sc.PAGE, 2, 16), bf),
            i32(sbt), randn(gen, (sc.B, sc.T, 2, 16), bf), randn(gen, (sc.B, sc.T, 2, 16), bf),
            i32(sbase), i32(sclens)), None, None)}


def on_card(args, card: int):
    return tuple(a.to(f"cuda:{card}") if isinstance(a, torch.Tensor) else a for a in args)


def run_check(check, args) -> dict:
    """One check, its error text kept (the parent commit's faults are a
    result here), then every card synchronized."""
    try:
        err, ok = check(args)
        row = {"max_abs_err": err, "ok": bool(ok)}
    except Exception as e:  # noqa: BLE001 — recorded and failed below
        row = {"ok": False, "error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"}
    sync_error = settle()
    if sync_error:
        row.update(ok=False, sync_error=sync_error)
    return row


def kernel_cards(prof) -> dict:
    """{the port's kernel symbol: the cards it ran on} from a profile."""
    symbols = sorted({s for v in SYMBOLS.values() for s in v})
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for sym in symbols:
                if sym in e.name:
                    out.setdefault(sym, set()).add(e.device_index)
    return {k: sorted(v) for k, v in out.items()}


def phase_cards_check():
    """Both faults a machine of several cards can hit (module docstring,
    ``check``).  Runs first in its process: no kernel has launched on any
    card before (b).  The profiler names the card each of the port's
    kernels ran on.  Every row is recorded; any failure fails the phase
    after its line."""
    t_phase = time.perf_counter()
    cases = card_check_cases(torch.Generator(device="cuda").manual_seed(SEED))
    settle()
    activity = [torch.profiler.ProfilerActivity.CUDA]
    # (b) card 0, then card 1 with card 1 current, in this fresh process
    cap = []
    with torch.profiler.profile(activities=activity) as prof:
        for name in TC_KERNELS:
            check, args, G, D = cases[name]
            row = {"kernel": name, "head_dim": D, "group": G}
            for card in (0, 1):
                moved = on_card(args, card)
                with torch.cuda.device(card):
                    row[f"card_{card}"] = run_check(check, moved)
            cap.append(row)
    cap_cards = kernel_cards(prof)
    # (a) every wrapper on card 1 from a thread whose current card is 0
    moved = {name: on_card(args, 1) for name, (_, args, _, _) in cases.items()}
    settle()
    thread_rows = []

    def body():
        torch.cuda.set_device(0)
        for name, (check, _, _, _) in cases.items():
            row = {"kernel": name, **run_check(check, moved[name])}
            row["current_card_after"] = torch.cuda.current_device()
            thread_rows.append(row)

    with torch.profiler.profile(activities=activity) as prof:
        th = threading.Thread(target=body, name="card-0-thread")
        th.start()
        th.join()
        settle()
    thread_cards = kernel_cards(prof)
    bad = []
    for row in cap:
        for card in (0, 1):
            if not row[f"card_{card}"]["ok"]:
                bad.append(f"(b) {row['kernel']} on card {card}: {row[f'card_{card}']}")
        sym = SYMBOLS[row["kernel"]][-1]
        if cap_cards.get(sym) != [0, 1]:
            bad.append(f"(b) {sym} ran on cards {cap_cards.get(sym)}, expected [0, 1]")
    for row in thread_rows:
        if not row["ok"] or row["current_card_after"] != 0:
            bad.append(f"(a) {row['kernel']} on card 1: {row}")
        for sym in SYMBOLS[row["kernel"]]:
            if thread_cards.get(sym) != [1]:
                bad.append(f"(a) {sym} ran on cards {thread_cards.get(sym)}, expected [1]")
    emit({"phase": "cards_check", "ok": not bad, "gpu": gpu_line(), "gpus": gpu_lines(),
          "src": str(ARGS.src), "torch": torch.__version__,
          "tol": {"bf16": TOL_NOTE[torch.bfloat16], "rmsnorm": RMS_TOL[torch.bfloat16],
                  "hash and scatter": "bitwise"},
          "b_cap_per_card": cap, "b_kernel_cards": cap_cards,
          "a_thread_on_card_0": thread_rows, "a_kernel_cards": thread_cards,
          "problems": bad, "seconds": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError(f"the cards_check phase failed: {bad}")


def phase_cards_mesh(cfg):
    """The card scenario at world CARDS on NCCL, rank r on card r (module
    docstring, ``mesh``); every check of the one-card distributed phase
    in every rank, the grid's, and four distinct cards."""
    t_phase = time.perf_counter()
    spec = dict(dist_spec(cfg), df_rows=CARDS_ROWS, grid=list(CARDS_GRID))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as workdir:
        t0 = time.perf_counter()
        ranks = DR.launch("card", CARDS, workdir, spec=spec, timeout=DIST_TIMEOUT_S,
                          threads=2, backend="nccl")
        ranks_s = time.perf_counter() - t0
    bad = [f"rank {r['rank']}: {b}" for r in ranks
           for b in dist_problems(r, "nccl", CARDS, f"cuda:{r['rank']}")]
    if [r["device"] for r in ranks] != [f"cuda:{i}" for i in range(CARDS)]:
        bad.append(f"ranks on {[r['device'] for r in ranks]}")
    # four distinct cards: by UUID, and by PCI bus id where the CUDA
    # driver gives one (nvidia-smi may read every bus id as [N/A])
    uuids = [r["card"]["uuid"] for r in ranks]
    buses = [r["card"]["pci_bus_id"] for r in ranks]
    if len(set(uuids)) != CARDS or (None not in buses and len(set(buses)) != CARDS):
        bad.append(f"the ranks' cards (UUIDs {uuids}, PCI bus ids {buses}) are not "
                   f"{CARDS} distinct cards")
    if len({tuple(r["grads"]["checksums"]) for r in ranks}) != 1:
        bad.append("the ranks' int8-synced gradients differ")
    lines = {}
    for r in ranks:
        lines.setdefault(r["grid"]["coords"]["pipe"], []).append(
            tuple(r["grid"]["sync"]["checksums"]))
    if sorted(len(v) for v in lines.values()) != [2, 2] \
            or any(len(set(v)) != 1 for v in lines.values()):
        bad.append("the two ranks of a data line synced different gradients")
    seen = {(op, e["world"]) for r in ranks for op, entries in r["wire"].items()
            for e in entries}
    want = {(op, CARDS) for op in DR.WIRE_OPS} | {(op, 2) for op in GRID_OPS}
    if seen != want:
        bad.append(f"the ranks' ops at each world {sorted(seen)}, expected {sorted(want)}")
    for r in ranks:
        print(f"cards_mesh: rank {r['rank']} on {r['device']} (PCI {r['card']['pci_bus_id']}, "
              f"UUID {r['card']['uuid']}): "
              + "; ".join(f"{op} " + ", ".join(f"{e['backend']} world {e['world']} on "
                                              f"{e['device']}" for e in entries)
                          for op, entries in sorted(r["wire"].items())), flush=True)
    out = {"phase": "cards_mesh", "ok": not bad, "gpu": gpu_line(), "gpus": gpu_lines(),
           "torch": torch.__version__, "ranks": CARDS, "backend": "nccl",
           "cards": [r["card"] for r in ranks], "devices": [r["device"] for r in ranks],
           "wire": {r["rank"]: r["wire"] for r in ranks}, **ranks_summary(ranks, spec),
           "ranks_s": ranks_s, "problems": bad, "seconds": time.perf_counter() - t_phase}
    emit(out)
    if bad:
        raise AssertionError(f"the cards_mesh phase failed: {bad}")


def phase_cards_pods(cfg):
    """``launch.train.run --kind-pods`` on the machine's cards at the
    runtime phase's settings (module docstring, ``pods``): every counter
    zeroed just before and read just after; each launch's card noted
    through ``build.launch``."""
    from repro_torch.launch import train as launch_train

    t_phase = time.perf_counter()
    layers = RUNTIME_LAYERS
    full_config = launch_train.get_config
    launch_train.get_config = lambda arch, smoke=False: full_config(
        arch, smoke=smoke).with_overrides(num_layers=layers)
    real_launch, on_cards = build.launch, Counter()

    def noting_launch(name, t, *args):
        on_cards[f"{name} on cuda:{t.get_device()}"] += 1
        return real_launch(name, t, *args)

    build.launch = noting_launch
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
            args = launch_train.build_parser().parse_args(
                ["--arch", ARCH, "--steps", str(RUNTIME_STEPS), "--batch", str(TRAIN_B),
                 "--seq", str(TRAIN_S), "--ckpt-dir", ckdir, "--kind-pods"])
            settle()
            zero_counts()
            t0 = time.perf_counter()
            res = launch_train.run(args)
            sync_error = settle()
            wall = time.perf_counter() - t0
            launches = read_counts()
            ckpt_step = store.latest_step(ckdir)
    finally:
        launch_train.get_config = full_config
        build.launch = real_launch
    dev = res["devices"]
    want = 2 * layers * RUNTIME_STEPS
    bad = [sync_error] if sync_error else []
    if not res["kind_pods"] or len(set(res["placement"].values())) != 2 \
            or res["placement"]["train"] != res["placement"]["postprocess"] \
            or res["placement"]["preprocess"] == res["placement"]["train"]:
        bad.append(f"pods {res['kind_pods']}, placement {res['placement']}")
    if dev["preprocess"] in (dev["train"], dev["postprocess"]) \
            or not all(d.startswith("cuda:") for d in dev.values()):
        bad.append(f"stages on {dev}: the data pod's card must differ from the DL pod's")
    if launches["flash_attention"] != want or any(
            c for n, c in launches.items() if n != "flash_attention"):
        bad.append(f"launches {launches}, expected flash {want} and nothing else")
    if dict(on_cards) != {f"flash_attention on {dev['train']}": want}:
        bad.append(f"launches by card {dict(on_cards)}, expected {want} on {dev['train']}")
    if not (res["improved"] and np.isfinite([res["first_loss"], res["last_loss"]]).all()
            and res["steps"] == RUNTIME_STEPS and ckpt_step == RUNTIME_STEPS):
        bad.append(f"the run did not learn or save: {res}, checkpoint step {ckpt_step}")
    emit({"phase": "cards_pods", "ok": not bad, "gpu": gpu_line(), "gpus": gpu_lines(),
          "entry": "repro_torch.launch.train.run --kind-pods", "arch": cfg.name,
          "layers": layers, "layers_published": cfg.num_layers, "batch": TRAIN_B,
          "seq": TRAIN_S, "steps": res["steps"], "kind_pods": res["kind_pods"],
          "placement": res["placement"], "devices": dev, "first_loss": res["first_loss"],
          "last_loss": res["last_loss"], "improved": res["improved"],
          "train_s": res["train_s"], "wall_s": wall, "overheads_s": res["overheads"],
          "checkpoint_step": ckpt_step, "launches": launches,
          "launches_by_card": dict(on_cards), "problems": bad,
          "seconds": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError(f"the cards_pods phase failed: {bad}")


def run_cards(check_only: bool) -> None:
    """The multi-card mode: ``nvidia-smi topo -m`` and the peer-access
    matrix, the build, then its parts in order (``check`` alone where
    ``check_only``)."""
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
    for ln in (topo.stdout + topo.stderr).splitlines():
        print(f"topo: {ln}", flush=True)
    if topo.returncode:
        print(f"topo: nvidia-smi topo -m exited {topo.returncode}", flush=True)
    n = torch.cuda.device_count()
    for i in range(n):  # which cards reach which by peer access (NVLink or PCIe)
        print(f"topo: card {i} peer access to " + " ".join(
            f"{j}:{int(torch.cuda.can_device_access_peer(i, j))}" for j in range(n) if j != i),
            flush=True)
    phase_build()
    cfg = get_config(ARCH)
    runs = {"check": phase_cards_check, "mesh": lambda: phase_cards_mesh(cfg),
            "gang": lambda: phase_gang(CARDS, CARDS_ROWS, phase="cards_gang"),
            "pods": lambda: phase_cards_pods(cfg)}
    failed = []
    for part, run in runs.items():  # a failed part fails the run after the others ran
        if check_only and part != "check":
            continue
        try:
            run()
        except Exception as e:  # noqa: BLE001 — re-raised below
            traceback.print_exc()
            failed.append(f"{part}: {type(e).__name__}: {str(e)[:1000]}")
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the multi-card mode failed: {failed}")


def profile_paper_step(step, steps: int):
    """``steps`` calls of ``step()`` (one SGD step each) under
    torch.profiler: wall and device busy ms per step, the device's idle
    share, device kernels and top-level aten ops per step."""
    from torch.profiler import ProfilerActivity, profile

    step()  # warm: cuBLAS handles, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        loss.item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, by_name = device_kernels(prof)
    busy_ms = sum(v[0] for v in by_name.values())
    cpu_ops = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::") and e.cpu_parent is None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "gpu_kernels_per_step": len(kernels) / steps,
            "device_us_per_kernel": 1e3 * busy_ms / max(len(kernels), 1),
            "top_level_aten_ops_per_step": cpu_ops / steps,
            "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                            for k, v in top]}


def phase_paper():
    """The paper's tables on the card (``launch.paper_tables`` at the JAX
    package's default sizes): Table 3, the 11 forecasting models trained
    bare-metal and as a RemoteAgent task (60 steps each); Tables 1-2, the
    hydrology LSTM (150 steps, 2000 days); Table 4, 11 pipelines of a
    cylon_stage sort and a dl_stage inference under one pilot against
    sequential.  Every task DONE, every metric finite, validation NNSE
    above 0.5 for NNSE_TARGETS, no port kernel launched (the models reach
    none).  Then Fig. 4 (``bench_scaling_ops``, not ``full``): sort and
    join over 1, 2, 4 and 8 logical shards of the card, strong and weak,
    every row kept, nothing dropped, only the hash kernel launched (the
    join's exchanges); its launches are returned.  Then a profile of
    PAPER_PROFILE_STEPS SGD steps of the GRU and of the LSTM at the
    benchmark's shapes."""
    from repro_torch.common import prng
    from repro_torch.launch import paper_tables as pt
    from repro_torch.models import forecasting as fm
    from repro_torch.models import hydrology as hm

    t_phase = time.perf_counter()
    zero_counts()
    t0 = time.perf_counter()
    fc = pt.bench_forecasting()
    fc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hy = pt.bench_hydrology()
    hy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = pt.bench_multi_pipeline()
    mp_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"the paper's models launched port kernels: {launches}")
    states = ([r["state"] for r in fc.values()] + [hy["state"]]
              + list(mp["task_states"].values()))
    if set(states) != {"done"} or mp["meta"]["n_failed"]:
        raise AssertionError(f"tasks not DONE: {states}")
    numbers = ([v for r in fc.values() for run in ("bm", "rc") for v in r[run].values()]
               + [v for m in hy["metrics"].values() for v in m.values()]
               + [hy["bm_train_s"], hy["rc_total_s"], mp["bm_s"], mp["rc_s"]])
    if not np.isfinite(numbers).all():
        raise AssertionError("a paper metric is not finite")
    low = {t: hy["metrics"][t]["val_nnse"] for t in NNSE_TARGETS
           if not hy["metrics"][t]["val_nnse"] > 0.5}
    if low:
        raise AssertionError(f"validation NNSE not above 0.5: {low}")
    zero_counts()
    t0 = time.perf_counter()
    fig4 = pt.bench_scaling_ops()
    torch.cuda.synchronize()
    fig4_s = time.perf_counter() - t0
    fig4_launches = read_counts()
    hash_name = "hash_partition_histogram"
    bad = [(mode, w, op) for mode in ("strong", "weak") for w, ops in fig4[mode].items()
           for op, r in ops.items()
           if r["dropped"] or (op == "sort" and r["rows_out"] != r["rows"])]
    if bad or fig4_launches[hash_name] <= 0 or any(
            c for n, c in fig4_launches.items() if n != hash_name):
        raise AssertionError(f"Fig. 4: rows lost or dropped at {bad}; launches {fig4_launches}")

    # the seeded draws on the card are JAX's: the ETT series against a
    # numpy reference built from threefry_np's bits
    ett = check_ett_series(fm)
    # where a step's time goes: the eager GRU (96 time steps) and LSTM (64)
    init, apply = fm.MODELS["GRU"](96, 24)
    gru = pt._trainable(init(prng.PRNGKey(SEED), "cuda"))
    series = fm.make_ett_series(4096, device="cuda")
    starts = prng.randint(prng.PRNGKey(SEED + 1), 128, 0, 3 * 4096 // 4 - 120).cuda().long()
    feats, targets = hm.make_camels_like(2000, device="cuda")
    x_all, y_all = hm.window_dataset(feats, targets, 64)
    lstm = pt._trainable(hm.lstm_init(prng.PRNGKey(SEED), device="cuda"))
    idx = prng.randint(prng.PRNGKey(SEED + 2), 64, 0, x_all.shape[0]).cuda().long()
    profiles = {
        "GRU": profile_paper_step(lambda: pt.forecaster_step(
            apply, gru, series, starts, 96, 24, 1e-3), PAPER_PROFILE_STEPS),
        "LSTM": profile_paper_step(lambda: pt.hydrology_step(lstm, x_all, y_all, idx),
                                   PAPER_PROFILE_STEPS)}
    emit({"phase": "paper_table3", "ok": True, "gpu": gpu_line(), "seconds": fc_s,
          "models": {name: {"steps": r["steps"], "bm_train_s": r["bm"]["train_s"],
                            "rc_total_s": r["rc_total_s"], "overhead_s": r["overhead_s"],
                            "task_overheads_s": r["task_overheads"], "state": r["state"],
                            **{k: r["bm"][k] for k in ("MAE", "MSE", "MAPE", "loss")}}
                     for name, r in fc.items()}})
    emit({"phase": "paper_tables12", "ok": True, "gpu": gpu_line(), "seconds": hy_s,
          **{k: hy[k] for k in ("steps", "days", "bm_train_s", "rc_train_s", "rc_total_s",
                                "overhead_s", "task_overheads", "state", "metrics")}})
    emit({"phase": "paper_table4", "ok": True, "gpu": gpu_line(), "seconds": mp_s,
          **{k: mp[k] for k in ("n_pipelines", "bm_s", "rc_s", "saved_s", "meta")}})
    emit({"phase": "paper_fig4", "ok": True, "gpu": gpu_line(), "seconds": fig4_s,
          "scales": fig4["meta"]["scales"], "base_rows": fig4["meta"]["base_rows"],
          "launches": fig4_launches,
          "rows": [{"mode": mode, "shards": w, "op": op, "rows": r["rows"],
                    "rows_out": r["rows_out"], "dropped": r["dropped"], "ms": r["s"] * 1e3}
                   for mode in ("strong", "weak") for w, ops in fig4[mode].items()
                   for op, r in ops.items()]})
    emit({"phase": "paper_profile", "ok": True, "gpu": gpu_line(), "launches": launches,
          "ett_series": ett, "profiles": profiles,
          "seconds": time.perf_counter() - t_phase})
    return fig4_launches[hash_name]


def check_ett_series(fm, n=4096, seeds=(0, 3)):
    """``make_ett_series`` on the card against numpy: the noise's bits
    exactly against threefry_np (key [0, seed], counters 0 .. n-1), the
    standardized series within ETT_TOL of a reference that draws the
    normals from those bits in float64 (scipy's erfinv) and computes the
    seasonal terms in float32 as both packages do."""
    from scipy.special import erfinv

    from repro_torch.common import prng

    out = {}
    for seed in seeds:
        key = np.array([0, seed & 0xFFFFFFFF], np.uint32)
        with np.errstate(over="ignore"):
            w1, w2 = threefry_np(key[0], key[1], np.zeros(n, np.uint32),
                                 np.arange(n, dtype=np.uint32))
        bits = w1 ^ w2
        got_bits = prng.random_bits(prng.PRNGKey(seed), n, device="cuda").cpu().numpy()
        floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - 1.0
        lo = np.float64(np.nextafter(np.float32(-1), np.float32(0)))
        noise = np.sqrt(2.0) * erfinv(np.maximum(lo, floats.astype(np.float64) * 2.0 + lo))
        t = np.arange(n, dtype=np.float32)
        series = (np.sin(2 * np.pi * t / 24.0) + 0.5 * np.sin(2 * np.pi * t / (24.0 * 7))
                  + 0.3 * np.sin(2 * np.pi * t / 96.0 + 1.0) + 0.0005 * t).astype(np.float64)
        series = series + 0.2 * noise
        want = (series - series.mean()) / series.std()
        got = fm.make_ett_series(n, seed=seed, device="cuda").cpu().numpy()
        err = float(np.abs(got - want).max())
        out[seed] = {"bits_equal": bool(np.array_equal(got_bits, bits)), "max_abs_err": err,
                     "tol": ETT_TOL}
        if not (out[seed]["bits_equal"] and err <= ETT_TOL):
            raise AssertionError(f"make_ett_series on the card is not JAX's: {out[seed]}")
    return out


def rms_cases(gen, n):
    """n (x, w) pairs at the training activations' shape, bf16."""
    return [(randn(gen, RMS_SHAPE, torch.bfloat16),
             randn(gen, RMS_SHAPE[-1:], torch.bfloat16)) for _ in range(n)]


def phase_rmsnorm(cfg):
    """The fused norm's only entry point, ``ops.rmsnorm``, once per layer on
    bf16 training activations, counters zeroed just before and read just
    after."""
    cases = rms_cases(torch.Generator(device="cuda").manual_seed(SEED + 4),
                      cfg.num_layers)
    torch.cuda.synchronize()
    zero_counts()
    outs = [ops.rmsnorm(x, w) for x, w in cases]
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["rmsnorm"] != cfg.num_layers or any(
            c for n, c in launches.items() if n not in PATH_KERNELS["rmsnorm"]):
        raise AssertionError(f"ops.rmsnorm launches {launches}, expected "
                             f"{cfg.num_layers} of rmsnorm alone")
    if not all(o.shape == x.shape and o.dtype == x.dtype and bool(o.isfinite().all())
               for o, (x, _) in zip(outs, cases)):
        raise AssertionError("ops.rmsnorm output of the wrong shape or not finite")
    emit({"phase": "rmsnorm", "ok": True, "calls": len(cases), "shape": list(RMS_SHAPE),
          "dtype": "torch.bfloat16", "launches": launches})
    return launches["rmsnorm"]


def rmsnorm_row(launches, device_us, lib_us):
    """Kernel 6 at the training activations' shape, rotating over four
    input sets (134 MB with the outputs, past the 50 MB L2); ``lib_us``:
    F.rms_norm's device us per call (profile_new_kernels)."""
    cases = rms_cases(torch.Generator(device="cuda").manual_seed(SEED + 5), 4)
    err = max((rms.rmsnorm_kernel(x, w).float() - rms.rmsnorm_plain(x, w).float())
              .abs().max().item() for x, w in cases[:2])
    nxt = rotate(cases)
    ms = cuda_ms(lambda: rms.rmsnorm_kernel(*nxt()))
    plain_ms = cuda_ms(lambda: rms.rmsnorm_plain(*nxt()))
    d = RMS_SHAPE[-1]

    def library():
        x, w = nxt()
        return F.rms_norm(x, (d,), w, eps=1e-5)

    lib_ms = cuda_ms(library)
    rows, esz = RMS_SHAPE[0], 2
    row = kernel_row("rmsnorm", "src/repro/kernels/rmsnorm.py:24", launches, err, ms,
                     plain_ms, 2 * rows * d * esz + d * esz, 4 * rows * d, lib_ms,
                     "torch.nn.functional.rms_norm (weight w, eps 1e-5), timed "
                     "only: the port never calls it",
                     {"x": list(RMS_SHAPE), "dtype": "torch.bfloat16", "w": [d]},
                     flops_per_s=FP32_FLOPS_PER_S, lib_us=lib_us)
    row["device_us_per_launch"] = device_us
    return row


def hash_row(launches, device_us):
    """Kernel 7 at the dataframe path's launch: [8, 2^23] int32 keys in
    [0, 2^20), 8 buckets, blocks of 2048 (two key sets of 268 MB)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cases = [torch.randint(0, DF_KEYS, (DF_SHARDS, DF_ROWS // DF_SHARDS), generator=gen,
                           device="cuda", dtype=torch.int32) for _ in range(2)]
    hist = [hp.hash_partition_histogram_kernel(k, num_buckets=DF_SHARDS) for k in cases]
    if not all(torch.equal(h, hp.hash_partition_histogram_plain(k, num_buckets=DF_SHARDS))
               for h, k in zip(hist, cases)):
        raise AssertionError("hash kernel disagrees with its plain version at the path's shape")
    nxt = rotate(cases)
    ms = cuda_ms(lambda: hp.hash_partition_histogram_kernel(nxt(), num_buckets=DF_SHARDS))
    plain_ms = cuda_ms(lambda: hp.hash_partition_histogram_plain(nxt(), num_buckets=DF_SHARDS),
                       iters=10)
    row = kernel_row("hash_partition_histogram", "src/repro/kernels/hash_partition.py:42",
                     launches, 0.0, ms, plain_ms, 4 * DF_ROWS + 4 * hist[0].numel(), 0,
                     None, "no single PyTorch call computes per-block histograms of "
                     "this hash (the plain version is a hash, a pad and a scatter_add_)",
                     {"keys": [DF_SHARDS, DF_ROWS // DF_SHARDS], "dtype": "torch.int32",
                      "buckets": DF_SHARDS, "block": 2048,
                      "ops_bound": "integer ops (~6 per key) not counted: bytes bound it"},
                     source="hash_partition")
    row["device_us_per_launch"] = device_us
    return row


def step_profile(fn, tries: int = 3):
    """One call of ``fn`` under torch.profiler, tracing the device alone
    (a host trace of a step's ~10^5 ops takes minutes to process),
    synchronized: wall ms, device busy ms and idle share, kernels, the top
    kernels.  A window without device events is opened again, up to
    ``tries`` times; then None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels, by_name = device_kernels(prof)
        if by_name:
            busy = sum(v[0] for v in by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
            return {"wall_ms": wall_ms, "device_busy_ms": busy,
                    "device_idle_share": 1.0 - busy / wall_ms, "gpu_kernels": len(kernels),
                    "top_kernels": [{"name": k[:80], "ms": v[0], "launches": v[1]}
                                    for k, v in top]}
    return None


def no_launches(what):
    launched = {n: c for n, c in read_counts().items() if c}
    if launched:
        raise AssertionError(f"{what} launched port kernels: {launched}")


def counted_run(fn):
    """``fn()`` with every launch counter zeroed just before and read just
    after (synchronized): (its result, the counts)."""
    torch.cuda.synchronize()
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def only(launches, want, what):
    """Raise unless ``launches`` are exactly ``want`` ({name: count}) and
    zero for every other kernel."""
    full = {n: want.get(n, 0) for n in COUNTED}
    if launches != full:
        raise AssertionError(f"{what} launched {launches}, expected {full}")


def rel_of_max(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def first_divergence(a, b, logits):
    """Where two [B, T] streams first differ, with the plain path's top-2
    logit gap there (``logits``: the plain path's [B, V] per step)."""
    row, step = next((r, j) for j in range(a.shape[1]) for r in range(a.shape[0])
                     if a[r, j] != b[r, j])
    top = torch.topk(logits[step][row].float(), 2).values
    return {"row": row, "step": step, "tokens": [int(a[row, step]), int(b[row, step])],
            "plain_top2_logit_gap": float(top[0] - top[1])}


def train_metrics(state, step_fn, batches):
    """Run ``batches`` through ``step_fn``: per-step losses, grad-norms, ms."""
    losses, norms, step_ms = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(m["loss"].item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(m["grad_norm"].item())
    return state, losses, norms, step_ms


def max_rel(a, b):
    """The largest relative difference of each TRAIN_TOL metric over the
    steps of two runs (``a``, ``b``: lists of {metric: value})."""
    return {k: max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b)) for k in TRAIN_TOL}


def recurrent_xlstm():
    """xlstm-125m at its published widths through the training driver's
    default arch (no --arch), XLSTM_STEPS steps of XLSTM_B x XLSTM_S: the
    loss falls (postprocess ``improved``) and no port kernel launches
    (JAX's xlstm path runs no Pallas kernel); then
    XLSTM_PARITY_STEPS fp32 steps at XLSTM_PARITY_B x XLSTM_PARITY_S from
    one state on the card and on the host CPU, loss and grad-norm within
    TRAIN_TOL (relative)."""
    from repro_torch.launch import train as launch_train

    t_phase = time.perf_counter()
    cfg = get_config(XLSTM)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
        args = launch_train.build_parser().parse_args(
            ["--device", "cuda", "--steps", str(XLSTM_STEPS), "--batch", str(XLSTM_B),
             "--seq", str(XLSTM_S), "--ckpt-dir", ckdir])
        if args.arch != XLSTM:
            raise AssertionError(f"the driver's default arch is {args.arch}")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = launch_train.run(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        no_launches("the xlstm training driver")
    if not (res["improved"] and res["steps"] == XLSTM_STEPS
            and np.isfinite([res["first_loss"], res["last_loss"]]).all()):
        raise AssertionError(f"the xlstm training driver did not learn: {res}")
    torch.cuda.empty_cache()

    run_cfg = RunConfig()

    # fp32 (TF32 off, set in main) on the card and on the host, one state
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    host = init_train_state(torch.Generator().manual_seed(SEED), cfg32, run_cfg, device="cpu")
    card = map_tree(lambda t: t.to("cuda"), host)
    pb = XLSTM_PARITY_B
    rows = torch.from_numpy(make_corpus(
        cfg.vocab_size, pb * XLSTM_PARITY_S * XLSTM_PARITY_STEPS, SEED + 1)).reshape(
            -1, XLSTM_PARITY_S)
    batches = [{"tokens": rows[i * pb:(i + 1) * pb],
                "labels": torch.roll(rows[i * pb:(i + 1) * pb], -1, dims=1)}
               for i in range(XLSTM_PARITY_STEPS)]
    metrics, parity_s = {}, {}
    zero_counts()
    for dev, st in (("cuda", card), ("cpu", host)):
        fn = make_train_step(cfg32, run_cfg)
        metrics[dev] = []
        t0 = time.perf_counter()
        for b in batches:
            st, m = fn(st, {k: v.to(dev) for k, v in b.items()})
            metrics[dev].append({k: v.item() for k, v in m.items()})
        parity_s[dev] = time.perf_counter() - t0
    no_launches("xlstm's fp32 steps")
    rel = max_rel(metrics["cuda"], metrics["cpu"])
    del card, host
    torch.cuda.empty_cache()
    out = {"phase": "recurrent", "part": "xlstm_train", "ok": True, "arch": XLSTM,
           "entry": "repro_torch.launch.train.run (no --arch)", "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": XLSTM_B, "seq": XLSTM_S, "steps": res["steps"],
           "first_loss": res["first_loss"], "last_loss": res["last_loss"],
           "improved": res["improved"], "train_s": res["train_s"], "wall_s": wall_s,
           "step_s": res["train_s"] / res["steps"],
           "tokens_per_s": XLSTM_B * XLSTM_S * res["steps"] / res["train_s"],
           "launches": "none (asserted)",
           "parity": {"compute_dtype": "torch.float32", "tf32": False, "batch": pb,
                      "seq": XLSTM_PARITY_S, "card": metrics["cuda"], "host": metrics["cpu"],
                      "max_rel_diff": rel, "tol_rel": TRAIN_TOL, "seconds": parity_s},
           "seconds": time.perf_counter() - t_phase}
    out["ok"] = all(rel[k] <= TRAIN_TOL[k] for k in TRAIN_TOL)
    emit(out)
    if not out["ok"]:
        raise AssertionError("xlstm's fp32 steps on the card and the host disagree")


def gemma_params(param_dtype, layers=None):
    """recurrentgemma-9b at its published widths (and ``layers`` of its
    layers, all by default), random weights from a seeded torch.Generator
    stored in ``param_dtype``."""
    cfg = get_config(GEMMA).with_overrides(param_dtype=param_dtype)
    if layers:
        cfg = cfg.with_overrides(num_layers=layers)
    specs = map_tree(lambda p: Param(p.shape, p.axes, param_dtype, p.init, p.scale),
                     model_specs(cfg))
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), specs, "cuda")
    return cfg, params, sum(t.numel() for t in tree_leaves(params))


def local_layers(cfg) -> int:
    from repro_torch.configs import block_pattern

    head, unit, reps, tail = block_pattern(cfg)
    return (sum(tk == "local" for tk, _ in head + tail)
            + reps * sum(tk == "local" for tk, _ in unit))


def zero_cache(cfg, B, max_len):
    from repro_torch.models.lm import lm_cache_specs

    return map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                    lm_cache_specs(cfg, B, max_len))


def recurrent_gemma_fp32():
    """recurrentgemma-9b with fp32 parameters and compute (TF32 off): the
    no-cache prefill step's last logits at S GEMMA_PREFILL_S against the
    decode replay's at the same position, within GEMMA_PREFILL_TOL of
    their max abs (JAX's chunked == step-by-step invariant); then
    GEMMA_GEN greedy tokens, the kernel path's stream equal to the plain
    path's (``decode_impl="ref"``), a divergence reported with the plain
    path's top-2 gap.  Returns kernel 2's launches."""
    from repro_torch.train.step import make_decode_step, make_prefill_step

    t_phase = time.perf_counter()
    cfg, params, n_params = gemma_params(torch.float32)
    cfg = cfg.with_overrides(compute_dtype=torch.float32)
    rng = np.random.default_rng(SEED + 21)
    P, B = GEMMA_PREFILL_S, GEMMA_B
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)).cuda()
    zero_counts()
    t0 = time.perf_counter()
    last = make_prefill_step(cfg)(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    no_launches("recurrentgemma's no-cache prefill")
    runs = {}
    for impl in ("auto", "ref"):
        c = cfg.with_overrides(decode_impl=impl)
        cache, dec = zero_cache(c, B, P + GEMMA_GEN), make_decode_step(c)
        tok, stream, logits = prompt[:, :1], [], []
        zero_counts()
        t0 = time.perf_counter()
        for i in range(P + GEMMA_GEN - 1):
            nxt, lg, cache = dec(params, tok, cache, i)
            if i >= P - 1:  # the replay's logits at the prompt's last position, then on
                stream.append(nxt)
                logits.append(lg[:, 0])
            tok = prompt[:, i + 1:i + 2] if i + 1 < P else nxt[:, None]
        torch.cuda.synchronize()
        runs[impl] = {"stream": torch.stack(stream, 1).cpu(), "logits": logits,
                      "launches": read_counts(), "steps": P + GEMMA_GEN - 1,
                      "wall_s": time.perf_counter() - t0}
        del cache
    steps = runs["auto"]["steps"]
    want = {n: (local_layers(cfg) * steps if n == "decode_attention" else 0) for n in COUNTED}
    if runs["auto"]["launches"] != want or any(runs["ref"]["launches"].values()):
        raise AssertionError(f"launches: kernel path {runs['auto']['launches']}, "
                             f"expected {want}; plain path {runs['ref']['launches']}")
    scale = last.abs().max().item()
    prefill_err = {impl: (r["logits"][0] - last).abs().max().item() / scale
                   for impl, r in runs.items()}
    a, b = runs["auto"]["stream"], runs["ref"]["stream"]
    out = {"phase": "recurrent", "part": "recurrentgemma_fp32", "arch": GEMMA,
           "params": n_params, "param_gb": n_params * 4 / 1e9, "layers": cfg.num_layers,
           "local_layers": local_layers(cfg), "batch": B, "prefill_s": prefill_s,
           "prefill_seq": P, "prefill_vs_replay_rel_err": prefill_err,
           "tol_rel_of_max_abs": GEMMA_PREFILL_TOL, "generated": GEMMA_GEN,
           "streams_identical": bool(torch.equal(a, b)),
           "kernel_path": {"launches": runs["auto"]["launches"], "wall_s": runs["auto"]["wall_s"]},
           "plain_path": {"wall_s": runs["ref"]["wall_s"]},
           "seconds": time.perf_counter() - t_phase}
    out["ok"] = out["streams_identical"] and max(prefill_err.values()) <= GEMMA_PREFILL_TOL
    if not out["streams_identical"]:
        out["first_divergence"] = first_divergence(a, b, runs["ref"]["logits"])
    emit(out)
    del params, runs, last
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError("recurrentgemma's fp32 paths disagree")
    return want["decode_attention"]


def recurrent_gemma_ring():
    """recurrentgemma-9b with bf16 parameters at GEMMA_RING_LAYERS layers,
    GEMMA_RING_B rows decoded token by token (greedy, scalar lengths on the card) through
    GEMMA_RING_STEPS positions, past its local layers' 2048-slot ring:
    kernel 2 exactly once per local layer a step and no other kernel,
    every logit finite; at the last step one decode on a clone of the
    cache through the plain path gives the same next tokens (a differing
    row passes only as a near-tie: the plain top-2 gap within twice the
    row's largest logit difference, recorded).  Tokens/s, step p50 (the
    device timeline between steps) and seconds.  Returns kernel 2's
    launches."""
    from repro_torch.train.step import make_decode_step

    t_phase = time.perf_counter()
    cfg, params, n_params = gemma_params(torch.bfloat16, GEMMA_RING_LAYERS)
    B, steps = GEMMA_RING_B, GEMMA_RING_STEPS
    cache = zero_cache(cfg, B, steps)
    slots = {t.shape[2] for key, t in cache["unit"]["b2"].items()}
    if slots != {cfg.window} or steps <= cfg.window:
        raise AssertionError(f"ring slots {slots}, window {cfg.window}, steps {steps}")
    dec = make_decode_step(cfg)
    lens = torch.arange(steps, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(SEED + 23)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)).cuda()
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        if i == steps - 1:
            snapshot, last_in = map_tree(lambda t: t.clone(), cache), tok
        nxt, lg, cache = dec(params, tok, cache, lens[i])
        finite &= torch.isfinite(lg).all()
        events[i + 1].record()
        tok = nxt[:, None]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    want = {n: (local_layers(cfg) * steps if n == "decode_attention" else 0) for n in COUNTED}
    if launches != want:
        raise AssertionError(f"ring decode launches {launches}, expected {want}")
    rn, rl, _ = make_decode_step(cfg.with_overrides(decode_impl="ref"))(
        params, last_in, snapshot, lens[-1])
    no_launches_after = {n: c - want[n] for n, c in read_counts().items()}
    if any(no_launches_after.values()):
        raise AssertionError(f"the plain decode launched kernels: {no_launches_after}")
    # two more decode steps under the profiler, on a clone of the cache
    probe = map_tree(lambda t: t.clone(), cache)
    prof = step_profile(lambda: [dec(params, tok, probe, lens[-1]) for _ in range(2)])
    if prof:
        prof["gpu_kernels_per_step"] = prof["gpu_kernels"] / 2
    rows = []
    for r in range(B):
        if int(rn[r]) == int(nxt[r]):
            continue
        plain = rl[r, 0].float()
        gap = float(plain[int(rn[r])] - plain[int(nxt[r])])
        diff = float((lg[r, 0].float() - plain).abs().max())
        rows.append({"row": r, "tokens": [int(nxt[r]), int(rn[r])],
                     "plain_gap_to_kernel_token": gap, "max_abs_logit_diff": diff,
                     "near_tie": gap <= 2 * diff})
    out = {"phase": "recurrent", "part": "recurrentgemma_ring_bf16", "arch": GEMMA,
           "layers": cfg.num_layers, "params": n_params, "param_gb": n_params * 2 / 1e9, "param_dtype": "torch.bfloat16",
           "compute_dtype": str(cfg.compute_dtype), "batch": B, "positions": steps,
           "ring_slots": cfg.window, "wraps": steps // cfg.window,
           "launches": launches, "kernel2_per_step": launches["decode_attention"] / steps,
           "all_logits_finite": bool(finite.item()),
           "last_step_plain_equal": not rows, "last_step_differing_rows": rows,
           "tokens_per_s": B * steps / wall_s, "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p95": float(np.percentile(step_ms, 95)), "wall_s": wall_s,
           "profiled_2_steps": prof, "seconds": time.perf_counter() - t_phase}
    out["ok"] = out["all_logits_finite"] and all(r["near_tie"] for r in rows)
    emit(out)
    del params, cache, snapshot, probe
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError("recurrentgemma's ring decode failed its checks")
    return launches["decode_attention"]


class CheckpointStandIn:
    """The training driver's ``AsyncCheckpointer`` for a run whose state is
    too large to write inside the time limit (GEMMA_CKPT_NOTE): records
    the steps it is asked to save, writes nothing."""

    saved: list = []

    def __init__(self, directory, keep=3):
        CheckpointStandIn.saved = []

    def save(self, step, state):
        CheckpointStandIn.saved.append(step)

    def close(self):
        pass


def recurrent_gemma_remat():
    """recurrentgemma-9b trained under its published remat policy (module
    docstring, phase 13): the driver's bf16 run, then fp32 steps under
    each remat mode."""
    from repro_torch.launch import train as launch_train

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    cut = lambda arch, smoke=False: get_config(arch, smoke=smoke).with_overrides(  # noqa: E731
        num_layers=GEMMA_TRAIN_LAYERS)
    cfg = cut(GEMMA)
    if cfg.remat_policy != "save_block_outputs" or cfg.param_dtype != torch.float32:
        raise AssertionError(f"recurrentgemma's policy {cfg.remat_policy}, "
                             f"parameters {cfg.param_dtype}")
    full_config, checkpointer = launch_train.get_config, launch_train.store.AsyncCheckpointer
    launch_train.get_config, launch_train.store.AsyncCheckpointer = cut, CheckpointStandIn
    try:
        args = launch_train.build_parser().parse_args(
            ["--arch", GEMMA, "--device", "cuda", "--steps", str(GEMMA_TRAIN_STEPS),
             "--batch", str(GEMMA_TRAIN_B), "--seq", str(GEMMA_TRAIN_S),
             "--ckpt-dir", str(ROOT / "build" / "gemma_ckpt")])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = launch_train.run(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        no_launches("recurrentgemma's training driver")
        driver_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        launch_train.get_config, launch_train.store.AsyncCheckpointer = full_config, checkpointer
    torch.cuda.empty_cache()
    if not (res["improved"] and res["steps"] == GEMMA_TRAIN_STEPS
            and CheckpointStandIn.saved == [GEMMA_TRAIN_STEPS]
            and np.isfinite([res["first_loss"], res["last_loss"]]).all()):
        raise AssertionError(f"recurrentgemma's training driver did not learn: {res}")

    # fp32 (TF32 off) from one seeded state under each remat mode, with
    # Adafactor (GEMMA_PARITY_OPTIMIZER)
    cfg32 = cfg.with_overrides(compute_dtype=torch.float32)
    run_cfg = RunConfig(optimizer=GEMMA_PARITY_OPTIMIZER)
    rows = torch.from_numpy(make_corpus(
        cfg.vocab_size, GEMMA_PARITY_B * GEMMA_TRAIN_S * GEMMA_PARITY_STEPS, SEED + 1)).reshape(
            -1, GEMMA_TRAIN_S).cuda()
    pb = GEMMA_PARITY_B
    batches = [{"tokens": rows[i * pb:(i + 1) * pb],
                "labels": torch.roll(rows[i * pb:(i + 1) * pb], -1, dims=1)}
               for i in range(GEMMA_PARITY_STEPS)]
    modes = {"none": (cfg32, RunConfig(optimizer=GEMMA_PARITY_OPTIMIZER, remat="none")),
             "full": (cfg32.with_overrides(remat_policy="full"), run_cfg),
             "save_block_outputs": (cfg32, run_cfg)}
    metrics, step_ms, peak_gb, grad_peak_gb = {}, {}, {}, {}
    zero_counts()
    for mode, (c, rc) in modes.items():
        state = init_train_state(torch.Generator(device="cuda").manual_seed(SEED), c, rc)
        fn = make_train_step(c, rc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, losses, norms, ms = train_metrics(state, fn, batches)
        peak_gb[mode] = torch.cuda.max_memory_allocated() / 1e9
        metrics[mode] = [{"loss": a, "grad_norm": b} for a, b in zip(losses, norms)]
        step_ms[mode] = ms
        # the forward and backward alone: what each mode holds above the
        # state (the step's peak is AdamW's, the same in every mode)
        leaves = [t.detach().requires_grad_() for t in tree_leaves(state["params"])]
        it = iter(leaves)
        torch.cuda.synchronize()
        resting = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = make_loss_fn(c, rc)(map_tree(lambda _: next(it), state["params"]), batches[0])
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        grad_peak_gb[mode] = (torch.cuda.max_memory_allocated() - resting) / 1e9
        del state, leaves, loss
        torch.cuda.empty_cache()
    no_launches("recurrentgemma's fp32 steps")
    rel = {m: max_rel(metrics[m], metrics["none"]) for m in ("full", "save_block_outputs")}
    out = {"phase": "recurrent", "part": "gemma_remat", "arch": GEMMA,
           "remat_policy": cfg.remat_policy, "layers": GEMMA_TRAIN_LAYERS,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(math.prod(p.shape) for p in tree_leaves(model_specs(cfg))),
           "entry": "repro_torch.launch.train.run (get_config cut to 3 layers)",
           "checkpoint": {"stand_in": True, "saved_steps": CheckpointStandIn.saved,
                          "why": GEMMA_CKPT_NOTE},
           "batch": GEMMA_TRAIN_B, "seq": GEMMA_TRAIN_S, "steps": res["steps"],
           "first_loss": res["first_loss"], "last_loss": res["last_loss"],
           "improved": res["improved"], "train_s": res["train_s"], "wall_s": wall_s,
           "step_s": res["train_s"] / res["steps"], "peak_memory_gb": driver_peak_gb,
           "launches": "none (asserted)",
           "resident_gb_before": resident_gb,
           "modes": {"compute_dtype": "torch.float32", "tf32": False, "batch": pb,
                     "optimizer": GEMMA_PARITY_OPTIMIZER,
                     "seq": GEMMA_TRAIN_S, "metrics": metrics, "step_ms": step_ms,
                     "peak_memory_gb": peak_gb,
                     "forward_backward_gb_above_state": grad_peak_gb,
                     "max_rel_diff_vs_none": rel,
                     "tol_rel": TRAIN_TOL},
           "seconds": time.perf_counter() - t_phase}
    out["ok"] = all(rel[m][k] <= TRAIN_TOL[k] for m in rel for k in TRAIN_TOL)
    emit(out)
    if not out["ok"]:
        raise AssertionError("recurrentgemma's remat modes disagree")


def phase_recurrent():
    """The recurrent families at their published widths: xlstm-125m
    through the training driver's default arch, then recurrentgemma-9b in
    fp32 (prefill == replay, kernel == plain streams), in bf16 through
    its ring, and trained under its remat policy.  Returns kernel 2's
    launches of the phase."""
    recurrent_xlstm()
    launches = recurrent_gemma_fp32() + recurrent_gemma_ring()
    recurrent_gemma_remat()
    return launches


def whisper_batches(cfg, B, steps, seed):
    """``steps`` batches of B rows: frames [B, WHISPER_FRAMES, d] seeded
    normal on the card (the stubbed conv front end's output), decoder
    tokens of the corpus (frames // dec_len_ratio a row) and the labels
    they give rolled by -1, as JAX's ``_batch`` in tests/test_models_smoke.py
    shapes them."""
    T = WHISPER_FRAMES // cfg.dec_len_ratio
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.from_numpy(make_corpus(cfg.vocab_size, B * T * steps, seed).reshape(
        steps, B, T)).cuda()
    return [{"frames": torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=gen,
                                   device="cuda"),
             "tokens": rows[i], "labels": torch.roll(rows[i], -1, dims=1)}
            for i in range(steps)]


def encdec_train():
    """whisper-medium trains at its published widths: fp32 parameters, bf16
    compute, AdamW, remat, WHISPER_STEPS steps of WHISPER_B x
    WHISPER_FRAMES frames and their decoder tokens; the loss falls and
    flash launches exactly 2 x (24 + 24) times a step (the encoder's full
    and the decoder's causal self-attention, again in each recompute),
    no other kernel; one more step profiled.  Then WHISPER_PARITY_STEPS
    fp32 steps (TF32 off) at
    WHISPER_PARITY_B on the kernel path and the plain path from one
    initial state: loss and grad-norm within TRAIN_TOL.  Returns the
    flash launches of the main run."""
    t_phase = time.perf_counter()
    cfg, run_cfg = get_config(WHISPER), RunConfig()
    per_step = 2 * (cfg.num_layers + cfg.num_decoder_layers)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(SEED), cfg, run_cfg)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    batches = whisper_batches(cfg, WHISPER_B, WHISPER_STEPS, SEED + 30)
    torch.cuda.reset_peak_memory_stats()
    step_fn = make_train_step(cfg, run_cfg)
    (state, losses, norms, step_ms), launches = counted_run(
        lambda: train_metrics(state, step_fn, batches))
    only(launches, {"flash_attention": per_step * WHISPER_STEPS}, "whisper's train steps")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = step_profile(lambda: step_fn(state, batches[0]))
    del state, batches
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"non-finite loss or grad-norm: {losses} {norms}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))

    runs = {}
    batches = whisper_batches(cfg, WHISPER_PARITY_B, WHISPER_PARITY_STEPS, SEED + 31)
    for impl in ("auto", "ref"):
        c = cfg.with_overrides(compute_dtype=torch.float32, decode_impl=impl)
        st = init_train_state(torch.Generator(device="cuda").manual_seed(SEED), c, run_cfg)
        (_, l, n, _), runs[impl] = counted_run(
            lambda: train_metrics(st, make_train_step(c, run_cfg), batches))
        runs[impl] = {"metrics": [{"loss": a, "grad_norm": b} for a, b in zip(l, n)],
                      "launches": runs[impl]}
        del st
        torch.cuda.empty_cache()
    only(runs["auto"]["launches"], {"flash_attention": per_step * WHISPER_PARITY_STEPS},
         "whisper's fp32 kernel path")
    only(runs["ref"]["launches"], {}, "whisper's fp32 plain path")
    rel = max_rel(runs["auto"]["metrics"], runs["ref"]["metrics"])
    steady = step_ms[1:]
    out = {"phase": "encdec", "part": "whisper_train", "arch": WHISPER, "params": n_params,
           "param_gb": n_params * 4 / 1e9, "encoder_layers": cfg.num_layers,
           "decoder_layers": cfg.num_decoder_layers, "d_model": cfg.d_model,
           "compute_dtype": str(cfg.compute_dtype), "batch": WHISPER_B,
           "frames": WHISPER_FRAMES, "decoder_tokens": WHISPER_FRAMES // cfg.dec_len_ratio,
           "steps": WHISPER_STEPS, "losses": losses, "grad_norms": norms,
           "first5_mean_loss": first, "last5_mean_loss": last,
           "first_step_ms": step_ms[0], "step_ms_p50": float(np.percentile(steady, 50)),
           "step_ms_p95": float(np.percentile(steady, 95)),
           "frames_per_s": WHISPER_B * WHISPER_FRAMES * len(steady) / (sum(steady) / 1e3),
           "peak_memory_gb": peak_gb, "launches": launches,
           "flash_launches_per_step": launches["flash_attention"] / WHISPER_STEPS,
           "profiled_step": prof,
           "parity": {"compute_dtype": "torch.float32", "tf32": False,
                      "batch": WHISPER_PARITY_B, "kernel_path": runs["auto"],
                      "plain_path": runs["ref"], "max_rel_diff": rel, "tol_rel": TRAIN_TOL},
           "seconds": time.perf_counter() - t_phase}
    out["ok"] = last < first and all(rel[k] <= TRAIN_TOL[k] for k in TRAIN_TOL)
    emit(out)
    if not out["ok"]:
        raise AssertionError("whisper's loss did not fall or its fp32 paths disagree")
    return launches["flash_attention"]


def whisper_decode(cfg, params, frames, lens, profile=False):
    """Encode ``frames`` (no remat), fill a WHISPER_MAX_LEN self cache's
    cross K/V, then WHISPER_GEN greedy decode steps from the start token
    at the scalar lengths ``lens`` (0-d device tensors): (stream [B, T] on
    the host, each step's logits [B, V], the encode's launches, the
    decode's launches, per-step device ms, decode wall s, and with
    ``profile`` two more steps under the profiler)."""
    from repro_torch.models import encdec
    from repro_torch.train.state import cache_specs
    from repro_torch.train.step import make_decode_step

    B = frames.shape[0]
    with torch.no_grad():
        enc, enc_launches = counted_run(lambda: encdec.encode(cfg, params, frames,
                                                              remat=False))
        cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                         cache_specs(cfg, B, WHISPER_MAX_LEN))
        cross = encdec.precompute_cross_cache(cfg, params, enc)
        for name in ("xk", "xv"):
            cache["dec_unit"]["b0"][name].copy_(cross["b0"][name])
        del enc, cross
        dec = make_decode_step(cfg)
        tok = torch.full((B, 1), WHISPER_START, dtype=torch.int32, device="cuda")
        stream, logits = [], []
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(lens) + 1)]
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        events[0].record()
        for i, n in enumerate(lens):
            nxt, lg, cache = dec(params, tok, cache, n)
            events[i + 1].record()
            stream.append(nxt)
            logits.append(lg[:, 0])
            tok = nxt[:, None]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counts()
        prof = step_profile(lambda: [dec(params, tok, cache, lens[-1] + 1)
                                     for _ in range(2)]) if profile else None
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(len(lens))]
    return (torch.stack(stream, 1).cpu(), logits, enc_launches, launches, step_ms, wall_s,
            prof)


def encdec_decode():
    """whisper-medium decodes at its published widths (fp32 parameters):
    WHISPER_DEC_B rows of WHISPER_FRAMES frames encoded (24 flash
    launches, full), the cross cache precomputed, WHISPER_GEN greedy
    tokens from the start token.  In fp32 (TF32 off) the kernel path's
    stream equals the plain path's (a divergence fails with its top-2
    gap), and the no-cache prefill step over the tokens fed gives last
    logits within WHISPER_PREFILL_TOL (of their max abs) of the decode
    replay's at its last position (48 flash launches).  In bf16 compute,
    kernel 2 launches exactly 48 times a step (24 self, 24 cross) and
    nothing else; tokens/s and step p50; two more steps profiled.  Returns
    the flash and kernel 2 launches of the kernel path's runs."""
    from repro_torch.train.step import make_prefill_step

    t_phase = time.perf_counter()
    cfg = get_config(WHISPER)
    L = cfg.num_decoder_layers
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED + 1),
                         model_specs(cfg), "cuda")
    frames = torch.randn((WHISPER_DEC_B, WHISPER_FRAMES, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(SEED + 32))
    lens = torch.arange(WHISPER_GEN, dtype=torch.int32, device="cuda")
    runs = {}
    for impl in ("auto", "ref"):
        c = cfg.with_overrides(compute_dtype=torch.float32, decode_impl=impl)
        stream, logits, enc_l, dec_l, _, wall_s, _ = whisper_decode(c, params, frames, lens)
        k = impl == "auto"
        if k:
            flash, k2 = enc_l["flash_attention"], dec_l["decode_attention"]
        only(enc_l, {"flash_attention": cfg.num_layers} if k else {}, f"whisper's {impl} encode")
        only(dec_l, {"decode_attention": 2 * L * WHISPER_GEN} if k else {},
             f"whisper's {impl} decode")
        runs[impl] = {"stream": stream, "logits": logits, "wall_s": wall_s}
    a, b = runs["auto"]["stream"], runs["ref"]["stream"]
    fed = torch.cat([torch.full((WHISPER_DEC_B, 1), WHISPER_START, dtype=torch.int32),
                     a[:, :-1]], 1).cuda()
    c32 = cfg.with_overrides(compute_dtype=torch.float32)
    last, pre_l = counted_run(lambda: make_prefill_step(c32)(
        params, {"frames": frames, "tokens": fed}))
    only(pre_l, {"flash_attention": cfg.num_layers + L}, "whisper's no-cache prefill")
    prefill_err = rel_of_max(runs["auto"]["logits"][-1], last)
    out = {"phase": "encdec", "part": "whisper_decode_fp32", "arch": WHISPER,
           "batch": WHISPER_DEC_B, "frames": WHISPER_FRAMES, "self_cache": WHISPER_MAX_LEN,
           "generated": WHISPER_GEN, "streams_identical": bool(torch.equal(a, b)),
           "prefill_vs_replay_rel_err": prefill_err, "tol_rel_of_max_abs": WHISPER_PREFILL_TOL,
           "wall_s": {k: r["wall_s"] for k, r in runs.items()}}
    if not out["streams_identical"]:
        out["first_divergence"] = first_divergence(a, b, runs["ref"]["logits"])
    out["ok"] = out["streams_identical"] and prefill_err <= WHISPER_PREFILL_TOL
    emit(out)
    del runs, last
    if not out["ok"]:
        raise AssertionError("whisper's fp32 decode paths disagree")

    stream, logits, enc_l, dec_l, step_ms, wall_s, prof = whisper_decode(cfg, params, frames,
                                                                         lens, profile=True)
    only(enc_l, {"flash_attention": cfg.num_layers}, "whisper's bf16 encode")
    only(dec_l, {"decode_attention": 2 * L * WHISPER_GEN}, "whisper's bf16 decode")
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    steady = step_ms[1:]
    out = {"phase": "encdec", "part": "whisper_decode_bf16", "arch": WHISPER,
           "compute_dtype": str(cfg.compute_dtype), "batch": WHISPER_DEC_B,
           "generated": WHISPER_GEN, "launches": dec_l,
           "kernel2_per_step": dec_l["decode_attention"] / WHISPER_GEN,
           "encode_flash_launches": enc_l["flash_attention"], "all_logits_finite": finite,
           "tokens_per_s": WHISPER_DEC_B * WHISPER_GEN / wall_s,
           "step_ms_p50": float(np.percentile(steady, 50)),
           "step_ms_p95": float(np.percentile(steady, 95)), "wall_s": wall_s,
           "profiled_2_steps": prof, "seconds": time.perf_counter() - t_phase, "ok": finite}
    emit(out)
    del params, frames
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("whisper's bf16 decode gave non-finite logits")
    return (flash + pre_l["flash_attention"] + enc_l["flash_attention"],
            k2 + dec_l["decode_attention"])


def encdec_rows():
    """Row 1 at the whisper encoder's shape (B 8, H 16, S 1500, D 64, full,
    bf16) and row 2 at its cross-attention decode (B 4, [B, 1500, 16, 64],
    scalar length 1500, bf16: split spans and the combine pass, its share
    in ``device_us_by_kernel``), one input set per layer, with SDPA
    beside (K/V already at every head: G 1)."""
    cfg = get_config(WHISPER)
    H, KV, D = decode_step_shape(WHISPER)
    dt, esz, L, S = torch.bfloat16, 2, cfg.num_layers, WHISPER_FRAMES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    B = WHISPER_B
    cases = [flash_case(gen, B, H, KV, S, D, dt) for _ in range(L)]
    err = max(check_flash(a, False)[0] for a in cases[:2])
    nxt = rotate(cases)
    fn = lambda: fa.flash_attention_kernel(*nxt(), causal=False)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(*nxt())  # noqa: E731
    flash = kernel_row(
        "flash_attention", "src/repro/kernels/flash_attention.py:85", {"flash_attention": 0},
        err, cuda_ms(fn), cuda_ms(lambda: fa.flash_attention_plain(*nxt(), causal=False)),
        esz * 4 * B * H * S * D, 4 * B * H * S * S * D, cuda_ms(lib),
        "SDPA (full), K/V at every head (G 1)",
        {"B": B, "H": H, "KV": KV, "S": S, "D": D, "causal": False, "arch": WHISPER,
         "path": "encoder self-attention", "dtype": str(dt)},
        lib_us=device_us_per_call(lib)[0])
    us, by_kernel = device_us_per_call(fn, reps=2 * L)
    if us is not None:
        redesigned(flash, us, by_kernel)
    del cases
    B = WHISPER_DEC_B
    cases = [contig_decode_case(gen, H, KV, D, S, [S] * B, dt) for _ in range(L)]
    cases = [(q, k, v, i32(S)) for q, k, v, _ in cases]
    decode = decode_row(cases, H, KV, D, S, [S] * B, {
        "arch": WHISPER, "path": "cross-attention decode", "cache_len": f"scalar {S}"})
    del cases
    return [flash, decode]


def decode_row(cases, H, KV, D, S, lens, at):
    """Kernel 2's row at ``cases`` (one input set per layer, bf16), with
    SDPA over K/V expanded to every head and the device time by kernel
    (the split body and, past 512 positions, the combine pass)."""
    B, esz = len(lens), 2
    err = max(check_contig_decode(a)[0] for a in cases[:2])
    lib = [contig_sdpa_inputs(
        q[:, :, None], k, v,
        (torch.arange(S, device="cuda")[None, :] < cl.expand(B)[:, None])[:, None, None, :],
        H, KV) for q, k, v, cl in cases]
    nxt, lib_nxt = rotate(cases), rotate(lib)
    fn, plain = dec.decode_attention_kernel, dec.decode_attention_plain
    live = sum(lens)
    row = kernel_row(
        "decode_attention", "src/repro/kernels/decode_attention.py:114",
        {"decode_attention": 0}, err, cuda_ms(lambda: fn(*nxt())),
        cuda_ms(lambda: plain(*nxt())),
        2 * live * KV * D * esz + 2 * B * H * D * esz + 4 * B, 4 * H * D * live,
        cuda_ms(lambda: sdpa(*lib_nxt())), CONTIG_SDPA,
        {"B": B, "H": H, "KV": KV, "D": D, "S": S, "dtype": "torch.bfloat16", **at},
        lib_us=device_us_per_call(lambda: sdpa(*lib_nxt()))[0])
    us, by_kernel = device_us_per_call(lambda: fn(*nxt()), reps=2 * len(cases))
    if us is None:
        row["device_us_per_launch"] = None
    else:
        redesigned(row, us, by_kernel, design="mma.sync m16n8k16, GQA-packed",
                   header="decode_tc.cuh")
        row["combine_share"] = sum(v for k, v in by_kernel.items() if "combine" in k) / us
    return row


def phase_encdec():
    """whisper-medium at its published widths: training (encdec_train),
    decoding (encdec_decode), then rows 1 and 2 at its shapes
    (encdec_rows).  Returns the rows and the phase's main-path launches."""
    train_flash = encdec_train()
    enc_flash, dec2 = encdec_decode()
    rows = encdec_rows()
    launches = {"flash_attention": train_flash + enc_flash, "decode_attention": dec2}
    for row in rows:
        row["launches"] = launches[row["name"]]
    emit({"phase": "timing", "ok": True, "arch": WHISPER, "rows": rows})
    torch.cuda.empty_cache()
    return rows, launches


def mrope_positions(B, text, grid_h, grid_w, tail):
    """[B, S, 3] int32 (t, h, w) on the card: ``text`` text tokens, an image
    of grid_h x grid_w patches at one t (h and w its row and column past
    the image's start), then ``tail`` text tokens; a text token's t, h
    and w are its index in the sequence (so the last is (S-1, S-1, S-1),
    where the decode step continues)."""
    rows = [[i, i, i] for i in range(text)]
    rows += [[text, text + r, text + c] for r in range(grid_h) for c in range(grid_w)]
    rows += [[i, i, i] for i in range(len(rows), len(rows) + tail)]
    return torch.tensor(rows, dtype=torch.int32, device="cuda")[None].expand(B, -1, -1)


def loss_grad_norm(cfg, params, batch):
    """One loss and the global norm of its gradient (no optimizer); a leaf
    the loss does not read gets zeros, as in the train step."""
    from repro_torch.train.step import make_loss_fn

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    tree = map_tree(lambda _: next(it), params)
    with torch.enable_grad():
        loss = make_loss_fn(cfg, RunConfig())(tree, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    return {"loss": loss.item(), "grad_norm": norm.item()}


def phase_mrope():
    """qwen2-vl-72b at its published widths, its depth cut to QWEN_LAYERS
    of 80 layers (fp32 parameters, 24 GB): embedding inputs with M-RoPE
    positions (an image grid, then text: t, h and w differ).  In fp32
    (TF32 off): the no-cache prefill step's last logits against the
    empty-cache prefill of S - 1 positions (lm_apply, flash exactly L
    launches) plus one decode step of the matching token at (p, p, p)
    (kernel 2 exactly L), within QWEN_PREFILL_TOL of their max abs; a
    loss and its gradient's norm at QWEN_PARITY_LAYERS layers on B 1 x
    QWEN_PARITY_S, kernel path against plain path within TRAIN_TOL.  Then
    bf16 parameters: QWEN_DEC_B rows prefilled (flash exactly L) and
    QWEN_GEN greedy steps (kernel 2 exactly L a step, nothing else);
    tokens/s and step p50, two more steps profiled; then row 2 at its
    decode shape.  Returns the
    row and the phase's main-path launches."""
    from repro_torch.models.lm import lm_apply, lm_cache_specs
    from repro_torch.train.step import make_decode_step, make_prefill_step

    t_phase = time.perf_counter()
    cfg = get_config(QWEN).with_overrides(num_layers=QWEN_LAYERS)
    L = cfg.num_layers
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED + 2),
                         model_specs(cfg), "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    pos = mrope_positions(QWEN_B, QWEN_TEXT, *QWEN_GRID, QWEN_TEXT)
    S = pos.shape[1]
    c32 = cfg.with_overrides(compute_dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (QWEN_B, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    emb = torch.randn((QWEN_B, S, cfg.d_model), generator=gen, device="cuda")
    emb[:, -1] = params["embed"][tok[:, 0]]
    with torch.no_grad():
        full, full_l = counted_run(lambda: make_prefill_step(c32)(
            params, {"embeds": emb, "positions": pos}))
        only(full_l, {"flash_attention": L}, "qwen's no-cache prefill")
        cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                         lm_cache_specs(c32, QWEN_B, S))
        _, pre_l = counted_run(lambda: lm_apply(c32, params, emb[:, :-1], pos[:, :-1],
                                                cache, 0, remat=False))
        only(pre_l, {"flash_attention": L}, "qwen's empty-cache prefill")
        (_, lg, _), dec_l = counted_run(lambda: make_decode_step(c32)(
            params, tok, cache, torch.tensor(S - 1, device="cuda")))
        only(dec_l, {"decode_attention": L}, "qwen's fp32 decode step")
    prefill_err = rel_of_max(lg[:, 0], full)
    del cache, lg, full

    # loss and grad at QWEN_PARITY_LAYERS layers: views of the first ones
    cp = c32.with_overrides(num_layers=QWEN_PARITY_LAYERS)
    pp = dict(params, unit=map_tree(lambda t: t[:QWEN_PARITY_LAYERS], params["unit"]))
    ppos = mrope_positions(1, QWEN_TEXT, *QWEN_GRID,
                           QWEN_PARITY_S - QWEN_TEXT - QWEN_GRID[0] * QWEN_GRID[1])
    batch = {"embeds": torch.randn((1, QWEN_PARITY_S, cfg.d_model), generator=gen,
                                   device="cuda"),
             "positions": ppos,
             "labels": torch.randint(0, cfg.vocab_size, (1, QWEN_PARITY_S), generator=gen,
                                     device="cuda")}
    grads = {}
    for impl in ("auto", "ref"):
        grads[impl], launches = counted_run(
            lambda: loss_grad_norm(cp.with_overrides(decode_impl=impl), pp, batch))
        only(launches, {"flash_attention": 2 * QWEN_PARITY_LAYERS} if impl == "auto" else {},
             f"qwen's {impl} loss and grad")
        torch.cuda.empty_cache()
    rel = max_rel([grads["auto"]], [grads["ref"]])
    out = {"phase": "mrope", "part": "qwen_fp32", "arch": QWEN, "layers": L,
           "layers_published": get_config(QWEN).num_layers, "params": n_params,
           "param_gb": n_params * 4 / 1e9, "batch": QWEN_B, "seq": S,
           "image_grid": list(QWEN_GRID), "prefill_vs_decode_rel_err": prefill_err,
           "tol_rel_of_max_abs": QWEN_PREFILL_TOL,
           "loss_grad": {"layers": QWEN_PARITY_LAYERS, "seq": QWEN_PARITY_S,
                         "kernel_path": grads["auto"], "plain_path": grads["ref"],
                         "max_rel_diff": rel, "tol_rel": TRAIN_TOL}}
    out["ok"] = prefill_err <= QWEN_PREFILL_TOL and all(rel[k] <= TRAIN_TOL[k]
                                                         for k in TRAIN_TOL)
    emit(out)
    del pp, batch, emb
    if not out["ok"]:
        raise AssertionError("qwen's fp32 checks failed")

    # bf16 parameters: a prefill and QWEN_GEN decode steps
    cb = cfg.with_overrides(param_dtype=torch.bfloat16)
    params = map_tree(lambda t: t.to(torch.bfloat16), params)
    torch.cuda.empty_cache()
    B, max_len = QWEN_DEC_B, 512
    pos = mrope_positions(B, QWEN_TEXT, *QWEN_GRID, QWEN_TEXT)
    emb = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    cache = map_tree(lambda p: torch.zeros(p.shape, dtype=p.dtype, device="cuda"),
                     lm_cache_specs(cb, B, max_len))
    lens = torch.arange(S, S + QWEN_GEN, dtype=torch.int32, device="cuda")
    dec_fn = make_decode_step(cb)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(QWEN_GEN + 1)]
    with torch.no_grad():
        (lg, _, _), pre_l = counted_run(lambda: lm_apply(cb, params, emb, pos, cache, 0,
                                                         remat=False, last_only=True))
        only(pre_l, {"flash_attention": L}, "qwen's bf16 prefill")
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        events[0].record()
        for i in range(QWEN_GEN):
            nxt, lg, cache = dec_fn(params, tok, cache, lens[i])
            finite &= torch.isfinite(lg).all()
            events[i + 1].record()
            tok = nxt[:, None]
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        dec_l = read_counts()
        prof = step_profile(lambda: [dec_fn(params, tok, cache, lens[-1]) for _ in range(2)])
    only(dec_l, {"decode_attention": L * QWEN_GEN}, "qwen's bf16 decode")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(QWEN_GEN)][1:]
    out = {"phase": "mrope", "part": "qwen_decode_bf16", "arch": QWEN, "layers": L,
           "param_gb": n_params * 2 / 1e9, "batch": B, "prompt": S, "generated": QWEN_GEN,
           "launches": dec_l, "prefill_flash_launches": pre_l["flash_attention"],
           "kernel2_per_step": dec_l["decode_attention"] / QWEN_GEN,
           "all_logits_finite": bool(finite.item()),
           "tokens_per_s": B * QWEN_GEN / wall_s,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p95": float(np.percentile(step_ms, 95)), "wall_s": wall_s,
           "profiled_2_steps": prof, "seconds": time.perf_counter() - t_phase}
    out["ok"] = out["all_logits_finite"]
    emit(out)
    del params, cache, emb
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError("qwen's bf16 decode gave non-finite logits")

    H, KV, D = decode_step_shape(QWEN)
    n = S + QWEN_GEN // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    cases = [contig_decode_case(gen, H, KV, D, max_len, [n] * B, torch.bfloat16)
             for _ in range(L)]
    row = decode_row([(q, k, v, i32(n)) for q, k, v, _ in cases], H, KV, D, max_len, [n] * B,
                     {"arch": QWEN, "path": "decode step (M-RoPE)", "cache_len": f"scalar {n}"})
    # the kernel path's runs: both fp32 prefills and the bf16 one, the
    # fp32 decode step and the bf16 ones
    launches = {"flash_attention": 3 * L, "decode_attention": L + L * QWEN_GEN}
    row["launches"] = launches["decode_attention"]
    emit({"phase": "timing", "ok": True, "arch": QWEN, "rows": [row]})
    return [row], launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    if ARGS.compare:
        phase_compare(ARGS.compare)
        return 0
    if ARGS.cards:
        n_cards = torch.cuda.device_count()
        if n_cards < CARDS:
            print(f"chip_smoke: --cards needs a machine of {CARDS} cards, this one has "
                  f"{n_cards}", file=sys.stderr)
            return 2
        run_cards(ARGS.cards == "check")
        print(gpu_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if ARGS.gang:
        phase_build()
        phase_gang()
        print(gpu_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    wall = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        wall[name] = now - clock[0]
        clock[0] = now

    phase_build()
    lap("build")
    phase_kernels()
    new_us = profile_new_kernels()
    lap("kernels")
    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, model_specs(cfg), "cuda")
    check_step_syncs(cfg, params)
    lap("step_syncs")
    launches, shapes = serve_rounds(cfg, params, SERVE_ROUNDS)
    lap("serve")
    rows = phase_timing(cfg, launches, shapes)
    ring_row = ring_decode_row({"decode_attention": 0})
    lap("timing")
    device_us = {}
    for layout in LAYOUTS:
        device_us.update(phase_profile(cfg, params, layout, window=PROFILE_WINDOW))
    for row in rows:  # each is taken at its timing shape, where measured
        if row.get("device_us_per_launch") is None:
            row["device_us_per_launch"] = device_us.get(row["name"])
    lap("profile")
    phase_stream(cfg, params)
    lap("stream")
    phase_sampling(cfg, params)
    lap("sampling")
    fleet_launches = phase_fleet(cfg, params)
    fleet_rows = fleet_prefill_rows(cfg, fleet_launches)
    del params
    torch.cuda.empty_cache()
    lap("fleet")
    phase_phi3()
    lap("phi3")
    family_launches, family_rows = phase_mla_moe()
    lap("mla_moe")
    flash_launches, flash_us, train = phase_train(cfg)
    torch.cuda.empty_cache()
    lap("train")
    phase_dryrun(cfg, train)
    lap("dryrun")
    phase_train_parity(cfg)
    lap("train_parity")
    rt_train, rt_serve = phase_runtime(cfg)
    lap("runtime")
    exec_launches = phase_exec(cfg)
    torch.cuda.empty_cache()
    lap("exec")
    dist_hash = phase_distributed(cfg)
    lap("distributed")
    gang_hash = phase_gang()
    torch.cuda.empty_cache()
    lap("gang")
    # the serving rows count the launches of every main path that runs
    # them: the fleet phase's disaggregated run, the runtime phase's
    # service stage, the exec phase's service stages in worker processes
    # (counted there), the MLA and MoE phases; and carry their timings at
    # the MLA and MoE serving shapes and the fleet's prefill widths
    for row in rows:
        by_phase = {"serve": row["launches"], "fleet": fleet_launches.get(row["name"], 0),
                    "runtime": rt_serve.get(row["name"], 0),
                    "exec": exec_launches.get(row["name"], 0),
                    **{k: v[row["name"]] for k, v in family_launches.items()}}
        if any(v for k, v in by_phase.items() if k != "serve"):
            row["launches_by_phase"] = by_phase
            row["launches"] = sum(by_phase.values())
        row["at_other_shapes"] = [r for r in family_rows + fleet_rows + [ring_row]
                                  if r["name"] == row["name"]]
    rows.append(flash_row(cfg, {"flash_attention": flash_launches
                                + rt_train["flash_attention"]}, flash_us,
                          new_us["flash_attention_library"]))
    rows[-1]["launches_by_phase"] = {"train": flash_launches,
                                     "runtime": rt_train["flash_attention"]}
    torch.cuda.empty_cache()
    host_cols, table, hash_launches = phase_dataframe()
    lap("dataframe")
    phase_pipeline(table, host_cols)
    del table, host_cols
    torch.cuda.empty_cache()
    lap("pipeline")
    rows.append(rmsnorm_row({"rmsnorm": phase_rmsnorm(cfg)}, new_us["rmsnorm"],
                            new_us["rmsnorm_library"]))
    exec_hash = exec_launches["hash_partition_histogram"]
    rows.append(hash_row({"hash_partition_histogram": hash_launches + exec_hash + dist_hash
                          + gang_hash}, new_us["hash_partition_histogram"]))
    rows[-1]["launches_by_phase"] = {"dataframe": hash_launches, "exec": exec_hash,
                                     "distributed": dist_hash, "gang": gang_hash}
    emit({"phase": "timing", "ok": True, "rows": rows[-3:]})
    lap("rmsnorm")
    fig4_hash = phase_paper()
    hash_row_ = next(r for r in rows if r["name"] == "hash_partition_histogram")
    hash_row_["launches_by_phase"]["paper_fig4"] = fig4_hash
    hash_row_["launches"] += fig4_hash
    lap("paper")
    # the recurrent phase's launches join kernel 2's row, as its ring
    # decode line's count
    ring_row["launches"] = phase_recurrent()
    row2 = next(r for r in rows if r["name"] == "decode_attention")
    row2.setdefault("launches_by_phase", {"serve": row2["launches"]})
    row2["launches_by_phase"]["recurrent"] = ring_row["launches"]
    row2["launches"] += ring_row["launches"]
    lap("recurrent")
    # whisper's and qwen2-vl's launches and shapes join rows 1 and 2
    encdec_rows, encdec_launches = phase_encdec()
    lap("encdec")
    mrope_rows, mrope_launches = phase_mrope()
    lap("mrope")
    for row in rows:
        if row["name"] in encdec_launches:
            row["launches_by_phase"]["encdec"] = encdec_launches[row["name"]]
            row["launches_by_phase"]["mrope"] = mrope_launches[row["name"]]
            row["launches"] = sum(row["launches_by_phase"].values())
            row.setdefault("at_other_shapes", [])
            row["at_other_shapes"] += [r for r in encdec_rows + mrope_rows
                                       if r["name"] == row["name"]]
    emit({"phase": "wall", "ok": True, "seconds": wall, "total_s": sum(wall.values())})
    print(gpu_line(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
