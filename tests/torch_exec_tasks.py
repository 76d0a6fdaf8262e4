"""Module-level task fns and stages for the port's subprocess transport:
``tests/test_torch_exec_transport.py`` runs them in worker processes on
the CPU and ``chip_smoke.py``'s exec phase on the card.

Worker processes import task fns by qualified name; ``tests/`` is on the
parent's ``sys.path`` (pytest puts it there, ``chip_smoke.py`` inserts
it) and the transport hands the parent's ``sys.path`` to every worker as
its ``PYTHONPATH``, so ``torch_exec_tasks.<fn>`` resolves there.  This
module imports torch and the port only: no JAX.

Every stage that can launch a port kernel returns the launch counts of
its own process (``launch_counts``), the kernel sources its process
compiled (``build.COMPILED``) and its pid: counters are per process, so
the caller adds them up.
"""
from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.common.params import from_jax_params, init_params, tree_leaves
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import stage
from repro_torch.dataframe import ops_dist
from repro_torch.dataframe.table import Table
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash_partition as hp
from repro_torch.kernels import prefill_attention as pf
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.state import model_specs

#: each kernel wrapper's launch counter, by kernel name
WRAPPERS = {"decode_attention_paged": dec.decode_attention_paged_kernel,
            "prefill_attention_paged": pf.prefill_attention_paged_kernel,
            "paged_scatter": pf.write_chunk_paged_kernel,
            "decode_attention": dec.decode_attention_kernel,
            "prefill_attention": pf.prefill_attention_kernel,
            "flash_attention": fa.flash_attention_kernel,
            "rmsnorm": rms.rmsnorm_kernel,
            "hash_partition_histogram": hp.hash_partition_histogram_kernel}


def launch_counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def _since(before: dict) -> dict:
    return {name: n - before[name] for name, n in launch_counts().items()}


def _process(device: torch.device) -> dict:
    """Who ran the task: pid, the sources compiled here, peak memory."""
    return {"pid": os.getpid(), "compiled": list(build.COMPILED),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None)}


# ---------------------------------------------------------------------------
# plain task fns (transport-level)
# ---------------------------------------------------------------------------


def echo(x):
    return x


def pid():
    return os.getpid()


def add_one(x):
    return x + 1


def boom():
    raise ValueError("worker-side failure")


def die(comm=None):
    os.kill(os.getpid(), signal.SIGKILL)


def sleep_for(seconds):
    time.sleep(seconds)
    return seconds


class SlowToLoad:
    """A result whose unpickling takes ``seconds``: the parent's receive
    thread decodes it while the worker's heartbeats queue behind it."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __reduce__(self):
        return _load_slowly, (self.seconds,)


def _load_slowly(seconds):
    time.sleep(seconds)
    return seconds


def slow_to_load(seconds):
    return SlowToLoad(seconds)


def train_then_die(comm, ckpt_dir, resume_step=None):
    """First attempt: checkpoint step 7 then kill its own worker (a node
    death).  Retry: report the step the agent threaded back in."""
    if resume_step is None:
        store.save(ckpt_dir, 7, {"w": np.zeros(2, np.float32)})
        os.kill(os.getpid(), signal.SIGKILL)
    return ("resumed", resume_step, os.getpid())


def mesh_info(comm, n):
    """What a worker carved: its pool, its communicator, its process."""
    from repro_torch.core.exec.remote import local_pool
    x = torch.ones(n, device=comm.device)
    return {"total": float(x.sum()), "comm_devices": comm.size,
            "worker_devices": len(local_pool(comm.device.type)),
            "device": str(comm.device), "pid": os.getpid()}


def run_paged_kernels(case: dict) -> dict:
    """Kernel 5 (the paged prefill, with its cache scatter) and kernel 3
    (the paged decode) on the worker's card, each held to its plain
    version on the same inputs; returns the largest differences and the
    worker's launch counts."""
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    c = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in case.items()}
    before = launch_counts()
    kp, vp = c["k_pages"].clone(), c["v_pages"].clone()
    got, _, _ = pf.prefill_attention_paged(c["q"], c["k_new"], c["v_new"], kp, vp,
                                           c["block_table"], c["base"], c["chunk_lens"])
    kr, vr = c["k_pages"].clone(), c["v_pages"].clone()
    want, _, _ = ref.prefill_attention_paged_ref(c["q"], c["k_new"], c["v_new"], kr, vr,
                                                 c["block_table"], c["base"],
                                                 c["chunk_lens"])
    dgot = dec.decode_attention_paged(c["q_dec"], kp, vp, c["block_table"], c["lens"])
    dwant = ref.decode_attention_paged_ref(c["q_dec"], kr, vr, c["block_table"], c["lens"])
    torch.cuda.synchronize()
    return {"prefill_err": (got.float() - want.float()).abs().max().item(),
            "pages_equal": bool(torch.equal(kp, kr) and torch.equal(vp, vr)),
            "decode_err": (dgot.float() - dwant.float()).abs().max().item(),
            "launches": _since(before), **_process(dev)}


def run_hash_kernel(keys, num_buckets: int) -> dict:
    """Kernel 7 on the worker's card against its plain version, bitwise."""
    dev = torch.device("cuda")
    k = keys.to(dev)
    before = launch_counts()
    got = hp.hash_partition_histogram(k, num_buckets=num_buckets)
    want = hp.hash_partition_histogram_plain(k, num_buckets=num_buckets)
    return {"equal": bool(torch.equal(got, want)), "launches": _since(before),
            **_process(dev)}


# ---------------------------------------------------------------------------
# the pipeline: a hash shuffle in one worker, its reduction in another
# ---------------------------------------------------------------------------


def shuffle_table(device, rows: int, shards: int, seed: int) -> dict:
    """A ``rows``-row table (int32 keys uniform in [0, 2^20), fp32 values
    from numpy at ``seed``) on ``device``, hash-shuffled over ``shards``
    logical shards (kernel 7 counts the destinations on the card): the
    rows each shard holds and the sum of their keys, and the rows
    dropped."""
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 1 << 20, rows).astype(np.int32),
            "v": rng.normal(size=rows).astype(np.float32)}
    mesh = make_mesh((shards,), ("data",), device=device)
    table = Table.from_columns(cols, mesh)
    out, dropped = ops_dist.shuffle(table, "k")
    k = out.col("k").reshape(shards, -1).to(torch.int64)
    valid = out.valid.reshape(shards, -1)
    return {"counts": valid.sum(1).cpu().numpy(),
            "key_sums": torch.where(valid, k, 0).sum(1).cpu().numpy(),
            "dropped": int(dropped)}


@stage(kind="data_engineering", name="shuffle")
def shuffle_stage(ctx, rows: int, shards: int, seed: int):
    before = launch_counts()
    t0 = time.perf_counter()
    out = shuffle_table(ctx.comm.device, rows, shards, seed)
    if ctx.comm.device.type == "cuda":
        torch.cuda.synchronize()
    return {**out, "seconds": time.perf_counter() - t0,
            "launches": _since(before), **_process(ctx.comm.device)}


@stage(kind="train", name="reduce")
def reduce_stage(ctx):
    up = ctx.upstream["shuffle"]
    return {"rows": int(up["counts"].sum()), "key_sum": int(up["key_sums"].sum()),
            "largest_shard": int(up["counts"].max()), "dropped": up["dropped"],
            "pid": os.getpid()}


# ---------------------------------------------------------------------------
# the service stage: a ServeEngine built inside the executing process
# ---------------------------------------------------------------------------


def weights_checksum(params) -> int:
    """An exact, order-free checksum of a parameter tree: the sum of every
    element's bits read as an integer (int32 words of fp32, int16 of
    bf16), modulo 2^63."""
    total = 0
    for t in tree_leaves(params):
        word = {4: torch.int32, 2: torch.int16}[t.element_size()]
        total += int(t.detach().contiguous().view(word).to(torch.int64).sum())
    return total % (1 << 63)


def make_engine(device, arch: str, smoke: bool, overrides: dict, engine_kw: dict,
                seed: int = 0, jax_params=None):
    """(engine, params): ``arch``'s config with ``overrides``, weights
    drawn on ``device`` from ``seed`` by a torch.Generator there, or JAX's
    numpy tree carried across."""
    cfg = get_config(arch, smoke=smoke).with_overrides(**overrides)
    if jax_params is not None:
        params = from_jax_params(jax_params, device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(gen, model_specs(cfg), device)
    engine = ServeEngine(cfg, RunConfig(), params=params, device=device, seed=seed,
                         **engine_kw)
    return engine, params


def warm_up(engine, warm) -> None:
    """Serve ``warm`` ((prompt, new tokens) pairs) on a throwaway engine of
    ``engine``'s settings and weights: the process's first launches (the
    kernel libraries, cuBLAS, the allocator) stay out of a timed run."""
    if not warm:
        return
    w = ServeEngine(engine.cfg, engine.run_cfg, params=engine.params,
                    device=engine.device, max_slots=engine.max_slots,
                    max_len=engine.max_len,
                    kv_layout="paged" if engine.paged else "contiguous",
                    page_size=engine.page_size,
                    prefill_chunk_tokens=engine.prefill_chunk_tokens)
    for p, g in warm:
        w.submit(p, max_new_tokens=g)
    w.run_until_drained()


def serve(device, arch: str = "tinyllama-1.1b", smoke: bool = True,
          overrides: dict = None, engine_kw: dict = None, seed: int = 0,
          jax_params=None, min_requests: int = 0, warm=None, control=None,
          resume_state=None) -> dict:
    """A service body: builds the engine on ``device`` and serves
    ``control``'s requests until stopped, drained or preempted (the
    checkpoint rides ``ServicePreempted``; ``resume_state`` resumes one).
    ``warm`` requests run first on a throwaway engine (``warm_up``).  With
    ``min_requests`` it starts stepping only once that many requests
    wait in the inbox (60 s at most), so its batches are those of an
    engine handed every request up front.  Returns the engine's stats, the
    weights' checksum, the serving seconds and this process's launches."""
    dev = torch.device(device)
    engine, params = make_engine(dev, arch, smoke, overrides or {}, engine_kw or {},
                                 seed, jax_params)
    checksum = weights_checksum(params)
    warm_up(engine, warm)
    deadline = time.time() + 60
    while (control is not None and control.pending_requests() < min_requests
           and time.time() < deadline):
        time.sleep(0.005)
    before = launch_counts()
    t0 = time.perf_counter()
    stats = engine.run_service(control, resume_state=resume_state)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"stats": stats, "weights_checksum": checksum,
            "serve_s": time.perf_counter() - t0, "launches": _since(before),
            **_process(dev)}


@stage(kind="inference", service=True, name="engine")
def engine_stage(ctx, **kw):
    """``serve`` as a service stage, on the device its communicator was
    carved on."""
    return serve(ctx.comm.device, control=ctx.control,
                 resume_state=ctx.resume_state, **kw)


# ---------------------------------------------------------------------------
# gangs: one task over several worker processes (SubprocessTransport.submit_gang)
# ---------------------------------------------------------------------------


def _gather(comm, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` along dim 0, in rank order (an all-gather over
    the gang's ``data`` axis)."""
    import torch.distributed as dist
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = wire.new_empty((comm.size * wire.shape[0],) + tuple(wire.shape[1:]))
    dist.all_gather_into_tensor(out, wire, group=comm.mesh.group("data"))
    return out.to(x.dtype)


def gang_info(comm, n):
    """Each rank's pid, rank and device, gathered: what the gang ran on.
    The sum of ``n`` ones over every rank checks the group's all-reduce."""
    import torch.distributed as dist
    x = torch.ones(n, device=comm.device)
    total = x.sum().reshape(1)
    dist.all_reduce(total)
    pids = _gather(comm, torch.tensor([os.getpid()], device=comm.device))
    return {"rank": comm.rank, "size": comm.size, "backend": comm.backend,
            "total": float(total), "pids": [int(p) for p in pids.cpu()],
            "device": str(comm.device), "describe": comm.describe()}


def gang_raises_once(comm, marker: str):
    """First attempt: every rank meets in an all-reduce, rank 0 returns,
    and rank 1 raises 2 s after it (so rank 0's worker is idle by then,
    even on a loaded host).  The retry (``marker`` exists) runs
    ``gang_info``: a fresh process group."""
    import torch.distributed as dist
    if not os.path.exists(marker):
        dist.all_reduce(torch.ones(1, device=comm.device))
        if comm.rank == 1:
            time.sleep(2.0)
            open(marker, "w").close()
            raise RuntimeError("rank 1 fails its first attempt")
        return {"attempt": 1, "pid": os.getpid()}
    return gang_info(comm, 4)


def gang_dies_in_collective(comm, marker: str):
    """First attempt: rank 1 kills its own worker while rank 0 waits for
    it in an all-reduce.  The retry (``marker`` exists) runs
    ``gang_info``."""
    import torch.distributed as dist
    if not os.path.exists(marker):
        if comm.rank == 1:
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        dist.all_reduce(torch.ones(1, device=comm.device))
        return {"attempt": 1, "pid": os.getpid()}
    return gang_info(comm, 4)


GANG_OPS = ("shuffle", "join", "groupby", "reduce")


def gang_tables(spec):
    """The gang's seeded tables as numpy columns: ``rows`` int32 keys
    uniform in [0, ``keys``) with fp32 normal values, and a ``keys``-row
    right table (k, 10 k)."""
    rng = np.random.default_rng(spec["seed"])
    left = {"k": rng.integers(0, spec["keys"], spec["rows"]).astype(np.int32),
            "v": rng.normal(size=spec["rows"]).astype(np.float32)}
    rk = np.arange(spec["keys"], dtype=np.int32)
    return left, {"k": rk, "w": (10 * rk).astype(np.float32)}


def gang_calls(t, r, ops, groups_cap):
    """The gang's operators on a left and a right table of either package
    (both run ``ops`` = their ``ops_dist``): name -> call."""
    return {"shuffle": lambda: ops.shuffle(t, "k"),
            "join": lambda: ops.join(t, r, "k"),
            "groupby": lambda: ops.groupby_sum(t, "k", ["v"],
                                               groups_cap_per_shard=groups_cap),
            "reduce": lambda: (ops.reduce_sum(t, ["v"]), 0)}


def gang_dataframe(comm, spec):
    """The dataframe over the gang's process mesh: this rank's shard of
    ``gang_tables(spec)`` on its device, then shuffle, join, groupby and
    reduce, each once to warm up when ``spec["warmup"]`` and once counted
    and timed.  Rank 0 returns host values taken after the collectives:
    every rank's result rows gathered in rank order (columns, the valid
    mask, rows dropped; reduce's sums), and each rank's kernel 7 launches,
    milliseconds and pid."""
    dev = comm.device
    W, r = comm.size, comm.rank
    left, right = gang_tables(spec)
    mine = lambda cols: {k: torch.from_numpy(v.reshape(W, -1)[r].copy()).to(dev)  # noqa: E731
                         for k, v in cols.items()}
    t = Table.from_columns(mine(left), comm.mesh)
    rt = Table.from_columns(mine(right), comm.mesh)
    calls = gang_calls(t, rt, ops_dist, spec["groups_cap"])
    results, launches, ms = {}, [], []
    for name in GANG_OPS:
        if spec.get("warmup"):
            calls[name]()
        n0 = hp.hash_partition_histogram_kernel.launches
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, dropped = calls[name]()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(hp.hash_partition_histogram_kernel.launches - n0)
        if name == "reduce":
            results[name] = res
            continue
        cols = {k: _gather(comm, v) for k, v in res.columns.items()}
        valid = _gather(comm, res.valid)
        results[name] = None if r else {
            "cols": {k: v.cpu().numpy() for k, v in cols.items()},
            "valid": valid.cpu().numpy(), "dropped": int(dropped)}
        del cols, valid
    per_rank = _gather(comm, torch.tensor([[os.getpid()] + launches + ms],
                                          dtype=torch.float64, device=dev))
    if r:
        return None
    rows = per_rank.cpu().numpy()
    k = len(GANG_OPS)
    return {"results": results, "world": W, "backend": comm.backend,
            "device": str(dev), "pids": [int(x) for x in rows[:, 0]],
            "launches": [{n: int(x) for n, x in zip(GANG_OPS, row[1:1 + k])} for row in rows],
            "ms": [{n: float(x) for n, x in zip(GANG_OPS, row[1 + k:])} for row in rows]}


@stage(kind="data_engineering", name="wide", num_devices=2)
def gang_stage(ctx):
    """A stage two devices wide: on a pool of one-device workers, a gang."""
    return gang_info(ctx.comm, 2)
