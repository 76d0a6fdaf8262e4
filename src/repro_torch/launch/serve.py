"""Serving driver (mirror of ``repro.launch.serve``): a continuous-batching
ServeEngine running as a long-running *service stage* on the port's pilot
runtime, or, with ``--fleet N``, an ``EngineRouter`` over N engines.

The single-engine path builds the engine inside a module-level
``@stage(kind="inference", service=True)`` body (``engine_service``) on
the device its communicator was carved on, serves the requests through
``Session.serve`` and drains the stage.  ``--fleet N`` switches to the
multi-engine gateway: the router load-balances the same request stream
over N engines (prefill/decode-disaggregated with ``--disaggregate``) and
this driver becomes a streaming front-end: it polls each request's live
token list and emits deltas as they land, the way a gateway would flush
SSE chunks.  Everything runs on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --fleet 2 --disaggregate
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --batch 4 --prompt-len 8 --gen 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import Session, stage
from repro_torch.core.pilot import PilotDescription, PilotManager
from repro_torch.launch.mesh import resolve_device
from repro_torch.serve import Request, ServeEngine


def _stream(requests, *, poll_s: float = 0.02, timeout: float = 600.0,
            quiet: bool = False) -> None:
    """Gateway-style streaming loop: ``Request.tokens`` is the live stream
    (the engine appends in place; ``_finish`` only stamps the terminal
    state), so polling its length and flushing the delta is what an SSE
    front-end does per chunk.  A failed request raises."""
    seen = [0] * len(requests)
    deadline = time.time() + timeout
    while True:
        live = False
        for i, r in enumerate(requests):
            n = len(r.tokens)
            if n > seen[i] and not quiet:
                done = " done" if r.done() else ""
                print(f"[stream] {r.rid}: +{n - seen[i]} tok ({n} total){done}",
                      flush=True)
            seen[i] = n
            if not r.done():
                live = True
            elif r.error is not None:
                raise RuntimeError(f"{r.rid} failed: {r.error}")
        if not live:
            return
        if time.time() > deadline:
            raise RuntimeError("streaming front-end timed out")
        time.sleep(poll_s)


def _requests(cfg, args):
    rng = np.random.default_rng(1)
    return [Request(rng.integers(1, cfg.vocab_size, args.prompt_len),
                    max_new_tokens=args.gen) for _ in range(args.batch)]


def run_fleet(args, cfg) -> dict:
    """Multi-engine gateway: EngineRouter over ``--fleet`` engines with
    load-aware admission; ``--disaggregate`` splits prefill and decode
    roles and migrates finished prompts by KV-page handoff."""
    from repro_torch.serve import build_fleet

    slots = args.slots or min(args.batch, 4)
    router = build_fleet(cfg, RunConfig(), num_engines=args.fleet,
                         disaggregate=args.disaggregate, seed=0,
                         max_slots=slots, max_len=args.prompt_len + args.gen + 1,
                         name_prefix="gateway", device=resolve_device(args.device))
    router.start()
    try:
        t0 = time.time()
        requests = [router.submit(r) for r in _requests(cfg, args)]
        _stream(requests, quiet=args.quiet)
        wall = time.time() - t0
        stats = router.stats()
    finally:
        router.close()
    n_tok = sum(len(r.tokens) for r in requests)
    ttft = sorted(r.ttft_s for r in requests)
    res = {
        "requests": len(requests),
        "engines": args.fleet,
        "disaggregate": args.disaggregate,
        "generated_tokens": n_tok,
        "tokens_per_s": n_tok / max(wall, 1e-9),
        "ttft_p50_s": ttft[len(ttft) // 2],
        "routed": stats.get("routed", 0),
        "handoffs": stats.get("handoffs_routed", 0),
        "router": stats,
    }
    spread = {k.split("routed_to.")[1]: v for k, v in stats.items()
              if k.startswith("routed_to.")}
    print(f"[serve] {cfg.name} fleet={args.fleet}"
          f"{' disaggregated' if args.disaggregate else ''}: "
          f"{res['tokens_per_s']:.1f} tok/s over {len(requests)} reqs; "
          f"p50 ttft {res['ttft_p50_s'] * 1e3:.0f}ms; routed {spread}"
          + (f"; handoffs {res['handoffs']}" if args.disaggregate else ""))
    return res


@stage(kind="inference", service=True, name="engine")
def engine_service(ctx, arch: str = "tinyllama-1.1b", smoke: bool = True,
                   max_slots: int = 4, max_len: int = 49, seed: int = 0):
    """Module-level service body: builds the ServeEngine inside the stage,
    on the device its communicator was carved on, and serves until the
    stage is stopped or drained."""
    cfg = get_config(arch, smoke=smoke)
    engine = ServeEngine(cfg, RunConfig(), max_slots=max_slots, max_len=max_len,
                         seed=seed, device=ctx.comm.device)
    return engine.run_service(ctx.control, resume_state=ctx.resume_state)


def run(args) -> dict:
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encoder_decoder or cfg.input_kind == "embeds":
        raise SystemExit("serve driver targets token-LM archs")
    if args.fleet > 1 or args.disaggregate:
        if args.disaggregate and args.fleet < 2:
            raise SystemExit("--disaggregate needs --fleet >= 2")
        return run_fleet(args, cfg)
    dev = resolve_device(args.device)
    slots = args.slots or min(args.batch, 4)
    serve_stage = engine_service.bind(
        arch=args.arch, smoke=args.smoke, max_slots=slots,
        max_len=args.prompt_len + args.gen + 1, seed=0)
    pm = PilotManager(devices=[dev] if dev.type == "cpu" else None)
    # close() runs on every exit path, so a failed serve task never leaks
    # the pilot's devices
    with Session(manager=pm, pods=[PilotDescription(name="serve-pod")],
                 max_workers_per_pilot=2, transport=args.transport) as session:
        handle = session.serve(serve_stage, name="serve")
        t0 = time.time()
        requests = [handle.submit_request(r) for r in _requests(cfg, args)]
        task = handle.task
        deadline = time.time() + 600
        for r in requests:
            while not r.wait(timeout=1.0):
                # an engine failure surfaces at once instead of letting
                # orphaned requests run the clock out
                if task.finalized and task.error:
                    raise RuntimeError(f"serve task failed: {task.error}")
                if time.time() > deadline:
                    raise RuntimeError(f"request {r.rid} did not finish")
        wall = time.time() - t0
        if not handle.stop(drain=True, timeout=60):
            raise RuntimeError("service stage did not drain")
        if task.error:
            raise RuntimeError(task.error)
        failed = [r.rid for r in requests if r.error is not None]
        if failed:
            raise RuntimeError(f"requests failed: {failed}")

        stats = task.result
        lat = sorted(r.latency_s for r in requests)
        ttft = sorted(r.ttft_s for r in requests)
        n_tok = sum(len(r.tokens) for r in requests)
        res = {
            "requests": len(requests),
            "generated_tokens": n_tok,
            "tokens_per_s": n_tok / max(wall, 1e-9),
            "latency_p50_s": lat[len(lat) // 2],
            "latency_max_s": lat[-1],
            "ttft_p50_s": ttft[len(ttft) // 2],
            "slot_occupancy": stats["slot_occupancy"],
            "engine": stats,
            "runtime_overheads": task.overhead_s,
            "preemptions": task.preemptions,
        }
        print(f"[serve] {cfg.name}: {res['tokens_per_s']:.1f} tok/s over "
              f"{len(requests)} reqs ({slots} slots, occupancy "
              f"{res['slot_occupancy']:.2f}); p50 latency "
              f"{res['latency_p50_s'] * 1e3:.0f}ms, p50 ttft "
              f"{res['ttft_p50_s'] * 1e3:.0f}ms; overheads {task.overhead_s}")
        return res


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to submit")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=0,
                    help="KV-cache slots (0 = min(batch, 4))")
    ap.add_argument("--fleet", type=int, default=1,
                    help="number of engines behind the router gateway")
    ap.add_argument("--disaggregate", action="store_true",
                    help="split the fleet into prefill/decode engines "
                         "joined by KV-page handoff")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-request streaming deltas")
    ap.add_argument("--transport", default="in-process",
                    choices=["in-process", "subprocess"],
                    help="where the service stage executes (the port runs "
                         "it in-process; 'subprocess' raises until the "
                         "port's core/exec/ lands)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                         "the CPU)")
    return ap


if __name__ == "__main__":
    run(build_parser().parse_args())
