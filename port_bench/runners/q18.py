"""The dataframe runner: TPC-H Q18's inner block over the port's
distributed operators, one rank a card, NCCL between them.

Rank 0 is the benchmark's own process; it starts ranks 1..N-1 as
processes of this module and waits for each.  Every rank makes its
share of ``orders`` and ``lineitem`` on its card from the seed (the
benchmark's generator, ``make_tables``), runs the query once to warm up,
and then back to back until rank 0 sees the window's seconds pass (it
broadcasts one code an iteration: go on, start or stop the trace, end).
An order's lines lie on several ranks.  One iteration is
``groupby_sum(lineitem, l_orderkey, [l_quantity])``, a mask of the
groups whose sum passes 300, ``join`` with ``orders`` on the key, and ``reduce_sum`` of the price, the quantities, the line counts
and the keys.  ``rows_per_s`` is the lineitem rows of the window's
iterations over the seconds from the window's start to the end of its
last iteration.  Rank 0 then holds the last iteration's answer and the
rows every operator dropped to a NumPy Q18 over the same tables, made
again from the seed (``reference/q18.py``).  A control run judges the
bfloat16 reference's answer in the program's place by the same checks.
"""
from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.harness import common
from port_bench.harness.trace import DeviceTrace

GO, TRACE_ON, TRACE_OFF, END = 1, 2, 3, 0
SUMMED = ("o_totalprice", "l_quantity", "_count", "o_orderkey")


def balanced_counts(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` line counts in ``[lo, hi]``, each count equally often, whose
    sum is ``n`` times their mean (the few left over from whole cycles are
    paired around the mean)."""
    k = hi - lo + 1
    c = np.arange(n) % k + lo
    rest = n % k
    if rest:
        mid = (lo + hi) / 2
        tail = [int(mid - 1 - i // 2) if i % 2 == 0 else int(mid + 1 + i // 2) for i in range(rest)]
        if rest % 2:
            tail[-1] = int(mid)
        c[n - rest:] = tail
    return c


def make_tables(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The whole data set from the seed: order keys as dbgen spaces them,
    a balanced set of 1-7 lines an order in an order drawn from the seed,
    quantities uniform over 1-50, prices uniform over the configuration's
    range."""
    n = cfg["orders_rows"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    i = torch.arange(n, device=device, dtype=torch.int64)
    per, stride = cfg["orderkeys_per_stride"], cfg["orderkey_stride"]
    okey = ((i // per) * stride + i % per + 1).to(torch.int32)
    counts = torch.as_tensor(balanced_counts(n, cfg["lineitem_lines_per_order_min"],
                                             cfg["lineitem_lines_per_order_max"]), device=device)
    counts = counts[torch.randperm(n, generator=gen, device=device)]
    lkey = torch.repeat_interleave(okey, counts)
    qty = torch.randint(cfg["l_quantity_min"], cfg["l_quantity_max"] + 1, lkey.shape,
                        generator=gen, device=device).to(torch.float32)
    lo, hi = cfg["o_totalprice_min"], cfg["o_totalprice_max"]
    price = torch.rand(n, generator=gen, device=device, dtype=torch.float32) * (hi - lo) + lo
    return {"o_orderkey": okey, "o_totalprice": price, "l_orderkey": lkey, "l_quantity": qty}


def shard(tables: Dict[str, torch.Tensor], rank: int, world: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s share: a block of the orders, and every
    ``world``-th lineitem row (an order's lines lie on several ranks, so
    both the group-by and the join must exchange rows)."""
    n = tables["o_orderkey"].numel() // world
    out = {k: tables[k][rank * n:(rank + 1) * n].clone() for k in ("o_orderkey", "o_totalprice")}
    out.update({k: tables[k][rank::world].contiguous() for k in ("l_orderkey", "l_quantity")})
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Query:
    """The program's operators over this rank's tables."""

    def __init__(self, cfg: Dict, tables: Dict, mesh, sync):
        from repro_torch.dataframe import ops_dist as D
        from repro_torch.dataframe.table import Table

        self.D, self.Table, self.cfg, self.sync = D, Table, cfg, sync
        self.lineitem = Table.from_columns(
            {"l_orderkey": tables["l_orderkey"], "l_quantity": tables["l_quantity"]}, mesh=mesh)
        self.orders = Table.from_columns(
            {"o_orderkey": tables["o_orderkey"], "o_totalprice": tables["o_totalprice"]}, mesh=mesh)
        self.ms = {"groupby": [], "join": [], "reduce": []}

    def timed(self, name, fn, spans: bool):
        if not spans:
            return fn()
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        self.ms[name].append((time.perf_counter() - t0) * 1e3)
        return out

    def __call__(self, spans: bool = False):
        D, T, cfg = self.D, self.Table, self.cfg
        g, d_group = self.timed("groupby", lambda: D.groupby_sum(
            self.lineitem, "l_orderkey", ["l_quantity"],
            groups_cap_per_shard=cfg["groups_cap_per_rank"]), spans)
        c = g.columns
        big = T({"o_orderkey": c["l_orderkey"], "l_quantity": c["l_quantity"],
                 "_count": c["_count"]},
                g.valid & (c["l_quantity"] > cfg["having_quantity_over"]), g.mesh, g.axis)
        j, d_join = self.timed("join", lambda: D.join(big, self.orders, "o_orderkey"), spans)
        r = self.timed("reduce", lambda: D.reduce_sum(j, list(SUMMED)), spans)
        return r, d_group + d_join


def rank_main(rank: int, world: int, port: int, seed: int, seconds: float, trace: bool,
              device: str, cfg: Dict, t_start: float, trace_s: float,
              fault: Optional[str] = None) -> Dict:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_process_mesh

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        sync = torch.cuda.synchronize
    else:
        dev = torch.device("cpu")
        sync = lambda: None  # noqa: E731
    kw = {"device_id": dev} if cuda else {}
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, **kw)
    try:
        if fault:
            mod, fn = fault.split(":")
            undo = getattr(importlib.import_module(mod), fn)()
        mesh = make_process_mesh([world], ["data"], device=dev)
        everything = make_tables(cfg, seed, dev)
        tables = shard(everything, rank, world)
        del everything
        rows = torch.tensor([tables["l_orderkey"].numel()], device=dev, dtype=torch.int64)
        dist.all_reduce(rows)
        rows = int(rows.item())
        q = Query(cfg, tables, mesh, sync)
        tracer = DeviceTrace(torch) if (trace and cuda) else None
        if tracer is not None:
            tracer.start()                    # the first start sets up CUPTI: seconds
        q()                                   # warm-up: NCCL's communicators, the allocator
        if tracer is not None:
            tracer.stop()
        sync()
        dist.barrier()
        w0 = time.time()
        setup_s = w0 - t_start
        code = torch.zeros(1, dtype=torch.int32, device=dev)
        iters, last, spans = 0, None, []
        p_start = (seconds - min(trace_s, seconds)) / 2
        p_state = 0
        while True:
            t0 = time.time()
            last = q(spans=trace)
            iters += 1
            t1 = time.time()
            spans.append(("query iteration", t0, t1))
            if rank == 0:
                el = t1 - w0
                c = GO
                if trace and p_state == 0 and el >= p_start:
                    c, p_state = TRACE_ON, 1
                elif trace and p_state == 1 and el >= p_start + trace_s:
                    c, p_state = TRACE_OFF, 2
                if el >= seconds:
                    c = END
                code.fill_(c)
            dist.broadcast(code, 0)
            c = int(code.item())
            if tracer is not None and c == TRACE_ON:
                tracer.start()
            if tracer is not None and c in (TRACE_OFF, END) and tracer.prof is not None:
                tracer.stop()
            if c == END:
                break
        w1 = t1
        sync()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        mine = {"rank": rank, "iters": iters, "w0": w0, "w1": w1, "setup_s": setup_s,
                "peak": int(peak), "rows": rows, "ms": {k: float(np.mean(v)) if v else None
                                                        for k, v in q.ms.items()},
                "answer": last[0], "dropped": int(last[1])}
        if tracer is not None and tracer.t1_ns:
            tb = tracer.time_by_name()
            mine.update(busy_s=tracer.busy_s(), window_s=tracer.window_s,
                        nccl_s=sum(v for n, v in tb.items() if "nccl" in n.lower()),
                        breakdown=tracer.breakdown(spans))
        everyone: List = [None] * world
        dist.all_gather_object(everyone, mine)
        return {"ranks": everyone}
    finally:
        if fault:
            undo()
        dist.destroy_process_group()


def run(opts) -> Dict:
    from port_bench.reference.q18 import query as reference_query

    cfg, world = opts.config, int(opts.config["ranks"])
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(common.ROOT), str(common.ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    args = {"world": world, "port": port, "seed": opts.seed, "seconds": opts.seconds,
            "trace": bool(opts.trace), "device": opts.device, "cfg": cfg,
            "trace_s": float(opts.cell.get("trace_s", 10.0)),
            "fault": opts.fault_spec}
    procs = []
    for r in range(1, world):
        log = tempfile.TemporaryFile()
        p = subprocess.Popen([sys.executable, "-m", "port_bench.runners.q18",
                              json.dumps(dict(args, rank=r, t_start=opts.t_start))],
                             cwd=str(common.ROOT), env=env, stdout=subprocess.DEVNULL,
                             stderr=log)
        procs.append((p, log))
    try:
        out = rank_main(0, world, port, opts.seed, opts.seconds, opts.trace, opts.device, cfg,
                        opts.t_start, args["trace_s"], args["fault"])
    finally:
        errors = reap(procs)
    if errors:
        raise common.BenchError("rank(s) failed:\n" + "\n".join(errors))
    ranks = out["ranks"]
    r0 = ranks[0]
    elapsed = r0["w1"] - r0["w0"]
    iters = r0["iters"]
    e2e = {"rows_per_s": iters * r0["rows"] / elapsed, "setup_s": r0["setup_s"]}
    # -- correctness: NumPy's Q18 over the same tables, made again ------------------
    if opts.device == "cuda":
        torch.cuda.empty_cache()
    dev = torch.device("cuda", 0) if opts.device == "cuda" else torch.device("cpu")
    want = reference_query([{k: v.cpu().numpy() for k, v in make_tables(cfg, opts.seed, dev).items()}],
                           cfg)
    limit = float(opts.cell["limits"]["price_sum_rel_err"])

    def judge(got: Dict) -> Dict:
        return {
            "orderkey_sum_diff": {"value": abs(got["o_orderkey"] - want["o_orderkey"]),
                                  "limit": 0},
            "line_count_diff": {"value": abs(got["_count"] - want["_count"]), "limit": 0},
            "quantity_sum_diff": {"value": abs(got["l_quantity"] - want["l_quantity"]),
                                  "limit": 0},
            "price_sum_rel_err": {"value": abs(got["o_totalprice"] - want["o_totalprice"])
                                  / abs(want["o_totalprice"]), "limit": limit},
            "rows_dropped": {"value": r0["dropped"], "limit": cfg["dropped_rows_allowed"]},
        }

    program = judge(r0["answer"])
    checks = program
    if opts.control:
        # the control's answer in the program's place, judged by the same checks
        checks = judge(reference_query([{k: v.cpu().numpy() for k, v in
                                         make_tables(cfg, opts.seed, dev).items()}],
                                       cfg, bf16=True))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    res = {"correct": bool(correct), "attempted": iters, "failed": 0 if correct else 1,
           "e2e": e2e, "checks": checks, "peak": max(r["peak"] for r in ranks),
           "info": {"iters": iters, "elapsed_s": elapsed, "qualifying": want["orders"],
                    "program": {k: c["value"] for k, c in program.items()},
                    "ms": [r["ms"] for r in ranks]}}
    ctx = {"kind": "dataframe", "ranks": ranks}
    traced = [r for r in ranks if "busy_s" in r]
    if traced:
        res["busy_s"] = float(np.mean([r["busy_s"] for r in traced]))
        res["window_s"] = float(np.mean([r["window_s"] for r in traced]))
        res["breakdown"] = r0.get("breakdown")
        ctx["traced"] = True
    res["ctx"] = ctx
    return res


def reap(procs, timeout: float = 120.0) -> List[str]:
    """Wait for every rank; end any that outlives ``timeout``; the logs of
    those that failed."""
    errors, end = [], time.time() + timeout
    for p, log in procs:
        try:
            p.wait(timeout=max(end - time.time(), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.returncode != 0:
            log.seek(0)
            errors.append(f"rank exit {p.returncode}: " + log.read().decode(errors="replace")[-4000:])
        log.close()
    return errors


if __name__ == "__main__":
    a = json.loads(sys.argv[1])
    os.environ.update(common.cache_env())
    torch.set_num_threads(4)
    rank_main(a["rank"], a["world"], a["port"], a["seed"], a["seconds"], a["trace"],
              a["device"], a["cfg"], a["t_start"], a["trace_s"], a["fault"])
