"""The paper's tables on the port (mirror of ``benchmarks/paper_tables.py``).

* ``bench_forecasting`` — Table 3: the 11 forecasting models trained
  bare-metal and as a ``RemoteAgent`` task, with MAE / MSE / MAPE;
* ``bench_hydrology`` — Tables 1-2: the hydrology LSTM, per-target train
  and validation MSE and NNSE, and the task's overhead decomposition;
* ``bench_multi_pipeline`` — Table 4: 11 pipelines of a ``cylon_stage``
  sort and a ``dl_stage`` inference under one pilot, against running
  them one after another;
* ``bench_scaling_ops`` — Fig. 4: strong and weak scaling of the
  distributed ``sort`` and ``join`` over meshes of 1, 2, 4 and 8 logical
  shards.  On one device this scales the shard count of one card's
  operators, not processes or cards.

Everything runs on ``device`` (the card unless the caller asks for the
CPU) under a ``PilotManager`` over that device.  Each function returns the
results dict the JAX package writes to ``results/bench/<name>.json``.
The data, the initial parameters and the batch indices are JAX's draws
(threefry keys, ``common/prng.py``, split where the JAX package splits
them), drawn on the host and the same on every device; each SGD step
takes its batch indices as an argument (``forecaster_step``,
``hydrology_step``).  The parameters are updated in place under
``torch.no_grad()``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.params import map_tree, tree_leaves
from repro_torch.core.agent import RemoteAgent
from repro_torch.core.bridge import cylon_stage, dl_stage
from repro_torch.core.pilot import PilotDescription, PilotManager
from repro_torch.core.pipeline import Pipeline, run_pipelines
from repro_torch.core.task import Task, TaskDescription, TaskState
from repro_torch.dataframe import ops_dist as D
from repro_torch.dataframe import ops_local as L
from repro_torch.dataframe.table import Table
from repro_torch.launch.mesh import make_mesh, resolve_device
from repro_torch.models import forecasting as F
from repro_torch.models import hydrology as Hy


def _manager(dev: torch.device) -> PilotManager:
    """The card's inventory, or the CPU when the caller asked for it."""
    return PilotManager(devices=[dev] if dev.type == "cpu" else None)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trainable(params):
    return map_tree(lambda t: t.detach().clone().requires_grad_(), params)


def _run_task(agent: RemoteAgent, name: str, fn: Callable) -> Task:
    """Run one task to its end; a task that did not end DONE raises."""
    task, = agent.submit([TaskDescription(name=name, fn=fn, kind="train")])
    if task.state is not TaskState.DONE:
        raise RuntimeError(f"task {name} ended {task.state.value}: {task.error}")
    return task


def sgd_(leaves: List[torch.Tensor], loss: torch.Tensor, lr: float) -> None:
    """``p <- p - lr * grad`` for every leaf, in place.  A leaf the loss
    does not reach (the last block's backcast in NBEATS and AutoNHITS)
    has a zero gradient and stays as it is."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            if g is not None:
                p.sub_(lr * g)


# ---------------------------------------------------------------------------
# shared training loop (bare-metal path)
# ---------------------------------------------------------------------------


def forecaster_step(apply, params, series: torch.Tensor, starts: torch.Tensor,
                    W: int, Hz: int, lr: float) -> torch.Tensor:
    """One SGD step on the windows of ``series`` starting at ``starts``
    (the first W points in, the next Hz out); returns the loss before it."""
    idx = starts[:, None] + torch.arange(W + Hz, device=series.device)[None, :]
    data = series[idx]
    x, y = data[:, :W], data[:, W:]
    loss = torch.mean((apply(params, x) - y) ** 2)
    sgd_(tree_leaves(params), loss, lr)
    return loss.detach()


def _train_forecaster(name: str, steps: int, W=96, Hz=24, batch=128,
                      lr=1e-3, seed=0, device=None) -> Dict[str, float]:
    dev = resolve_device(device)
    init, apply = F.MODELS[name](W, Hz)
    params = _trainable(init(prng.PRNGKey(seed), dev))
    series = F.make_ett_series(4096, seed=seed, device=dev)
    split = 3 * len(series) // 4
    key = prng.PRNGKey(seed + 1)
    _sync(dev)
    t0 = time.time()
    for _ in range(steps):
        key, sub = prng.split(key)
        starts = prng.randint(sub, batch, 0, split - W - Hz).to(dev).long()
        loss = forecaster_step(apply, params, series, starts, W, Hz, lr)
    last = float(loss)  # waits for the device
    train_s = time.time() - t0
    # eval on held-out suffix
    starts = np.arange(split, len(series) - W - Hz, Hz)
    idx = starts[:, None] + np.arange(W + Hz)[None, :]
    data = series.cpu().numpy()[idx]
    x, y = torch.from_numpy(data[:, :W]).to(dev), data[:, W:]
    with torch.no_grad():
        pred = apply(params, x).cpu().numpy()
    mae = float(np.mean(np.abs(pred - y)))
    mse = float(np.mean((pred - y) ** 2))
    mape = float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 0.5))) * 100
    return {"train_s": train_s, "MAE": mae, "MSE": mse, "MAPE": mape,
            "loss": last}


# ---------------------------------------------------------------------------
# Table 3 — 11 forecasting models, bare-metal vs Deep RC
# ---------------------------------------------------------------------------


def bench_forecasting(full: bool = False, *, steps=None, device=None) -> Dict[str, Any]:
    """``steps`` defaults to the JAX package's (400 full, else 60)."""
    dev = resolve_device(device)
    steps = steps or (400 if full else 60)
    results = {}
    agent = RemoteAgent(_manager(dev).submit_pilot(PilotDescription()),
                        max_workers=1)
    try:
        for name in F.MODELS:
            bm = _train_forecaster(name, steps, device=dev)
            t0 = time.time()
            task = _run_task(agent, name, lambda comm, nm=name:
                             _train_forecaster(nm, steps, device=dev))
            rc_total = time.time() - t0
            rc = task.result
            results[name] = {"bm": bm, "rc": rc, "rc_total_s": rc_total,
                             "overhead_s": rc_total - rc["train_s"],
                             "task_overheads": dict(task.overhead_s),
                             "state": task.state.value, "steps": steps}
    finally:
        agent.close()
    return results


# ---------------------------------------------------------------------------
# Tables 1-2 — hydrology LSTM: accuracy + overhead decomposition
# ---------------------------------------------------------------------------


def hydrology_step(params, x_all: torch.Tensor, y_all: torch.Tensor,
                   idx: torch.Tensor, lr: float = 3e-3) -> torch.Tensor:
    """One SGD step of the LSTM on the windows ``idx``; returns the loss
    before it."""
    loss = torch.mean((Hy.lstm_apply(params, x_all[idx]) - y_all[idx]) ** 2)
    sgd_(tree_leaves(params), loss, lr)
    return loss.detach()


def bench_hydrology(full: bool = False, *, steps=None, device=None) -> Dict[str, Any]:
    """``steps`` defaults to the JAX package's (2000 full, else 150)."""
    dev = resolve_device(device)
    steps = steps or (2000 if full else 150)
    window = 64
    feats, targets = Hy.make_camels_like(5000 if full else 2000, device=dev)
    x_all, y_all = Hy.window_dataset(feats, targets, window)
    n = x_all.shape[0]
    split = 3 * n // 4
    params = Hy.lstm_init(prng.PRNGKey(0), device=dev)

    def run_train(comm=None):
        p = _trainable(params)
        key = prng.PRNGKey(1)
        _sync(dev)
        t0 = time.time()
        for _ in range(steps):
            key, sub = prng.split(key)
            idx = prng.randint(sub, 64, 0, split).to(dev).long()
            loss = hydrology_step(p, x_all, y_all, idx)
        float(loss)  # waits for the device
        return p, time.time() - t0

    # bare metal
    p_bm, bm_s = run_train()
    # Deep RC
    agent = RemoteAgent(_manager(dev).submit_pilot(PilotDescription()),
                        max_workers=1)
    try:
        t0 = time.time()
        task = _run_task(agent, "hydrology", run_train)
        rc_total = time.time() - t0
    finally:
        agent.close()
    _, rc_train_s = task.result
    overhead = rc_total - rc_train_s

    # Table-1 metrics per target
    with torch.no_grad():
        pred_tr = Hy.lstm_apply(p_bm, x_all[:split])
        pred_va = Hy.lstm_apply(p_bm, x_all[split:])
    y_tr, y_va = y_all[:split], y_all[split:]
    metrics = {}
    for i, t in enumerate(Hy.TARGETS):
        metrics[t] = {
            "train_mse": float(torch.mean((pred_tr[:, i] - y_tr[:, i]) ** 2)),
            "val_mse": float(torch.mean((pred_va[:, i] - y_va[:, i]) ** 2)),
            "train_nnse": float(Hy.nnse(pred_tr[:, i], y_tr[:, i])),
            "val_nnse": float(Hy.nnse(pred_va[:, i], y_va[:, i])),
        }
    return {"bm_train_s": bm_s, "rc_train_s": rc_train_s,
            "rc_total_s": rc_total, "overhead_s": overhead,
            "task_overheads": dict(task.overhead_s), "state": task.state.value,
            "steps": steps, "days": int(feats.shape[0]), "metrics": metrics}


# ---------------------------------------------------------------------------
# Fig 4 — sort/join strong+weak scaling
# ---------------------------------------------------------------------------


SCALING_SHARDS = (1, 2, 4, 8)


def scaling_tables(rows: int, shards: int, device):
    """The JAX benchmark's two tables on a mesh of ``shards`` logical
    shards: ``rows`` keys uniform in [0, rows) with normal values (numpy
    seed 0), and a right table of keys 0 .. rows/2 - 1 with weight 1."""
    mesh = make_mesh((shards,), ("data",), device=device)
    rng = np.random.default_rng(0)
    t = Table.from_columns({"k": rng.integers(0, rows, rows).astype(np.int32),
                            "v": rng.normal(size=rows).astype(np.float32)}, mesh)
    r = Table.from_columns({"k": np.arange(rows // 2).astype(np.int32),
                            "w": np.ones(rows // 2, np.float32)}, mesh)
    return t, r


def scaling_op(op: str, t: Table, r: Table):
    """``(result table, dropped rows)`` of Fig. 4's ``op``."""
    return D.sort(t, "k") if op == "sort" else D.join(t, r, "k")


def bench_scaling_ops(full: bool = False, *, device=None) -> Dict[str, Any]:
    """Fig. 4 in one process (torch needs no environment set before its
    import, so every mesh width runs here): for each of 1, 2, 4 and 8
    logical shards, ``sort`` and ``join`` on 40,000 rows (200,000 with
    ``full``; strong scaling) and on that over 4 times the shards (weak
    scaling), each run once to warm up and once timed, synchronized:
    seconds, rows out and rows dropped."""
    dev = resolve_device(device)
    base_rows = 200_000 if full else 40_000
    results: Dict[str, Any] = {"strong": {}, "weak": {}}
    for mode in ("strong", "weak"):
        for w in SCALING_SHARDS:
            rows = base_rows if mode == "strong" else base_rows // 4 * w
            t, r = scaling_tables(rows, w, dev)
            per_op = {}
            for op in ("sort", "join"):
                scaling_op(op, t, r)  # warm-up: allocator, cuBLAS, libraries
                _sync(dev)
                t0 = time.time()
                res, dropped = scaling_op(op, t, r)
                _sync(dev)
                per_op[op] = {"s": time.time() - t0, "rows": rows,
                              "rows_out": int(res.valid.sum()), "dropped": int(dropped)}
            results[mode][w] = per_op
    results["meta"] = {"device": str(dev), "base_rows": base_rows,
                       "shards": list(SCALING_SHARDS),
                       "scales": "logical shards of one device"}
    return results


# ---------------------------------------------------------------------------
# Table 4 — multi-pipeline: shared pilot vs bare-metal sequential
# ---------------------------------------------------------------------------


def bench_multi_pipeline(full: bool = False, *, device=None) -> Dict[str, Any]:
    """Each inference task runs 10 forward passes, at either size (the
    JAX package's ``steps`` here is unused)."""
    dev = resolve_device(device)
    n_pipelines = 11
    names = list(F.MODELS)[:n_pipelines]

    def infer_fn(comm, upstream, nm):
        # inference task: forward pass over a fresh batch, many repeats
        init, apply = F.MODELS[nm](96, 24)
        params = init(prng.PRNGKey(0), dev)
        x = torch.zeros((256, 96), device=dev)
        with torch.no_grad():
            apply(params, x)
            _sync(dev)
            t0 = time.time()
            for _ in range(10):
                y = apply(params, x)
            _sync(dev)
        if not bool(torch.isfinite(y).all()):
            raise FloatingPointError(f"{nm}: non-finite inference output")
        return time.time() - t0

    def cylon_fn(comm, upstream):
        rng = np.random.default_rng(0)
        n = 20_000
        t = Table.from_columns({"k": rng.integers(0, n, n).astype(np.int32),
                                "v": rng.normal(size=n).astype(np.float32)},
                               device=dev)
        cols, valid = L.sort_by_key(t.columns, t.valid, "k")
        return float(torch.where(valid, cols["v"], 0).sum())

    # bare metal: run everything sequentially, re-"acquiring" per pipeline
    t0 = time.time()
    for nm in names:
        cylon_fn(None, None)
        infer_fn(None, None, nm)
    bm_s = time.time() - t0

    # Deep RC: one pilot, one shared data-eng task + N overlapped inference
    pipes = []
    for nm in names:
        pipes.append(Pipeline(f"pipe-{nm}", [
            cylon_stage("join", cylon_fn),
            dl_stage("infer", lambda c, u, nm=nm: infer_fn(c, u, nm),
                     deps=("join",), kind="inference"),
        ]))
    pilot = _manager(dev).submit_pilot(PilotDescription())
    t0 = time.time()
    out = run_pipelines(pipes, pilot=pilot, max_workers=4)
    rc_s = time.time() - t0
    failures = {p.name: out[p.name]["_error"] for p in pipes
                if "_error" in out[p.name]}
    if failures:  # fault isolation records failures; a benchmark must not
        # publish a speedup computed from pipelines that never ran
        raise RuntimeError(f"multi_pipeline: {len(failures)} pipeline(s) "
                           f"failed: {failures}")
    states = {f"{p.name}/{s}": t.state.value for p in pipes
              for s, t in p.tasks.items()}
    return {"bm_s": bm_s, "rc_s": rc_s, "saved_s": bm_s - rc_s,
            "n_pipelines": n_pipelines, "task_states": states,
            "meta": {k: out["_meta"][k] for k in
                     ("wall_s", "queue_s", "communicator_s", "task_busy_s",
                      "overlap_factor", "n_tasks", "n_failed")}}

