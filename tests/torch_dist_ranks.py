"""Rank processes of the port's multi-process runs: ``launch`` starts
WORLD copies of this script, each one rank of a ``torch.distributed``
group that meets through a TCP store on 127.0.0.1 (held by the launching
process, on a port the OS picks), runs one scenario in each and returns
what each rank's scenario returned, in rank order.

    python tests/torch_dist_ranks.py SCENARIO RANK WORLD DIR STORE_PORT SPEC_JSON BACKEND

The CPU tests run the scenarios as gloo ranks on the CPU
(``tests/test_torch_distributed.py``, ``test_torch_sharding.py``,
``test_torch_dataframe.py``); ``chip_smoke.py``'s distributed phase runs
``card`` as 2 gloo ranks on the one card, and in its own process at world
1 on NCCL; its ``--cards`` mode runs ``card`` as 4 NCCL ranks, rank r on
card r (``launch(..., backend="nccl")``).  Every rank is reaped on every
exit path: a rank that fails stops the others.  This module imports no
jax.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.common.params import init_params, map_tree, tree_leaves  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.pipeline_par import pipeline_forward  # noqa: E402
from repro_torch.distributed.sharding import param_shardings_tree  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402

# the int8 cases of tests/test_torch_distributed.py: inputs [8, ...], one
# row per rank
INT8_CASES = ("g1024", "g1000", "g_2d", "scaled")
SYNC_STEPS = 8


def host_store(world: int):
    """A TCP store on 127.0.0.1 at a port the OS picks, for ``world``
    ranks to meet through (``store.port``)."""
    return dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False)


BACKENDS = ("gloo", "nccl")


def launch(scenario: str, world: int, workdir, *, spec=None, timeout: float = 120.0,
           threads: int = 1, backend: str = "gloo"):
    """Run ``scenario`` in ``world`` rank processes on ``backend`` and
    return each rank's result.  Under ``"nccl"`` rank r owns card r: it
    makes the card current before it joins the group, and its spec's
    ``device`` is ``cuda:r``; a machine with fewer cards than ranks is an
    error before any rank starts.  A rank that exits non-zero, or the
    deadline, kills the rest; the error carries the failed ranks' logs."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if cards < world:
            raise ValueError(f"NCCL ranks own a card each: {world} ranks need {world} "
                             f"cards, this machine has {cards}")
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = host_store(world)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join(filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
    argv = [scenario, "", str(world), str(workdir), str(store.port), "", backend]
    procs, logs = [], []
    try:
        for r in range(world):
            argv[1] = str(r)
            argv[5] = json.dumps(dict(spec or {}, device=f"cuda:{r}") if backend == "nccl"
                                 else spec or {})
            logs.append(open(workdir / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *argv],
                                          stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = {r: (workdir / f"rank{r}.log").read_text()[-2500:]
                 for r, c in enumerate(codes) if c}
        raise RuntimeError(f"{scenario}: rank exit codes {codes} (timeout {timeout} s)\n{tails}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def leaf_paths(tree, prefix: str = "") -> dict:
    """``{"a/b/0": leaf}`` of a tree of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaf_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# -- CPU scenarios: the port against JAX's results -------------------------------


def collectives(spec):
    """``int8_psum`` on each INT8_CASES row of this rank, averaged as JAX's
    test averages it; ``compressed_grad_sync`` of one tree for SYNC_STEPS
    syncs with and without error feedback, accumulated."""
    pm = make_process_mesh((dist.get_world_size(),), ("data",), device="cpu")
    with np.load(spec["npz"]) as f:
        data = dict(f)
    n = pm.shape["data"]
    out = {}
    for name in INT8_CASES:
        x = torch.from_numpy(data[f"int8/{name}/in"][pm.rank])
        out[f"int8/{name}"] = (C.int8_psum(x, pm, "data") / float(n)).numpy()
    grads = {k: torch.from_numpy(data[f"sync/{k}/in"]) for k in ("w", "m")}
    (acc_ef, acc_plain), ef = _syncs(grads, pm)
    for k in grads:
        out[f"sync/{k}/ef"] = acc_ef[k].numpy()
        out[f"sync/{k}/plain"] = acc_plain[k].numpy()
        out[f"sync/{k}/residual"] = ef[k].numpy()
    # each rank's own gradient, as data parallelism gives it (JAX's test
    # syncs one that every rank holds): both sums against the fp32 mean
    gen = torch.Generator().manual_seed(100 + pm.rank)
    own = {k: torch.randn(v.shape, generator=gen) * 0.01 for k, v in grads.items()}
    (acc_ef, acc_plain), ef = _syncs(own, pm)
    for k, g in own.items():
        true = _mean(g, pm.group("data"), n) * SYNC_STEPS
        out[f"own/{k}/ef_err"] = float(torch.linalg.norm(acc_ef[k] - true))
        out[f"own/{k}/plain_err"] = float(torch.linalg.norm(acc_plain[k] - true))
        # one step of the shared grid at most: a block's scale is the
        # largest |carried-in value| of any rank / 127, and what is carried
        # in is the gradient plus at most one step
        top = g.abs().max().reshape(1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=pm.group("data"))
        out[f"own/{k}/residual_max"] = float(ef[k].abs().max())
        out[f"own/{k}/grid_step"] = float(top) / 127 * (128 / 127)
    return out


def _syncs(grads, pm):
    """SYNC_STEPS syncs of ``grads`` along ``data`` with error feedback and
    as many without, each accumulated: (the two sums, the last residual)."""
    ef = None
    acc_ef = {k: torch.zeros_like(v) for k, v in grads.items()}
    acc_plain = {k: torch.zeros_like(v) for k, v in grads.items()}
    for _ in range(SYNC_STEPS):
        synced, ef = C.compressed_grad_sync(grads, pm, "data", error_feedback=ef)
        plain, _ = C.compressed_grad_sync(grads, pm, "data")
        acc_ef = {k: acc_ef[k] + synced[k] for k in grads}
        acc_plain = {k: acc_plain[k] + plain[k] for k in grads}
    return (acc_ef, acc_plain), ef


def pipeline(spec):
    """``pipeline_forward`` over the group's ranks on JAX's test inputs."""
    with np.load(spec["npz"]) as f:
        x, w = f["pipe/x"], f["pipe/w"]
    pm = make_process_mesh((dist.get_world_size(),), ("pipe",), device="cpu")
    y = pipeline_forward(lambda p, h: h * 2.0 + p, torch.from_numpy(w),
                         torch.from_numpy(x), pm, "pipe")
    return {"pipeline": y.numpy()}


def sharding(spec):
    """On a (data, model) mesh of the group's ranks, this rank's local
    shard of each parameter of a smoke config (seeded) under
    ``param_shardings_tree``'s placements."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.train.state import model_specs

    mesh = make_process_mesh(spec["shape"], ("data", "model"), device="cpu")
    specs = model_specs(get_config(spec["arch"], smoke=True))
    params = leaf_paths(init_params(torch.Generator().manual_seed(spec["seed"]), specs, "cpu"))
    places = leaf_paths(param_shardings_tree(specs, mesh.device_mesh))
    shards = {k: distribute_tensor(t, mesh.device_mesh, list(places[k])).to_local().numpy()
              for k, t in params.items()}
    return {"coords": mesh.coords, "shards": shards}


def dataframe_cases(spec):
    """Every case of ``tests/torch_df_cases.py`` on a process mesh of the
    group's ranks, this rank's shard of the rows."""
    from repro_torch.dataframe import ops_dist
    from repro_torch.dataframe.table import Table
    from torch_df_cases import CASES, run_ops

    pm = make_process_mesh((dist.get_world_size(),), ("data",), device="cpu")
    return {name: run_ops(pm, Table, ops_dist, name, shard=(pm.rank, pm.shape["data"]))
            for name in CASES}


# -- the card's distributed phase ------------------------------------------------


WIRE_OPS = ("all_to_all_single", "all_gather_into_tensor", "all_reduce", "send", "recv",
            "broadcast")
DF_OPS = ("shuffle", "sort", "join", "groupby", "reduce")


@contextlib.contextmanager
def recording_wire(seen: dict):
    """Note, for each ``torch.distributed`` op called inside, the backend,
    the world size and the device of the tensors it was handed."""
    real = {n: getattr(dist, n) for n in WIRE_OPS}

    def wrap(name, fn):
        def call(tensor, *args, **kw):
            group = kw.get("group")
            entry = {"backend": str(dist.get_backend(group)),
                     "world": dist.get_world_size(group), "device": str(tensor.device)}
            if entry not in seen.setdefault(name, []):
                seen[name].append(entry)
            return fn(tensor, *args, **kw)
        return call

    for n, fn in real.items():
        setattr(dist, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def _timed(fn, dev):
    """(fn(), ms on the host clock, synchronized on the card)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bits(t: torch.Tensor) -> int:
    """A checksum of a tensor's bits (equal tensors, equal sums)."""
    words = t.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(words.numel(), device=t.device) % 8191 + 1
    return int((words * weights).sum())


def _card_dataframe(spec, pm, dev):
    """The five operators on this rank's shard of a seeded table on the
    process mesh (keys in [0, ``df_keys``), the groupby's capacity a slot
    per key), against the same table on a logical mesh of as many
    shards in this process: per operator equal (columns, masks and drop
    counts bitwise, groupby sums within ``df_atol``, reduce within
    ``reduce_rtol``), the kernel 7 launches of the process-mesh run, both
    runs' ms."""
    from repro_torch.dataframe import ops_dist as D
    from repro_torch.dataframe.table import Table
    from repro_torch.kernels import hash_partition as hp
    from repro_torch.launch.mesh import make_mesh

    W, r = pm.shape["data"], pm.coords["data"]
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    n, nk = spec["df_rows"], spec["df_keys"]
    left = {"k": torch.randint(0, nk, (n,), generator=gen, device=dev, dtype=torch.int32),
            "v": torch.randn(n, generator=gen, device=dev)}
    rk = torch.arange(nk, device=dev, dtype=torch.int32)
    right = {"k": rk, "w": (10 * rk).float()}
    lmesh = make_mesh((W,), ("data",), device=dev)
    mine = lambda c: {k: v.reshape(W, -1)[r] for k, v in c.items()}  # noqa: E731
    tables = {"logical": (Table.from_columns(left, lmesh), Table.from_columns(right, lmesh)),
              "process": (Table.from_columns(mine(left), pm),
                          Table.from_columns(mine(right), pm))}

    def calls(t, rt):
        return {"shuffle": lambda: D.shuffle(t, "k"), "sort": lambda: D.sort(t, "k"),
                "join": lambda: D.join(t, rt, "k"),
                "groupby": lambda: D.groupby_sum(t, "k", ["v"], groups_cap_per_shard=nk),
                "reduce": lambda: (D.reduce_sum(t, ["v"]), 0)}

    out = {}
    for name in DF_OPS:
        runs = {}
        for kind, (t, rt) in tables.items():
            call = calls(t, rt)[name]
            call()  # warm-up: the allocator, the wire
            hp.hash_partition_histogram_kernel.launches = 0
            (res, dropped), ms = _timed(call, dev)
            runs[kind] = (res, int(dropped), ms, hp.hash_partition_histogram_kernel.launches)
        (pres, pdrop, pms, plaunch), (lres, ldrop, lms, _) = runs["process"], runs["logical"]
        row = {"ms_process": pms, "ms_logical": lms, "hash_launches": plaunch,
               "dropped": pdrop, "dropped_logical": ldrop}
        if name == "reduce":
            rel = abs(pres["v"] - lres["v"]) / abs(lres["v"])
            row.update(equal=rel <= spec["reduce_rtol"], reduce_rel_diff=rel)
        else:
            shard = lambda c: c.reshape((W, -1) + tuple(c.shape[1:]))[r]  # noqa: E731
            ok = pdrop == ldrop and pres.column_names == lres.column_names \
                and torch.equal(pres.valid, shard(lres.valid))
            diff = 0.0
            for col in pres.column_names:
                a, b = pres.col(col), shard(lres.col(col))
                if name == "groupby" and col == "v":
                    diff = float((a - b).abs().max())
                    ok = ok and diff <= spec["df_atol"]
                else:
                    ok = ok and torch.equal(a, b)
            row.update(equal=bool(ok), groupby_sum_max_abs_diff=diff,
                       valid_rows=int(pres.valid.sum()))
        out[name] = row
    return out


def _card_backward(spec, pm, dev):
    """One backward of a seeded model on this rank's own batch: (config,
    gradient tree, flash kernel launches of the backward's forward)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.state import model_specs
    from repro_torch.train.step import make_loss_fn

    cfg = get_config(spec["arch"], smoke=spec["smoke"])
    params = init_params(torch.Generator(device=dev).manual_seed(spec["seed"]),
                         model_specs(cfg), dev)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 1 + pm.rank)
    tok = torch.randint(0, cfg.vocab_size, (spec["grad_b"], spec["grad_s"]),
                        generator=gen, device=dev)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    n0 = fa.flash_attention_kernel.launches
    loss = make_loss_fn(cfg, RunConfig())(map_tree(lambda _: next(it), params),
                                          {"tokens": tok, "labels": torch.roll(tok, -1, 1)})
    it = iter(torch.autograd.grad(loss, leaves))
    grads = map_tree(lambda _: next(it), params)
    return cfg, grads, fa.flash_attention_kernel.launches - n0


def _mean(t, group, n):
    """The fp32 all-reduce mean of ``t`` over ``group``'s ``n`` ranks."""
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out / n


def _card_grads(spec, pm, cfg, grads, dev):
    """The gradient tree synced exactly (fp32 all_reduce, then / ranks) and
    with ``compressed_grad_sync``: ms, bytes handed to the all-reduces, the
    largest relative error of a leaf (max |int8 - exact| / max |exact|),
    a checksum of every synced leaf; then error feedback over ``ef_syncs``
    syncs against as many plain ones (JAX's check) on this rank's own
    embedding gradient, and on its mean (``replicated``).  At one rank,
    whether every collective was the identity."""
    W = pm.shape["data"]
    flat = tree_leaves(grads)
    group = pm.group("data")
    exact, fp32_ms = _timed(lambda: [_mean(g, group, W) for g in flat], dev)
    (synced, _), int8_ms = _timed(lambda: C.compressed_grad_sync(grads, pm, "data"), dev)
    synced = tree_leaves(synced)
    rel = max(float((s - e).abs().max() / e.abs().max()) for s, e in zip(synced, exact))
    out = {"layers": cfg.num_layers, "leaves": len(flat),
           "params": sum(g.numel() for g in flat),
           "fp32_ms": fp32_ms, "int8_ms": int8_ms,
           "fp32_bytes": sum(g.numel() * 4 for g in flat),
           "int8_bytes": sum(C.wire_bytes(g) for g in flat),
           "max_rel_err": rel, "checksums": [_bits(s) for s in synced]}
    if W == 1:
        out["identity"] = all(torch.equal(e, g) for e, g in zip(exact, flat)) and all(
            torch.equal(s, C._dequantize_int8(*C._quantize_int8(g.reshape(-1)))
                        .reshape(g.shape)) for s, g in zip(synced, flat))
    del exact, synced
    # error feedback on this rank's own embedding gradient, and on its
    # fp32 mean, which every rank holds (JAX's own check,
    # tests/spawn/distributed_extras.py, syncs such a gradient)
    out.update(_error_feedback(spec, pm, grads["embed"], dev))
    rep = _error_feedback(spec, pm, _mean(grads["embed"], group, W), dev)
    out["replicated"] = {"ef_err": rep["ef_err"], "plain_err": rep["plain_err"]}
    return out


def _error_feedback(spec, pm, grad, dev):
    """``ef_syncs`` syncs of ``grad`` along ``data`` with error feedback and
    as many plain ones, each accumulated, against ``ef_syncs`` x the fp32
    mean: both errors' norms, ms a sync with feedback."""
    W = pm.shape["data"]
    emb = {"embed": grad}
    true = _mean(grad, pm.group("data"), W) * spec["ef_syncs"]

    def feedback():
        ef, acc = None, torch.zeros_like(true)
        for _ in range(spec["ef_syncs"]):
            s_, ef = C.compressed_grad_sync(emb, pm, "data", error_feedback=ef)
            acc += s_["embed"]
        return acc

    acc_ef, ef_ms = _timed(feedback, dev)
    plain = C.compressed_grad_sync(emb, pm, "data")[0]["embed"]
    acc_plain = torch.zeros_like(true)
    for _ in range(spec["ef_syncs"]):  # the same sum each time, as JAX's loop adds it
        acc_plain += plain
    return {"ef_err": float(torch.linalg.norm(acc_ef - true)),
            "plain_err": float(torch.linalg.norm(acc_plain - true)),
            "ef_ms_per_sync": ef_ms / spec["ef_syncs"], "embed_elems": true.numel()}


def _card_pipeline(spec, pm, axis, dev):
    """GPipe over ``pm``'s ``axis`` on ``pipe_micro`` seeded microbatches of
    ``pipe_shape``, JAX's test stage ``x * 2 + w_i``: the largest relative
    difference from the sequential result, ms per microbatch."""
    S = pm.shape[axis]
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 100)
    x = torch.randn([spec["pipe_micro"], *spec["pipe_shape"]], generator=gen, device=dev)
    w = torch.arange(1.0, S + 1, device=dev)[:, None] * torch.ones(S, x.shape[-1], device=dev)

    def run():
        return pipeline_forward(lambda p, h: h * 2.0 + p, w, x, pm, axis)

    run()  # warm-up: the wire (NCCL makes a pair's communicator at its first send)
    y, ms = _timed(run, dev)
    want = x
    for i in range(S):
        want = want * 2.0 + w[i]
    return {"stages": S, "max_rel_diff": float((y - want).abs().max() / want.abs().max()),
            "ms": ms, "ms_per_microbatch": ms / spec["pipe_micro"],
            "bytes_per_message": x[0].numel() * 4}


def _card_grid(spec, grads, dev):
    """On a (data, pipe) mesh of the ranks (``spec["grid"]``), each axis a
    subgroup: the gradient tree's ``compressed_grad_sync`` along ``data``
    against the line's fp32 mean (the largest relative error of a leaf, a
    checksum of every synced leaf), and GPipe along ``pipe``."""
    pm = make_process_mesh(spec["grid"], ("data", "pipe"), device=dev)
    n = pm.shape["data"]
    flat = tree_leaves(grads)
    exact = [_mean(g, pm.group("data"), n) for g in flat]
    (synced, _), int8_ms = _timed(lambda: C.compressed_grad_sync(grads, pm, "data"), dev)
    synced = tree_leaves(synced)
    rel = max(float((s - e).abs().max() / e.abs().max()) for s, e in zip(synced, exact))
    return {"shape": dict(pm.shape), "coords": dict(pm.coords),
            "sync": {"max_rel_err": rel, "int8_ms": int8_ms,
                     "checksums": [_bits(s) for s in synced]},
            "pipeline": _card_pipeline(spec, pm, "pipe", dev)}


def _pci_bus_id(index: int):
    """Card ``index``'s PCI bus id from the CUDA driver API
    (``cuDeviceGetPCIBusId``, which numbers the cards as the runtime
    does), or None where it gives none."""
    cu = ctypes.CDLL("libcuda.so.1")
    card, buf = ctypes.c_int(), ctypes.create_string_buffer(64)
    if cu.cuInit(0) or cu.cuDeviceGet(ctypes.byref(card), index) \
            or cu.cuDeviceGetPCIBusId(buf, len(buf), card):
        return None
    return buf.value.decode()


def _card_id(dev) -> dict:
    """This rank's card: its name, UUID and PCI bus id."""
    if dev.type != "cuda":
        return {}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    props = torch.cuda.get_device_properties(index)
    return {"name": props.name, "uuid": str(props.uuid), "pci_bus_id": _pci_bus_id(index)}


def card(spec):
    """The card's checks on this rank: the dataframe, the gradient syncs,
    GPipe, and on ``spec["grid"]`` (a (data, pipe) shape) the grid's;
    which backend, world and tensor device each op ran on; this rank's
    card."""
    dev = torch.device(spec["device"])
    seen: dict = {}
    with recording_wire(seen):
        pm = make_process_mesh((dist.get_world_size(),), ("data",), device=dev)
        out = {"rank": pm.rank, "world": pm.shape["data"], "backend": pm.backend,
               "device": str(dev), "card": _card_id(dev)}
        out["dataframe"] = _card_dataframe(spec, pm, dev)
        cfg, grads, out["flash_launches"] = _card_backward(spec, pm, dev)
        out["grads"] = _card_grads(spec, pm, cfg, grads, dev)
        out["pipeline"] = _card_pipeline(
            spec, make_process_mesh((pm.shape["data"],), ("pipe",), device=dev), "pipe", dev)
        if spec.get("grid"):
            out["grid"] = _card_grid(spec, grads, dev)
        del grads
        if pm.shape["data"] == 1:  # each collective the identity on its own
            x = torch.randn(4096, generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            g = torch.empty_like(x)
            dist.all_gather_into_tensor(g, x)
            z = x.clone()
            dist.all_reduce(z)
            b = x.clone()
            dist.broadcast(b, 0)
            out["identity"] = all(torch.equal(t, x) for t in (y, g, z, b))
    out["wire"] = seen
    return out


SCENARIOS = {"collectives": collectives, "pipeline": pipeline, "sharding": sharding,
             "dataframe_cases": dataframe_cases, "card": card}


def main(argv) -> int:
    scenario, rank, world, workdir, port, spec, backend = argv
    spec = json.loads(spec)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    if backend == "nccl":  # this rank's card, current before the group exists
        torch.cuda.set_device(torch.device(spec["device"]))
    store = dist.TCPStore("127.0.0.1", int(port), int(world), is_master=False)
    dist.init_process_group(backend, store=store, rank=int(rank), world_size=int(world))
    try:
        out = SCENARIOS[scenario](spec)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
