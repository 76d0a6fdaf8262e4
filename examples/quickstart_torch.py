"""Quickstart on the PyTorch port: the minimal Deep RC pipeline through
the Session API, on the card unless ``--device cpu``.

Synthetic table -> Cylon-analogue preprocess -> zero-copy Data Bridge ->
train a tiny linear model -> postprocess, written as a stage graph
(`@stage` + `>>`) and run under one Session; devices are recycled on exit.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Session, stage  # noqa: E402
from repro_torch.core.bridge import data_bridge  # noqa: E402
from repro_torch.core.pilot import PilotManager  # noqa: E402
from repro_torch.dataframe.table import Table  # noqa: E402
from repro_torch.launch.mesh import resolve_device  # noqa: E402


@stage(kind="data_engineering")
def preprocess(ctx):
    rng = np.random.default_rng(0)
    n = 4096
    x1, x2 = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
    y = 2.0 * x1 - x2 + 0.05 * rng.normal(size=n).astype(np.float32)
    return Table.from_columns({"x1": x1, "x2": x2, "y": y}, device=ctx.comm.device)


@stage(kind="train")
def train(ctx):
    loader = data_bridge(ctx.upstream["preprocess"], ["x1", "x2"], "y", 512)
    dev = ctx.comm.device
    w = torch.zeros(2, device=dev, requires_grad=True)
    b = torch.zeros((), device=dev, requires_grad=True)
    for epoch in range(20):
        for feats, labels, mask in loader.epoch(epoch):
            err = torch.where(mask, feats @ w + b - labels, 0.0)
            loss = (err ** 2).sum() / mask.sum().clamp(min=1)
            gw, gb = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                w -= 0.2 * gw
                b -= 0.2 * gb
    return {"w": w.detach().cpu().numpy(), "loss": float(loss)}


@stage(kind="inference")
def postprocess(ctx):
    r = ctx.dep("train")
    return {"w": r["w"].round(3).tolist(), "final_loss": r["loss"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    dev = resolve_device(ap.parse_args().device)
    manager = PilotManager(devices=[dev] if dev.type == "cpu" else None)
    with Session(manager=manager, max_workers_per_pilot=2) as session:
        pipe = session.start(preprocess >> train >> postprocess, name="quickstart")
        pipe.wait()
        if pipe.error is not None:
            raise RuntimeError(pipe.error)
        out = pipe.results
        print("result:", out["postprocess"])
        print("train-task overheads:", pipe.tasks["train"].overhead_s)
        print("placement:", pipe.stage_placements())
    assert out["postprocess"]["final_loss"] < 0.1
    assert session.manager.free_devices() == session.manager.total_devices, \
        "Session.close() must recycle the pilot's devices"
    print("quickstart_torch OK")
