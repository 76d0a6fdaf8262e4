"""Fault-tolerance demo on the PyTorch port: a training stage that fails
mid-run is retried by the runtime and resumes from the last checkpoint,
through the Session API (the stage declares ``checkpoint=`` and reads
``ctx.resume_step``; Session.close() recycles the surviving devices).  On
the card unless ``--device cpu``.

The stage runs at the pool's width: 8 logical devices of the one CPU, or
every card.  On several cards it is a gang of worker processes, one a
card (``transport="subprocess"``).  Where JAX's demo loses 2 of its 8
host devices, the port's first attempt fails without losing a device: the
CPU pool lists one device 8 times (a lost id would take all of them), a
failure inside a worker is a plain task failure, and one card has no
survivor.  The retry runs at the same width.

  PYTHONPATH=src python examples/fault_tolerant_train_torch.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core import Session, stage  # noqa: E402
from repro_torch.core.pilot import PilotManager  # noqa: E402
from repro_torch.launch.mesh import resolve_device  # noqa: E402

STEPS, FAIL_AT = 10, 4


@stage(kind="train", max_retries=2)
def train(ctx, ckpt):
    # checkpoint-aware retry: the agent reads the last completed step from
    # the checkpoint dir and hands it in as ctx.resume_step on every
    # retried attempt; in a gang every rank computes, rank 0 writes
    dev = ctx.comm.device
    writer = ctx.comm.rank in (None, 0)
    state = {"w": torch.zeros(4, device=dev), "step": torch.zeros((), device=dev)}
    start = 0
    if ctx.resume_step is not None:
        state = store.restore(ckpt, state, step=ctx.resume_step)
        start = int(state["step"])
        print(f"  agent handed resume_step={ctx.resume_step}; resuming at {start}")
    for i in range(start, STEPS):
        state = {"w": state["w"] + 1.0, "step": state["step"] + 1}
        if writer:
            store.save(ckpt, i + 1, state)
        if i == FAIL_AT and start == 0 and writer:  # the first attempt dies mid-run
            raise RuntimeError("injected mid-training failure")
    return {"final_w": float(state["w"][0]), "steps": int(state["step"]),
            "width": ctx.comm.size, "backend": ctx.comm.backend}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="deep_rc_ft_")
    shutil.rmtree(ckpt, ignore_errors=True)
    if dev.type == "cpu":
        manager, opts = PilotManager(devices=[dev] * 8), {}
    else:
        manager = PilotManager()
        # several cards: a gang of one worker a card; its stage fn pickles
        # by this module's importable name
        import fault_tolerant_train_torch as me
        train = me.train
        opts = ({"transport": "subprocess",
                 "transport_options": {"worker_devices": 1}}
                if manager.total_devices > 1 else {})
    n_dev = manager.total_devices
    with Session(manager=manager, max_workers_per_pilot=2, **opts) as session:
        # non-blocking submission: start() returns before the stage runs;
        # the stage's width is the pool's (num_devices=n_dev)
        pipe = session.start(train.options(num_devices=n_dev, checkpoint=ckpt)
                             .bind(ckpt), name="ft")
        print("submitted (non-blocking), finished:", pipe.finished)
        pipe.wait()
        task = pipe.tasks["train"]
        print("state:", task.state.value, "result:", task.result,
              "attempts:", task.attempts)
        pilot, = session.pilots
        alive = len(pilot.alive_devices())
        print("alive devices after failure:", alive, "/", pilot.size)
        assert task.result["steps"] == STEPS and task.attempts == 2, task.error
        assert task.result["width"] == n_dev
    # close() recycled the devices back to the manager's pool
    assert session.manager.free_devices() == alive == n_dev
    shutil.rmtree(ckpt, ignore_errors=True)
    print("fault_tolerant_train_torch OK (devices recycled:",
          session.manager.free_devices(), "of", n_dev, ")")
