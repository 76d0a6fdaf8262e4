"""Paper Tables 1-2 pipeline on the PyTorch port: the LSTM hydrology model
on synthetic CAMELS-like data through Deep RC, with the Table-2 overhead
decomposition surfaced from the scheduler's per-task accounting (queue /
communicator build / execute), on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/hydrology_pipeline_torch.py [--steps 150] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import Session, stage  # noqa: E402
from repro_torch.core.pilot import PilotManager  # noqa: E402
from repro_torch.launch.mesh import resolve_device  # noqa: E402
from repro_torch.launch.paper_tables import bench_hydrology  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="SGD steps of the LSTM (default: the paper table's 150)")
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    res = bench_hydrology(full=False, steps=args.steps, device=dev)
    print(f"{'hydrology bare-metal train':35s} {res['bm_train_s'] * 1e6:12.1f}us")
    print(f"{'hydrology Deep RC train':35s} {res['rc_train_s'] * 1e6:12.1f}us  "
          f"overhead {res['overhead_s'] * 1e6:.1f}us")
    for target, m in res["metrics"].items():
        print(f"  {target:20s} val_nnse={m['val_nnse']:.3f} val_mse={m['val_mse']:.4f}")

    # Table-2 decomposition through the async scheduler: a minimal
    # preprocess -> train DAG whose per-task overheads are recorded by the
    # agent.  Each stage's communicator records which pilot pool it was
    # carved from.
    pilots_seen = set()

    def note_pilot(c, v):
        pilots_seen.add(getattr(c, "pilot_uid", None))
        return v

    @stage(kind="data_engineering")
    def preprocess(ctx):
        return note_pilot(ctx.comm, 1.0)

    @stage(kind="train")
    def train(ctx):
        return note_pilot(ctx.comm, ctx.upstream["preprocess"] * 2)

    manager = PilotManager(devices=[dev] if dev.type == "cpu" else None)
    with Session(manager=manager) as session:
        # quota=1: hydro never holds more than 1 device at once
        pipe = session.start(preprocess >> train, name="hydro", quota=1)
        pipe.wait()
        if pipe.error is not None:
            raise RuntimeError(pipe.error)
        for stage_name, task in pipe.tasks.items():
            print(f"overhead/{stage_name:12s} "
                  f"queue={task.overhead_s['queue'] * 1e3:.2f}ms "
                  f"communicator={task.overhead_s['communicator'] * 1e3:.2f}ms "
                  f"execute={task.duration_s * 1e3:.2f}ms")
        print(f"pipeline wall={pipe.wall_s * 1e3:.1f}ms "
              f"placement={pipe.stage_placements()} carved_from={sorted(pilots_seen)}")
    assert res["state"] == "done", res["state"]
    print("hydrology pipeline_torch OK")
