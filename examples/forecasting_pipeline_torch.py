"""Paper Table-3 pipeline on the PyTorch port: NeuralForecast-analogue
models trained and evaluated through Deep RC as N *concurrent* stage
graphs batched under one Session (the Table-4 mode), on the card unless
``--device cpu``.

``--pilots 2`` splits the pool into disjoint per-pod pilots (on the CPU,
logical devices of the one CPU) and the Session's per-stage placement
spreads the model stages across them; ``--quota N`` caps each pipeline's
concurrent device share.

  PYTHONPATH=src python examples/forecasting_pipeline_torch.py \
      [--models NLinear,GRU] [--steps 60] [--pilots 2] [--quota 1] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import Session, StageGraph, stage  # noqa: E402
from repro_torch.core.pilot import PilotManager  # noqa: E402
from repro_torch.launch import paper_tables as P  # noqa: E402
from repro_torch.launch.mesh import resolve_device  # noqa: E402
from repro_torch.models import forecasting as F  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(list(F.MODELS)[:3]))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--pilots", type=int, default=1,
                    help="number of disjoint pods to spread pipelines over")
    ap.add_argument("--quota", type=int, default=None,
                    help="per-pipeline concurrent-device cap")
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    args = ap.parse_args()
    names = args.models.split(",")
    dev = resolve_device(args.device)

    @stage(kind="train", name="train")
    def train_model(ctx, model_name, steps):
        return P._train_forecaster(model_name, steps, device=ctx.comm.device)

    # one single-stage graph per model, compiled to a pipeline named after
    # the model so results stay keyed the way Table 3 reports them
    pipes = [StageGraph([train_model.bind(nm, args.steps)]).compile(nm, quota=args.quota)
             for nm in names]
    # the CPU's pool: 4 logical devices, as JAX's example forces 4 host devices
    manager = PilotManager(devices=[dev] * 4 if dev.type == "cpu" else None)
    with Session(manager=manager, pods=args.pilots if args.pilots > 1 else None,
                 max_workers_per_pilot=4) as session:
        out = session.run_all(pipes)
    meta = out["_meta"]
    failed = False
    for name in names:
        if "_error" in out[name]:  # fault isolation: siblings still report
            failed = True
            print(f"{name:20s} FAILED: {out[name]['_error'].splitlines()[0]}")
            continue
        r = out[name]["train"]
        print(f"{name:20s} MAE={r['MAE']:.3f} MSE={r['MSE']:.3f} "
              f"MAPE={r['MAPE']:.2f}% train={r['train_s']:.1f}s")
    print(f"batch wall={meta['wall_s']:.1f}s task_busy={meta['task_busy_s']:.1f}s "
          f"overlap_factor={meta['overlap_factor']:.2f}")
    if args.pilots > 1:
        print("placement:", meta["placement"])
        if meta["quota_violations"]:
            sys.exit(f"quota violations: {meta['quota_violations']}")
    if failed:
        sys.exit("forecasting pipeline had failures (see above)")
    print("forecasting pipeline_torch OK")
