"""End-to-end driver on the PyTorch port: train an assigned-architecture
LM through the full Deep RC pipeline (data engineering -> bridge -> train
loop -> async checkpoints -> postprocess), on the card unless
``--device cpu``.

Default is a quick smoke run of tinyllama-1.1b; a full-width run:
  PYTHONPATH=src python examples/train_lm_torch.py --no-smoke \
      --arch tinyllama-1.1b --steps 10 --batch 8 --seq 512
Restart after interruption with --resume.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import build_parser, run  # noqa: E402

if __name__ == "__main__":
    ap = build_parser()
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.set_defaults(smoke=True, steps=20, arch="tinyllama-1.1b")
    res = run(ap.parse_args())
    assert res["improved"], res
    print("train_lm_torch OK")
