"""Batched serving on the PyTorch port: a continuous-batching ServeEngine
as a service stage of the port's runtime, or a fleet of engines behind
its router (``--fleet N``, ``--disaggregate``), on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/serve_lm_torch.py --batch 4 --gen 16
  PYTHONPATH=src python examples/serve_lm_torch.py --fleet 2 --disaggregate
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import build_parser, run  # noqa: E402

if __name__ == "__main__":
    ap = build_parser()
    ap.set_defaults(smoke=True)
    res = run(ap.parse_args())
    print("serve_lm_torch OK")
