"""Static-analysis toolkit for the port's runtime (mirror of
``repro.analysis``).

Passes producing :class:`Finding` records that the CLI (``python -m
repro_torch.analysis``) diffs against a checked-in baseline
(``analysis-baseline-torch.json``; ``analysis-baseline.json`` is the JAX
package's):

- ``locks``    — AST lock-discipline checker driven by ``# guarded-by:``
  declarations on shared attributes (:mod:`repro_torch.analysis.locks`),
  paired with a runtime lock-order recorder for tests
  (:mod:`repro_torch.analysis.lockorder`).
- ``jit``      — host syncs and Python branches on tensor values in
  everything a step reaches, from a declared table of the counterparts
  of JAX's jit roots (:mod:`repro_torch.analysis.host_sync`, the twin of
  JAX's ``jit_boundary``).
- ``kernels``  — the serving steps run on meta tensors across the config
  matrix and both KV layouts, and the kernels' head dims and grids
  checked statically, no accelerator required
  (:mod:`repro_torch.analysis.kernel_contracts`).
- ``excepts``  — rejects broad ``except Exception`` handlers outside
  ``# noqa: BLE001``-annotated isolation boundaries
  (:mod:`repro_torch.analysis.excepts`).
- ``pickles``  — nested ``@stage`` functions and lambda task bodies, which
  cannot cross a subprocess transport (:mod:`repro_torch.analysis.pickles`).
- ``timeouts`` — blocking calls without a timeout
  (:mod:`repro_torch.analysis.timeouts`).
"""
from repro_torch.analysis.findings import Finding, load_baseline, write_baseline

__all__ = ["Finding", "load_baseline", "write_baseline"]
