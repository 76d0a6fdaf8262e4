"""Resilience layer: deterministic fault injection + unified failure policy
(mirror of ``repro.core.resilience``).

* :mod:`repro_torch.core.resilience.faults` — seeded :class:`FaultPlan` /
  :class:`FaultInjector` with injection sites in the checkpoint store, the
  ServeEngine's step and the fleet router's KV-handoff delivery, so every
  failure mode the runtime claims to survive is reproducible in-process
  from a single seed.
* :mod:`repro_torch.core.resilience.policy` — :class:`FailurePolicy`
  (exponential backoff + deterministic jitter, retry budgets, per-attempt
  timeouts, end-to-end deadlines) honored by the agent's retry loop and
  the router's per-engine :class:`CircuitBreaker`.
"""
from repro_torch.core.resilience.faults import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active,
    inject,
    install_from_env,
    set_fault_injector,
)
from repro_torch.core.resilience.policy import CircuitBreaker, FailurePolicy

__all__ = [
    "CircuitBreaker", "FailurePolicy", "FaultInjector", "FaultPlan",
    "FaultSpec", "InjectedFault", "active", "inject", "install_from_env",
    "set_fault_injector",
]
