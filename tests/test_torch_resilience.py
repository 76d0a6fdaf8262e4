"""Port parity for the resilience layer (``repro_torch.core.resilience``),
mirroring tests/test_resilience.py on the CPU: the FailurePolicy's
deterministic backoff (equal to the JAX package's schedule), the retry
budget and deadline arithmetic, the circuit breaker's state machine, the
seeded FaultPlan (its JSON equal to the JAX package's) and its
reproducible trace, a torn checkpoint that restores the prior step
bitwise through the port's store, the fleet's breaker cycle (crash,
eject, probe, re-admit: zero requests lost or duplicated, fp32 greedy
streams token for token those of one JAX engine on the same weights, the
same fault trace twice), a failed KV-handoff delivery re-routed and not
lost, a deadline that fails a task cleanly, and
``Request.reset_for_retry``.

The JAX suite's worker-respawn test (``SubprocessTransport`` respawning
a crashed worker with policy-driven backoff) waits for the port's
cross-process transport, ``core/exec/`` (ROADMAP.md queue 1, item 6)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.params import init_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.resilience import FailurePolicy as JPolicy  # noqa: E402
from repro.core.resilience import FaultPlan as JPlan  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.train.state import model_specs  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.params import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.agent import RemoteAgent  # noqa: E402
from repro_torch.core.pilot import Pilot  # noqa: E402
from repro_torch.core.resilience import (CircuitBreaker, FailurePolicy,  # noqa: E402
                                         FaultPlan, inject, set_fault_injector)
from repro_torch.core.task import TaskDescription, TaskState  # noqa: E402
from repro_torch.serve import Request, RequestState, build_fleet  # noqa: E402

JCFG32 = dataclasses.replace(jget("tinyllama-1.1b", smoke=True), compute_dtype=jnp.float32)
CFG = tget("tinyllama-1.1b", smoke=True)
CFG32 = CFG.with_overrides(compute_dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = init_params(jax.random.PRNGKey(0), model_specs(JCFG32))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# FailurePolicy: deterministic backoff, retry budget, deadlines
# ---------------------------------------------------------------------------


def test_backoff_deterministic_and_bounded():
    pol = FailurePolicy(backoff_base_s=0.5, backoff_factor=2.0,
                        backoff_max_s=3.0, jitter=0.1)
    assert pol.backoff_s(1, key="t1") == pol.backoff_s(1, key="t1")
    assert pol.backoff_s(2, key="t1") == pol.backoff_s(2, key="t1")
    assert pol.backoff_s(1, key="t1") != pol.backoff_s(1, key="t2")
    for attempt, base in ((1, 0.5), (2, 1.0), (3, 2.0)):
        d = pol.backoff_s(attempt, key="k")
        assert base <= d <= base * 1.1 + 1e-9, (attempt, d)
    assert pol.backoff_s(9, key="k") <= 3.0 * 1.1 + 1e-9
    # the JAX package's schedule, delay for delay
    jpol = JPolicy(backoff_base_s=0.5, backoff_factor=2.0, backoff_max_s=3.0,
                   jitter=0.1)
    for attempt in range(1, 10):
        for key in ("", "t1", "worker-3"):
            assert pol.backoff_s(attempt, key=key) == jpol.backoff_s(attempt, key=key)


def test_retry_budget_and_deadline_arithmetic():
    pol = FailurePolicy(max_retries=2, deadline_s=10.0)
    assert pol.allow_retry(1) and pol.allow_retry(2)
    assert not pol.allow_retry(3)
    assert pol.deadline_at(100.0) == 110.0
    assert FailurePolicy(deadline_s=None).deadline_at(100.0) is None
    assert FailurePolicy.from_retries(5) == FailurePolicy(max_retries=5)


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(eject_after=2, probation_s=0.05)
    assert br.state == "closed"
    assert not br.record_fault()
    assert br.record_fault()
    assert br.state == "open"
    assert not br.admit()
    time.sleep(0.06)
    assert br.admit()
    assert br.state == "half_open"
    assert not br.admit()
    br.record_fault()
    assert br.state == "open"
    time.sleep(0.06)
    assert br.admit()
    br.record_success()
    assert br.state == "closed"
    assert br.snapshot()["consecutive_faults"] == 0
    assert [state for state, _ in br.transitions] == \
        ["open", "half_open", "open", "half_open", "closed"]


# ---------------------------------------------------------------------------
# FaultPlan: seeded, serializable, reproducible trace
# ---------------------------------------------------------------------------


def _plans():
    def build(cls):
        return (cls(seed=5).crash_worker(worker=1, at_task=2).drop_reply(nth=3)
                .tear_checkpoint(at_byte=64, step=7).fail_handoff(nth=2)
                .crash_engine(engine="e0", at_step=4)
                .stall_heartbeat(0.5, worker=0).delay_reply(0.25, nth=2))
    return build(FaultPlan), build(JPlan)


def test_fault_plan_roundtrip_and_injector_determinism():
    plan, jplan = _plans()
    assert FaultPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    # the same JSON as the JAX package's plan: either side can arm the other
    assert plan.to_json() == jplan.to_json()
    assert FaultPlan.from_json(jplan.to_json()).to_json() == jplan.to_json()
    plan = (FaultPlan(seed=5).crash_worker(worker=1, at_task=2).drop_reply(nth=3)
            .tear_checkpoint(at_byte=64, step=7))

    def drive(inj):
        fired = []
        for task in range(1, 4):
            for worker in range(2):
                fired.append(inj.fire("transport.dispatch", worker=worker, task=task))
        for n in range(4):
            fired.append(inj.fire("protocol.recv", mtype="result", frame=n))
        fired.append(inj.fire("checkpoint.save", step=7))
        return fired

    a, b = plan.injector(), plan.injector()
    assert drive(a) == drive(b)
    assert a.trace() == b.trace()
    assert a.all_fired() and not a.pending()
    assert [(e[1], e[2]) for e in a.trace()] == [
        ("transport.dispatch", "crash_worker"),
        ("protocol.recv", "drop"),
        ("checkpoint.save", "tear"),
    ]


def test_install_from_env_arms_the_plan():
    from repro_torch.core.resilience import faults

    plan = FaultPlan(seed=1).fail_handoff(nth=1)
    try:
        inj = faults.install_from_env({faults.PLAN_ENV: plan.to_json()})
        assert faults.active() is inj and inj.plan.to_json() == plan.to_json()
    finally:
        set_fault_injector(None)
    assert faults.install_from_env({}) is None and faults.active() is None


# ---------------------------------------------------------------------------
# crash-consistent checkpoints: torn write -> prior step restored bitwise
# ---------------------------------------------------------------------------


def test_torn_checkpoint_restores_prior_step_bitwise(tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(3)
    state1 = {"w": torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)),
              "step": torch.tensor(1)}
    state2 = {"w": torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)),
              "step": torch.tensor(2)}
    store.save(d, 1, state1)
    # a crash mid-write of step 2, after the rename made it visible
    with inject(FaultPlan(seed=0).tear_checkpoint(at_byte=48, step=2)) as inj:
        store.save(d, 2, state2)
        assert inj.all_fired()
    assert store.verify_step(d, 1)
    assert not store.verify_step(d, 2)
    assert store.latest_step(d, verify=False) == 2
    with pytest.warns(RuntimeWarning):
        assert store.latest_step(d, verify=True) == 1
    with pytest.raises(store.CheckpointCorrupt):
        store.restore(d, state1, step=2)
    with pytest.warns(RuntimeWarning):
        got = store.restore(d, state1)
    assert int(got["step"]) == 1
    assert torch.equal(got["w"], state1["w"])


# ---------------------------------------------------------------------------
# fleet chaos: breaker eject / probation / re-admit
# ---------------------------------------------------------------------------


def _chaos_fleet_run(tp, prompts, gen, plan):
    """One fleet run under the plan: engine flt.eng0 crashes mid-decode,
    is ejected (eject_after=1), probed after probation, re-admitted."""
    policy = FailurePolicy(eject_after=1, probation_s=0.2)
    router = build_fleet(CFG32, num_engines=2, params=tp, max_slots=2,
                         max_len=96, page_size=16, name_prefix="flt",
                         router_kwargs={"policy": policy}, device="cpu")
    inj = plan.injector()
    set_fault_injector(inj)
    try:
        with router:
            reqs = [router.submit(Request(p, max_new_tokens=gen)) for p in prompts]
            assert router.drain(timeout=300)
            # the probationary probe is a real request: feed tiny ones
            # until the ejected engine has been re-admitted
            rng = np.random.default_rng(123)
            deadline = time.time() + 30
            while time.time() < deadline:
                st = router.stats()
                if st.get("readmissions", 0) >= st.get("ejections", 0):
                    break
                router.submit(Request(rng.integers(1, CFG.vocab_size, 4).astype(np.int32),
                                      max_new_tokens=2))
                router.drain(timeout=60)
                time.sleep(0.02)
            stats = router.stats()
    finally:
        set_fault_injector(None)
    return reqs, stats, inj.trace()


def test_breaker_ejects_probes_and_readmits_bitwise(params):
    jp, tp = params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32)
               for n in (6, 9, 5, 8, 7, 10)]
    gen = 10
    # the undisturbed reference: one JAX engine, greedy, fp32
    eng = JEngine(JCFG32, params=jp, max_slots=2, max_len=96, page_size=16)
    ref = [eng.submit(JRequest(p, max_new_tokens=gen)) for p in prompts]
    eng.run_until_drained()

    def plan():
        return FaultPlan(seed=7).crash_engine(engine="flt.eng0", at_step=3)

    reqs, st, trace = _chaos_fleet_run(tp, prompts, gen, plan())
    # zero lost, zero duplicated: every request terminal once, with exactly
    # the requested number of tokens
    assert all(r.state is RequestState.DONE for r in reqs)
    assert [len(r.tokens) for r in reqs] == [gen] * len(reqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in ref]
    assert st["engine_crashes"] == 1
    assert st["ejections"] == 1 and st["readmissions"] == 1
    assert st["requests_recovered"] >= 1
    assert st["recoveries"] and st["recoveries"][0]["engine"] == "flt.eng0"
    assert st["recoveries"][0]["recovery_s"] > 0
    snap = st["breakers"]["flt.eng0"]
    assert snap["state"] == "closed"
    assert [state for state, _ in snap["transitions"]] == ["open", "half_open", "closed"]
    assert sum(e.get("recovered", 0) for e in st["engines"]) >= 1

    # same seed => same logical fault trace
    reqs2, _, trace2 = _chaos_fleet_run(tp, prompts, gen, plan())
    assert trace2 == trace
    assert [r.tokens for r in reqs2] == [r.tokens for r in ref]


def test_failed_handoff_delivery_is_rerouted_not_lost(params):
    """FaultPlan.fail_handoff: the second KV-page delivery fails; the
    router re-queues the handoff (its pages are on the host) and delivers
    it again, so every stream is still one JAX engine's."""
    jp, tp = params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, CFG.vocab_size, int(n)).astype(np.int32)
               for n in (5, 17, 23, 9)]
    eng = JEngine(JCFG32, params=jp, max_slots=2, max_len=64, page_size=16)
    ref = [eng.submit(JRequest(p, max_new_tokens=8)) for p in prompts]
    eng.run_until_drained()
    router = build_fleet(CFG32, num_engines=2, disaggregate=True, params=tp,
                         max_slots=4, max_len=64, page_size=16, name_prefix="hf",
                         device="cpu")
    with inject(FaultPlan(seed=3).fail_handoff(nth=2)) as inj:
        with router:
            reqs = [router.submit(Request(p, max_new_tokens=8)) for p in prompts]
            assert router.drain(timeout=180)
            st = router.stats()
        assert inj.all_fired()
    assert [r.tokens for r in reqs] == [r.tokens for r in ref]
    assert st["handoff_faults"] == 1
    assert st["handoffs_routed"] == st["fleet_handoffs_imported"] == len(prompts)
    assert st["fleet_handoffs_exported"] == len(prompts)


# ---------------------------------------------------------------------------
# deadline expiry: clean failure, devices recycled, quotas balanced
# ---------------------------------------------------------------------------


class _FakeDevice:
    def __init__(self, i):
        self.id = i
        self.type = "fake"


class _FakePilot(Pilot):
    """Pilot over stand-in devices; carve builds no communicator."""

    def carve(self, devices, mesh_shape=None, mesh_axes=("data",)):
        return SimpleNamespace(devices=tuple(devices), size=len(devices),
                               backend="fake", build_time_s=0.0)


def _always_fails(comm):
    raise ValueError("permanently broken task body")


def test_deadline_expiry_fails_cleanly_devices_recycled():
    pilot = _FakePilot("fake.4", [_FakeDevice(i) for i in range(4)])
    pol = FailurePolicy(max_retries=1000, backoff_base_s=0.05,
                        backoff_factor=1.0, jitter=0.0, deadline_s=0.6)
    with RemoteAgent(pilot, max_workers=2) as agent:
        agent.set_quota("grp", 2)
        t0 = time.time()
        (task,) = agent.submit([TaskDescription(
            name="doomed", fn=_always_fails, num_devices=2, group="grp",
            policy=pol)])
        assert task.state is TaskState.FAILED
        assert "deadline exceeded" in task.error
        assert 1 <= task.attempts < 1000
        assert time.time() - t0 < 30
        deadline = time.time() + 5
        while pilot.free_count() != 4 and time.time() < deadline:
            time.sleep(0.01)
        assert pilot.free_count() == 4
        assert agent.quota_violations() == {}


# ---------------------------------------------------------------------------
# Request.reset_for_retry: the engine-recovery primitive
# ---------------------------------------------------------------------------


def test_reset_for_retry_requeues_and_rejects_finished():
    r = Request(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    r.state = RequestState.RUNNING
    r.tokens = [3, 1]
    r.token_times = [0.1, 0.2]
    r.admitted_at = r.first_token_at = 1.0
    r.reset_for_retry()
    assert r.state is RequestState.QUEUED
    assert r.tokens == [] and r.token_times == []
    assert r.admitted_at is None and r.first_token_at is None
    assert not r.done()
    r._finish(RequestState.DONE)
    with pytest.raises(RuntimeError):
        r.reset_for_retry()
