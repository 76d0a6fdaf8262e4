"""The port's multi-pilot placement layer (``repro_torch.core``), test for
test the mirror of tests/test_placement.py: disjoint pilot pools,
capacity/kind placement, migration on pilot degradation, per-pipeline
device quotas, the pluggable task transport, and checkpoint-aware retry
(through the port's checkpoint store, numpy leaves only).

Like tests/test_torch_runtime.py, scheduling logic runs on FakePilots over
plain-object devices (carve skips the port's Mesh).

Left out: ``test_cross_node_transport_is_explicitly_unavailable``, a test
of the JAX package's ``JaxDistributedTransport``, which comes with the
port's ``core/exec/`` (ROADMAP.md queue 1, item 6); in its place,
``test_cross_process_transports_raise_naming_their_item``.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.checkpoint import store
from repro_torch.core.agent import RemoteAgent
from repro_torch.core.pilot import Pilot, PilotDescription, PilotManager
from repro_torch.core.pipeline import (MultiPilotScheduler, Pipeline,
                                 PipelineScheduler, Stage)
from repro_torch.core.task import TaskDescription, TaskState
from repro_torch.core.transport import InProcessTransport, Transport, make_transport


class FakeDevice:
    def __init__(self, i):
        self.id = i
        self.platform = "cpu"


class FakePilot(Pilot):
    """Pilot over dummy devices; carve returns a mesh-free communicator."""

    def carve(self, devices, mesh_shape=None, mesh_axes=("data",)):
        return SimpleNamespace(devices=tuple(devices), size=len(devices),
                               backend="fake", build_time_s=0.0,
                               pilot_uid=self.uid)


def make_manager(n):
    return PilotManager(devices=[FakeDevice(i) for i in range(n)],
                        pilot_factory=FakePilot)


def device_ids(pilot):
    return {d.id for d in pilot.alive_devices()}


# ---------------------------------------------------------------------------
# PilotManager: disjoint pools
# ---------------------------------------------------------------------------


def test_pilots_own_disjoint_pools():
    pm = make_manager(8)
    a = pm.submit_pilot(PilotDescription(num_devices=4, name="a"))
    b = pm.submit_pilot(PilotDescription(num_devices=4, name="b"))
    assert not device_ids(a) & device_ids(b), "pools overlap (seed bug)"
    assert device_ids(a) | device_ids(b) == set(range(8))


def test_submit_raises_when_machine_exhausted():
    pm = make_manager(4)
    pm.submit_pilot(PilotDescription(num_devices=4))
    with pytest.raises(RuntimeError, match="free"):
        pm.submit_pilot(PilotDescription(num_devices=1))


def test_default_pilot_takes_remaining_devices():
    pm = make_manager(8)
    pm.submit_pilot(PilotDescription(num_devices=3))
    rest = pm.submit_pilot(PilotDescription())  # -1 = all still free
    assert rest.size == 5
    with pytest.raises(RuntimeError):
        pm.submit_pilot(PilotDescription())


def test_cancel_pilot_recovers_alive_devices_only():
    pm = make_manager(4)
    a = pm.submit_pilot(PilotDescription(num_devices=4))
    a.mark_failed([0])  # one device dies while the pilot holds the pool
    assert pm.cancel_pilot(a) == 3
    with pytest.raises(RuntimeError):
        pm.submit_pilot(PilotDescription(num_devices=4))
    b = pm.submit_pilot(PilotDescription(num_devices=3))
    assert 0 not in device_ids(b), "failed device re-entered the pool"


def test_cancel_pilot_refuses_while_leased():
    pm = make_manager(2)
    a = pm.submit_pilot(PilotDescription(num_devices=2))
    assert a.lease(1, "t") is not None
    with pytest.raises(RuntimeError, match="leased"):
        pm.cancel_pilot(a)  # recycling a running device would alias pools
    a.release("t")
    assert pm.cancel_pilot(a) == 2


# ---------------------------------------------------------------------------
# PilotManager: placement
# ---------------------------------------------------------------------------


def test_place_picks_most_free_capacity():
    pm = make_manager(8)
    a = pm.submit_pilot(PilotDescription(num_devices=4, name="a"))
    b = pm.submit_pilot(PilotDescription(num_devices=4, name="b"))
    assert a.lease(2, "occupier") is not None
    assert pm.place(num_devices=1) is b
    # the load overlay models capacity already promised but not leased
    assert pm.place(num_devices=1, load={b.uid: 3}) is a


def test_place_respects_kind_and_mesh_requirement():
    pm = make_manager(8)
    de = pm.submit_pilot(PilotDescription(
        num_devices=4, name="de-pod", task_kinds=("data_engineering",)))
    any_ = pm.submit_pilot(PilotDescription(num_devices=4, name="any"))
    assert pm.place(kinds={"train"}) is any_
    assert pm.place(kinds={"data_engineering"}, load={any_.uid: 0}) in (de, any_)
    de.lease(4, "busy")  # kind-pilot full: still placeable (alive, not free)
    assert pm.place(num_devices=5) is None, "no pilot has 5 alive devices"
    assert pm.place(kinds={"train"}, exclude=(any_,)) is None


# ---------------------------------------------------------------------------
# MultiPilotScheduler: spread, migration, unplaceable
# ---------------------------------------------------------------------------


def _sleep_pipeline(name, sleep_s=0.0, quota=None):
    def first(comm, upstream):
        time.sleep(sleep_s)
        return comm.pilot_uid

    def second(comm, upstream):
        time.sleep(sleep_s)
        return upstream["first"]

    return Pipeline(name, [
        Stage("first", first),
        Stage("second", second, deps=("first",)),
    ], quota=quota)


def test_pipelines_land_on_least_loaded_pilot():
    pm = make_manager(4)
    pm.submit_pilot(PilotDescription(num_devices=2, name="a"))
    pm.submit_pilot(PilotDescription(num_devices=2, name="b"))
    sched = MultiPilotScheduler(pm, max_workers_per_pilot=2)
    try:
        out = sched.run([_sleep_pipeline("p0"), _sleep_pipeline("p1")])
    finally:
        sched.close()
    placement = out["_meta"]["placement"]
    assert len(set(placement.values())) == 2, (
        f"both pipelines piled onto one pilot: {placement}")
    for name in ("p0", "p1"):
        assert out[name]["second"] == placement[name], (
            "stage did not run on its placed pilot")


def test_migration_on_pilot_degradation():
    pm = make_manager(8)
    pm.submit_pilot(PilotDescription(num_devices=4, name="a"))
    pm.submit_pilot(PilotDescription(num_devices=4, name="b"))
    started, gate = threading.Event(), threading.Event()
    seen = {}

    def first(comm, upstream):
        seen["first"] = comm.pilot_uid
        started.set()
        gate.wait(5.0)
        return 1

    def wide(comm, upstream):
        seen["wide"] = comm.pilot_uid
        return comm.size

    pipe = Pipeline("mig", [
        Stage("first", first),
        Stage("wide", wide, deps=("first",), num_devices=4),
    ])
    sched = MultiPilotScheduler(pm, max_workers_per_pilot=4)
    results = {}
    th = threading.Thread(target=lambda: results.update(sched.run([pipe])))
    th.start()
    try:
        assert started.wait(5.0), "first stage never launched"
        home = next(p for p in pm.pilots if p.uid == seen["first"])
        other = next(p for p in pm.pilots if p is not home)
        # two device failures drop the home pilot below the 4-device mesh
        # requirement of the remaining stage -> migrate
        home.mark_failed([d.id for d in home.alive_devices()[:2]])
        gate.set()
        th.join(10.0)
        assert not th.is_alive()
    finally:
        gate.set()
        th.join(1.0)
        sched.close()
    assert results["mig"].get("_error") is None or "_error" not in results["mig"]
    assert seen["wide"] == other.uid, (
        f"remaining stage ran on degraded pilot {seen['wide']}")
    assert results["mig"]["wide"] == 4, "migrated stage lost its full mesh"
    migs = results["_meta"]["migrations"]
    assert len(migs) == 1 and migs[0]["from"] == home.uid \
        and migs[0]["to"] == other.uid


def test_unplaceable_pipeline_aborts_without_poisoning_siblings():
    pm = make_manager(4)
    pm.submit_pilot(PilotDescription(num_devices=2, name="a"))
    pm.submit_pilot(PilotDescription(num_devices=2, name="b"))
    huge = Pipeline("huge", [Stage("x", lambda c, u: 1, num_devices=16)])
    ok = _sleep_pipeline("ok")
    sched = MultiPilotScheduler(pm, max_workers_per_pilot=2)
    try:
        out = sched.run([huge, ok])
    finally:
        sched.close()
    assert "unplaceable" in out["huge"]["_error"]
    assert "_error" not in out["ok"]


# ---------------------------------------------------------------------------
# quotas: cap + fairness + backpressure
# ---------------------------------------------------------------------------


def make_agent(n_devices, **kw):
    kw.setdefault("max_workers", n_devices)
    return RemoteAgent(FakePilot("fake.q", [FakeDevice(i) for i in range(n_devices)]),
                       **kw)


def test_quota_capped_pipeline_never_exceeds_share():
    agent = make_agent(4, max_workers=8)
    wide = Pipeline("wide", [
        Stage(f"s{i}", lambda c, u, i=i: time.sleep(0.05) or i)
        for i in range(6)
    ], quota=1)
    sibs = [_sleep_pipeline(f"sib{i}", sleep_s=0.05) for i in range(2)]
    out = PipelineScheduler(agent).run([wide] + sibs)
    assert "_error" not in out["wide"]
    for i in range(2):
        assert "_error" not in out[f"sib{i}"], "sibling starved/failed"
    peaks = agent.group_peaks()
    assert peaks["wide"] == 1, f"quota breached: {peaks}"
    assert agent.quota_violations() == {}
    # the auditable trace agrees with the peak accounting
    held_max = max((held for _, g, _, held in agent.lease_trace if g == "wide"),
                   default=0)
    assert held_max <= 1
    # fairness: while wide serialises on its quota, siblings overlap freely
    wide_wall = out["_meta"]["per_pipeline"]["wide"]["wall_s"]
    for i in range(2):
        assert out["_meta"]["per_pipeline"][f"sib{i}"]["wall_s"] < wide_wall
    agent.close()


def test_quota_shrinks_wide_stage_elastically():
    agent = make_agent(4)
    pipe = Pipeline("clamped", [
        Stage("wide", lambda c, u: c.size, num_devices=4),
    ], quota=2)
    out = PipelineScheduler(agent).run([pipe])
    assert out["clamped"]["wide"] == 2, (
        "stage should shrink to its group's quota share")
    agent.close()


def test_quota_can_be_lifted():
    agent = make_agent(2)
    agent.set_quota("g", 1)
    assert agent.quota("g") == 1
    agent.set_quota("g", None)
    assert agent.quota("g") is None
    with pytest.raises(ValueError):
        agent.set_quota("g", 0)
    agent.close()


# ---------------------------------------------------------------------------
# transport abstraction
# ---------------------------------------------------------------------------


class RecordingTransport(Transport):
    name = "recording"

    def __init__(self, max_workers=2):
        self.capacity = max_workers
        self.submissions = 0
        self._inner = InProcessTransport(max_workers)

    def submit(self, fn, *args):
        self.submissions += 1
        return self._inner.submit(fn, *args)

    def shutdown(self, wait=True):
        self._inner.shutdown(wait=wait)


def test_agent_executes_through_pluggable_transport():
    transport = RecordingTransport(max_workers=2)
    agent = RemoteAgent(FakePilot("fake.t", [FakeDevice(0), FakeDevice(1)]),
                        max_workers=99, transport=transport)
    assert agent.max_workers == 2, "transport capacity must bound in-flight"
    tasks = agent.submit([TaskDescription(name=f"t{i}", fn=lambda comm: comm.size)
                          for i in range(3)])
    assert all(t.state == TaskState.DONE for t in tasks)
    assert transport.submissions >= 3, "attempts bypassed the transport"
    agent.close()
    transport.shutdown()  # injected transports belong to the caller


def test_shared_transport_survives_sibling_agent_close():
    """Closing one agent must not shut down a caller-injected transport
    that another agent still dispatches through."""
    transport = InProcessTransport(max_workers=4)
    a1 = RemoteAgent(FakePilot("fake.s1", [FakeDevice(0)]), transport=transport)
    a2 = RemoteAgent(FakePilot("fake.s2", [FakeDevice(1)]), transport=transport)
    t1, = a1.submit([TaskDescription(name="one", fn=lambda comm: 1)])
    a1.close()
    t2, = a2.submit([TaskDescription(name="two", fn=lambda comm: 2)])
    assert t1.state == TaskState.DONE and t2.state == TaskState.DONE
    assert t2.result == 2
    a2.close()
    transport.shutdown()


def test_dead_transport_fails_task_not_dispatcher():
    """A transport that rejects submissions must fail the task cleanly;
    the dispatcher thread and the device lease must both survive."""
    transport = InProcessTransport(max_workers=2)
    pilot = FakePilot("fake.d", [FakeDevice(0), FakeDevice(1)])
    agent = RemoteAgent(pilot, transport=transport)
    transport.shutdown()  # simulate a shared transport torn down elsewhere
    task, = agent.submit_async([TaskDescription(name="doomed",
                                                fn=lambda comm: 1)])
    assert task.wait(5.0), "waiter hung on transport failure"
    assert task.state == TaskState.FAILED
    assert "transport rejected" in task.error
    assert pilot.free_count() == 2, "lease leaked on transport failure"
    agent.close()


def test_cross_process_transports_raise_naming_their_item():
    """The JAX package's cross-process transports are not ported yet:
    asking for one raises and names the ROADMAP item that brings it,
    before any pilot is submitted."""
    for spec in ("subprocess", "jax-distributed"):
        with pytest.raises(NotImplementedError, match="queue 1, item 6"):
            make_transport(spec)
    assert make_transport("in-process") is None
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("carrier-pigeon")
    from repro_torch.core import Session
    pm = make_manager(2)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        Session(manager=pm, transport="subprocess").run(
            Pipeline("p", [Stage("s", lambda c, u: 1)]))
    assert pm.pilots == [] and pm.free_devices() == 2


# ---------------------------------------------------------------------------
# checkpoint-aware retry
# ---------------------------------------------------------------------------


def test_retry_receives_last_checkpoint_step(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    agent = make_agent(2)
    seen = []

    def train(comm, resume_step=None):
        seen.append(resume_step)
        if resume_step is None:
            # first attempt: make progress to step 5, then die
            store.save(ckpt_dir, 5, {"w": np.zeros(2, np.float32)})
            raise RuntimeError("mid-train crash")
        return resume_step

    task, = agent.submit([TaskDescription(
        name="ckpt-train", fn=train, checkpoint_dir=ckpt_dir,
        max_retries=1, speculative=False)])
    assert task.state == TaskState.DONE, task.error
    assert seen == [None, 5], (
        f"agent did not thread the checkpoint step into the retry: {seen}")
    assert task.result == 5
    agent.close()


def test_checkpoint_retry_with_no_checkpoint_passes_none(tmp_path):
    agent = make_agent(2)
    seen = []

    def flaky(comm, resume_step=None):
        seen.append(resume_step)
        if len(seen) == 1:
            raise RuntimeError("crash before any checkpoint")
        return "ok"

    task, = agent.submit([TaskDescription(
        name="no-ckpt", fn=flaky, checkpoint_dir=str(tmp_path / "empty"),
        max_retries=1, speculative=False)])
    assert task.state == TaskState.DONE
    assert seen == [None, None]
    agent.close()
