"""The port's Session API (``repro_torch.core``), test for test the
mirror of tests/test_session.py: the stage-graph DSL (`@stage`, `>>`,
`|`, `.after`), the Session facade (lazy pods, lifecycle, quotas,
serving), and per-stage cross-pilot placement — one DAG whose stages
land on different kind-specialised pods with real dependency edges
crossing agents, plus per-STAGE migration when a pod degrades.

Like tests/test_torch_runtime.py, scheduling logic runs on FakePilots over
plain-object devices (carve skips the port's Mesh), so an N-device pool is
modelled on the CPU.
"""
import threading
import time
from types import SimpleNamespace

import pytest

from repro_torch.core import (KindAwarePlacement, Session, StageContext,
                        StageGraph, StageSpec, stage)
from repro_torch.core.pilot import Pilot, PilotDescription, PilotManager
from repro_torch.core.pipeline import (Pipeline, Stage, aggregate_metrics,
                                 run_pipelines, run_pipelines_multi)
from repro_torch.core.task import TaskState


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


def make_session(n, pods=None, **kw):
    return Session(manager=make_manager(n), pods=pods, **kw)


KIND_PODS = [
    PilotDescription(num_devices=2, name="data",
                     task_kinds=("data_engineering",)),
    PilotDescription(num_devices=2, name="dl",
                     task_kinds=("train", "inference")),
]


# ---------------------------------------------------------------------------
# stage DSL: decorator, composition, compilation
# ---------------------------------------------------------------------------


def test_stage_decorator_defaults_and_options():
    @stage
    def plain(ctx):
        return 1

    assert isinstance(plain, StageSpec)
    assert (plain.name, plain.kind, plain.num_devices) == ("plain", "generic", 1)

    @stage(kind="train", num_devices=4, checkpoint="/tmp/ck", priority=3)
    def heavy(ctx):
        return 2

    assert heavy.kind == "train" and heavy.num_devices == 4
    assert heavy.checkpoint == "/tmp/ck" and heavy.priority == 3
    narrowed = heavy.options(num_devices=2)
    assert narrowed.num_devices == 2 and heavy.num_devices == 4, \
        "options() must clone, not mutate"


def test_rshift_and_parallel_build_expected_edges():
    a, b, c, d = [stage(lambda ctx: None, name=n) for n in "abcd"]
    g = (a | b) >> c >> d
    specs = {s.name: s for s in g}
    assert set(specs) == {"a", "b", "c", "d"}
    assert specs["a"].deps == () and specs["b"].deps == ()
    assert set(specs["c"].deps) == {"a", "b"}
    assert specs["d"].deps == ("c",)
    assert g.sources() == ("a", "b") and g.sinks() == ("d",)


def test_after_adds_explicit_edges():
    a = stage(lambda ctx: 1, name="a")
    b = stage(lambda ctx: 2, name="b")
    c = stage(lambda ctx: 3, name="c").after(a, "b")
    g = StageGraph([a, b, c])
    assert set(next(s for s in g if s.name == "c").deps) == {"a", "b"}
    assert g.sinks() == ("c",)


def test_named_reuse_and_duplicate_detection():
    work = stage(lambda ctx: 0, name="work")
    g = StageGraph([work.named("w0"), work.named("w1")])
    assert set(g.names) == {"w0", "w1"}
    with pytest.raises(ValueError, match="duplicate"):
        StageGraph([work, work])
    with pytest.raises(ValueError, match="duplicate"):
        _ = StageGraph([work]) >> work


def test_spec_is_directly_callable_and_bindable():
    @stage(kind="train")
    def scale(ctx, factor, offset=0):
        return ctx.upstream["src"] * factor + offset

    ctx = StageContext(comm=None, upstream={"src": 10})
    assert scale(ctx, 3) == 30
    bound = scale.bind(2, offset=5)
    assert bound(ctx) == 25
    assert bound.to_stage().fn(None, {"src": 10}) == 25


def test_ctx_dep_helper():
    ctx = StageContext(comm=None, upstream={"only": 7})
    assert ctx.dep() == 7 and ctx.dep("only") == 7
    two = StageContext(comm=None, upstream={"a": 1, "b": 2})
    with pytest.raises(KeyError):
        two.dep()


def test_compile_lowers_to_pipeline():
    a = stage(lambda ctx: 1, name="a", kind="data_engineering")
    b = stage(lambda ctx: 2, name="b", kind="train", num_devices=3)
    pipe = (a >> b).compile("lowered", quota=2)
    assert isinstance(pipe, Pipeline) and pipe.quota == 2
    stages = {s.name: s for s in pipe.stages}
    assert stages["b"].deps == ("a",)
    assert stages["b"].kind == "train" and stages["b"].num_devices == 3


def test_rshift_refuses_all_service_left_side():
    svc = stage(lambda ctx: None, name="svc", service=True)
    tail = stage(lambda ctx: None, name="tail")
    with pytest.raises(ValueError, match="service"):
        _ = StageGraph([svc]) >> tail


# ---------------------------------------------------------------------------
# Pipeline._validate_dag: unknown dependency vs cycle (bugfix)
# ---------------------------------------------------------------------------


def test_unknown_dependency_is_not_reported_as_cycle():
    pipe = Pipeline("p", [Stage("a", lambda c, u: 1, deps=("ghost",))])
    with pytest.raises(RuntimeError, match="unknown stage.*ghost"):
        pipe.start(None)


def test_cycle_still_reported_as_cycle():
    pipe = Pipeline("p", [
        Stage("a", lambda c, u: 1, deps=("b",)),
        Stage("b", lambda c, u: 2, deps=("a",)),
    ])
    with pytest.raises(RuntimeError, match="cycle"):
        pipe.start(None)


# ---------------------------------------------------------------------------
# submit-time task recording (bugfix): live readers see running stages
# ---------------------------------------------------------------------------


def test_running_stage_visible_in_tasks_and_metrics():
    from repro_torch.core.agent import RemoteAgent

    agent = RemoteAgent(FakePilot("fake.live", [FakeDevice(0), FakeDevice(1)]),
                        max_workers=2)
    started, gate = threading.Event(), threading.Event()

    def slow(comm, upstream):
        started.set()
        gate.wait(5.0)
        return "done"

    pipe = Pipeline("live", [Stage("slow", slow)])
    try:
        pipe.start(agent)
        assert started.wait(5.0)
        task = pipe.tasks.get("slow")
        assert task is not None and not task.finalized, (
            "non-service task must be visible at submit time")
        meta = aggregate_metrics([pipe], wall=0.1)
        assert meta["per_pipeline"]["live"]["running"] == ["slow"]
        assert meta["n_running"] == 1
        gate.set()
        assert pipe.wait(10.0)
        meta = aggregate_metrics([pipe], wall=0.1)
        assert meta["per_pipeline"]["live"]["running"] == []
        assert meta["n_running"] == 0 and pipe.results["slow"] == "done"
    finally:
        gate.set()
        agent.close()


# ---------------------------------------------------------------------------
# Session lifecycle
# ---------------------------------------------------------------------------


def test_session_materializes_pods_lazily_and_recycles_on_close():
    session = make_session(8, pods=2)
    assert session.manager.pilots == [], "pilots must not exist before use"
    out = session.run(stage(lambda ctx: 42, name="x"), name="p")
    assert out == {"x": 42}
    assert len(session.manager.pilots) == 2
    sizes = sorted(p.size for p in session.manager.pilots)
    assert sizes == [4, 4]
    ids = [frozenset(d.id for d in p.alive_devices())
           for p in session.manager.pilots]
    assert not ids[0] & ids[1], "session pods must be disjoint"
    session.close()
    assert session.manager.free_devices() == 8, (
        "close() must cancel owned pilots and recycle devices")
    with pytest.raises(RuntimeError, match="closed"):
        session.run(stage(lambda ctx: 0, name="y"))


def test_session_context_manager_closes_on_error():
    pm = make_manager(4)
    with pytest.raises(RuntimeError, match="boom"):
        with Session(manager=pm) as session:
            session.run(stage(lambda ctx: 0, name="ok"), name="warm")
            raise RuntimeError("boom")
    assert pm.free_devices() == 4, "devices leaked on the error path"


def test_session_adopts_existing_pilots_without_owning_them():
    pm = make_manager(4)
    mine = pm.submit_pilot(PilotDescription(num_devices=4, name="mine"))
    session = Session(manager=pm)
    assert session.run(stage(lambda ctx: 1, name="s")) == {"s": 1}
    assert session.pilots == [mine]
    session.close()
    assert pm.pilots == [mine], "adopted pilots must survive close()"


def test_session_run_raises_on_stage_failure():
    session = make_session(2)

    @stage(max_retries=0)
    def bad(ctx):
        raise ValueError("exploded")

    try:
        with pytest.raises(RuntimeError, match="exploded"):
            session.run(bad, name="failing")
    finally:
        session.close()


def test_quota_pipeline_sticks_to_one_pod():
    """The device cap is enforced per agent, so a quota'd pipeline must
    not spread over pods (it could then hold quota*K devices): all its
    stages resolve to the SAME pilot when one pod can host them, and the
    recorded peak never exceeds the quota anywhere."""
    session = make_session(8, pods=2, max_workers_per_pilot=8)
    work = stage(lambda ctx: time.sleep(0.03) or 1, name="w")
    g = StageGraph([work.named(f"w{i}") for i in range(6)])
    try:
        pipe = session.start(g, name="sticky", quota=1)
        assert pipe.wait(10.0) and pipe.error is None, pipe.error
        placements = pipe.stage_placements()
        assert len(set(placements.values())) == 1, (
            f"quota'd pipeline spread over pods: {placements}")
        total_peak = sum(
            session.agent_for(p).group_peaks().get("sticky", 0)
            for p in session.pilots)
        assert total_peak == 1, (
            f"pipeline-wide quota breached across agents: {total_peak}")
    finally:
        session.close()


def test_quota_passes_through_to_prebuilt_pipeline():
    session = make_session(4, max_workers_per_pilot=4)
    pipe = Pipeline("pre", [
        Stage(f"s{i}", lambda c, u: time.sleep(0.02) or 1) for i in range(4)])
    try:
        out = session.run_all([pipe], quota=1)
        assert "_error" not in out["pre"]
        pilot, = session.pilots
        assert session.agent_for(pilot).group_peaks()["pre"] == 1
    finally:
        session.close()


def test_session_quota_enforced_via_graph_compile():
    session = make_session(4, max_workers_per_pilot=8)
    work = stage(lambda ctx: time.sleep(0.05) or 1, name="w")
    g = StageGraph([work.named(f"w{i}") for i in range(6)])
    try:
        session.run(g, name="capped", quota=1)
        pilot, = session.pilots
        peaks = session.agent_for(pilot).group_peaks()
        assert peaks["capped"] == 1, f"quota breached: {peaks}"
        assert session.agent_for(pilot).quota_violations() == {}
    finally:
        session.close()


# ---------------------------------------------------------------------------
# per-stage cross-pilot placement (the tentpole)
# ---------------------------------------------------------------------------


def test_cross_pilot_dag_places_stages_by_kind_and_flows_results():
    """One preprocess -> train -> postprocess DAG over two kind-specialised
    pods: the data stage lands on the data pod, the DL stages on the DL
    pod, and the dependency edges cross agents with results intact."""
    session = make_session(4, pods=KIND_PODS)
    seen = {}

    @stage(kind="data_engineering")
    def preprocess(ctx):
        seen["preprocess"] = ctx.comm.pilot_uid
        return 21

    @stage(kind="train")
    def train(ctx):
        seen["train"] = ctx.comm.pilot_uid
        return ctx.upstream["preprocess"] * 2

    @stage(kind="inference")
    def postprocess(ctx):
        seen["postprocess"] = ctx.comm.pilot_uid
        return ctx.upstream["train"] + 1

    try:
        pipe = session.start(preprocess >> train >> postprocess, name="x")
        assert pipe.wait(10.0) and pipe.error is None, pipe.error
        assert pipe.results == {"preprocess": 21, "train": 42,
                                "postprocess": 43}
        placements = pipe.stage_placements()
        assert placements["preprocess"].startswith("data")
        assert placements["train"].startswith("dl")
        assert placements["postprocess"].startswith("dl")
        assert placements["preprocess"] != placements["train"], (
            "dependency edge must cross pilots")
        # stages really executed on the pilot they were placed on
        assert seen == {k: placements[k] for k in placements}
        # one agent per pilot: the stages' agents differ across the edge
        assert pipe.stage_agents["preprocess"] is not pipe.stage_agents["train"]
    finally:
        session.close()


def test_data_and_dl_pod_stages_overlap():
    """Independent stages of ONE pipeline run concurrently on their
    respective pods — the overlap the old two-pipeline --kind-pods hack
    serialized away.  Each stage blocks until it has seen the other
    running; a serialized schedule would deadlock-and-fail here."""
    session = make_session(4, pods=KIND_PODS)
    de_running, dl_running = threading.Event(), threading.Event()

    @stage(kind="data_engineering")
    def de(ctx):
        de_running.set()
        assert dl_running.wait(5.0), "DL stage never overlapped"
        return "de"

    @stage(kind="train")
    def tr(ctx):
        dl_running.set()
        assert de_running.wait(5.0), "data stage never overlapped"
        return "tr"

    try:
        pipe = session.start(de | tr, name="overlap")
        assert pipe.wait(10.0) and pipe.error is None, pipe.error
        placements = pipe.stage_placements()
        assert placements["de"] != placements["tr"]
        assert pipe.results == {"de": "de", "tr": "tr"}
    finally:
        session.close()


def test_degraded_pod_migrates_only_the_affected_stage():
    """While the data stage is still running, the DL pod planned for the
    train stage degrades below its device ask: at submit time the stage
    re-resolves to the healthy DL pod and a per-STAGE migration is
    recorded; the data stage's placement is untouched."""
    session = make_session(8, pods=[
        PilotDescription(num_devices=2, name="data",
                         task_kinds=("data_engineering",)),
        PilotDescription(num_devices=4, name="dl1",
                         task_kinds=("train", "inference")),
        PilotDescription(num_devices=2, name="dl2",
                         task_kinds=("train", "inference")),
    ])
    started, gate = threading.Event(), threading.Event()
    seen = {}

    @stage(kind="data_engineering")
    def pre(ctx):
        seen["pre"] = ctx.comm.pilot_uid
        started.set()
        assert gate.wait(5.0)
        return 1

    @stage(kind="train", num_devices=2)
    def tr(ctx):
        seen["tr"] = ctx.comm.pilot_uid
        return ctx.comm.size

    try:
        pipe = session.start(pre >> tr, name="mig")
        assert started.wait(5.0), "data stage never launched"
        dl1 = next(p for p in session.pilots if p.uid.startswith("dl1"))
        dl2 = next(p for p in session.pilots if p.uid.startswith("dl2"))
        # planned placement favoured dl1 (most free capacity); kill 3 of
        # its 4 devices so it can no longer host the 2-device train stage
        dl1.mark_failed([d.id for d in dl1.alive_devices()[:3]])
        gate.set()
        assert pipe.wait(10.0) and pipe.error is None, pipe.error
        assert seen["tr"] == dl2.uid, (
            f"train stage ran on degraded pod: {seen['tr']}")
        assert pipe.results["tr"] == 2, "migrated stage lost its mesh"
        assert seen["pre"].startswith("data"), (
            "unaffected stage must keep its placement")
        assert len(pipe.migrations) == 1, pipe.migrations
        m = pipe.migrations[0]
        assert m["stage"] == "tr" and m["from"] == dl1.uid \
            and m["to"] == dl2.uid
    finally:
        gate.set()
        session.close()


def test_unplaceable_kind_aborts_pipeline_before_start():
    session = make_session(2, pods=[
        PilotDescription(num_devices=2, name="data",
                         task_kinds=("data_engineering",))])
    try:
        with pytest.raises(RuntimeError, match="unplaceable.*train"):
            session.run(stage(lambda ctx: 1, name="t", kind="train"),
                        name="nope")
    finally:
        session.close()


def test_stage_unplaceable_at_submit_time_fails_pipeline_cleanly():
    """The pre-flight check passes, then EVERY pod able to host the train
    stage dies while the data stage runs — the ready stage resolves to
    None and the pipeline fails with the stage named, without hanging."""
    session = make_session(4, pods=KIND_PODS)
    started, gate = threading.Event(), threading.Event()

    @stage(kind="data_engineering")
    def pre(ctx):
        started.set()
        assert gate.wait(5.0)
        return 1

    @stage(kind="train", num_devices=2)
    def tr(ctx):
        return 2

    try:
        pipe = session.start(pre >> tr, name="doomed")
        assert started.wait(5.0)
        dl = next(p for p in session.pilots if p.uid.startswith("dl"))
        dl.mark_failed([d.id for d in dl.alive_devices()])
        gate.set()
        assert pipe.wait(10.0), "pipeline hung on unplaceable stage"
        assert pipe.error is not None and "unplaceable" in pipe.error
        assert pipe.failed_stage == "tr"
    finally:
        gate.set()
        session.close()


def test_run_all_isolates_unplaceable_sibling():
    session = make_session(4, pods=KIND_PODS)
    ok = StageGraph([stage(lambda ctx: 5, name="s",
                           kind="data_engineering")]).compile("ok")
    huge = StageGraph([stage(lambda ctx: 1, name="wide", kind="train",
                             num_devices=16)]).compile("huge")
    try:
        out = session.run_all([ok, huge])
        assert out["ok"]["s"] == 5
        assert "unplaceable" in out["huge"]["_error"]
        assert set(out["_meta"]["placement"]["ok"]) == {"s"}
    finally:
        session.close()


# ---------------------------------------------------------------------------
# serving through the Session
# ---------------------------------------------------------------------------


def _echo_service():
    @stage(kind="inference", service=True)
    def svc(ctx):
        out = []
        while True:
            ctx.control.wait_for_work(0.05)
            out.extend(ctx.control.take_requests())
            if ctx.control.stop_requested():
                break
            if ctx.control.drain_requested() \
                    and ctx.control.pending_requests() == 0:
                break
        return out

    return svc


def test_session_serve_roundtrip_and_drain():
    session = make_session(2)
    try:
        handle = session.serve(_echo_service(), name="echo")
        handle.submit_request("a")
        handle.submit_request("b")
        assert handle.stop(drain=True, timeout=10.0), "service did not drain"
        assert handle.result == ["a", "b"]
        assert handle.task.state == TaskState.DONE
    finally:
        session.close()


def test_session_close_stops_running_service():
    session = make_session(2)
    handle = session.serve(_echo_service(), name="echo")
    handle.submit_request("x")
    session.close()
    task = handle.task
    assert task is not None and task.wait(10.0), (
        "close() must stop the service, not leave it holding its lease")
    assert session.manager.free_devices() == 2


def test_serve_rejects_graphs_without_exactly_one_service_stage():
    session = make_session(2)
    ran = []
    try:
        with pytest.raises(ValueError, match="service"):
            session.serve(stage(lambda ctx: ran.append(1), name="plain"))
        time.sleep(0.05)
        assert ran == [], "invalid serve graph must be rejected BEFORE it runs"
    finally:
        session.close()


# ---------------------------------------------------------------------------
# deprecation shims
# ---------------------------------------------------------------------------


def test_run_pipelines_shim_still_works_but_warns():
    pilot = FakePilot("fake.shim", [FakeDevice(0), FakeDevice(1)])
    with pytest.warns(DeprecationWarning, match="Session"):
        out = run_pipelines([Pipeline("p", [Stage("s", lambda c, u: 1)])],
                            pilot=pilot)
    assert out["p"]["s"] == 1


def test_run_pipelines_multi_shim_still_works_but_warns():
    with pytest.warns(DeprecationWarning, match="Session"):
        out = run_pipelines_multi(
            [Pipeline("p", [Stage("s", lambda c, u: 2)])],
            manager=make_manager(4), num_pilots=2)
    assert out["p"]["s"] == 2


# ---------------------------------------------------------------------------
# a fault of the reference, fixed in the port (ROADMAP.md queue 3)
# ---------------------------------------------------------------------------


def test_bad_transport_spec_leaves_no_pilot_behind():
    """JAX's Session submits its pilots before it resolves their
    transports, so a spec that raises leaves them held (free 0 of 2,
    and close() cannot cancel them).  The port resolves first."""
    pm = make_manager(2)
    session = Session(manager=pm, transport="bogus")
    with pytest.raises(ValueError, match="unknown transport"):
        session.run(stage(lambda ctx: 1, name="s"))
    assert pm.pilots == [] and pm.free_devices() == 2
    session.close()
    assert pm.free_devices() == 2
