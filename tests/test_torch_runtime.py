"""The port's async scheduler (``repro_torch.core``), test for test the
mirror of tests/test_scheduler.py: non-blocking submission, the two agent
regressions (concurrent.futures.TimeoutError mis-catch, speculative lease
leak), and PipelineScheduler behaviour under contention.

Scheduling logic runs on a FakePilot whose devices are plain objects and
whose ``carve`` skips the port's Mesh, modelling an N-device pool on the
CPU.  Real-mesh execution is covered by tests/test_torch_system.py.
"""
import threading
import time
from types import SimpleNamespace

import pytest

from repro_torch.core.agent import RemoteAgent
from repro_torch.core.pilot import Pilot
from repro_torch.core.pipeline import Pipeline, PipelineScheduler, Stage, run_pipelines
from repro_torch.core.task import TaskDescription, TaskState


class FakeDevice:
    def __init__(self, i):
        self.id = i
        self.platform = "cpu"


class FakePilot(Pilot):
    """Pilot over dummy devices; carve returns a mesh-free communicator."""

    def carve(self, devices, mesh_shape=None, mesh_axes=("data",)):
        return SimpleNamespace(devices=tuple(devices), size=len(devices),
                               backend="fake", build_time_s=0.0)


def make_pilot(n):
    return FakePilot(f"fake.{n}", [FakeDevice(i) for i in range(n)])


def make_agent(n_devices, **kw):
    kw.setdefault("max_workers", n_devices)
    return RemoteAgent(make_pilot(n_devices), **kw)


# ---------------------------------------------------------------------------
# submit_async is non-blocking
# ---------------------------------------------------------------------------


def test_submit_async_returns_before_completion():
    agent = make_agent(2)
    release = threading.Event()

    def slow(comm):
        release.wait(5.0)
        return "done"

    t0 = time.time()
    tasks = agent.submit_async([TaskDescription(name="slow", fn=slow)])
    elapsed = time.time() - t0
    assert elapsed < 0.5, "submit_async must not block on task completion"
    assert tasks[0].state != TaskState.DONE
    release.set()
    assert agent.wait(tasks, timeout=10.0)
    assert tasks[0].state == TaskState.DONE and tasks[0].result == "done"
    agent.close()


def test_completion_callback_fires_once_terminal():
    agent = make_agent(2)
    seen = []
    tasks = agent.submit_async(
        [TaskDescription(name="cb", fn=lambda comm: 7)],
        on_complete=lambda t: seen.append(t))
    assert agent.wait(tasks, timeout=10.0)
    time.sleep(0.05)
    assert len(seen) == 1 and seen[0].result == 7 and seen[0].finalized
    agent.close()


# ---------------------------------------------------------------------------
# regression: concurrent.futures.TimeoutError on Python 3.10
# ---------------------------------------------------------------------------


def test_slow_task_not_popped_as_done():
    """Old ``execute`` caught builtin TimeoutError around
    ``Future.result(timeout=...)``; on Python 3.10 the raised
    ``concurrent.futures.TimeoutError`` is NOT a subclass, so a
    still-running task fell into the generic handler and was returned
    while RUNNING.  A blocking submit must return the task DONE."""
    agent = make_agent(1)

    def slow(comm):
        time.sleep(0.4)
        return 42

    task, = agent.submit([TaskDescription(name="slow", fn=slow)])
    assert task.state == TaskState.DONE, (
        f"blocking submit returned non-terminal task: {task.state}")
    assert task.result == 42
    agent.close()


# ---------------------------------------------------------------------------
# regression: speculative execution leaked its device lease
# ---------------------------------------------------------------------------


def test_speculative_lease_released():
    """_maybe_speculate leased under ``uid + '.spec'`` but the worker
    released ``task.uid`` — speculative leases were never returned.  With
    the lease uid threaded through the worker, free_count recovers."""
    pilot = make_pilot(4)
    agent = RemoteAgent(pilot, max_workers=4, straggler_factor=1.0,
                        straggler_min_s=0.05, straggler_check_s=0.02)
    # seed duration history so the straggler median is tiny
    agent.submit([TaskDescription(name=f"h{i}", fn=lambda comm: None,
                                  kind="k") for i in range(3)])

    def straggler(comm):
        time.sleep(0.5)
        return "ok"

    task, = agent.submit([TaskDescription(name="s", fn=straggler, kind="k")])
    assert task.state == TaskState.DONE
    # the speculative twin (if any) sleeps too; give it time to drain
    deadline = time.time() + 3.0
    while pilot.free_count() != 4 and time.time() < deadline:
        time.sleep(0.02)
    assert pilot.free_count() == 4, (
        f"leaked leases: free={pilot.free_count()}/4 — speculative lease "
        "was not released")
    agent.close()


def test_retry_success_clears_error():
    """A task that fails then succeeds on retry must not keep its stale
    error — error-checking callers would reject a DONE task."""
    agent = make_agent(2)
    attempts = {"n": 0}

    def flaky(comm):
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("transient")
        return "recovered"

    task, = agent.submit([TaskDescription(name="flaky", fn=flaky,
                                          max_retries=2)])
    assert task.state == TaskState.DONE and task.result == "recovered"
    assert task.error is None, f"stale error survived retry: {task.error!r}"
    agent.close()


def test_close_finalizes_pending_tasks():
    """close() must CANCEL queued-but-unlaunched tasks and release their
    waiters instead of leaving them hanging."""
    agent = make_agent(1)
    gate = threading.Event()
    blocking = agent.submit_async(
        [TaskDescription(name="blocker", fn=lambda comm: gate.wait(5.0))])
    time.sleep(0.1)  # blocker holds the only device
    queued = agent.submit_async(
        [TaskDescription(name="starved", fn=lambda comm: "never")])
    threading.Timer(0.2, gate.set).start()
    agent.close()
    assert agent.wait(blocking + queued, timeout=5.0), "waiter hung"
    assert queued[0].state == TaskState.CANCELED
    assert queued[0].finalized


# ---------------------------------------------------------------------------
# capacity + priority
# ---------------------------------------------------------------------------


def test_no_overlease_under_contention():
    pilot = make_pilot(2)
    agent = RemoteAgent(pilot, max_workers=8)
    lock = threading.Lock()
    state = {"now": 0, "peak": 0}

    def work(comm):
        with lock:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
        time.sleep(0.05)
        with lock:
            state["now"] -= 1
        return True

    tasks = agent.submit([TaskDescription(name=f"w{i}", fn=work)
                          for i in range(6)])
    assert all(t.state == TaskState.DONE for t in tasks)
    assert state["peak"] <= 2, f"over-lease: {state['peak']} > 2 devices"
    agent.close()


def test_priority_order_preserved():
    agent = make_agent(1)
    gate = threading.Event()
    order = []

    def blocker(comm):
        gate.wait(5.0)

    def record(comm, tag):
        order.append(tag)

    blocking = agent.submit_async([TaskDescription(name="blocker", fn=blocker)])
    time.sleep(0.1)  # ensure the blocker holds the only device
    queued = agent.submit_async([
        TaskDescription(name="lo", fn=record, args=("lo",), priority=1),
        TaskDescription(name="hi", fn=record, args=("hi",), priority=5),
        TaskDescription(name="mid", fn=record, args=("mid",), priority=3),
    ])
    gate.set()
    assert agent.wait(blocking + queued, timeout=10.0)
    assert order == ["hi", "mid", "lo"]
    agent.close()


# ---------------------------------------------------------------------------
# PipelineScheduler: concurrency, isolation, overlap
# ---------------------------------------------------------------------------


def _two_stage_pipeline(i, sleep_s=0.0):
    def first(comm, upstream):
        time.sleep(sleep_s)
        return i * 10

    def second(comm, upstream):
        time.sleep(sleep_s)
        return upstream["first"] + 1

    return Pipeline(f"p{i}", [
        Stage("first", first),
        Stage("second", second, deps=("first",)),
    ])


def test_concurrent_pipelines_complete():
    agent = make_agent(4)
    pipes = [_two_stage_pipeline(i) for i in range(5)]
    out = PipelineScheduler(agent).run(pipes)
    for i in range(5):
        assert out[f"p{i}"]["first"] == i * 10
        assert out[f"p{i}"]["second"] == i * 10 + 1
        assert "_error" not in out[f"p{i}"]
    meta = out["_meta"]
    assert meta["n_tasks"] == 10 and meta["n_failed"] == 0
    assert meta["wall_s"] > 0
    agent.close()


def test_failing_pipeline_does_not_poison_siblings():
    agent = make_agent(4)

    def boom(comm, upstream):
        raise ValueError("injected")

    bad = Pipeline("bad", [
        Stage("ok", lambda comm, upstream: 1),
        Stage("explode", boom, deps=("ok",), max_retries=0),
        Stage("never", lambda comm, upstream: 2, deps=("explode",)),
    ])
    good = [_two_stage_pipeline(i) for i in range(4)]
    out = PipelineScheduler(agent).run([bad] + good)
    assert "injected" in out["bad"]["_error"]
    assert out["bad"]["_failed_stage"] == "explode"
    assert out["bad"]["ok"] == 1          # upstream result still recorded
    assert "never" not in out["bad"]      # downstream never ran
    for i in range(4):
        assert out[f"p{i}"]["second"] == i * 10 + 1, "sibling was poisoned"
    agent.close()


def test_duplicate_stage_names_rejected():
    p = Pipeline("dup", [Stage("a", lambda c, u: 1),
                         Stage("a", lambda c, u: 2)])
    agent = make_agent(1)
    with pytest.raises(RuntimeError, match="duplicate stage names"):
        p.run(agent)
    agent.close()


def test_pipeline_run_still_raises():
    agent = make_agent(2)
    p = Pipeline("solo", [Stage("explode",
                                lambda comm, upstream: 1 / 0,
                                max_retries=0)])
    with pytest.raises(RuntimeError, match="solo"):
        p.run(agent)
    agent.close()


def test_overlap_beats_serial():
    """>=4 pipelines on >=2 devices: concurrent scheduling must beat the
    one-pipeline-at-a-time baseline on wall clock."""
    sleep_s = 0.15
    n = 4

    # serial baseline: each pipeline run to completion before the next
    agent = make_agent(4)
    t0 = time.time()
    for i in range(n):
        _two_stage_pipeline(i, sleep_s).run(agent)
    serial_wall = time.time() - t0
    agent.close()

    pilot = make_pilot(4)
    out = run_pipelines([_two_stage_pipeline(i, sleep_s) for i in range(n)],
                        pilot=pilot)
    concurrent_wall = out["_meta"]["wall_s"]
    assert concurrent_wall < serial_wall * 0.75, (
        f"no overlap: concurrent={concurrent_wall:.2f}s "
        f"serial={serial_wall:.2f}s")
    assert out["_meta"]["overlap_factor"] > 1.5


def test_run_pipelines_reports_decomposition():
    out = run_pipelines([_two_stage_pipeline(i) for i in range(3)],
                        pilot=make_pilot(2))
    meta = out["_meta"]
    assert set(meta["per_pipeline"]) == {"p0", "p1", "p2"}
    for row in meta["per_pipeline"].values():
        assert row["wall_s"] is not None and row["error"] is None
    assert meta["queue_s"] >= 0 and meta["communicator_s"] >= 0
    assert meta["n_tasks"] == 6
