"""End-to-end behaviour of the port's runtime (mirror of the non-spawned
tests of tests/test_system.py): the paper's pipeline (data engineering ->
zero-copy bridge -> DL training -> postprocess) under the port's pilot
runtime on the CPU, held to the JAX package's pipeline on the same table
and unshuffled batches; N pipelines on a shared pilot; task isolation;
and in-process mirrors of two spawned suites of tests/test_system.py on
an 8-device pilot of stand-in devices: ``test_runtime_fault_tolerance``
(tests/spawn/runtime_ft.py: retries, the elastic re-carve after a
DeviceFailure, disjoint pools, a DAG, checkpoints) and
``test_subprocess_transport_multiprocess_e2e``
(tests/spawn/subprocess_transport.py: concurrent 2-device tasks over a
worker pool, a SIGKILL and the checkpoint retry, a pipeline across two
pods over one pool, the reap).

Left out here, covered elsewhere: ``test_distributed_dataframe_ops``
(the port's dataframe against JAX's at 8 devices, on logical shards and
on 8 gloo ranks, is tests/test_torch_dataframe.py) and
``test_distributed_extras`` (pipeline parallelism over 4 gloo ranks and
the int8 gradient all-reduce over 8, against JAX's under ``shard_map``,
is tests/test_torch_distributed.py).
"""
import os
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.agent import RemoteAgent as JAgent  # noqa: E402
from repro.core.bridge import cylon_stage as j_cylon_stage  # noqa: E402
from repro.core.bridge import data_bridge as j_data_bridge  # noqa: E402
from repro.core.bridge import dl_stage as j_dl_stage  # noqa: E402
from repro.core.pilot import PilotDescription as JPilotDescription  # noqa: E402
from repro.core.pilot import PilotManager as JPilotManager  # noqa: E402
from repro.core.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.dataframe.ops_local import filter_rows as j_filter_rows  # noqa: E402
from repro.dataframe.table import Table as JTable  # noqa: E402
from repro_torch.core.agent import RemoteAgent  # noqa: E402
from repro_torch.core.bridge import cylon_stage, data_bridge, dl_stage  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core.pilot import Pilot, PilotDescription, PilotManager  # noqa: E402
from repro_torch.core.pipeline import Pipeline, Stage, run_pipelines  # noqa: E402
from repro_torch.core.task import DeviceFailure, TaskDescription, TaskState  # noqa: E402
from repro_torch.dataframe.ops_local import filter_rows  # noqa: E402
from repro_torch.dataframe.table import Table  # noqa: E402

CPU = torch.device("cpu")
EPOCHS = 30
# 240 fp32 SGD steps from the same start on the same batches: the two
# packages sum in other orders, and the differences carry on
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.default_rng(0)
    N = 2048
    x1 = rng.normal(size=N).astype(np.float32)
    x2 = rng.normal(size=N).astype(np.float32)
    y = 3.0 * x1 - 2.0 * x2 + 0.1 * rng.normal(size=N).astype(np.float32)
    return x1, x2, y


def _postprocess(comm, upstream):
    r = upstream["train"]
    return {"w_err": float(np.abs(r["w"] - np.array([3.0, -2.0])).max()), **r}


def _port_pipeline(shuffle):
    x1, x2, y = _data()

    def preprocess(comm, upstream):
        t = Table.from_columns({"x1": x1, "x2": x2, "y": y}, device=comm.device)
        cols, valid = filter_rows(t.columns, t.valid, t.col("x1").abs() < 3.0)
        return t.with_columns(cols, valid)

    def train(comm, upstream):
        loader = data_bridge(upstream["preprocess"], ["x1", "x2"], "y",
                             global_batch=256, shuffle=shuffle)
        w = torch.zeros((2,), device=comm.device, requires_grad=True)
        b = torch.zeros((), device=comm.device, requires_grad=True)
        losses = []
        for epoch in range(EPOCHS):
            for feats, labels, mask in loader.epoch(epoch):
                err = torch.where(mask, feats @ w + b - labels, 0.0)
                loss = (err ** 2).sum() / mask.sum().clamp(min=1)
                gw, gb = torch.autograd.grad(loss, (w, b))
                with torch.no_grad():
                    w -= 0.1 * gw
                    b -= 0.1 * gb
            losses.append(float(loss.detach()))
        return {"w": w.detach().cpu().numpy(), "loss": losses[-1], "first": losses[0]}

    return Pipeline("e2e", [
        cylon_stage("preprocess", preprocess),
        dl_stage("train", train, deps=("preprocess",)),
        dl_stage("postprocess", _postprocess, deps=("train",), kind="inference"),
    ])


def _jax_pipeline():
    """tests/test_system.py's pipeline with unshuffled batches."""
    x1, x2, y = _data()

    def preprocess(comm, upstream):
        t = JTable.from_columns({"x1": x1, "x2": x2, "y": y})
        cols, valid = j_filter_rows(t.columns, t.valid, jnp.abs(t.col("x1")) < 3.0)
        return t.with_columns(cols, valid)

    def train(comm, upstream):
        loader = j_data_bridge(upstream["preprocess"], ["x1", "x2"], "y",
                               global_batch=256, shuffle=False)
        w, b = jnp.zeros((2,)), jnp.zeros(())

        @jax.jit
        def step(w, b, feats, labels, mask):
            def loss_fn(wb):
                pred = feats @ wb[0] + wb[1]
                err = jnp.where(mask, pred - labels, 0.0)
                return jnp.sum(err**2) / jnp.maximum(jnp.sum(mask), 1)
            l, g = jax.value_and_grad(loss_fn)((w, b))
            return w - 0.1 * g[0], b - 0.1 * g[1], l

        losses = []
        for epoch in range(EPOCHS):
            for feats, labels, mask in loader.epoch(epoch):
                w, b, l = step(w, b, feats, labels, mask)
            losses.append(float(l))
        return {"w": np.asarray(w), "loss": losses[-1], "first": losses[0]}

    return JPipeline("e2e", [
        j_cylon_stage("preprocess", preprocess),
        j_dl_stage("train", train, deps=("preprocess",)),
        j_dl_stage("postprocess", _postprocess, deps=("train",), kind="inference"),
    ])


def _agent():
    return RemoteAgent(PilotManager(devices=[CPU]).submit_pilot(PilotDescription()),
                       max_workers=2)


@pytest.mark.parametrize("shuffle", [True, False])
def test_end_to_end_pipeline_single_device(shuffle):
    """The full flow on one device: synthetic table -> preprocess
    (filter) -> zero-copy loader -> train a linear model -> postprocess
    metric.  Unshuffled, the port's w, final loss and w_err equal the JAX
    package's pipeline on the same table and batches."""
    agent = _agent()
    pipe = _port_pipeline(shuffle)
    try:
        out = pipe.run(agent)["postprocess"]
    finally:
        agent.close()
    assert out["loss"] < out["first"]
    assert out["w_err"] < 0.2, out
    # overhead accounting exists (paper Table 2 decomposition)
    t = pipe.tasks["train"]
    assert "communicator" in t.overhead_s and "queue" in t.overhead_s
    if shuffle:
        return  # the port's permutations come from a torch.Generator
    jagent = JAgent(JPilotManager().submit_pilot(JPilotDescription()), max_workers=2)
    try:
        want = _jax_pipeline().run(jagent)["postprocess"]
    finally:
        jagent.close()
    np.testing.assert_allclose(out["w"], want["w"], **TOL)
    for k in ("loss", "first", "w_err"):
        np.testing.assert_allclose(out[k], want[k], **TOL)


def test_multi_pipeline_shared_pilot():
    """Table-4 mode: N pipelines under one pilot all complete."""
    def work(comm, upstream, i):
        return float(torch.sum(torch.ones((64,), device=comm.device) * i))

    pipes = [
        Pipeline(f"p{i}", [dl_stage("work", lambda c, u, j=i: work(c, u, j))])
        for i in range(5)
    ]
    pilot = PilotManager(devices=[CPU]).submit_pilot(PilotDescription())
    with pytest.warns(DeprecationWarning, match="Session"):
        out = run_pipelines(pipes, pilot=pilot, max_workers=4)
    for i in range(5):
        assert out[f"p{i}"]["work"] == 64.0 * i
    assert out["_meta"]["wall_s"] > 0


def test_task_isolation():
    """A failing task never breaks its siblings (paper §2.3 claim)."""
    agent = _agent()

    def good(comm):
        return comm.describe()

    def bad(comm):
        raise ValueError("boom")

    try:
        tasks = agent.submit([
            TaskDescription(name="good", fn=good),
            TaskDescription(name="bad", fn=bad, max_retries=0),
        ])
    finally:
        agent.close()
    by_name = {t.description.name: t for t in tasks}
    assert by_name["good"].state == TaskState.DONE
    assert by_name["good"].result["backend"] == "host"
    assert by_name["good"].result["device_ids"] == [0]
    assert by_name["bad"].state == TaskState.FAILED
    assert "boom" in by_name["bad"].error


# ---------------------------------------------------------------------------
# in-process mirrors of the spawned suites, on 8 stand-in devices
# ---------------------------------------------------------------------------


class _StandIn:
    """A device of the 8-device pilot (the spawned suites' emulated pool)."""

    def __init__(self, i):
        self.id = i
        self.platform = "cpu"


class _StandInPilot(Pilot):
    """A pilot over stand-in devices: carve returns a mesh-free
    communicator of the leased devices."""

    def carve(self, devices, mesh_shape=None, mesh_axes=("data",)):
        return SimpleNamespace(devices=tuple(devices), size=len(devices),
                               backend="stand-in", build_time_s=0.0,
                               pilot_uid=self.uid, device=CPU)


def _stand_in_manager(n=8):
    return PilotManager(devices=[_StandIn(i) for i in range(n)],
                        pilot_factory=_StandInPilot)


def _compute(comm, x):
    return float(torch.ones(x, device=comm.device).sum())


class _Flaky:
    """Fails its first two calls (a transient fault), then recovers."""

    def __init__(self):
        self.n = 0

    def __call__(self, comm):
        self.n += 1
        if self.n < 3:
            raise RuntimeError("transient")
        return "recovered"


class _FailingDevices:
    """The first attempt loses two of its devices; the retry reports the
    width it was re-carved at."""

    def __init__(self):
        self.calls = 0

    def __call__(self, comm):
        self.calls += 1
        if self.calls == 1:
            raise DeviceFailure([d.id for d in comm.devices[:2]])
        return comm.size


def test_runtime_fault_tolerance(tmp_path):
    """tests/spawn/runtime_ft.py on 8 stand-in devices."""
    pm = _stand_in_manager()
    pilot = pm.submit_pilot(PilotDescription(num_devices=8))
    agent = RemoteAgent(pilot, max_workers=4)
    try:
        tasks = agent.submit([TaskDescription(name=f"t{i}", fn=_compute, args=(100 + i,),
                                              num_devices=2) for i in range(6)])
        assert all(t.state is TaskState.DONE for t in tasks), [t.error for t in tasks]
        assert [t.result for t in tasks] == [100.0 + i for i in range(6)]
        assert set(tasks[0].overhead_s) >= {"queue", "communicator"}
        t, = agent.submit([TaskDescription(name="flaky", fn=_Flaky(), max_retries=3)])
        assert t.state is TaskState.DONE and t.result == "recovered" and t.attempts == 3
        t, = agent.submit([TaskDescription(name="devfail", fn=_FailingDevices(),
                                           num_devices=8, max_retries=2)])
        assert t.state is TaskState.DONE, t.error
        assert t.result == 6  # re-carved on the 6 survivors
        assert len(pilot.alive_devices()) == 6
        with pytest.raises(RuntimeError):
            pm.submit_pilot(PilotDescription(num_devices=2))  # no overlapping pool
    finally:
        agent.close()
    assert pm.cancel_pilot(pilot) == 6  # the 2 failed devices stay retired
    pilot2 = pm.submit_pilot(PilotDescription(num_devices=4))
    pilot3 = pm.submit_pilot(PilotDescription(num_devices=2))
    ids2 = {d.id for d in pilot2.alive_devices()}
    ids3 = {d.id for d in pilot3.alive_devices()}
    assert not ids2 & ids3, f"pilot pools overlap: {ids2 & ids3}"
    with RemoteAgent(pilot2, max_workers=2) as agent2:
        out = Pipeline("demo", [Stage("produce", lambda comm, up: 21),
                                Stage("consume", lambda comm, up: up["produce"] * 2,
                                      deps=("produce",))]).run(agent2)
    assert out["consume"] == 42
    state = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
             "step": torch.tensor(7)}
    store.save(str(tmp_path / "ckpt"), 7, state)
    restored = store.restore(str(tmp_path / "ckpt"), state)
    assert torch.equal(restored["w"], state["w"]) and int(restored["step"]) == 7
    ac = store.AsyncCheckpointer(str(tmp_path / "async"), keep=2)
    for s in range(4):
        ac.save(s, state)
    ac.close()
    assert store.latest_step(str(tmp_path / "async")) == 3
    assert sorted(os.listdir(tmp_path / "async")) == ["step_00000002", "step_00000003"]


def test_subprocess_transport_multiprocess_e2e(tmp_path):
    """tests/spawn/subprocess_transport.py: an 8-device pilot of stand-in
    devices whose attempts run in worker processes of 2 logical devices
    each."""
    import torch_exec_tasks as T
    from repro_torch.core import Session
    from repro_torch.core.exec import SubprocessTransport

    transport = SubprocessTransport(max_workers=2, worker_devices=2, device="cpu")
    try:
        pm = _stand_in_manager()
        pilot = pm.submit_pilot(PilotDescription(num_devices=8))
        agent = RemoteAgent(pilot, transport=transport, max_workers=2)
        # no speculative twins: a twin leases one device, so one that beat
        # a primary held up by a booting worker would report width 1
        # (test_torch_runtime.py::test_straggler_twin_runs_at_width_one)
        tasks = agent.submit([TaskDescription(name=f"t{i}", fn=T.mesh_info,
                                              args=(64 + i,), num_devices=2,
                                              speculative=False)
                              for i in range(4)])
        assert all(t.state is TaskState.DONE for t in tasks), [t.error for t in tasks]
        pids = {t.result["pid"] for t in tasks}
        assert os.getpid() not in pids and 1 <= len(pids) <= 2
        for i, t in enumerate(tasks):
            # the worker's pool is its own 2 logical devices, not the 8
            assert t.result["worker_devices"] == 2 and t.result["comm_devices"] == 2
            assert t.result["total"] == 64.0 + i
        ckpt = str(tmp_path / "ckpt")
        task, = agent.submit([TaskDescription(
            name="train", fn=T.train_then_die, args=(ckpt,), checkpoint_dir=ckpt,
            max_retries=2, group="g")])
        assert task.state is TaskState.DONE, task.error
        assert task.result[:2] == ("resumed", 7) and task.attempts == 2
        assert agent.quota_violations() == {}
        assert pilot.free_count() == 8, "lease leaked across worker death"
        agent.close()
        pm.cancel_pilot(pilot)
        with Session(manager=pm, pods=[
                PilotDescription(num_devices=4, name="pod-a",
                                 task_kinds=("data_engineering",)),
                PilotDescription(num_devices=4, name="pod-b", task_kinds=("train",))],
                max_workers_per_pilot=1, transport=transport) as session:
            out = session.run(T.shuffle_stage.bind(4096, 4, 0) >> T.reduce_stage,
                              name="xpod")
        assert out["reduce"]["rows"] == 4096 and out["reduce"]["dropped"] == 0
        assert {out["shuffle"]["pid"], out["reduce"]["pid"]} <= set(transport.worker_pids())
        pids = transport.worker_pids()
    finally:
        transport.shutdown(wait=False)
    deadline = time.time() + 10
    alive = pids
    while alive and time.time() < deadline:
        alive = [p for p in pids if _alive(p)]
        time.sleep(0.05)
    assert not alive, f"orphaned workers: {alive}"


def _alive(pid):
    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except (ProcessLookupError, OSError):
        return False
