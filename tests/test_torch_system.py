"""End-to-end behaviour of the port's runtime (mirror of the non-spawned
tests of tests/test_system.py): the paper's pipeline (data engineering ->
zero-copy bridge -> DL training -> postprocess) under the port's pilot
runtime on the CPU, held to the JAX package's pipeline on the same table
and unshuffled batches; N pipelines on a shared pilot; task isolation.

Left out: the spawned multi-device suites of tests/test_system.py
(``test_distributed_dataframe_ops``, ``test_runtime_fault_tolerance``,
``test_distributed_extras``, ``test_subprocess_transport_multiprocess_e2e``):
they need meshes over processes, the distributed extras and the
subprocess transport, which come with ROADMAP.md queue 1, item 6.
"""
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
from repro_torch.core.pilot import PilotDescription, PilotManager  # noqa: E402
from repro_torch.core.pipeline import Pipeline, run_pipelines  # noqa: E402
from repro_torch.core.task import TaskDescription, TaskState  # noqa: E402
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
