"""The port's entry points under its pilot runtime, on the CPU: the
training entry point ``launch.train.run`` as a stage graph (with checkpoint
resume), ``ServeEngine.run_service`` as a service stage (stop, drain,
preempt and resume, with streams equal to ``run_until_drained``), the
paper's tables (``launch.paper_tables``) at a few steps, and the
refusals: no GPU without ``device='cpu'``, the JAX package's default
architecture, Fig. 4.  Mirrors the service-stage tests of
tests/test_serving.py."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.params import init_params  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core import Session, stage  # noqa: E402
from repro_torch.core.agent import RemoteAgent  # noqa: E402
from repro_torch.core.pilot import PilotDescription, PilotManager  # noqa: E402
from repro_torch.core.pipeline import Pipeline, PipelineScheduler, Stage  # noqa: E402
from repro_torch.core.task import (ServiceControl, ServicePreempted,  # noqa: E402
                                   TaskDescription, TaskState)
from repro_torch.launch import paper_tables as P  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.serve import Request, RequestState, ServeEngine  # noqa: E402
from repro_torch.train.state import init_train_state, model_specs  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CFG = get_config("tinyllama-1.1b", smoke=True).with_overrides(
    compute_dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), model_specs(CFG), "cpu")


def _cpu_manager():
    return PilotManager(devices=[CPU])


def _engine(params, **kw):
    kw.setdefault("idle_wait_s", 0.002)
    return ServeEngine(CFG, RunConfig(), params=params, device="cpu", **kw)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, n).astype(np.int32) for n in lens]


def _direct(params, prompts, gen, **kw):
    eng = _engine(params, **kw)
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run_until_drained()
    return [r.tokens for r in reqs]


def _service_pipeline(engine, priority=0):
    return Pipeline("serve", [Stage(
        "engine",
        lambda comm, upstream, control=None, resume_state=None:
            engine.run_service(control, resume_state=resume_state),
        kind="inference", service=True, priority=priority)])


# ---------------------------------------------------------------------------
# the training entry point as a stage graph
# ---------------------------------------------------------------------------


def _train_args(tmp_path, *extra):
    return tlaunch.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
         "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt"),
         *extra])


def test_launch_train_runs_as_a_stage_graph_and_resumes(tmp_path):
    res = tlaunch.run(_train_args(tmp_path, "--steps", "3"))
    assert res["steps"] == 3 and math.isfinite(res["last_loss"])
    assert set(res["placement"]) == {"preprocess", "train", "postprocess"}
    assert len(set(res["placement"].values())) == 1, "one card, one pod"
    assert {"queue", "communicator"} <= set(res["overheads"])
    assert res["kind_pods"] is None
    assert store.latest_step(str(tmp_path / "ckpt")) == 3
    # the train stage computes what the plain loop computes: its first
    # loss is the first step's on the corpus' first batch
    cfg = get_config("tinyllama-1.1b", smoke=True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg,
                             RunConfig(), device="cpu")
    corpus = tlaunch.make_corpus(cfg.vocab_size, 2 * 32 * (3 + 8))
    tok = torch.from_numpy(corpus[:64].reshape(2, 32))
    _, m = make_train_step(cfg, RunConfig())(
        state, {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)})
    assert res["first_loss"] == pytest.approx(m["loss"].item(), rel=1e-6)
    # --resume restarts from the newest checkpoint and trains the rest
    res = tlaunch.run(_train_args(tmp_path, "--steps", "5", "--resume"))
    assert res["steps"] == 2
    assert store.latest_step(str(tmp_path / "ckpt")) == 5


def test_launch_train_kind_pods_fall_back_to_one_pod(tmp_path):
    res = tlaunch.run(_train_args(tmp_path, "--steps", "1", "--kind-pods"))
    assert res["kind_pods"] is None and res["steps"] == 1


def test_launch_train_default_arch_raises_the_model_layers_refusal(tmp_path):
    """The JAX package's default, xlstm-125m, is recurrent: the port raises
    the model layer's refusal before it acquires anything, and does not
    pick another architecture."""
    args = tlaunch.build_parser().parse_args(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert args.arch == "xlstm-125m"
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        tlaunch.run(args)
    assert not any(tmp_path.iterdir())


def test_entry_points_need_the_card_unless_the_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PilotManager()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session()
    args = tlaunch.build_parser().parse_args(
        ["--arch", "tinyllama-1.1b", "--smoke", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.run(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.bench_hydrology(steps=1)


# ---------------------------------------------------------------------------
# ServeEngine.run_service as a service stage
# ---------------------------------------------------------------------------


def test_session_serve_streams_equal_the_direct_engine(params):
    prompts = _prompts(1, [5, 9, 3, 12])
    want = _direct(params, prompts, 6, max_slots=2, max_len=32)
    eng = _engine(params, max_slots=2, max_len=32)

    @stage(kind="inference", service=True)
    def engine(ctx):
        return eng.run_service(ctx.control, resume_state=ctx.resume_state)

    with Session(manager=_cpu_manager()) as session:
        handle = session.serve(engine, name="serve")
        reqs = [handle.submit_request(Request(p, max_new_tokens=6))
                for p in prompts]
        assert handle.stop(drain=True, timeout=60), "service did not drain"
        assert handle.task.state is TaskState.DONE, handle.task.error
        stats = handle.result
    assert [r.tokens for r in reqs] == want
    assert all(r.state is RequestState.DONE for r in reqs)
    assert stats["completed"] == len(prompts) and stats["kv_layout"] == "paged"


def test_stop_releases_waiting_requests(params):
    """A hard stop() must FAIL outstanding requests (in-slot and queued),
    not abandon them — clients block on Request.wait() with no timeout."""
    eng = _engine(params, max_slots=1, max_len=64)
    ctl = ServiceControl()
    r1 = ctl.submit_request(Request(np.arange(1, 6, dtype=np.int32),
                                    max_new_tokens=50))
    r2 = ctl.submit_request(Request(np.arange(1, 4, dtype=np.int32),
                                    max_new_tokens=50))
    for r in ctl.take_requests():
        eng.submit(r)
    eng.step()  # r1 occupies the only slot; r2 still queued
    ctl.stop()
    stats = eng.run_service(ctl)
    for r in (r1, r2):
        assert r.wait(5), f"{r.rid} waiter never released"
        assert r.state is RequestState.FAILED and "stopped" in r.error
    assert not eng.has_work() and stats["failed"] == 2
    assert sorted(eng.free_pages) == list(range(eng.num_pages)), "pages leaked"


def test_drain_exits_when_idle(params):
    eng = _engine(params, max_slots=2, max_len=32)
    ctl = ServiceControl()
    req = ctl.submit_request(Request(np.arange(1, 5, dtype=np.int32),
                                     max_new_tokens=3))
    ctl.drain()
    with pytest.raises(RuntimeError, match="draining"):
        ctl.submit_request(Request(np.arange(1, 3, dtype=np.int32)))
    stats = eng.run_service(ctl)
    assert req.state is RequestState.DONE and len(req.tokens) == 3
    assert stats["completed"] == 1 and not eng.has_work()


def test_preempt_and_resume_keeps_the_streams(params):
    prompts = _prompts(2, [5, 8])
    want = _direct(params, prompts, 12, max_slots=2, max_len=64)
    eng = _engine(params, max_slots=2, max_len=64)
    ctl = ServiceControl()
    reqs = [ctl.submit_request(Request(p, max_new_tokens=12)) for p in prompts]
    for r in ctl.take_requests():
        eng.submit(r)
    for _ in range(4):
        eng.step()
    ctl.request_preempt()
    with pytest.raises(ServicePreempted) as ei:
        eng.run_service(ctl)
    assert eng.cache is None, "a preempted engine releases its caches"
    ctl._clear_preempt()
    ctl.drain()
    stats = eng.run_service(ctl, resume_state=ei.value.state)
    assert [r.tokens for r in reqs] == want
    assert stats["preemptions"] == 1 and stats["resumes"] == 1


def test_service_stage_excluded_from_barrier(params):
    eng = _engine(params, max_slots=1, max_len=32)
    agent = RemoteAgent(_cpu_manager().submit_pilot(PilotDescription()),
                        max_workers=2)
    try:
        pipe = Pipeline("mixed", [
            Stage("plain", lambda comm, upstream: 41),
            Stage("engine",
                  lambda comm, upstream, control=None, resume_state=None:
                      eng.run_service(control, resume_state=resume_state),
                  kind="inference", service=True),
        ])
        out = pipe.run(agent)  # returns when `plain` is done
        assert out["plain"] == 41
        assert not pipe.tasks["engine"].finalized, "service must outlive the barrier"
        req = pipe.control("engine").submit_request(
            Request(np.arange(1, 5, dtype=np.int32), max_new_tokens=3))
        assert req.wait(30) and req.state is RequestState.DONE
        assert pipe.stop_services(drain=True, timeout=30)
        assert pipe.results["engine"]["completed"] == 1
    finally:
        agent.close()


def test_failed_pipeline_stops_its_service(params):
    eng = _engine(params, max_slots=1, max_len=32)
    agent = RemoteAgent(_cpu_manager().submit_pilot(PilotDescription()),
                        max_workers=2)
    try:
        pipe = Pipeline("doomed", [
            Stage("boom", lambda comm, upstream: 1 / 0, max_retries=0),
            Stage("engine",
                  lambda comm, upstream, control=None, resume_state=None:
                      eng.run_service(control, resume_state=resume_state),
                  kind="inference", service=True),
        ])
        with pytest.raises(RuntimeError, match="division"):
            pipe.run(agent)
        svc = pipe.tasks["engine"]
        assert svc.wait(30), "service must stop when the pipeline fails"
        assert svc.state is TaskState.DONE
    finally:
        agent.close()


def test_training_preempts_service_and_it_resumes(params):
    """A service stage and a higher-priority training pipeline share one
    one-device pilot: the agent preempts the engine (it checkpoints and
    yields), training runs, the engine resumes and drains every request
    with the streams the direct engine gives."""
    prompts = _prompts(5, [6, 6, 6])
    want = _direct(params, prompts, 40, max_slots=2, max_len=128)
    eng = _engine(params, max_slots=2, max_len=128)
    agent = RemoteAgent(_cpu_manager().submit_pilot(PilotDescription(num_devices=1)),
                        max_workers=2)
    try:
        serve_pipe = _service_pipeline(eng, priority=0)
        trained = threading.Event()

        def train_fn(comm, upstream):
            trained.set()
            time.sleep(0.1)
            return "trained"

        train_pipe = Pipeline("train", [
            Stage("step", train_fn, kind="train", priority=10)])
        serve_pipe.start(agent)
        ctl = serve_pipe.control("engine")
        reqs = [ctl.submit_request(Request(p, max_new_tokens=40)) for p in prompts]
        deadline = time.time() + 60
        while reqs[0].first_token_at is None:
            assert time.time() < deadline, "service never started generating"
            time.sleep(0.01)
        out = PipelineScheduler(agent).run([train_pipe], timeout=60)
        assert out["train"]["step"] == "trained" and trained.is_set()
        assert serve_pipe.tasks["engine"].preemptions >= 1
        for r in reqs:
            assert r.wait(120), f"{r.rid} not drained after resume"
        assert [r.tokens for r in reqs] == want
        assert serve_pipe.stop_services(drain=True, timeout=60)
        stats = serve_pipe.results["engine"]
        assert stats["completed"] == 3 and stats["resumes"] >= 1
    finally:
        agent.close()


def test_agent_close_stops_running_service(params):
    eng = _engine(params, max_slots=1, max_len=32)
    agent = RemoteAgent(_cpu_manager().submit_pilot(PilotDescription()),
                        max_workers=2)
    task, = agent.submit_async([TaskDescription(
        name="svc",
        fn=lambda comm, control=None, resume_state=None:
            eng.run_service(control, resume_state=resume_state),
        kind="inference", service=True)])
    deadline = time.time() + 30
    while task.state is not TaskState.RUNNING:
        assert time.time() < deadline
        time.sleep(0.01)
    agent.close()
    assert task.wait(30), "close() must stop the running service"


# ---------------------------------------------------------------------------
# the paper's tables, a few steps each
# ---------------------------------------------------------------------------


def test_paper_tables_run_every_task_to_done():
    fc = P.bench_forecasting(steps=2, device="cpu")
    assert list(fc) == list(P.F.MODELS)
    for name, r in fc.items():
        assert r["state"] == "done", name
        assert {"queue", "communicator"} <= set(r["task_overheads"])
        for run in ("bm", "rc"):
            assert all(math.isfinite(r[run][k])
                       for k in ("MAE", "MSE", "MAPE", "loss", "train_s")), name
        # the same seeds: the task trains exactly what bare metal trains
        assert r["bm"]["MSE"] == r["rc"]["MSE"], name
    hy = P.bench_hydrology(steps=3, device="cpu")
    assert hy["state"] == "done" and hy["days"] == 2000
    assert set(hy["metrics"]) == set(P.Hy.TARGETS)
    assert all(math.isfinite(v) for m in hy["metrics"].values() for v in m.values())
    mp = P.bench_multi_pipeline(device="cpu")
    assert mp["n_pipelines"] == 11 and mp["meta"]["n_failed"] == 0
    assert set(mp["task_states"].values()) == {"done"} and len(mp["task_states"]) == 22


def test_scaling_figure_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        P.bench_scaling_ops(device="cpu")


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def test_port_modules_load_no_jax_and_no_repro():
    """Importing every module of the port, in a fresh interpreter, loads
    neither jax nor the JAX package (the import-statement check of
    test_torch_configs.py, run through every transitive import)."""
    mods = sorted(".".join(p.relative_to(REPO / "src").with_suffix("").parts)
                  for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'flax'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(mods) > 40
