"""The port's cross-process worker transport (``repro_torch.core.exec``),
on the CPU: the mirror of tests/test_exec_transport.py test for test
(RPC round trip, tensors bitwise, typed remote errors, the picklable
contract naming the leaf, SIGKILL and respawn, the heartbeat backstop,
reaping, checkpoint-aware retry through the agent, the single-host
distributed transport, the Session pipeline, the service stage and the
fleet's KV handoff across a real process boundary), then the port
against the JAX package where a value is computed: the pipeline's
result equals JAX's operators' at 8 host devices, and a worker's
service stage streams JAX's engine's tokens on JAX's weights.  Last, the
streamer race of the JAX worker (``_Streamer.sweep`` read the token
count before ``done``), pinned deterministically, repaired in the port.

Task fns live in ``tests/torch_exec_tasks.py`` (workers import them by
qualified name through the ``sys.path`` the transport hands them).
JAX's distributed operators need 8 host devices: the module runs itself
as a script in a subprocess for them (``python
tests/test_torch_exec_transport.py OUT.npz``)."""
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_exec_tasks as T  # noqa: E402
from repro_torch.core import Session  # noqa: E402
from repro_torch.core.agent import RemoteAgent  # noqa: E402
from repro_torch.core.exec import (DistributedTransport, RemoteTaskError,  # noqa: E402
                                   SubprocessTransport, WorkerCrashed,
                                   ensure_picklable)
from repro_torch.core.exec import protocol  # noqa: E402
from repro_torch.core.exec.pickling import check_roundtrip  # noqa: E402
from repro_torch.core.exec.remote import run_task_body  # noqa: E402
from repro_torch.core.exec.transport import _StreamTable  # noqa: E402
from repro_torch.core.exec.worker import _Streamer  # noqa: E402
from repro_torch.core.pilot import PilotDescription, PilotManager  # noqa: E402
from repro_torch.core.task import TaskDescription, TaskState  # noqa: E402
from repro_torch.serve import Request, RequestState, build_fleet  # noqa: E402

CPU = torch.device("cpu")
ARCH = "tinyllama-1.1b"
ENGINE_KW = {"max_slots": 2, "max_len": 24}
FP32 = {"compute_dtype": torch.float32}
# the pipeline: rows of the shuffled table, logical shards, its seed
ROWS, SHARDS, SEED = 4096, 8, 0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    t = SubprocessTransport(max_workers=2, worker_devices=1, device="cpu")
    yield t
    t.shutdown(wait=False)


def _cpu_manager(n=1):
    return PilotManager(devices=[CPU] * n)


# ---------------------------------------------------------------------------
# RPC round trip + wire fidelity
# ---------------------------------------------------------------------------


def test_submit_roundtrip(pool):
    futs = [pool.submit(T.echo, i) for i in range(8)]
    assert [f.result(timeout=120) for f in futs] == list(range(8))
    info = pool.wait_ready(timeout=120)
    assert all(w["devices"] == 1 and w["device_name"] == "cpu" for w in info.values())
    assert os.getpid() not in {pool.submit(T.pid).result(timeout=120) for _ in range(4)}


def test_tensors_cross_bitwise(pool):
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(1000, 64)).astype(np.float32))
    view = base[10:12, ::2]
    a = {"f32": base[:16], "bf16": base[:16].to(torch.bfloat16), "view": view,
         "np": rng.normal(size=(16, 8)).astype(np.float32), "empty": torch.empty(0, 3)}
    out = pool.submit(T.echo, a).result(timeout=120)
    for k in ("f32", "bf16", "view", "empty"):
        assert out[k].dtype == a[k].dtype and torch.equal(out[k], a[k]), k
    np.testing.assert_array_equal(out["np"], a["np"])
    # the bits themselves, bf16 included
    assert torch.equal(out["bf16"].view(torch.int16), a["bf16"].view(torch.int16))
    assert torch.equal(check_roundtrip(view), view)
    # a view ships its own 64 elements, not its 64000-element base
    assert len(protocol.dumps(view)) < 4 * view.numel() + 512
    assert len(protocol.dumps(base)) > 4 * base.numel()


def test_frame_lengths_past_4_gib_fit_the_header():
    """A frame's length is 8 bytes: a gang's result gathered to rank 0
    passes 2 GiB at 2^26 rows over 4 ranks (~3 GB), which a 4-byte
    header under JAX's 2 GiB cap took for a corrupt frame (the parent
    then reported the worker dead); a length past MAX_FRAME is still
    refused as corrupt."""
    n = 5 << 30
    assert protocol._LEN.unpack(protocol._LEN.pack(n)) == (n,) and n <= protocol.MAX_FRAME
    server = socket.create_server(("127.0.0.1", 0))
    a = socket.create_connection(server.getsockname())
    b, _ = server.accept()
    try:
        tx, rx = protocol.Channel(a), protocol.Channel(b)
        tx.send({"type": "echo", "v": list(range(5))})
        assert rx.recv(timeout=10) == {"type": "echo", "v": [0, 1, 2, 3, 4]}
        a.sendall(protocol._LEN.pack(protocol.MAX_FRAME + 1))
        with pytest.raises(protocol.ConnectionClosed, match="corrupt frame length"):
            rx.recv(timeout=10)
    finally:
        for sock in (a, b, server):
            sock.close()


def test_a_frame_in_flight_counts_as_life():
    """The heartbeat monitor reads ``Channel.last_rx``: bytes of a frame
    that takes longer than the heartbeat timeout to arrive (a gang's
    3 GB result, its heartbeats queued behind it) keep the worker alive;
    the frame still arrives whole after a receive timed out mid-way."""
    server = socket.create_server(("127.0.0.1", 0))
    a = socket.create_connection(server.getsockname())
    b, _ = server.accept()
    try:
        rx = protocol.Channel(b)
        payload = protocol.dumps({"type": "result", "v": list(range(1000))})
        frame = protocol._LEN.pack(len(payload)) + payload
        t0 = rx.last_rx
        time.sleep(0.05)
        a.sendall(frame[:100])
        with pytest.raises(socket.timeout):
            rx.recv(timeout=0.5)
        assert rx.last_rx > t0 + 0.04  # the partial frame moved it
        a.sendall(frame[100:])
        assert rx.recv(timeout=10)["v"] == list(range(1000))
    finally:
        for sock in (a, b, server):
            sock.close()


def test_a_frame_that_decodes_longer_than_the_heartbeat_timeout_counts_as_life():
    """A result whose unpickling in the parent outlasts the heartbeat
    timeout (a gang's 3 GB result decodes for seconds) leaves the worker
    alive: the monitor reads a frame being decoded as life."""
    t = SubprocessTransport(max_workers=1, worker_devices=1, device="cpu",
                            heartbeat_s=0.1, heartbeat_timeout_s=1.0)
    try:
        assert t.submit(T.echo, 0).result(timeout=120) == 0
        (pid,) = t.worker_pids()
        assert t.submit(T.slow_to_load, 2.5).result(timeout=60) == 2.5
        assert t.worker_pids() == [pid] and t.submit(T.echo, 1).result(timeout=60) == 1
    finally:
        t.shutdown(wait=False)


def test_remote_exception_is_typed(pool):
    with pytest.raises(RemoteTaskError) as ei:
        pool.submit(T.boom).result(timeout=120)
    assert ei.value.remote_type == "ValueError"
    assert "worker-side failure" in str(ei.value)
    assert "boom" in ei.value.remote_traceback


def test_unpicklable_fn_rejected_at_submit(pool):
    with pytest.raises(TypeError, match="picklable-task contract"):
        pool.submit(lambda: 1)
    with pytest.raises(TypeError, match="picklable-task contract"):
        pool.submit(pool.shutdown)  # bound method of a live instance

    captured = 3

    def nested():
        return captured

    ensure_picklable(T.echo)  # module-level fn: fine
    with pytest.raises(TypeError, match="nested function"):
        ensure_picklable(nested)


def test_unpicklable_argument_names_the_leaf(pool):
    with pytest.raises(TypeError, match=r"args\[0\]\['ev'\]"):
        pool.submit(T.echo, {"ev": threading.Event()})


def test_cuda_lease_in_a_worker_without_a_gpu_raises(pool):
    """The pool runs on the CPU, so its workers see no card: a task body
    whose lease is of the card raises there instead of carrying on on the
    CPU."""
    fut = pool.submit(run_task_body, T.mesh_info, (4,), {}, 1, None, ("data",), "cuda")
    with pytest.raises(RemoteTaskError, match="sees no GPU"):
        fut.result(timeout=120)
    out = pool.submit(run_task_body, T.mesh_info, (4,), {}, 2, None, ("data",),
                      "cpu").result(timeout=120)
    # a 2-device lease degrades to the worker's one-device pool
    assert out["result"]["comm_devices"] == 1 and out["result"]["total"] == 4.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SubprocessTransport(max_workers=1)


# ---------------------------------------------------------------------------
# fault detection
# ---------------------------------------------------------------------------


def test_sigkill_surfaces_promptly_and_worker_respawns():
    t = SubprocessTransport(max_workers=1, worker_devices=1, device="cpu")
    try:
        assert t.submit(T.echo, 1).result(timeout=120) == 1
        t0 = time.time()
        with pytest.raises(WorkerCrashed, match="died while running"):
            t.submit(T.die).result(timeout=30)
        assert time.time() - t0 < 10.0, "crash detection too slow"
        # the pool respawned: the next task runs on a fresh worker
        assert t.submit(T.echo, 2).result(timeout=120) == 2
    finally:
        t.shutdown(wait=False)


def test_hung_worker_caught_by_heartbeat_backstop():
    """SIGSTOP freezes the worker without closing its socket or exiting
    the process — only the heartbeat-age path can catch it."""
    t = SubprocessTransport(max_workers=1, worker_devices=1, device="cpu",
                            heartbeat_s=0.1, heartbeat_timeout_s=1.0)
    try:
        # prove the worker is up first: freezing it mid-boot would land on
        # the (long) start-timeout path instead of the heartbeat backstop
        assert t.submit(T.echo, 0).result(timeout=120) == 0
        fut = t.submit(T.sleep_for, 60)
        time.sleep(0.3)  # let the task land on the worker
        (pid,) = t.worker_pids()
        os.kill(pid, signal.SIGSTOP)
        with pytest.raises(WorkerCrashed, match="heartbeat"):
            fut.result(timeout=30)
    finally:
        t.shutdown(wait=False)


def test_shutdown_no_wait_reaps_all_workers():
    t = SubprocessTransport(max_workers=2, worker_devices=1, device="cpu")
    t.submit(T.echo, 1).result(timeout=120)
    t.wait_ready(timeout=120)
    pids = t.worker_pids()
    assert len(pids) == 2
    t.shutdown(wait=False)
    deadline = time.time() + 10
    while time.time() < deadline:
        alive = [p for p in pids if _pid_alive(p)]
        if not alive:
            return
        time.sleep(0.05)
    raise AssertionError(f"orphaned workers after shutdown: {alive}")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    # zombie counts as reaped-in-progress: ask the kernel for state
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


# ---------------------------------------------------------------------------
# agent integration: checkpoint-aware retry across a worker death
# ---------------------------------------------------------------------------


def test_agent_retries_dead_worker_task_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    transport = SubprocessTransport(max_workers=1, worker_devices=1, device="cpu")
    pm = _cpu_manager()
    pilot = pm.submit_pilot(PilotDescription(num_devices=1))
    agent = RemoteAgent(pilot, transport=transport)
    try:
        task, = agent.submit([TaskDescription(
            name="train", fn=T.train_then_die, args=(ckpt,),
            checkpoint_dir=ckpt, max_retries=2, group="g")])
        assert task.state == TaskState.DONE, task.error
        assert task.result[:2] == ("resumed", 7)
        assert task.result[2] != os.getpid()
        assert task.attempts == 2
        assert agent.quota_violations() == {}
        assert pilot.free_count() == 1, "lease leaked across worker death"
    finally:
        agent.close()
        transport.shutdown(wait=False)


# ---------------------------------------------------------------------------
# the distributed transport on one host is the subprocess pool
# ---------------------------------------------------------------------------


def test_jax_distributed_single_host_executes():
    with pytest.raises(NotImplementedError, match="no multi-host fabric"):
        DistributedTransport(world_size=2, rank=0, device="cpu")
    t = DistributedTransport(world_size=1, rank=0, max_workers=1,
                             worker_devices=1, device="cpu")
    try:
        assert t.name == "jax-distributed" and t.remote
        assert t.submit(T.echo, 41).result(timeout=120) == 41
    finally:
        t.shutdown(wait=False)


# ---------------------------------------------------------------------------
# Session: pipeline + service stage end to end over subprocess workers
# ---------------------------------------------------------------------------


def _run_pipeline(transport_spec):
    with Session(manager=_cpu_manager(), pods=[PilotDescription(num_devices=1)],
                 max_workers_per_pilot=1, transport=transport_spec,
                 transport_options={"worker_devices": 1}) as s:
        graph = T.shuffle_stage.bind(ROWS, SHARDS, SEED) >> T.reduce_stage
        return s.run(graph, name="p")


@pytest.fixture(scope="module")
def pipelines():
    return {spec: _run_pipeline(spec) for spec in ("subprocess", "in-process")}


def test_session_pipeline_matches_in_process(pipelines):
    sub, inp = pipelines["subprocess"], pipelines["in-process"]
    assert sub["reduce"]["pid"] != os.getpid() and sub["shuffle"]["pid"] != os.getpid()
    assert inp["reduce"]["pid"] == os.getpid()
    for k in ("rows", "key_sum", "largest_shard", "dropped"):
        assert sub["reduce"][k] == inp["reduce"][k], k
    for k in ("counts", "key_sums"):
        np.testing.assert_array_equal(sub["shuffle"][k], inp["shuffle"][k])
    assert sub["reduce"]["rows"] == ROWS and sub["reduce"]["dropped"] == 0


def _serve(transport_spec, jax_params, prompts, gen):
    stage_ = T.engine_stage.bind(arch=ARCH, smoke=True, overrides=FP32,
                                 engine_kw=ENGINE_KW, jax_params=jax_params)
    with Session(manager=_cpu_manager(), pods=[PilotDescription(num_devices=1)],
                 max_workers_per_pilot=1, transport=transport_spec,
                 transport_options={"worker_devices": 1}) as s:
        handle = s.serve(stage_, name="svc")
        reqs = [handle.submit_request(Request(p, max_new_tokens=gen)) for p in prompts]
        deadline = time.time() + 300
        for r in reqs:
            while not r.wait(1.0):
                task = handle.task
                if task is not None and task.finalized and task.error:
                    raise AssertionError(f"service failed: {task.error}")
                assert time.time() < deadline, f"{r.rid} stalled: {r.tokens}"
        assert handle.stop(drain=True, timeout=60)
        return reqs, handle.task.result


@pytest.fixture(scope="module")
def jax_weights():
    """JAX's smoke tinyllama weights (fp32 compute) as numpy, and its
    engine's greedy streams of three prompts."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.common.params import init_params as jinit
    from repro.configs import get_config as jget
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    from repro.train.state import model_specs as jspecs

    jcfg = dataclasses.replace(jget(ARCH, smoke=True), compute_dtype=jnp.float32)
    jp = jinit(jax.random.PRNGKey(0), jspecs(jcfg))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 64, 8).astype(np.int32) for _ in range(3)]
    eng = JEngine(jcfg, params=jp, **ENGINE_KW)
    ref = [eng.submit(JRequest(p, max_new_tokens=6)) for p in prompts]
    eng.run_until_drained()
    return jax.tree.map(np.asarray, jp), prompts, [list(r.tokens) for r in ref]


def test_service_stage_streams_match_in_process(jax_weights):
    jp, prompts, _ = jax_weights
    sub, sub_out = _serve("subprocess", jp, prompts, 6)
    inp, inp_out = _serve("in-process", jp, prompts, 6)
    assert sub_out["pid"] != os.getpid() and inp_out["pid"] == os.getpid()
    assert sub_out["weights_checksum"] == inp_out["weights_checksum"]
    assert [r.tokens for r in sub] == [r.tokens for r in inp]
    assert all(r.state is RequestState.DONE and len(r.tokens) == 6 for r in sub)
    assert sub_out["stats"]["completed"] == inp_out["stats"]["completed"] == 3


# ---------------------------------------------------------------------------
# fleet: KV-page handoff round-trips bitwise across the process boundary
# ---------------------------------------------------------------------------


def _run_fleet(transport, tp):
    from repro_torch.configs import get_config
    cfg = get_config(ARCH, smoke=True).with_overrides(**FP32)
    kw = {"transport": transport} if transport is not None else {}
    router = build_fleet(cfg, num_engines=2, disaggregate=True, params=tp,
                         seed=0, router_kwargs=kw, name_prefix="t", device="cpu",
                         **ENGINE_KW)
    router.start()
    try:
        rng = np.random.default_rng(3)
        reqs = [router.submit(Request(rng.integers(1, 64, 8), max_new_tokens=6))
                for _ in range(3)]
        deadline = time.time() + 300
        for r in reqs:
            while not r.wait(1.0):
                assert time.time() < deadline, f"{r.rid} stalled: {r.tokens}"
        return [list(r.tokens) for r in reqs], router.stats()
    finally:
        router.close()


def test_fleet_handoff_roundtrips_bitwise_across_processes(jax_weights):
    from repro_torch.common.params import from_jax_params
    tp = from_jax_params(jax_weights[0], "cpu")
    transport = SubprocessTransport(max_workers=1, worker_devices=1, device="cpu")
    try:
        toks_sub, stats_sub = _run_fleet(transport, tp)
    finally:
        transport.shutdown(wait=False)
    toks_in, stats_in = _run_fleet(None, tp)
    # every prefill->decode migration crossed a real process boundary on
    # the subprocess run, and the decoded streams are identical token for
    # token — the page bytes round-tripped bitwise
    assert stats_sub["handoffs_routed"] >= 1
    assert stats_sub["handoff_wire_roundtrips"] == stats_sub["handoffs_routed"]
    assert stats_sub["handoff_wire_bytes"] > 0 and stats_sub["handoff_wire_s"] > 0
    assert stats_in.get("handoff_wire_roundtrips", 0) == 0
    assert toks_sub == toks_in


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def _jax_main(path):
    """The JAX side of the pipeline, at 8 host devices: the same table
    hash-shuffled by JAX's ``ops_dist.shuffle`` (its shard_map bodies
    jitted: the same computation, compiled once), per-shard rows and key
    sums."""
    import jax

    from repro.dataframe import ops_dist as JD
    from repro.dataframe.table import Table as JTable
    from repro.launch.mesh import make_mesh as jmake_mesh

    plain_shard_map = JD.shard_map
    JD.shard_map = lambda f, **kw: jax.jit(plain_shard_map(f, **kw))
    rng = np.random.default_rng(SEED)
    cols = {"k": rng.integers(0, 1 << 20, ROWS).astype(np.int32),
            "v": rng.normal(size=ROWS).astype(np.float32)}
    t = JTable.from_columns(cols, jmake_mesh((SHARDS,), ("data",)))
    out, dropped = JD.shuffle(t, "k")
    k = np.asarray(out.columns["k"]).reshape(SHARDS, -1).astype(np.int64)
    valid = np.asarray(out.valid).reshape(SHARDS, -1)
    np.savez(path, counts=valid.sum(1), key_sums=np.where(valid, k, 0).sum(1),
             dropped=np.asarray(int(dropped)))


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax8") / "pipeline.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(repo, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={SHARDS}")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"JAX side failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    with np.load(path) as f:
        return dict(f)


def test_pipeline_in_workers_matches_jax(pipelines, jax8):
    """The shuffle stage ran in one worker and its reduction in another;
    the rows each shard holds and their key sums are JAX's, exactly."""
    sub = pipelines["subprocess"]
    np.testing.assert_array_equal(sub["shuffle"]["counts"], jax8["counts"])
    np.testing.assert_array_equal(sub["shuffle"]["key_sums"], jax8["key_sums"])
    assert sub["shuffle"]["dropped"] == int(jax8["dropped"])
    assert sub["reduce"]["key_sum"] == int(jax8["key_sums"].sum())


def test_worker_service_streams_match_jax_engine(jax_weights):
    """A worker's service stage on JAX's weights (fp32 greedy) streams
    JAX's engine's tokens, every request at its full count."""
    jp, prompts, want = jax_weights
    reqs, out = _serve("subprocess", jp, prompts, 6)
    assert out["pid"] != os.getpid()
    assert [r.tokens for r in reqs] == want
    assert all(len(r.tokens) == 6 for r in reqs)


# ---------------------------------------------------------------------------
# the streamer race (the JAX worker's ``_Streamer.sweep``)
# ---------------------------------------------------------------------------


class _RacyTokens(list):
    """A request's token list whose length read lets the engine's last
    append and ``finish`` land right after it: between the streamer's
    read of the token count and its read of ``done``."""

    def __init__(self, tokens, last, req):
        super().__init__(tokens)
        self._last = last
        self._req = req

    def __len__(self):
        n = super().__len__()
        if self._last is not None:
            last, self._last = self._last, None
            self.append(last)
            self._req.token_times.append(time.time())
            self._req._finish(RequestState.DONE)
        return n


class _Wire:
    """A stand-in channel: each frame the streamer sends is applied to
    the parent's table; the parent replica's token count is recorded at
    the moment its ``finish`` lands."""

    def __init__(self, table, parent):
        self.table, self.parent, self.frames = table, parent, []
        self.tokens_at_finish = None

    def send(self, msg):
        self.frames.append(msg["type"])
        if msg["type"] == "finish":
            self.tokens_at_finish = len(self.parent.tokens)
            self.table.apply_finish(msg)
        else:
            self.table.apply_stream(msg)


def test_streamer_sends_every_token_before_finish():
    prompt = np.arange(1, 5, dtype=np.int32)
    worker_req = Request(prompt, max_new_tokens=6)
    worker_req.state = RequestState.RUNNING
    worker_req.tokens = _RacyTokens([7] * 5, 7, worker_req)
    worker_req.token_times = [0.0] * 5
    parent = Request(prompt, max_new_tokens=6)
    parent.rid = worker_req.rid
    table = _StreamTable()
    table.track(parent)
    wire = _Wire(table, parent)
    streamer = _Streamer(wire, task_id=0)
    try:
        streamer.register(worker_req)
        assert parent.wait(10.0), "the finish frame never came"
    finally:
        streamer.close()
    assert wire.tokens_at_finish == 6, wire.frames
    assert wire.frames == ["stream", "stream", "finish"]
    assert parent.tokens == [7] * 6 and parent.state is RequestState.DONE


def test_stream_table_applies_tokens_after_finish():
    """A token frame that arrives after its request's finish frame is
    applied, not dropped; a second finish changes nothing."""
    req = Request(np.arange(1, 5, dtype=np.int32), max_new_tokens=3)
    table = _StreamTable()
    table.track(req)
    table.apply_stream({"rid": req.rid, "tokens": [4, 5], "times": [0.0, 0.1]})
    table.apply_finish({"rid": req.rid, "state": "DONE", "error": None,
                        "finished_at": 1.0})
    table.apply_stream({"rid": req.rid, "tokens": [6], "times": [0.2]})
    table.apply_finish({"rid": req.rid, "state": "FAILED", "error": "late",
                        "finished_at": 2.0})
    assert req.tokens == [4, 5, 6] and req.state is RequestState.DONE
    assert req.finished_at == 1.0


if __name__ == "__main__":
    _jax_main(sys.argv[1])
