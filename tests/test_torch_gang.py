"""A task ganged over worker processes, on the CPU: the port's counterpart
of JAX's communicator over several devices (``repro.core.communicator``).

JAX's ``RemoteAgent`` runs a ``num_devices=2`` (and 4) task on a mesh of
as many host devices in one process; the port's runs it as a gang of as
many ranks, one a worker process of a ``SubprocessTransport``
(``worker_devices=1``), over a gloo ``ProcessMesh``.  The attempt's
result is rank 0's.  JAX's side runs in a subprocess at that many host
devices (``python tests/test_torch_gang.py OUT.npz RANKS``), as
``tests/test_torch_dataframe.py`` starts its own.

Tolerances: columns, masks and rows dropped bitwise; groupby sums within
1e-4 absolute and reduce within 1e-5 relative (the card's distributed
phase's bounds)."""
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_exec_tasks as T  # noqa: E402
from repro_torch.core.agent import RemoteAgent  # noqa: E402
from repro_torch.core.communicator import build_communicator  # noqa: E402
from repro_torch.core.exec import SubprocessTransport  # noqa: E402
from repro_torch.core.exec.transport import _Gang, _Job, _match  # noqa: E402
from repro_torch.core.pilot import PilotDescription, PilotManager  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.core.task import TaskDescription, TaskState  # noqa: E402

CPU = torch.device("cpu")
RANKS = 2
SPEC = {"seed": 0, "rows": 4096, "keys": 1000, "groups_cap": 4096, "warmup": False}
SUM_ATOL, REDUCE_RTOL = 1e-4, 1e-5


def _jax_main(path, ranks):
    """JAX's agent runs the gang's operators as one task over a mesh of
    ``ranks`` host devices; its host values go to an ``.npz``.  The
    shard_map bodies are jitted, as in ``tests/test_torch_dataframe.py``."""
    import jax

    from repro.core.agent import RemoteAgent as JAgent
    from repro.core.pilot import PilotDescription as JDesc
    from repro.core.pilot import PilotManager as JManager
    from repro.core.task import TaskDescription as JTask
    from repro.dataframe import ops_dist as JD
    from repro.dataframe.table import Table as JTable

    plain_shard_map = JD.shard_map
    JD.shard_map = lambda f, **kw: jax.jit(plain_shard_map(f, **kw))

    def task(comm):
        left, right = T.gang_tables(SPEC)
        t = JTable.from_columns(left, comm.mesh)
        r = JTable.from_columns(right, comm.mesh)
        out = {"size": np.asarray(comm.size)}
        for name, call in T.gang_calls(t, r, JD, SPEC["groups_cap"]).items():
            res, dropped = call()
            if name == "reduce":
                out["reduce/v"] = np.asarray(res["v"])
                continue
            out[f"{name}/dropped"] = np.asarray(dropped)
            out[f"{name}/valid"] = np.asarray(res.valid)
            for col, v in res.columns.items():
                out[f"{name}/{col}"] = np.asarray(v)
        return out

    pilot = JManager().submit_pilot(JDesc(num_devices=ranks))
    agent = JAgent(pilot, max_workers=1)
    try:
        t, = agent.submit([JTask(name="df", fn=task, num_devices=ranks)])
    finally:
        agent.close()
    assert t.state.name == "DONE", t.error
    np.savez(path, **t.result)


def _pool(n):
    t = SubprocessTransport(max_workers=n, worker_devices=1, device="cpu",
                            heartbeat_s=0.1, heartbeat_timeout_s=3.0)
    t.wait_ready(timeout=120)
    return t


@pytest.fixture(scope="module")
def pool():
    t = _pool(RANKS)
    yield t
    t.shutdown(wait=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agent(pool, n=RANKS):
    pilot = PilotManager(devices=[CPU] * n).submit_pilot(PilotDescription(num_devices=n))
    return RemoteAgent(pilot, transport=pool)


def _run(pool, fn, *args, n=RANKS, **kw):
    with _agent(pool, n) as agent:
        task, = agent.submit([TaskDescription(name=fn.__name__, fn=fn, args=args,
                                              num_devices=n, speculative=False, **kw)])
        return task, agent


# -- (a) the gang through the agent ---------------------------------------------


def test_gang_runs_one_rank_a_worker_and_returns_rank_0s_result(pool):
    task, agent = _run(pool, T.gang_info, 3)
    assert task.state is TaskState.DONE, task.error
    out = task.result
    assert out["rank"] == 0 and out["size"] == RANKS and out["backend"] == "gloo"
    assert out["total"] == 3.0 * RANKS  # the group's all-reduce
    assert len(set(out["pids"])) == RANKS
    assert set(out["pids"]) == set(pool.worker_pids()) and os.getpid() not in out["pids"]
    assert out["describe"]["rank"] == 0 and out["describe"]["size"] == RANKS
    assert {"queue", "rendezvous", "communicator"} <= set(task.overhead_s)
    assert agent.pilot.free_count() == RANKS  # the lease came back


def test_session_stage_wider_than_a_worker_runs_as_a_gang(pool):
    """A stage whose num_devices spans more than a worker's pool runs as a
    gang under a Session on a worker-pool transport."""
    pm = PilotManager(devices=[CPU] * RANKS)
    with Session(manager=pm, pods=[PilotDescription(num_devices=RANKS)],
                 transport=pool) as session:
        out = session.run(T.gang_stage, name="gang")
    assert out["wide"]["size"] == RANKS and out["wide"]["rank"] == 0
    assert len(set(out["wide"]["pids"])) == RANKS


# -- (b) parity with JAX's num_devices=2 task -----------------------------------


def _jax_gang(tmp_path_factory, ranks):
    path = tmp_path_factory.mktemp(f"jax{ranks}") / "gang.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(repo, "src"),
                                           os.path.dirname(os.path.abspath(__file__))]),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={ranks}")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(path), str(ranks)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"JAX side failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    with np.load(path) as f:
        return dict(f)


# the gang's widths: 2, and the 4 ranks chip_smoke.py --cards gangs over
# four cards (JAX: num_devices=4 on 4 host devices)
GANG_WIDTHS = (RANKS, 4)


@pytest.fixture(scope="module", params=GANG_WIDTHS, ids=lambda n: f"ranks{n}")
def gang_and_jax(request, tmp_path_factory):
    """(ranks, JAX's task at num_devices=ranks, the port's gang of ranks)."""
    n = request.param
    want = _jax_gang(tmp_path_factory, n)
    wide = request.getfixturevalue("pool") if n == RANKS else _pool(n)
    try:
        task, _ = _run(wide, T.gang_dataframe, SPEC, n=n)
    finally:
        if n != RANKS:
            wide.shutdown(wait=False)
    assert task.state is TaskState.DONE, task.error
    return n, want, task.result


@pytest.mark.parametrize("op", T.GANG_OPS)
def test_gang_dataframe_matches_jax(gang_and_jax, op):
    n, jaxr, gang = gang_and_jax
    assert int(jaxr["size"]) == gang["world"] == n
    assert gang["backend"] == "gloo" and len(set(gang["pids"])) == n
    assert [sorted(x) for x in gang["launches"]] == [sorted(T.GANG_OPS)] * n
    res = gang["results"][op]
    if op == "reduce":
        want = float(jaxr["reduce/v"])
        assert abs(res["v"] - want) <= REDUCE_RTOL * abs(want)
        return
    assert res["dropped"] == int(jaxr[f"{op}/dropped"])
    np.testing.assert_array_equal(res["valid"], jaxr[f"{op}/valid"])
    assert set(res["cols"]) == {k.split("/", 1)[1] for k in jaxr
                                if k.startswith(f"{op}/")} - {"dropped", "valid"}
    for col, got in res["cols"].items():
        want = jaxr[f"{op}/{col}"]
        assert got.dtype == want.dtype and got.shape == want.shape, col
        if op == "groupby" and col == "v":
            np.testing.assert_allclose(got, want, rtol=0, atol=SUM_ATOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=col)


# -- (c), (d) a failed or killed rank -------------------------------------------


def test_a_rank_that_raises_fails_the_attempt_and_the_retry_reuses_the_workers(pool, tmp_path):
    before = set(pool.worker_pids())
    task, _ = _run(pool, T.gang_raises_once, str(tmp_path / "marker"), max_retries=2)
    assert task.state is TaskState.DONE, task.error
    assert task.attempts == 2
    # the retry joined a fresh group (its all-reduce sums both ranks) on
    # the same two workers: no stale process group was left behind
    assert task.result["total"] == 4.0 * RANKS and task.result["size"] == RANKS
    assert set(task.result["pids"]) == before == set(pool.worker_pids())


def test_a_rank_killed_in_a_collective_fails_the_attempt_and_the_workers_respawn(pool, tmp_path):
    respawns = pool.stats()["respawns"]
    t0 = time.time()
    task, _ = _run(pool, T.gang_dies_in_collective, str(tmp_path / "marker"),
                   max_retries=2, timeout_s=60.0)
    assert time.time() - t0 < 60, "a rank blocked in a collective was left hanging"
    assert task.state is TaskState.DONE, task.error
    assert task.attempts == 2 and task.result["total"] == 4.0 * RANKS
    # the killed rank's worker and the one blocked in the all-reduce
    assert pool.stats()["respawns"] >= respawns + 2
    assert set(task.result["pids"]) == set(pool.worker_pids())


def test_a_gang_the_pool_can_no_longer_place_fails_and_does_not_block_the_queue():
    """With the respawn cap spent, a dead slot stays dead: a gang that
    needs it fails at the queue head, and a plain task queued behind it
    still runs on the live worker."""
    t = SubprocessTransport(max_workers=RANKS, worker_devices=1, device="cpu",
                            heartbeat_s=0.1, heartbeat_timeout_s=3.0, max_respawns=0)
    try:
        t.wait_ready(timeout=120)
        victim = t.worker_pids()[0]
        os.kill(victim, signal.SIGKILL)
        deadline = time.time() + 30
        while victim in t.worker_pids() and time.time() < deadline:
            time.sleep(0.05)
        assert t.worker_pids() and victim not in t.worker_pids()
        gang = t.submit_gang(T.gang_info, [CPU] * RANKS, 1)
        plain = t.submit(T.pid)
        with pytest.raises(RuntimeError, match="can no longer be placed"):
            gang.result(timeout=30)
        assert plain.result(timeout=30) == t.worker_pids()[0]
        assert t.stats()["respawns"] == 0
    finally:
        t.shutdown(wait=False)


def test_a_gangs_kill_spares_a_worker_that_took_up_other_work(pool):
    """The kill of a failed gang's ranks names the job it expects: a
    worker that no longer runs it (here: idle) is left alone."""
    before = sorted(pool.worker_pids())
    respawns = pool.stats()["respawns"]
    w = next(iter(pool._workers.values()))
    stale = _Gang(None, [None], "gloo", 30.0)
    pool._worker_lost(w, "rank 1 of its gang failed",
                      only_if_job=_Job(-1, b"", "stale rank", None, None, gang=stale))
    assert sorted(pool.worker_pids()) == before
    assert pool.stats()["respawns"] == respawns


# -- (e) a gang wider than the pool ---------------------------------------------


def test_a_gang_wider_than_the_pool_is_refused(pool):
    task, agent = _run(pool, T.gang_info, 1, n=RANKS + 1)
    assert task.state is TaskState.FAILED
    assert "wider than this pool of 2 workers" in task.error
    assert agent.pilot.free_count() == RANKS + 1
    with pytest.raises(ValueError, match="wider than this pool"):
        pool.submit_gang(T.gang_info, [CPU] * (RANKS + 1), 1)


# -- (f) the in-process transport's refusal of distinct cards -------------------


def test_in_process_transport_refuses_distinct_cards():
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match='transport="subprocess"'):
        build_communicator(cards)
    pilot = PilotManager(devices=cards).submit_pilot(PilotDescription(num_devices=2))
    with RemoteAgent(pilot, max_workers=1) as agent:
        task, = agent.submit([TaskDescription(name="x", fn=T.gang_info, args=(1,),
                                              num_devices=2)])
    assert task.state is TaskState.FAILED
    assert 'transport="subprocess"' in task.error
    # one card listed twice stays a logical mesh in one process
    assert build_communicator([CPU, CPU]).mesh.shape == {"data": 2}


# -- the gang's dispatch rules --------------------------------------------------


@pytest.mark.parametrize("devices,worker_devices,gang", [
    ([CPU], 1, False),
    ([CPU, CPU], 1, True),
    ([CPU, CPU], 2, False),
    ([torch.device("cuda", 0), torch.device("cuda", 0)], 1, True),
    ([torch.device("cuda", 0), torch.device("cuda", 0)], 2, False),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], 2, True),
])
def test_needs_gang(pool, devices, worker_devices, gang):
    """A lease wider than a worker's pool, or of distinct cards, is a gang."""
    rule = SimpleNamespace(worker_devices=worker_devices)
    assert SubprocessTransport.needs_gang(rule, devices) is gang


def test_ranks_land_on_workers_that_see_their_cards():
    """Slots hold cards round-robin; each rank goes to a distinct worker
    that sees its card, at that worker's own index of it."""
    w = [SimpleNamespace(wid=i, cards=c) for i, c in
         enumerate((["0", "1"], ["2", "3"], ["0", "1"], ["2", "3"]))]
    placed = _match(["3", "1", "0", "2"], w)
    assert sorted(x.wid for x in placed) == [0, 1, 2, 3]
    assert all(c in x.cards for c, x in zip(["3", "1", "0", "2"], placed))
    assert _match(["0", "0", "0"], w) is None  # two slots hold card 0
    assert [x.wid for x in _match([None, None], w[:2])] in ([0, 1], [1, 0])
    gang = _Gang(None, ["3", "0"], "nccl", 30.0)
    rdv = gang.rendezvous(0, w[1], 29500)
    assert rdv == {"rank": 0, "world": 2, "init_method": "tcp://127.0.0.1:29500",
                   "backend": "nccl", "timeout_s": 30.0, "device": "cuda:1"}
    assert gang.rendezvous(1, w[2], 29500)["device"] == "cuda:0"


if __name__ == "__main__":
    _jax_main(sys.argv[1], int(sys.argv[2]))
