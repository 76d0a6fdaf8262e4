"""Port parity for fleet serving (``repro_torch.serve.router``), mirroring
tests/test_fleet.py on the CPU: EngineRouter load-aware routing and a
drain that is not a shutdown; the engine's one-lock admission signals; a
rolling restart mid-stream through checkpoint and resume; pilot mode on
stand-in pilots, where a higher-priority task preempts an engine, the
router re-routes its work and no quota is violated; disaggregated
prefill/decode through KV-page handoffs shipped by the transport, whose
bytes are exactly the migrating requests' own pages, also over a
stand-in remote transport that pickles them; the handoff's block-table
rewrite on a single exporter and importer; and ``launch.serve`` on the
CPU.  Every greedy
stream is fp32 and equals, token for token, one JAX engine's on the same
weights (``from_jax_params``).  The smoke MoE config's disaggregated
streams equal a JAX engine's that prefills whole prompts, as a
prefill-only engine does (MoE routing sees a chunk's padding, so both
sides must pad alike: the prompts share one chunk bucket)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402
import pickle  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.params import init_params  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.train.state import model_specs  # noqa: E402
from repro_torch.common.params import from_jax_params  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.pilot import Pilot, PilotDescription, PilotManager  # noqa: E402
from repro_torch.core.task import TaskDescription, TaskState  # noqa: E402
from repro_torch.core.transport import InProcessTransport  # noqa: E402
from repro_torch.serve import (EngineRouter, Request, RequestState,  # noqa: E402
                               ServeEngine, build_fleet)

ARCH, MOE = "tinyllama-1.1b", "moonshot-v1-16b-a3b"


def _cfgs(arch):
    return (dataclasses.replace(jget(arch, smoke=True), compute_dtype=jnp.float32),
            tget(arch, smoke=True).with_overrides(compute_dtype=torch.float32))


JCFG32, CFG32 = _cfgs(ARCH)
VOCAB = CFG32.vocab_size


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg, _ = _cfgs(arch)
    jp = init_params(jax.random.PRNGKey(0), model_specs(jcfg))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def params():
    return _weights(ARCH)


def _prompts(rng, lens):
    return [rng.integers(1, VOCAB, int(n)).astype(np.int32) for n in lens]


def _ref_streams(prompts, gen, *, max_len=96, arch=ARCH, **kw):
    """The undisturbed single JAX engine every fleet run must match."""
    jcfg, _ = _cfgs(arch)
    eng = JEngine(jcfg, params=_weights(arch)[0], max_slots=2, max_len=max_len,
                  page_size=16, **kw)
    reqs = [eng.submit(JRequest(p, max_new_tokens=gen)) for p in prompts]
    eng.run_until_drained()
    return [r.tokens for r in reqs]


# ---------------------------------------------------------------------------
# routing: load-aware spread, streams, non-terminal drain
# ---------------------------------------------------------------------------


def test_router_spreads_load_and_matches_reference(params):
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, rng.integers(4, 30, 10))
    ref = _ref_streams(prompts, 16)

    router = build_fleet(CFG32, num_engines=2, params=params[1], max_slots=2,
                         max_len=96, page_size=16, name_prefix="t", device="cpu")
    with router:
        reqs = [router.submit(Request(p, max_new_tokens=16)) for p in prompts]
        assert router.drain(timeout=180)
        # drain is a flush, not a shutdown: the router keeps accepting
        extra = [router.submit(Request(p, max_new_tokens=4)) for p in prompts[:2]]
        assert router.drain(timeout=60)
        stats = router.stats()
    assert [r.tokens for r in reqs] == ref, "fleet changed token streams"
    assert all(r.state is RequestState.DONE for r in extra)
    spread = {k: v for k, v in stats.items() if k.startswith("routed_to.")}
    assert len(spread) == 2, f"both engines must serve: {spread}"
    assert stats["fleet_completed"] == len(reqs) + len(extra)
    # the decode steps' tokens: each request's first comes from its prefill
    assert stats["fleet_tokens_generated"] == sum(len(r.tokens) - 1 for r in reqs + extra)


def test_router_admission_signals_one_lock_snapshot(params):
    eng = ServeEngine(CFG32, params=params[1], max_slots=2, max_len=64,
                      page_size=16, name="sig", device="cpu")
    sig = eng.admission_signals()
    assert sig["engine"] == "sig" and not sig["prefill_only"]
    assert sig["occupied"] == 0 and sig["queue_depth"] == 0
    assert sig["free_pages"] == sig["num_pages"] == eng.num_pages
    eng.submit(Request(np.arange(1, 6, dtype=np.int32), max_new_tokens=4))
    sig = eng.admission_signals()
    assert sig["queue_depth"] == 1
    assert sig["oldest_queued_age_s"] >= 0.0
    pre = ServeEngine(CFG32, params=params[1], max_slots=2, max_len=64,
                      page_size=16, prefill_only=True, device="cpu")
    assert pre.admission_signals()["prefill_only"] and pre.stats()["prefill_only"]


# ---------------------------------------------------------------------------
# rolling restart: checkpoint/resume mid-stream
# ---------------------------------------------------------------------------


def test_rolling_restart_mid_stream_bitwise(params):
    rng = np.random.default_rng(1)
    prompts = _prompts(rng, rng.integers(4, 30, 12))
    ref = _ref_streams(prompts, 24)

    router = build_fleet(CFG32, num_engines=2, params=params[1], max_slots=2,
                         max_len=96, page_size=16, name_prefix="rr", device="cpu")
    with router:
        reqs = [router.submit(Request(p, max_new_tokens=24)) for p in prompts]
        # wait until engine 0 holds bound in-flight work, then bounce it:
        # queued entries re-route, bound slots checkpoint and resume
        t0 = time.time()
        while router.members[0].engine.occupancy() == 0 and time.time() - t0 < 60:
            time.sleep(0.002)
        assert router.members[0].engine.occupancy() > 0
        router.rolling_restart(0)
        assert router.drain(timeout=180)
        stats = router.stats()
    assert [r.tokens for r in reqs] == ref, "restart changed token streams"
    assert stats["restarts"] == 1
    assert sum(e.get("resumes", 0) for e in stats["engines"]) >= 1


# ---------------------------------------------------------------------------
# pilot mode: placement, priority preemption, re-route, quotas
# ---------------------------------------------------------------------------


class FakeDevice:
    def __init__(self, i):
        self.id = i
        self.type = "fake"


class FakePilot(Pilot):
    """Pilot over stand-in devices; carve builds no communicator."""

    def carve(self, devices, mesh_shape=None, mesh_axes=("data",)):
        return SimpleNamespace(devices=tuple(devices), size=len(devices),
                               backend="fake", build_time_s=0.0, pilot_uid=self.uid)


def test_pilot_mode_preemption_reroutes_without_quota_violations(params):
    rng = np.random.default_rng(1)
    prompts = _prompts(rng, rng.integers(4, 30, 12))
    ref = _ref_streams(prompts, 24)

    mgr = PilotManager(devices=[FakeDevice(i) for i in range(8)], pilot_factory=FakePilot)
    mgr.submit_pilot(PilotDescription(num_devices=4, name="pod0"))
    mgr.submit_pilot(PilotDescription(num_devices=4, name="pod1"))
    engines = [ServeEngine(CFG32, params=params[1], max_slots=2, max_len=96,
                           page_size=16, name=f"pm{i}", device="cpu") for i in range(2)]
    router = EngineRouter(engines, manager=mgr, group="fleet", priority=0)
    with router:
        assert len({m.pilot.uid for m in router.members}) == 2, \
            "engines must land on distinct pilots"
        reqs = [router.submit(Request(p, max_new_tokens=24)) for p in prompts]
        assert router.drain(timeout=180)

        # a higher-priority task wanting the whole pod forces the service
        # lease to yield: the agent preempts engine 0, the router steals its
        # inbox and re-routes, and the quota ledger stays clean
        m0 = router.members[0]
        m0.agent.set_quota("fleet", 4)

        def hog(comm):
            time.sleep(0.3)
            return "done"

        tasks = m0.agent.submit_async([TaskDescription(
            name="hog", fn=hog, num_devices=4, priority=10)])
        extra = [router.submit(Request(p, max_new_tokens=8)) for p in prompts[:6]]
        m0.agent.wait(tasks, timeout=120)
        assert tasks[0].state is TaskState.DONE, tasks[0].error
        assert router.drain(timeout=180)
        violations = m0.agent.quota_violations()
        assert m0.agent.preemption_requests >= 1
    assert [r.tokens for r in reqs] == ref, "pilot-mode changed streams"
    assert all(r.state is RequestState.DONE for r in extra)
    assert not violations, f"quota violations during preemption: {violations}"


# ---------------------------------------------------------------------------
# disaggregation: prefill -> decode KV handoff
# ---------------------------------------------------------------------------


def test_disaggregated_handoff_bitwise_and_byte_bounded(params):
    # 17 and 23 straddle a page edge at page 16: the handoff keeps the
    # intra-page offsets across the block-table rewrite
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(1, 18, dtype=np.int32),
               np.arange(1, 24, dtype=np.int32)]
    ref = _ref_streams(prompts, 12, max_len=64)

    router = build_fleet(CFG32, num_engines=2, disaggregate=True, params=params[1],
                         max_slots=4, max_len=64, page_size=16, name_prefix="dg",
                         device="cpu")
    with router:
        reqs = [router.submit(Request(p, max_new_tokens=12)) for p in prompts]
        assert router.drain(timeout=180)
        stats = router.stats()
        eng = router.members[0].engine
        pool_bytes = eng._page_bytes * eng.num_pages
    assert [r.tokens for r in reqs] == ref, "handoff changed token streams"
    assert stats["handoffs_routed"] == len(prompts), "every prompt migrates once"
    owned_pages = sum(-(-len(p) // 16) for p in prompts)
    assert stats["handoff_pages"] == owned_pages
    assert stats["handoff_bytes"] == owned_pages * eng._page_bytes, \
        "the handoff ships exactly the owned pages, never the pool"
    assert stats["handoff_bytes"] < pool_bytes
    assert stats["fleet_handoffs_exported"] == len(prompts)
    assert stats["fleet_handoffs_imported"] == len(prompts)
    pre, dec = (s for s in stats["engines"])
    assert pre["prefill_only"] and not dec["prefill_only"]
    assert pre.get("decode_steps", 0) == 0, "the prefill engine never decodes"
    assert pre["prefill_chunk_tokens"] is None


def test_handoff_export_import_block_table_rewrite(params):
    prompt = np.arange(1, 18, dtype=np.int32)  # 2 pages, straddles one
    [ref] = _ref_streams([prompt], 8, max_len=64)

    pre = ServeEngine(CFG32, params=params[1], max_slots=2, max_len=64, page_size=16,
                      prefill_only=True, name="pre", device="cpu")
    req = pre.submit(Request(prompt, max_new_tokens=8))
    pre.run_until_drained()  # a prefill engine drains by exporting the slot
    [hand] = pre.take_handoffs()
    assert req.state is RequestState.RUNNING, \
        "a migrating request stays RUNNING across the handoff"
    assert hand.n_pages == 2 and hand.page_size == 16
    assert hand.kv_bytes == 2 * pre._page_bytes
    assert len(req.tokens) == 1, "the prefill engine samples the first token"
    assert all(t.device.type == "cpu" for t in _leaves(hand.pages))
    # the exporter's pages are back in the pool, its table row sentineled
    assert len(pre.free_pages) == pre.num_pages
    assert (pre.block_table == pre.num_pages).all()

    dec = ServeEngine(CFG32, params=params[1], max_slots=2, max_len=64, page_size=16,
                      name="dec", device="cpu")
    assert dec.submit(hand) is req
    dec.step()  # admit (import) + one decode step
    row = dec.block_table[0]
    assert (row[:2] < dec.num_pages).all(), "imported pages must be bound"
    assert (row[2:] == dec.num_pages).all(), \
        "beyond the owned pages the table row stays at the sentinel"
    dec.run_until_drained()
    assert req.state is RequestState.DONE
    assert req.tokens == ref, "the migrated stream matches colocated"
    assert dec.stats()["handoffs_imported"] == 1


class _WireTransport(InProcessTransport):
    """A stand-in remote transport: the task's arguments and result cross
    a pickle boundary, as they would to and from a worker process."""

    remote = True

    def submit(self, fn, *args, on_done=None):
        def run():
            return pickle.loads(pickle.dumps(fn(*pickle.loads(pickle.dumps(args)))))
        fut = super().submit(run)
        if on_done is not None:
            fut.add_done_callback(on_done)
        return fut


def test_disaggregated_handoffs_over_a_pickling_transport(params):
    """The router's remote path (``_ship_wire``, ``_deliver_shipped``): each
    handoff's pages cross a pickle boundary and back (numpy on the wire)
    and decode to the colocated streams, bound to the client's requests."""
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(1, 18, dtype=np.int32),
               np.arange(3, 40, dtype=np.int32)]
    ref = _ref_streams(prompts, 8, max_len=64)
    wire = _WireTransport(max_workers=2)
    router = build_fleet(CFG32, num_engines=2, disaggregate=True, params=params[1],
                         max_slots=4, max_len=64, page_size=16, name_prefix="wire",
                         router_kwargs={"transport": wire}, device="cpu")
    try:
        with router:
            reqs = [router.submit(Request(p, max_new_tokens=8)) for p in prompts]
            assert router.drain(timeout=180)
            stats = router.stats()
    finally:
        wire.shutdown()
    assert [r.tokens for r in reqs] == ref
    assert stats["handoff_wire_roundtrips"] == stats["handoffs_routed"] == len(prompts)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_moe_disaggregated_streams_match_whole_prompt_engine():
    """The smoke MoE config through a 1 + 1 disaggregated fleet: prompts
    of 17 to 32 tokens, so every prefill chunk pads to the same width 32
    whichever prompts share it; the streams equal a JAX engine's that
    prefills whole prompts (``prefill_chunk_tokens=None``)."""
    _, cfg32 = _cfgs(MOE)
    rng = np.random.default_rng(4)
    prompts = _prompts(rng, [17, 32, 20, 25, 31, 18])
    ref = _ref_streams(prompts, 6, max_len=64, arch=MOE, prefill_chunk_tokens=None)
    router = build_fleet(cfg32, num_engines=2, disaggregate=True,
                         params=_weights(MOE)[1], max_slots=4, max_len=64,
                         page_size=16, name_prefix="moe", device="cpu")
    with router:
        reqs = [router.submit(Request(p, max_new_tokens=6)) for p in prompts]
        assert router.drain(timeout=180)
        stats = router.stats()
    assert [r.tokens for r in reqs] == ref, "MoE handoff changed token streams"
    assert stats["handoffs_routed"] == len(prompts)
    assert stats["handoff_pages"] == sum(-(-len(p) // 16) for p in prompts)


# ---------------------------------------------------------------------------
# the entry points: launch.serve and the device default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--fleet", "2", "--disaggregate", "--batch", "6", "--prompt-len", "20"],
    ["--fleet", "2", "--batch", "4", "--prompt-len", "8"],
    ["--batch", "3", "--prompt-len", "8"],
])
def test_launch_serve_runs_on_the_cpu(argv):
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--gen", "4", "--quiet"] + argv)
    res = serve.run(args)
    assert res["requests"] == args.batch
    assert res["generated_tokens"] == args.batch * args.gen
    if args.disaggregate:
        assert res["handoffs"] == args.batch


def test_fleet_needs_the_card_unless_the_cpu_is_asked(params):
    """build_fleet's device defaults to the card; without a GPU it raises
    instead of running the fleet on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fleet(CFG32, num_engines=2, params=params[1])
