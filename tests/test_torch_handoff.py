"""KV handoffs across packages, on the CPU: a JAX ``prefill_only`` engine's
handoff, lowered to numpy by its ``__getstate__`` and brought into the
port by ``KVHandoff.from_state``, is decoded by a port engine to the
stream the JAX decode engine gives the same handoff (fp32, shared
weights; prompts that end inside a page, on a page edge and across one).
A port handoff's state round-trips bitwise (a bf16 pool too, through
numpy's fp32), and engines refuse handoffs they cannot import."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

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
from repro_torch.serve import KVHandoff, Request, RequestState, ServeEngine  # noqa: E402

JCFG32 = dataclasses.replace(jget("tinyllama-1.1b", smoke=True), compute_dtype=jnp.float32)
CFG = tget("tinyllama-1.1b", smoke=True)
CFG32 = CFG.with_overrides(compute_dtype=torch.float32)
ENGINE = dict(max_slots=4, max_len=64, page_size=16)
GEN = 10


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


def _jax_handoffs(jp, prompts):
    pre = JEngine(JCFG32, params=jp, prefill_only=True, **ENGINE)
    reqs = [pre.submit(JRequest(p, max_new_tokens=GEN)) for p in prompts]
    pre.run_until_drained()
    hands = {h.rid: h for h in pre.take_handoffs()}
    return [hands[r.rid] for r in reqs]


def _port_request(jreq) -> Request:
    """The client-side request of a handoff from the other package: its
    prompt, budget and the first token its prefill engine sampled."""
    req = Request(np.asarray(jreq.prompt), max_new_tokens=jreq.max_new_tokens)
    req.tokens = list(jreq.tokens)
    req.state = RequestState.RUNNING
    return req


def test_jax_handoff_decodes_in_the_port(params):
    jp, tp = params
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, CFG.vocab_size, n).astype(np.int32)
               for n in (5, 16, 17, 23)]
    hands = _jax_handoffs(jp, prompts)
    # lowered (and their requests copied) before the JAX decode appends
    states = [dict(h.__getstate__(), request=_port_request(h.request)) for h in hands]
    dec = JEngine(JCFG32, params=jp, **ENGINE)
    for h in hands:
        dec.submit(h)
    dec.run_until_drained()
    want = [h.request.tokens for h in hands]

    eng = ServeEngine(CFG32, params=tp, device="cpu", **ENGINE)
    got = []
    for state in states:
        assert isinstance(state["pages"]["unit"], dict)
        hand = KVHandoff.from_state(state, "cpu")
        assert hand.n_pages == -(-len(hand.request.prompt) // 16)
        assert hand.length == len(hand.request.prompt)
        got.append(eng.submit(hand))
    eng.run_until_drained()
    assert all(r.state is RequestState.DONE for r in got)
    assert [r.tokens for r in got] == want, "a JAX handoff decodes to JAX's stream"
    st = eng.stats()
    assert st["handoffs_imported"] == len(prompts)
    assert st["handoff_bytes_imported"] == sum(s["kv_bytes"] for s in states)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_handoff_state_round_trips_bitwise(params, dtype):
    cfg = CFG.with_overrides(compute_dtype=dtype)
    pre = ServeEngine(cfg, params=params[1], prefill_only=True, device="cpu", **ENGINE)
    req = pre.submit(Request(np.arange(1, 24, dtype=np.int32), max_new_tokens=GEN))
    pre.run_until_drained()
    [hand] = pre.take_handoffs()
    state = hand.__getstate__()
    leaves = [state["pages"][k] for k in ("head_layers", "unit", "tail_layers")]
    assert all(isinstance(v, np.ndarray) for part in leaves for v in _leaves(part))
    back = KVHandoff.from_state(state, "cpu")
    assert back.request is req and back.kv_bytes == hand.kv_bytes
    for a, b in zip(_leaves(hand.pages), _leaves(back.pages)):
        assert torch.equal(a.float(), b.float())
    # the rebuilt handoff decodes like the original one
    one = ServeEngine(cfg, params=params[1], device="cpu", **ENGINE)
    one.submit(back)
    one.run_until_drained()
    assert req.state is RequestState.DONE and len(req.tokens) == GEN


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_engines_refuse_handoffs_they_cannot_import(params):
    pre = ServeEngine(CFG32, params=params[1], prefill_only=True, device="cpu", **ENGINE)
    pre.submit(Request(np.arange(1, 9, dtype=np.int32), max_new_tokens=GEN))
    pre.run_until_drained()
    [hand] = pre.take_handoffs()
    contiguous = ServeEngine(CFG32, params=params[1], kv_layout="contiguous",
                             device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="paged engine"):
        contiguous.submit(hand)
    other = ServeEngine(CFG32, params=params[1], device="cpu",
                        **dict(ENGINE, page_size=8))
    with pytest.raises(ValueError, match="page_size"):
        other.submit(hand)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(CFG32, params=params[1], kv_layout="contiguous",
                    prefill_only=True, device="cpu", **ENGINE)
