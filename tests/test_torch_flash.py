"""Port parity for the flash-attention slice, on the CPU: the port's plain
``flash_attention`` against the Pallas kernel in interpret mode and the
JAX oracle, the port's ``chunked_attention`` against JAX's, and the
kernel's autograd ``Function`` (driven by the plain forward) against
``jax.grad`` of JAX's ``chunked_attention``.  Inputs are seeded numpy
arrays handed to both packages."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402

# fp32 forward: the repo's kernel tolerance (tests/test_kernels.py)
TOL = dict(atol=2e-5, rtol=2e-5)
# fp32 gradients through the recompute: sums in another order
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, B, H, KV, S, D):
    rng = np.random.default_rng(seed)
    return _x(rng, (B, H, S, D)), _x(rng, (B, KV, S, D)), _x(rng, (B, KV, S, D))


# the sweep of tests/test_kernels.py (MHA, GQA 4x, MQA at D 128, a tail
# that is not a multiple of 128) and the ragged tail of
# tests/test_prefill_kernel.py (S 130 over 64-blocks)
SHAPES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128),
          (1, 8, 8, 192, 32), (1, 4, 4, 130, 64),
          (1, 8, 2, 130, 96), (1, 4, 4, 64, 96)]  # head dim 96 (phi3-mini), G 4 and 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,D", SHAPES)
def test_plain_flash_matches_pallas_and_oracle(B, H, KV, S, D, causal):
    q, k, v = _qkv(S + D, B, H, KV, S, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.shape == (B, H, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


def test_flash_dispatch_by_device_and_impl():
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 4, 2, 16, 16))
    want = tref.flash_attention_ref(q, k, v)
    before = tfa.flash_attention_kernel.launches
    for impl in ("auto", "ref"):
        torch.testing.assert_close(ops.flash_attention(q, k, v, impl=impl), want,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="decode impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    assert tfa.flash_attention_kernel.launches == before


# window and q_offset cases, chunks smaller than S (S a multiple of the
# KV chunk, where the JAX function is exact)
CHUNKED = [
    # B, Sq, Skv, H, KV, D, causal, window, q_chunk, kv_chunk, q_offset
    (2, 32, 32, 4, 2, 16, True, 0, 8, 16, 0),
    (1, 24, 24, 4, 4, 8, True, 5, 4, 4, 0),
    (2, 16, 16, 6, 2, 8, False, 0, 8, 4, 0),
    (1, 8, 24, 4, 1, 16, True, 0, 4, 8, 16),
    (1, 12, 24, 2, 2, 8, True, 6, 4, 8, 12),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,qc,kc,off", CHUNKED)
def test_chunked_attention_matches_jax(B, Sq, Skv, H, KV, D, causal, window,
                                       qc, kc, off):
    rng = np.random.default_rng(Sq * Skv + window)
    q, k, v = _x(rng, (B, Sq, H, D)), _x(rng, (B, Skv, KV, D)), _x(rng, (B, Skv, KV, D))
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc, q_offset=off)
    want = jax.jit(lambda *a: jb.chunked_attention(*a, **kw))(
        *map(jnp.asarray, (q, k, v)))
    got = tb.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_attention_ragged_kv_chunk_is_exact():
    """A last KV chunk that runs past Skv: the port cuts it short and
    equals the full-softmax oracle; JAX's ``dynamic_slice`` shifts it back
    over keys it already counted (ROADMAP.md queue 3)."""
    q, k, v = _qkv(5, 1, 2, 2, 10, 8)
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    for causal in (True, False):
        kw = dict(causal=causal, q_chunk=4, kv_chunk=4)
        got = tb.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
        want = tref.flash_attention_ref(
            *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
            causal=causal).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        jax_out = np.asarray(jb.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw))
        assert np.abs(jax_out - want.numpy()).max() > 0.1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,D,qc,kc", [(2, 4, 2, 24, 16, 8, 8),
                                              (1, 6, 6, 16, 8, 16, 16),
                                              (1, 8, 1, 32, 16, 16, 8)])
def test_flash_function_gradients_match_jax(B, H, KV, S, D, qc, kc, causal):
    """The kernel's autograd Function with the plain forward swapped in:
    its output and dq, dk, dv against JAX's chunked_attention and
    ``jax.grad`` of it, for one seeded cotangent."""
    rng = np.random.default_rng(B * S + H)
    q, k, v = _x(rng, (B, S, H, D)), _x(rng, (B, S, KV, D)), _x(rng, (B, S, KV, D))
    ct = _x(rng, (B, S, H, D))

    def jloss(q, k, v):
        o = jb.chunked_attention(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
        return jnp.sum(o * jnp.asarray(ct)), o

    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention_autograd(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), causal=causal,
        q_chunk=qc, kv_chunk=kc, forward_fn=tfa.flash_attention_plain).transpose(1, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct))
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
