"""Port parity for the rmsnorm kernel's plain version, on the CPU: against
the Pallas kernel in interpret mode and ``ref.rmsnorm_ref`` on the shapes
of tests/test_kernels.py, at 1e-5 in fp32 and 2e-2 in bf16 (one bf16 ulp
of the cast), and the ops dispatch.  The CUDA kernel itself runs only on
the card (tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rmsnorm as jrn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402

TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    return jx, jw, tx, tw


@pytest.mark.parametrize("shape", [(32, 128), (4, 17, 256), (1, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_ref(shape, dtype):
    jx, jw, tx, tw = _inputs(shape, dtype)
    got = trn.rmsnorm_plain(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = TOLS[dtype]
    for want in (jrn.rmsnorm(jx, jw, block_rows=16, interpret=True),
                 jref.rmsnorm_ref(jx, jw)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_dispatch(impl):
    jx, jw, tx, tw = _inputs((6, 64), "float32", seed=1)
    np.testing.assert_allclose(ops.rmsnorm(tx, tw, impl=impl).numpy(),
                               np.asarray(jrn.rmsnorm(jx, jw, interpret=True)),
                               atol=1e-5, rtol=1e-5)
    # another eps (the Pallas kernel takes only its default: a traced eps
    # is a constant its body may not capture)
    np.testing.assert_allclose(ops.rmsnorm(tx, tw, eps=0.5, impl=impl).numpy(),
                               np.asarray(jref.rmsnorm_ref(jx, jw, eps=0.5)),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(tx, tw, impl="cuda")


def test_fused_norm_is_not_the_model_norm_in_bf16():
    """The kernel multiplies in fp32, the model's norm in bf16: they differ
    in bf16 (many elements, by at most a few bf16 ulps), agree in fp32."""
    _, _, tx, tw = _inputs((8, 1024), "bfloat16", seed=2)
    fused = ops.rmsnorm(tx, tw)
    model = tblocks.rmsnorm_apply({"scale": tw}, tx)
    differ = (fused != model).sum().item()
    assert differ > fused.numel() // 10, differ
    assert (fused.float() - model.float()).abs().max().item() < 0.1
    x32, w32 = tx.float(), tw.float()
    torch.testing.assert_close(ops.rmsnorm(x32, w32),
                               tblocks.rmsnorm_apply({"scale": w32}, x32),
                               atol=1e-6, rtol=1e-6)
