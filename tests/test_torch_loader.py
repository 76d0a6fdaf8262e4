"""Port parity for the Data Bridge, on the CPU: the zero-copy loader's
batches against ``repro.bridge.loader`` (bitwise without shuffling; the
shuffled order comes from a torch.Generator, not threefry, so only its
properties are held), the host prefetcher, the window sampler, and the
paper's preprocess -> loader -> train pipeline against the same loop in
JAX (losses at 1e-5 relative: fp32 sums in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.bridge.loader import ZeroCopyLoader as JLoader  # noqa: E402
from repro.dataframe.ops_local import filter_rows as jfilter  # noqa: E402
from repro.dataframe.table import Table as JTable  # noqa: E402
from repro_torch.bridge.loader import HostPrefetcher, ZeroCopyLoader, window_batches  # noqa: E402
from repro_torch.dataframe.ops_local import filter_rows  # noqa: E402
from repro_torch.dataframe.table import Table  # noqa: E402


def _columns(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {"f1": rng.normal(size=n).astype(np.float32),
            "f2": rng.integers(0, 9, n).astype(np.int32),
            "y": rng.normal(size=n).astype(np.float32)}, rng.random(n) < 0.8


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_unshuffled_batches_equal_jax(drop_remainder):
    cols, valid = _columns()
    jl = JLoader(JTable.from_columns(cols, valid=valid), ["f1", "f2"], "y", 128,
                 shuffle=False, drop_remainder=drop_remainder)
    tl = ZeroCopyLoader(Table.from_columns(cols, valid=valid, device="cpu"),
                        ["f1", "f2"], "y", 128, shuffle=False,
                        drop_remainder=drop_remainder)
    assert tl.steps_per_epoch == jl.steps_per_epoch
    want, got = list(jl.epoch(0)), list(tl.epoch(0))
    assert len(got) == len(want) == tl.steps_per_epoch
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            assert b.numpy().dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_shuffled_loader_is_a_seeded_permutation_per_epoch():
    """The properties of tests/test_train_components.py's loader test."""
    n = 1024
    t = Table.from_columns({"f": np.arange(n, dtype=np.float32),
                            "y": np.arange(n, dtype=np.int32)}, device="cpu")
    ld = ZeroCopyLoader(t, ["f"], "y", global_batch=128, shuffle=True, seed=7)
    e0 = [lab for _, lab, _ in ld.epoch(0)]
    e0b = [lab for _, lab, _ in ld.epoch(0)]
    e1 = [lab for _, lab, _ in ld.epoch(1)]
    assert all(torch.equal(a, b) for a, b in zip(e0, e0b)), "epoch not deterministic"
    assert any(not torch.equal(a, b) for a, b in zip(e0, e1)), "shuffle not epoch-varying"
    assert torch.equal(torch.sort(torch.cat(e0)).values, torch.arange(n, dtype=torch.int32))
    # features and labels come from the same rows
    for f, lab, m in ld.epoch(3):
        assert torch.equal(f[:, 0], lab.float()) and bool(m.all())


def test_host_prefetcher_keeps_order_and_content():
    rng = np.random.default_rng(1)
    host = [(rng.normal(size=(4, 3)).astype(np.float32),
             {"y": rng.integers(0, 5, 4).astype(np.int32)}) for _ in range(7)]
    pf = HostPrefetcher(iter(host), device="cpu", depth=3)
    got = list(pf)
    assert len(got) == len(host)
    for (x, d), (tx, td) in zip(host, got):
        assert isinstance(tx, torch.Tensor) and tx.device.type == "cpu"
        np.testing.assert_array_equal(tx.numpy(), x)
        np.testing.assert_array_equal(td["y"].numpy(), d["y"])
    # a copy, not a view of the host batch
    host[0][0][0, 0] = 1e9
    assert got[0][0][0, 0].item() != 1e9
    assert list(pf) == []


def test_host_prefetcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostPrefetcher(iter([]))


def test_window_batches_are_series_slices():
    series = np.arange(200, dtype=np.float32) * 2
    t = Table.from_columns({"s": series}, device="cpu")
    gen = torch.Generator().manual_seed(3)
    x, y = window_batches(t, "s", 12, 4, 32, generator=gen)
    assert x.shape == (32, 12) and y.shape == (32, 4)
    starts = x[:, 0] / 2
    full = torch.cat([x, y], dim=1)
    assert torch.equal(full, (starts[:, None] + torch.arange(16)) * 2)
    assert bool((starts >= 0).all()) and bool((starts < 200 - 16).all())
    x2, _ = window_batches(t, "s", 12, 4, 32, generator=torch.Generator().manual_seed(3))
    assert torch.equal(x, x2)


def test_pipeline_matches_jax():
    """tests/test_system.py's pipeline without the pilot and unshuffled:
    filter |x1| < 3, load batches of 256, SGD on a linear model, 3 epochs."""
    rng = np.random.default_rng(0)
    n = 2048
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = 3.0 * x1 - 2.0 * x2 + 0.1 * rng.normal(size=n).astype(np.float32)
    cols = {"x1": x1, "x2": x2, "y": y}

    jt = JTable.from_columns(cols)
    jc, jv = jfilter(jt.columns, jt.valid, jnp.abs(jt.col("x1")) < 3.0)
    jl = JLoader(jt.with_columns(jc, jv), ["x1", "x2"], "y", 256, shuffle=False)

    @jax.jit
    def jstep(w, b, feats, labels, mask):
        def loss_fn(wb):
            err = jnp.where(mask, feats @ wb[0] + wb[1] - labels, 0.0)
            return jnp.sum(err ** 2) / jnp.maximum(jnp.sum(mask), 1)
        loss, g = jax.value_and_grad(loss_fn)((w, b))
        return w - 0.1 * g[0], b - 0.1 * g[1], loss

    w, b, jlosses = jnp.zeros((2,)), jnp.zeros(()), []
    for epoch in range(3):
        for batch in jl.epoch(epoch):
            w, b, loss = jstep(w, b, *batch)
            jlosses.append(float(loss))

    tt = Table.from_columns(cols, device="cpu")
    tc, tv = filter_rows(tt.columns, tt.valid, tt.col("x1").abs() < 3.0)
    tl = ZeroCopyLoader(tt.with_columns(tc, tv), ["x1", "x2"], "y", 256, shuffle=False)
    tw = torch.zeros(2, requires_grad=True)
    tb = torch.zeros((), requires_grad=True)
    tlosses = []
    for epoch in range(3):
        for feats, labels, mask in tl.epoch(epoch):
            err = torch.where(mask, feats @ tw + tb - labels, 0.0)
            loss = (err ** 2).sum() / mask.sum().clamp(min=1)
            gw, gb = torch.autograd.grad(loss, (tw, tb))
            with torch.no_grad():
                tw -= 0.1 * gw
                tb -= 0.1 * gb
            tlosses.append(loss.item())
    assert len(tlosses) == len(jlosses) == 24
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert np.abs(tw.detach().numpy() - [3.0, -2.0]).max() < 0.2
    assert tlosses[-1] < tlosses[0]
