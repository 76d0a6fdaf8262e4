"""Port parity for the dataframe slice, on the CPU: the Table, every local
operator on one shard, and every distributed operator at 8 shards against
``repro`` at 8 host devices, from the same numpy inputs.

JAX's distributed operators need 8 host devices, and this process's jax
already sees one: the module runs itself as a script in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and writes JAX's
results to an ``.npz`` (``python tests/test_torch_dataframe.py OUT.npz``).
The port runs the same operators over 8 logical shards of one device.

Exactness: shard-by-shard columns, masks and drop counts bitwise (the
rows of each shard in their order, padding and dropped slots included);
groupby sums at 2e-5 (float32 sums in another order) and reduce sums at
1e-5 relative."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dataframe import ops_dist as JD  # noqa: E402
from repro.dataframe import ops_local as JL  # noqa: E402
from repro.dataframe.table import Table as JTable  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro_torch.dataframe import ops_dist as TD  # noqa: E402
from repro_torch.dataframe import ops_local as TL  # noqa: E402
from repro_torch.dataframe.table import Table as TTable  # noqa: E402
from repro_torch.kernels import hash_partition as thp  # noqa: E402
from repro_torch.launch.mesh import make_mesh as tmake_mesh  # noqa: E402

SHARDS = 8
SUM_TOL = dict(atol=2e-5, rtol=2e-5)  # float32 sums in another order
REDUCE_RTOL = 1e-5
OPS = ("shuffle", "sort", "join", "groupby", "reduce")
# the spawn test's inputs; the same shapes filtered (only the mask
# differs) and with skewed keys (only the keys differ), so JAX compiles
# its shard_map bodies once for the three; then a row count that 8 does
# not divide
CASES = ("base", "filtered", "skewed", "ragged")


def case_inputs(name):
    """(left columns, left valid, right columns) as numpy arrays."""
    rng = np.random.default_rng(0)
    n = 4100 if name == "ragged" else 4096
    keys = rng.integers(0, 1000, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    valid = np.ones(n, bool)
    if name == "filtered":
        valid = np.abs(vals) < 1.0
    if name == "skewed":  # 3 of 4 rows share one key: buckets overflow
        keys = np.where(rng.random(n) < 0.75, 7, keys).astype(np.int32)
    nr = 999 if name == "ragged" else 1000
    rkeys = np.arange(nr).astype(np.int32)
    right = {"k": rkeys, "w": (rkeys * 10).astype(np.float32)}
    return {"k": keys, "v": vals}, valid, right


def pad_rows(cols, valid, size):
    """Columns zero-padded and ``valid`` False-padded to a multiple of
    ``size`` rows: what ``Table.reshard`` means to do."""
    pad = (-len(valid)) % size
    cols = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            for k, v in cols.items()}
    return cols, np.concatenate([valid, np.zeros(pad, bool)])


def run_ops(mesh, table_cls, ops, name, prepad=False):
    """Every distributed operator on one case -> {result name: array}.
    ``prepad``: hand the Table rows already padded to the shard count."""
    left, valid, right = case_inputs(name)
    rvalid = np.ones(len(right["k"]), bool)
    if prepad:
        size = mesh.shape["data"]
        left, valid = pad_rows(left, valid, size)
        right, rvalid = pad_rows(right, rvalid, size)
    t = table_cls.from_columns(left, mesh, valid=valid)
    r = table_cls.from_columns(right, mesh, valid=rvalid)
    out = {}
    for op, (tb, dropped) in (("shuffle", ops.shuffle(t, "k")),
                              ("sort", ops.sort(t, "k")),
                              ("join", ops.join(t, r, "k")),
                              ("groupby", ops.groupby_sum(t, "k", ["v"]))):
        out[f"{op}/dropped"] = np.asarray(dropped)
        out[f"{op}/valid"] = np.asarray(tb.valid)
        for col, v in tb.columns.items():
            out[f"{op}/{col}"] = np.asarray(v)
    out["reduce/v"] = np.asarray(ops.reduce_sum(t, ["v"])["v"])
    out["table/valid"] = np.asarray(t.valid)
    for col, v in t.columns.items():
        out[f"table/{col}"] = np.asarray(v)
    return out


def _jax_main(path):
    """The JAX side, at 8 host devices.  Each shard_map body is jitted: the
    same computation, compiled once per call instead of primitive by
    primitive as eager shard_map does (~50 s a case on the CPU).  On the
    filtered case the jitted results equal the eager ones bit for bit,
    sums included."""
    plain_shard_map = JD.shard_map
    JD.shard_map = lambda f, **kw: jax.jit(plain_shard_map(f, **kw))
    mesh = jmake_mesh((SHARDS,), ("data",))
    results = {}
    for name in CASES:
        # JAX's reshard pads ``valid`` twice, so a row count the shard
        # count does not divide raises: hand it the rows padded once
        for k, v in run_ops(mesh, JTable, JD, name, prepad=name == "ragged").items():
            results[f"{name}/{k}"] = v
    left, valid, _ = case_inputs("ragged")
    try:
        JTable.from_columns(left, mesh, valid=valid)
        results["ragged/reshard_error"] = np.asarray("")
    except ValueError as e:
        results["ragged/reshard_error"] = np.asarray(str(e))
    np.savez(path, **results)


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax8") / "dataframe.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(repo, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={SHARDS}")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"JAX side failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def port8():
    mesh = tmake_mesh((SHARDS,), ("data",), device="cpu")
    return {name: run_ops(mesh, TTable, TD, name) for name in CASES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- distributed operators at 8 shards ------------------------------------------


@pytest.mark.parametrize("op", OPS + ("table",))
@pytest.mark.parametrize("case", CASES)
def test_distributed_op_matches_jax(jax8, port8, case, op):
    got = {k.split("/", 1)[1]: v for k, v in port8[case].items()
           if k.startswith(op + "/")}
    want = {k.split("/", 2)[2]: v for k, v in jax8.items()
            if k.startswith(f"{case}/{op}/")}
    assert sorted(got) == sorted(want)
    for col, w in want.items():
        g = got[col]
        assert g.shape == w.shape, (col, g.shape, w.shape)
        if op == "reduce":
            np.testing.assert_allclose(g, w, rtol=REDUCE_RTOL, atol=0)
        elif op == "groupby" and col == "v":
            np.testing.assert_allclose(g, w, **SUM_TOL)
        else:  # integers, masks, moved floats, drop counts: bitwise
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=col)
    if case == "skewed" and op not in ("reduce", "table"):
        assert int(got["dropped"]) > 0  # the case drops rows
    if case in ("base", "ragged") and op not in ("reduce", "table"):
        assert int(got["dropped"]) == 0


def test_distributed_ops_meet_the_spawn_checks(port8):
    """The port's own results pass tests/spawn/dataframe_ops.py's checks."""
    left, _, _ = case_inputs("base")
    res = port8["base"]
    kk, vv = res["sort/k"], res["sort/valid"]
    per = kk.shape[0] // SHARDS
    glob = [kk[i * per:(i + 1) * per][vv[i * per:(i + 1) * per]] for i in range(SHARDS)]
    assert all(np.all(np.diff(g) >= 0) for g in glob)
    assert all(glob[i].max() <= glob[i + 1].min() for i in range(SHARDS - 1))
    assert np.array_equal(np.concatenate(glob), np.sort(left["k"]))
    # every shuffled key on the shard its hash names
    sk, sv = res["shuffle/k"], res["shuffle/valid"]
    shard = np.arange(sk.shape[0]) // (sk.shape[0] // SHARDS)
    dest = TL.hash_u32(torch.from_numpy(sk)).numpy() % SHARDS
    assert np.array_equal(dest[sv], shard[sv]) and sv.sum() == len(left["k"])
    jv = res["join/valid"]
    assert jv.sum() == len(left["k"])
    assert np.array_equal(res["join/w"][jv], res["join/k"][jv] * 10)
    want = np.bincount(left["k"], weights=left["v"].astype(np.float64), minlength=1000)
    gv = res["groupby/valid"]
    np.testing.assert_allclose(res["groupby/v"][gv], want[res["groupby/k"][gv]],
                               atol=1e-5, rtol=1e-5)


def test_dist_ops_need_a_mesh():
    t = TTable.from_columns({"k": np.arange(8, dtype=np.int32)}, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        TD.shuffle(t, "k")


# -- the sort's sample indices ----------------------------------------------------


@pytest.mark.parametrize("n,m", [(512, 64), (513, 64), (1 << 20, 64), (1 << 20, 32),
                                 (1 << 23, 64), (1 << 23, 8), (1 << 23, 24),
                                 (12345, 16), (7, 8), (2, 8)])
def test_linspace_indices_match_jnp(n, m):
    """The sort samples at jnp.linspace(0, n-1, m).astype(int32) as XLA
    computes it; torch.linspace is off by one at (512, 64) index 27."""
    want = jax.jit(lambda: jnp.linspace(0, n - 1, m).astype(jnp.int32))()
    np.testing.assert_array_equal(TD.linspace_indices(n, m), np.asarray(want))


# -- the Table ----------------------------------------------------------------------


def test_table_basics_match_jax():
    rng = np.random.default_rng(1)
    cols = {"k": rng.integers(0, 50, 37).astype(np.int32),
            "x": rng.normal(size=(37, 3)).astype(np.float32)}
    valid = rng.random(37) < 0.6
    jt = JTable.from_columns(cols, valid=valid)
    tt = TTable.from_columns(cols, valid=valid, device="cpu")
    assert (tt.num_rows, tt.num_valid, tt.column_names) == \
        (jt.num_rows, jt.num_valid, jt.column_names)
    for want, got in ((jt.to_numpy(), tt.to_numpy()), (jt.head(4), tt.head(4)),
                      (jt.project(["x"]).to_numpy(), tt.project(["x"]).to_numpy())):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(tt.col("k").numpy(), np.asarray(jt.col("k")))
    w = tt.with_columns({"y": tt.col("k") * 2}, valid=~tt.valid)
    assert w.column_names == ["y"] and w.num_valid == 37 - tt.num_valid
    with pytest.raises(ValueError, match="length"):
        TTable.from_columns({"a": np.zeros(3), "b": np.zeros(4)}, device="cpu")


def test_table_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTable.from_columns({"a": np.zeros(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmake_mesh((8,), ("data",))


def test_reshard_pads_valid_once(jax8):
    """JAX's reshard pads ``valid`` twice and raises on a row count the
    shard count does not divide (4100 rows: valid 4108 long); the port
    pads it once, as the columns (the parity cases above compare the
    port's padded table with JAX's on rows padded beforehand)."""
    assert "divisible by 8" in str(jax8["ragged/reshard_error"])
    mesh = tmake_mesh((SHARDS,), ("data",), device="cpu")
    left, valid, _ = case_inputs("ragged")
    t = TTable.from_columns(left, mesh, valid=valid)
    assert t.num_rows == 4104 and t.valid.shape == (4104,)


def test_reshard_pads_with_invalid_rows():
    mesh = tmake_mesh((8,), ("data",), device="cpu")
    t = TTable.from_columns({"k": np.arange(1, 14, dtype=np.int32)}, mesh)
    assert t.num_rows == 16 and t.num_valid == 13
    assert t.col("k")[13:].tolist() == [0, 0, 0] and not t.valid[13:].any()


# -- local operators on one shard ------------------------------------------------


def _local_inputs(seed=3, n=64):
    """Duplicate keys (in [0, 12)), some invalid rows, a 2-D column."""
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 12, n).astype(np.int32),
            "v": rng.normal(size=n).astype(np.float32),
            "x": rng.normal(size=(n, 2)).astype(np.float32)}
    return cols, rng.random(n) < 0.7


def _both(cols, valid):
    jc = {k: jnp.asarray(v) for k, v in cols.items()}
    tc = {k: torch.from_numpy(v) for k, v in cols.items()}
    return jc, jnp.asarray(valid), tc, torch.from_numpy(valid)


def _assert_cols_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_hash_u32_matches_jax_on_the_int32_range():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        np.array([-1, 0, 1, 2 ** 31 - 1, -2 ** 31, 65535, 65536, -65536], np.int32),
        rng.integers(-2 ** 31, 2 ** 31, 100_000, dtype=np.int64).astype(np.int32)])
    want = np.asarray(JL.hash_u32(jnp.asarray(keys))).astype(np.int64)
    got = TL.hash_u32(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:5].tolist() == [1640556423, 0, 2654463878, 3788007303, 2147516416]


def test_filter_and_compact_match_jax():
    cols, valid = _local_inputs()
    jc, jv, tc, tv = _both(cols, valid)
    mask = cols["v"] > 0
    _, fjv = JL.filter_rows(jc, jv, jnp.asarray(mask))
    _, ftv = TL.filter_rows(tc, tv, torch.from_numpy(mask))
    np.testing.assert_array_equal(ftv.numpy(), np.asarray(fjv))
    jcc, jcv = JL.compact(jc, fjv)
    tcc, tcv = TL.compact(tc, ftv)
    _assert_cols_equal(tcc, jcc)
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))


@pytest.mark.parametrize("descending", [False, True])
def test_sort_by_key_matches_jax(descending):
    cols, valid = _local_inputs()
    jc, jv, tc, tv = _both(cols, valid)
    jsc, jsv = JL.sort_by_key(jc, jv, "k", descending=descending)
    tsc, tsv = TL.sort_by_key(tc, tv, "k", descending=descending)
    _assert_cols_equal(tsc, jsc)
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))


@pytest.mark.parametrize("cap", [4, 12, 40])
def test_local_groupby_sum_matches_jax(cap):
    """Keys >= 0, where the two agree; cap 4 drops groups."""
    cols, valid = _local_inputs()
    jc, jv, tc, tv = _both(cols, valid)
    jk, js, jn = JL.local_groupby_sum(jc, jv, "k", ["v"], cap)
    tk, ts, tn = TL.local_groupby_sum(tc, tv, "k", ["v"], cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(ts["v"].numpy(), np.asarray(js["v"]), **SUM_TOL)


def test_local_groupby_reports_negative_keys():
    """JAX reports key 0 for a group whose key is negative (its slot
    starts at 0 and takes a max); the port reports the group's key."""
    cols = {"k": np.array([-5, -5, 3], np.int32), "v": np.array([1, 2, 4], np.float32)}
    valid = np.ones(3, bool)
    jc, jv, tc, tv = _both(cols, valid)
    jk, _, _ = JL.local_groupby_sum(jc, jv, "k", ["v"], 4)
    tk, ts, tn = TL.local_groupby_sum(tc, tv, "k", ["v"], 4)
    assert np.asarray(jk).tolist() == [0, 3, 0, 0]  # the reference's fault
    assert tk.tolist() == [-5, 3, 0, 0]
    assert ts["v"].tolist() == [3, 4, 0, 0] and tn.tolist() == [2, 1, 0, 0]


def test_local_hash_join_matches_jax():
    cols, valid = _local_inputs()
    rng = np.random.default_rng(4)
    rk = rng.permutation(16).astype(np.int32)[:10]  # keys 12-15 match nothing
    right = {"k": np.concatenate([rk, rk[:3]]),     # duplicates: first wins
             "w": rng.normal(size=13).astype(np.float32),
             "x": rng.normal(size=(13, 2)).astype(np.float32)}
    rvalid = rng.random(13) < 0.8
    jc, jv, tc, tv = _both(cols, valid)
    jrc, jrv, trc, trv = _both(right, rvalid)
    jo, jm = JL.local_hash_join(jc, jv, jrc, jrv, "k")
    to, tm = TL.local_hash_join(tc, tv, trc, trv, "k")
    _assert_cols_equal(to, jo)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_local_ops_batch_over_shards():
    """A leading shard axis gives each shard's one-shard result."""
    shards = [_local_inputs(seed) for seed in (5, 6, 7)]
    tc = {k: torch.from_numpy(np.stack([c[k] for c, _ in shards])) for k in shards[0][0]}
    tv = torch.from_numpy(np.stack([v for _, v in shards]))
    bk, bs, bn = TL.local_groupby_sum(tc, tv, "k", ["v"], 8)
    for i, (c, v) in enumerate(shards):
        k1, s1, n1 = TL.local_groupby_sum({k: torch.from_numpy(a) for k, a in c.items()},
                                          torch.from_numpy(v), "k", ["v"], 8)
        assert torch.equal(bk[i], k1) and torch.equal(bn[i], n1)
        assert torch.equal(bs["v"][i], s1["v"])


# -- distributed operators on one shard, in process -------------------------------


@pytest.fixture
def jit_shard_map(monkeypatch):
    """Jit each JAX shard_map body (see ``_jax_main``)."""
    plain = JD.shard_map
    monkeypatch.setattr(JD, "shard_map", lambda f, **kw: jax.jit(plain(f, **kw)))


def test_distributed_ops_on_one_shard_match_jax(jit_shard_map):
    want = run_ops(jmake_mesh((1,), ("data",)), JTable, JD, "filtered")
    got = run_ops(tmake_mesh((1,), ("data",), device="cpu"), TTable, TD, "filtered")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in ("groupby/v", "reduce/v"):
            np.testing.assert_allclose(got[k], w, rtol=REDUCE_RTOL, atol=2e-5)
        else:
            np.testing.assert_array_equal(got[k], w.astype(got[k].dtype), err_msg=k)


def test_shuffle_counts_come_from_the_histogram(monkeypatch):
    """The hash-partitioned operators take their per-destination counts
    from the histogram wrapper, one call per exchange: shuffle 1, join 2,
    groupby 1, sort none."""
    calls = []
    real = thp.hash_partition_histogram_plain

    def counting(keys, **kw):
        calls.append(tuple(keys.shape))
        return real(keys, **kw)

    monkeypatch.setattr(thp, "hash_partition_histogram_plain", counting)
    mesh = tmake_mesh((SHARDS,), ("data",), device="cpu")
    left, valid, right = case_inputs("filtered")
    t = TTable.from_columns(left, mesh, valid=valid)
    r = TTable.from_columns(right, mesh)
    for fn, n in ((lambda: TD.shuffle(t, "k"), 1), (lambda: TD.join(t, r, "k"), 2),
                  (lambda: TD.groupby_sum(t, "k", ["v"]), 1),
                  (lambda: TD.sort(t, "k"), 0)):
        calls.clear()
        fn()
        assert len(calls) == n and all(c[0] == SHARDS for c in calls)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
