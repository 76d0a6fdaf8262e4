"""The dataframe parity cases, free of jax: the inputs of
``tests/test_torch_dataframe.py``'s cases and the operators run on them,
shared by that module (both packages, logical shards) and by the port's
rank processes (``tests/torch_dist_ranks.py``, a process mesh)."""
import numpy as np

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


def shard_rows(cols, valid, rank, ranks):
    """Rank ``rank``'s rows of ``ranks`` equal shards."""
    per = len(valid) // ranks
    cut = slice(rank * per, (rank + 1) * per)
    return {k: v[cut] for k, v in cols.items()}, valid[cut]


def _host(x):
    """A column as a numpy array, from either package."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def run_ops(mesh, table_cls, ops, name, prepad=False, shard=None):
    """Every distributed operator on one case -> {result name: array}.
    ``prepad``: hand the Table rows already padded to the shard count;
    ``shard`` (rank, ranks): hand it that rank's shard of the padded rows
    (a process mesh's Table)."""
    left, valid, right = case_inputs(name)
    rvalid = np.ones(len(right["k"]), bool)
    if prepad or shard is not None:
        size = mesh.shape["data"]
        left, valid = pad_rows(left, valid, size)
        right, rvalid = pad_rows(right, rvalid, size)
    if shard is not None:
        rank, ranks = shard
        left, valid = shard_rows(left, valid, rank, ranks)
        right, rvalid = shard_rows(right, rvalid, rank, ranks)
    t = table_cls.from_columns(left, mesh, valid=valid)
    r = table_cls.from_columns(right, mesh, valid=rvalid)
    out = {}
    for op, (tb, dropped) in (("shuffle", ops.shuffle(t, "k")),
                              ("sort", ops.sort(t, "k")),
                              ("join", ops.join(t, r, "k")),
                              ("groupby", ops.groupby_sum(t, "k", ["v"]))):
        out[f"{op}/dropped"] = np.asarray(dropped)
        out[f"{op}/valid"] = _host(tb.valid)
        for col, v in tb.columns.items():
            out[f"{op}/{col}"] = _host(v)
    out["reduce/v"] = np.asarray(ops.reduce_sum(t, ["v"])["v"])
    out["table/valid"] = _host(t.valid)
    for col, v in t.columns.items():
        out[f"table/{col}"] = _host(v)
    return out
