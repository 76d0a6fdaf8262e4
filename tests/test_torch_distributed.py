"""Port parity for ``repro_torch.distributed``'s collectives and pipeline
parallelism, on the CPU: the port's ranks are gloo processes on
localhost (``tests/torch_dist_ranks.py``), JAX's ranks are host devices.

JAX's side needs 8 host devices, and this process's jax already sees one:
the module runs itself as a script in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and writes its
inputs and results to an ``.npz`` (``python tests/test_torch_distributed.py
OUT.npz``): ``tests/spawn/distributed_extras.py``'s pipeline (4 stages,
``x * 2 + w_i``, 8 microbatches), ``int8_psum`` under ``shard_map`` over 8
devices on four inputs (JAX's own, a length the 256-element block does not
divide, a 2-D leaf, and ranks whose scales differ by 2^7), and
``compressed_grad_sync`` of a two-leaf tree over 8 syncs with and without
error feedback, each jitted.  The port's ranks read the same inputs.

Exactness: ``int8_psum`` and ``compressed_grad_sync`` bitwise (the same
fp32 operations in the same order: ``torch.round`` and ``jnp.round`` both
round half to even, every division is an fp32 division); the pipeline
within 1e-5 relative, JAX's own bound (it is bitwise here too)."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_ranks as R  # noqa: E402

PIPE_RTOL = 1e-5


def _jax_main(path):
    import functools

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.distributed.collectives import compressed_grad_sync, int8_psum
    from repro.distributed.pipeline_par import pipeline_forward
    from repro.launch.mesh import make_mesh

    out = {}
    # distributed_extras.py's pipeline
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 2, 16))
    w = jnp.arange(1.0, 5.0)[:, None] * jnp.ones((4, 16))
    got = pipeline_forward(lambda p, h: h * 2.0 + p, w, x, make_mesh((4,), ("pipe",)), "pipe")
    out.update({"pipe/x": x, "pipe/w": w, "pipe/out": got})

    mesh8 = make_mesh((8,), ("data",))
    g = jax.random.normal(jax.random.PRNGKey(1), (8, 1024)) * 0.01  # distributed_extras'
    cases = {"g1024": g,
             "g1000": jax.random.normal(jax.random.PRNGKey(4), (8, 1000)) * 0.01,
             "g_2d": jax.random.normal(jax.random.PRNGKey(5), (8, 33, 7)),
             "scaled": g * (2.0 ** jnp.arange(-4.0, 4.0))[:, None]}
    for name, gl in cases.items():
        @jax.jit
        @functools.partial(shard_map, mesh=mesh8, in_specs=P("data"), out_specs=P("data"))
        def sync(v):
            return int8_psum(v[0], "data")[None] / 8.0

        out[f"int8/{name}/in"] = gl
        out[f"int8/{name}/out"] = sync(gl)

    grads = {"w": jax.random.normal(jax.random.PRNGKey(2), (512,)) * 0.01,
             "m": jax.random.normal(jax.random.PRNGKey(3), (16, 40)) * 0.01}
    with_ef = jax.jit(lambda gr, ef: compressed_grad_sync(gr, mesh8, "data", error_feedback=ef))
    plain = jax.jit(lambda gr: compressed_grad_sync(gr, mesh8, "data"))
    ef = None
    acc_ef = jax.tree.map(jnp.zeros_like, grads)
    acc_plain = jax.tree.map(jnp.zeros_like, grads)
    for step in range(R.SYNC_STEPS):
        synced, ef = (plain(grads) if ef is None else with_ef(grads, ef))
        acc_ef = jax.tree.map(jnp.add, acc_ef, synced)
        acc_plain = jax.tree.map(jnp.add, acc_plain, plain(grads)[0])
    for k in grads:
        out.update({f"sync/{k}/in": grads[k], f"sync/{k}/ef": acc_ef[k],
                    f"sync/{k}/plain": acc_plain[k], f"sync/{k}/residual": ef[k]})
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def jax8(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax8") / "distributed.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(repo, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"JAX side failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    with np.load(path) as f:
        return path, dict(f)


@pytest.fixture(scope="module")
def port8(jax8, tmp_path_factory):
    return R.launch("collectives", 8, tmp_path_factory.mktemp("ranks8"),
                    spec={"npz": str(jax8[0])})


@pytest.fixture(scope="module")
def port4(jax8, tmp_path_factory):
    return R.launch("pipeline", 4, tmp_path_factory.mktemp("ranks4"),
                    spec={"npz": str(jax8[0])})


@pytest.mark.parametrize("case", R.INT8_CASES)
def test_int8_psum_matches_jax_bitwise(jax8, port8, case):
    """Every rank's quantized mean equals JAX's shard of the same rank, bit
    for bit, and every rank holds the same result."""
    want = jax8[1][f"int8/{case}/out"]
    for rank, res in enumerate(port8):
        np.testing.assert_array_equal(res[f"int8/{case}"], want[rank], err_msg=f"rank {rank}")
    mean = jax8[1][f"int8/{case}/in"].mean(0)
    err = np.abs(port8[0][f"int8/{case}"] - mean).max() / np.abs(mean).max()
    assert err < 0.02  # JAX's bound on the quantization error


@pytest.mark.parametrize("leaf", ["w", "m"])
def test_compressed_grad_sync_matches_jax_bitwise(jax8, port8, leaf):
    """8 syncs with error feedback and 8 without, accumulated, and the last
    residual: JAX's bit for bit on every rank; the error-feedback sum is no
    further from the truth than 1.05 x the plain one's (JAX's check)."""
    want = jax8[1]
    for res in port8:
        for what in ("ef", "plain", "residual"):
            np.testing.assert_array_equal(res[f"sync/{leaf}/{what}"],
                                          want[f"sync/{leaf}/{what}"], err_msg=what)
    true = want[f"sync/{leaf}/in"] * R.SYNC_STEPS
    err_ef = np.linalg.norm(port8[0][f"sync/{leaf}/ef"] - true)
    err_plain = np.linalg.norm(port8[0][f"sync/{leaf}/plain"] - true)
    assert err_ef <= err_plain * 1.05, (err_ef, err_plain)


@pytest.mark.parametrize("leaf", ["w", "m"])
def test_error_feedback_on_each_ranks_own_gradient(port8, leaf):
    """Each of the 8 ranks syncs a gradient of its own, as data
    parallelism gives it: 8 syncs with error feedback land no further
    from 8 x the fp32 mean than 1.05 x the plain syncs (JAX's check, which
    JAX runs on one gradient that every rank holds).  Each rank carries
    its own quantization error, within one step of the shared grid;
    carrying ``carry_in - synced`` would add its distance from the mean."""
    for rank, res in enumerate(port8):
        err_ef, err_plain = res[f"own/{leaf}/ef_err"], res[f"own/{leaf}/plain_err"]
        assert err_ef <= err_plain * 1.05, (rank, err_ef, err_plain)
        assert res[f"own/{leaf}/residual_max"] <= res[f"own/{leaf}/grid_step"], rank


def test_pipeline_forward_matches_jax_on_every_rank(jax8, port4):
    want = jax8[1]["pipe/out"]
    seq = jax8[1]["pipe/x"]
    for i in range(4):
        seq = seq * 2.0 + jax8[1]["pipe/w"][i]
    np.testing.assert_allclose(want, seq, rtol=PIPE_RTOL)
    for rank, res in enumerate(port4):
        np.testing.assert_allclose(res["pipeline"], want, rtol=PIPE_RTOL, atol=0,
                                   err_msg=f"rank {rank}")


# -- the card phase's scenario, rehearsed on the CPU ---------------------------

# chip_smoke.py's distributed phase at toy sizes: the smoke config's
# gradient tree, tables of 2^12 rows
CARD_SPEC = {"device": "cpu", "seed": 0, "df_rows": 1 << 12, "df_keys": 1 << 8,
             "df_atol": 1e-4, "reduce_rtol": 1e-5,
             "arch": "tinyllama-1.1b", "smoke": True, "grad_b": 2,
             "grad_s": 16, "ef_syncs": R.SYNC_STEPS, "pipe_micro": 8, "pipe_shape": [2, 4, 16]}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_card_scenario_holds_on_the_cpu(world, tmp_path):
    """Every check of the card's phase holds on gloo ranks (at 4, the
    four-card run's world on NCCL): the process mesh's operators equal
    the logical mesh's, the int8 sync within JAX's bound and the same on
    every rank, error feedback no worse than 1.05x, GPipe over ``world``
    stages the sequential result; at one rank every collective is the
    identity; each op names its backend, world and device."""
    ranks = R.launch("card", world, tmp_path, spec=CARD_SPEC)
    for res in ranks:
        assert res["world"] == world and res["backend"] == "gloo"
        assert res["pipeline"]["stages"] == world and res["card"] == {}
        assert res["flash_launches"] == 0  # the plain attention on the CPU
        assert all(row["equal"] for row in res["dataframe"].values()), res["dataframe"]
        assert all(row["dropped"] == 0 for row in res["dataframe"].values())
        # the plain histogram on the CPU: no kernel launches
        assert all(row["hash_launches"] == 0 for row in res["dataframe"].values())
        g = res["grads"]
        assert g["max_rel_err"] < 0.02 and g["ef_err"] <= 1.05 * g["plain_err"]
        assert g["replicated"]["ef_err"] <= 1.05 * g["replicated"]["plain_err"]
        assert g["int8_bytes"] >= g["fp32_bytes"]  # int32 payloads, plus the scales
        assert res["pipeline"]["max_rel_diff"] <= PIPE_RTOL
        assert {e["backend"] for v in res["wire"].values() for e in v} == {"gloo"}
        assert {e["world"] for v in res["wire"].values() for e in v} == {world}
    assert len({tuple(r["grads"]["checksums"]) for r in ranks}) == 1
    if world == 1:
        assert ranks[0]["identity"] and ranks[0]["grads"]["identity"]
    else:
        assert set(R.WIRE_OPS) == set(ranks[0]["wire"]) | set(ranks[1]["wire"])


def test_card_scenario_on_a_data_pipe_grid_holds_on_the_cpu(tmp_path):
    """The four-card run's (data 2, pipe 2) mesh on 4 gloo ranks: each axis
    a subgroup of 2; the int8 sync along ``data`` the same on both ranks
    of a line and within JAX's bound of the line's fp32 mean; GPipe of 2
    stages along ``pipe`` the sequential result; the subgroups' ops at
    world 2 beside the default group's at world 4."""
    ranks = R.launch("card", 4, tmp_path, spec=dict(CARD_SPEC, grid=[2, 2]))
    lines = {}
    for res in ranks:
        grid = res["grid"]
        assert grid["shape"] == {"data": 2, "pipe": 2}
        assert grid["sync"]["max_rel_err"] < 0.02
        assert grid["pipeline"]["stages"] == 2
        assert grid["pipeline"]["max_rel_diff"] <= PIPE_RTOL
        lines.setdefault(grid["coords"]["pipe"], []).append(grid["sync"]["checksums"])
        assert {e["world"] for v in res["wire"].values() for e in v} == {2, 4}
    assert sorted(len(v) for v in lines.values()) == [2, 2]
    assert all(a == b for a, b in lines.values())
    # the two lines sync different pairs of batches
    assert lines[0][0] != lines[1][0]


def test_nccl_ranks_need_a_card_each(tmp_path, monkeypatch):
    """NCCL asked for on a machine with fewer cards than ranks (two, on
    any machine) raises, naming both counts, before a rank starts or its
    folder is made; it never becomes gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4 ranks need 4 cards, this machine has 2"):
        R.launch("card", 4, tmp_path / "nccl", spec=CARD_SPEC, backend="nccl")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        R.launch("card", 1, tmp_path / "mpi", backend="mpi")
    assert not any(tmp_path.iterdir())


if __name__ == "__main__":
    _jax_main(sys.argv[1])
