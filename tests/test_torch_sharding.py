"""Port parity for ``repro_torch.distributed.sharding`` and the port's
meshes, on the CPU.

The rule table and ``spec_for`` against JAX's on JAX's own cases
(``tests/test_sharding_and_analysis.py``); ``param_specs_tree`` against
JAX's on every leaf of every full config's train state (its optimizer's
states included) and caches at the decode shapes, on the production mesh
``{"data": 16, "model": 16}`` and the multi-pod ``{"pod": 2, "data": 16,
"model": 16}``, under the default rules and with FSDP over the pod axis
(``launch/specs.py``'s ``fsdp_over_pod`` override).  JAX's spec derivation
reads only ``mesh.shape``, so a stand-in mesh needs no devices.  Then the
placements on a real mesh: 4 gloo ranks on localhost in a 2 x 2 (data,
model) ``DeviceMesh``, each rank's local shard of every parameter of a
smoke config equal to the numpy slice JAX's spec names for that rank's
coordinates.  Last, the logical meshes with several axes."""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import default_run_config as jdefault_run_config  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro_torch.common.params import init_params  # noqa: E402
from repro_torch.configs import default_run_config as tdefault_run_config  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.dataframe import ops_dist as TD  # noqa: E402
from repro_torch.dataframe.table import Table as TTable  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_process_mesh  # noqa: E402
from repro_torch.train import state as tstate  # noqa: E402

import torch_dist_ranks as R  # noqa: E402
from torch_df_cases import run_ops  # noqa: E402


def fake_mesh(shape):
    return types.SimpleNamespace(shape=shape)


MESHES = {"pod1": {"data": 16, "model": 16}, "pod2": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": None, "fsdp_over_pod": {"embed": ("pod", "data")}}
CACHE_SHAPES = ("decode_32k", "long_500k")


def test_rule_table_is_jax_s():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    over = {"embed": ("pod", "data"), "act_seq": ("model",)}
    assert TS.merge_rules(over) == JS.merge_rules(over)


@pytest.mark.parametrize("axes,shape,mesh,want", [
    (("embed", "mlp"), (2048, 5632), "pod1", ("data", "model")),
    (("embed", "kv_heads", None), (2048, 10, 64), "pod1", ("data",)),  # 10 ∤ 16
    (("heads", "mlp"), (32, 64), "pod1", ("model",)),  # exclusivity
    (("act_batch", None), (256, 128), "pod2", (("pod", "data"),)),
    (("act_batch", None), (1, 128), "pod2", ()),  # batch 1: everything falls back
    (("act_batch", None), (16, 128), "pod2", ("pod",)),  # the longest dividing prefix
])
def test_spec_for_matches_jax(axes, shape, mesh, want):
    m = fake_mesh(MESHES[mesh])
    got = TS.spec_for(axes, shape, m, TS.merge_rules())
    assert got == want
    assert got == JS.spec_for(axes, shape, m, JS.merge_rules())
    with pytest.raises(KeyError, match="no sharding rule"):
        TS.spec_for(("nonesuch",), (4,), m, TS.merge_rules())


def _trees(arch):
    """{name: (JAX Param tree, port Param tree)} of one full config."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jrun, trun = jdefault_run_config(arch, "train_4k"), tdefault_run_config(arch, "train_4k")
    out = {"train_state": (jstate.train_state_specs(jcfg, jrun),
                           tstate.train_state_specs(tcfg, trun))}
    for name in CACHE_SHAPES:
        B, S = SHAPES[name].global_batch, SHAPES[name].seq_len
        out[name] = (jstate.cache_specs(jcfg, B, S), tstate.cache_specs(tcfg, B, S))
    return out


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_tree_matches_jax(arch, mesh, rules):
    m = fake_mesh(MESHES[mesh])
    for name, (jtree, ttree) in _trees(arch).items():
        want = R.leaf_paths(JS.param_specs_tree(jtree, m, RULES[rules]))
        got = R.leaf_paths(TS.param_specs_tree(ttree, m, RULES[rules]))
        assert sorted(got) == sorted(want), name
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        assert not bad, (name, bad)
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    got = TS.param_specs_tree(tstate.train_state_specs(tcfg, tdefault_run_config(arch, "train_4k")),
                              m, RULES[rules])
    assert tstate.state_shardings(tcfg, tdefault_run_config(arch, "train_4k"), m,
                                  RULES[rules]) == got
    want = jstate.state_shardings(jcfg, jdefault_run_config(arch, "train_4k"), m, RULES[rules])
    assert R.leaf_paths(got) == R.leaf_paths(want)


def test_placements_name_each_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    axes = ("pod", "data", "model")
    assert TS.placements_for((("pod", "data"), None, "model"), axes) == \
        (Shard(0), Shard(0), Shard(2))
    assert TS.placements_for((), axes) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        TS.placements_for((("data", "pod"),), axes)


def test_constrain_is_the_identity():
    x = torch.arange(6.0)
    assert TS.constrain(x, ("act_batch",)) is x
    assert TS.Axes(("embed", "mlp")).spec((2048, 5632), fake_mesh(MESHES["pod1"]),
                                          TS.merge_rules()) == ("data", "model")


# -- placements on a 2 x 2 gloo DeviceMesh ---------------------------------------


ARCH, SEED = "tinyllama-1.1b", 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.launch("sharding", 4, tmp_path_factory.mktemp("ranks"),
                    spec={"shape": [2, 2], "arch": ARCH, "seed": SEED})


def _jax_slice(full, spec, coords, sizes):
    """The block of ``full`` that JAX's ``spec`` gives the device at
    ``coords`` (axes split major to minor)."""
    idx = []
    for d, entry in enumerate(tuple(spec) + (None,) * (full.ndim - len(spec))):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n, i = 1, 0
        for a in names:
            i = i * sizes[a] + coords[a]
            n *= sizes[a]
        per = full.shape[d] // n
        idx.append(slice(i * per, (i + 1) * per))
    return full[tuple(idx)]


def test_local_shards_are_jax_s_slices(ranks):
    """Every rank's shard of every parameter is the numpy slice of the
    seeded full tensor that JAX's spec names for its coordinates; at least
    one tensor is split on each mesh axis."""
    sizes = {"data": 2, "model": 2}
    specs = R.leaf_paths(JS.param_specs_tree(jstate.model_specs(jget_config(ARCH, smoke=True)),
                                             fake_mesh(sizes)))
    full = R.leaf_paths(init_params(torch.Generator().manual_seed(SEED),
                                    tstate.model_specs(tget_config(ARCH, smoke=True)), "cpu"))
    assert sorted({r["coords"]["data"] * 2 + r["coords"]["model"] for r in ranks}) == [0, 1, 2, 3]
    split = set()
    for res in ranks:
        assert sorted(res["shards"]) == sorted(specs)
        for k, spec in specs.items():
            want = _jax_slice(full[k].numpy(), spec, res["coords"], sizes)
            np.testing.assert_array_equal(res["shards"][k], want, err_msg=k)
            split.update(a for e in spec if e for a in (e if isinstance(e, tuple) else (e,)))
    assert split == {"data", "model"}


# -- the logical meshes ---------------------------------------------------------


def test_multi_axis_logical_mesh_runs_the_dataframe_over_its_axis():
    """A (data 8, model 2) logical mesh holds its shape in order; the
    operators over "data" give the 1-D mesh of 8's results, bitwise."""
    mesh = make_mesh((8, 2), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 8, "model": 2} and list(mesh.shape) == ["data", "model"]
    want = run_ops(make_mesh((8,), ("data",), device="cpu"), TTable, TD, "filtered")
    got = run_ops(mesh, TTable, TD, "filtered")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    with pytest.raises(ValueError, match="one distinct name"):
        make_mesh((2, 2), ("data", "data"), device="cpu")
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh((2, 0), ("data", "model"), device="cpu")


def test_process_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_process_mesh((2,), ("data",), device="cpu")
