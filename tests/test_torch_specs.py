"""Port parity for ``repro_torch.launch.specs`` and the pieces the dry run
needs: ``shape_applicable``, ``abstract_params``, ``param_count``,
``param_bytes`` and ``abstract_train_state``, on the CPU.

``input_specs`` against JAX's for every (arch x shape) cell that JAX's
``shape_applicable`` admits, at smoke width, at the smoke shapes and at
the published ones, on stand-ins of both production meshes (JAX's spec
derivation reads only ``mesh.shape``, so one object with JAX's shapes is
passed to both packages): the same step kind, and every argument leaf of
the same shape and dtype (dtypes compared by name), with the same input
and output spec trees.  Exact: shapes, dtypes and specs are integers and
names.  Then what both packages do with a smoke shape that cannot hold
the published microbatch count: both steps raise."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.common import params as JP  # noqa: E402
from repro.launch import specs as JSPEC  # noqa: E402
from repro.train import state as JST  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.common import params as TP  # noqa: E402
from repro_torch.launch import specs as TSPEC  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.train import state as TST  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402

torch.set_num_threads(1)

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
SHAPE_SETS = {"smoke": (JC.SMOKE_SHAPES, TC.SMOKE_SHAPES), "full": (JC.SHAPES, TC.SHAPES)}
CELLS = [(a, s) for a in JC.ARCHS for s in JC.SHAPES if JC.shape_applicable(a, s)]


def _is_spec(x) -> bool:
    if isinstance(x, PartitionSpec):
        return True
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def flat(tree, path=""):
    """{path: leaf} of a tree of dicts, lists and tuples; a spec (JAX's
    PartitionSpec or the port's tuple) is a leaf, as JAX's entries."""
    if _is_spec(tree):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in flat(x, f"{path}/{i}").items()}
    return {path: tree}


def dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def signature(args):
    return {p: (tuple(x.shape), dtype_name(x.dtype)) for p, x in flat(args).items()}


def test_production_meshes_have_jaxs_shapes():
    assert make_production_mesh().shape == MESHES["single"]
    assert make_production_mesh(multi_pod=True).shape == MESHES["multi"]
    assert make_production_mesh().device.type == "meta"


def test_shape_applicable_is_jaxs():
    assert TC.FULL_ATTENTION_ARCHS == JC.FULL_ATTENTION_ARCHS
    for arch in JC.ARCHS:
        for shape in JC.SHAPES:
            assert TC.shape_applicable(arch, shape) == JC.shape_applicable(arch, shape)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_abstract_params_count_and_bytes_are_jaxs(arch, smoke):
    jcfg, tcfg = JC.get_config(arch, smoke=smoke), TC.get_config(arch, smoke=smoke)
    for shape in ("train_4k", "decode_32k"):
        jrc, trc = JC.default_run_config(arch, shape), TC.default_run_config(arch, shape)
        jspecs, tspecs = JST.train_state_specs(jcfg, jrc), TST.train_state_specs(tcfg, trc)
        assert TP.param_count(tspecs) == JP.param_count(jspecs)
        assert TP.param_bytes(tspecs) == JP.param_bytes(jspecs)
        t_abs = TST.abstract_train_state(tcfg, trc)
        assert signature(t_abs) == signature(JST.abstract_train_state(jcfg, jrc))
        assert all(t.device.type == "meta" for t in flat(t_abs).values())
        assert signature(TP.abstract_params(TST.model_specs(tcfg))) == \
            signature(JP.abstract_params(JST.model_specs(jcfg)))
        assert flat(TP.map_params(lambda p: p.shape, tspecs)) == \
            flat(JP.map_params(lambda p: p.shape, jspecs))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shapes", sorted(SHAPE_SETS))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_are_jaxs(arch, shape_name, shapes, mesh):
    stand_in = types.SimpleNamespace(shape=dict(MESHES[mesh]))
    jshapes, tshapes = SHAPE_SETS[shapes]
    jcfg = JC.get_config(arch, smoke=True).with_overrides(decode_impl="ref")
    tcfg = TC.get_config(arch, smoke=True).with_overrides(decode_impl="ref")
    jout = JSPEC.input_specs(jcfg, jshapes[shape_name],
                             JC.default_run_config(arch, shape_name), stand_in)
    tout = TSPEC.input_specs(tcfg, tshapes[shape_name],
                             TC.default_run_config(arch, shape_name), stand_in)
    assert tout[0] == jout[0]
    assert signature(tout[1]) == signature(jout[1])
    assert all(t.device.type == "meta" for t in flat(tout[1]).values())
    assert flat(tout[2]) == flat(jout[2])
    assert flat(tout[3]) == flat(jout[3])


def test_microbatches_above_the_smoke_batch_raise_in_both():
    """qwen2-vl's published train_4k run config takes 8 microbatches; the
    smoke batch is 4.  JAX's step cannot split it and neither can the
    port's: the specs hold JAX's shapes and no shape of the port's own."""
    arch, shape = "qwen2-vl-72b", "train_4k"
    stand_in = types.SimpleNamespace(shape=dict(MESHES["single"]))
    jcfg = JC.get_config(arch, smoke=True).with_overrides(decode_impl="ref")
    tcfg = TC.get_config(arch, smoke=True).with_overrides(decode_impl="ref")
    jrc, trc = JC.default_run_config(arch, shape), TC.default_run_config(arch, shape)
    assert jrc.num_microbatches == trc.num_microbatches == 8
    assert JC.SMOKE_SHAPES[shape].global_batch == 4
    _, jargs, _, _ = JSPEC.input_specs(jcfg, JC.SMOKE_SHAPES[shape], jrc, stand_in)
    _, targs, _, _ = TSPEC.input_specs(tcfg, TC.SMOKE_SHAPES[shape], trc, stand_in)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(JSTEP.make_train_step(jcfg, jrc), *jargs)
    with pytest.raises(RuntimeError, match="invalid for input of size"):
        TSTEP.make_train_step(tcfg, trc)(*targs)


def test_specs_leaves_hold_no_memory():
    """Every argument is a meta tensor: a full-width cell's 13 GB train
    state costs nothing to describe."""
    tcfg = TC.get_config("tinyllama-1.1b")
    kind, args, _, _ = TSPEC.input_specs(tcfg, TC.SHAPES["train_4k"],
                                         TC.default_run_config("tinyllama-1.1b", "train_4k"),
                                         make_production_mesh())
    leaves = list(flat(args).values())
    assert kind == "train" and all(t.device.type == "meta" for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    assert nbytes == TP.param_bytes(TST.train_state_specs(
        tcfg, TC.default_run_config("tinyllama-1.1b", "train_4k"))) + 2 * 256 * 4096 * 4
