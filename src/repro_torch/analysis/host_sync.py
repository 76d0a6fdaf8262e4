"""Host-sync pass (the port's counterpart of ``repro.analysis.jit_boundary``,
run under its pass name ``jit``).

Eager torch has no ``jax.jit`` to find, so the roots are a declared table
(:data:`ROOTS`) of the port's counterparts of JAX's jit roots: the step
factories' returned closures, the sampler, the loader's gather, the
training driver's and the dry run's steps, and the ``kernels/ops.py``
entry points (the counterparts of the ``jax.jit``-wrapped Pallas
functions).  From each root an AST call graph is walked, as JAX's pass
walks it, and the code reachable from a step is checked for

- **host syncs** (rule ``host-sync``): ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()`` and ``.to("cpu")`` on a tensor; ``int()``,
  ``float()`` or ``bool()`` of a tensor; ``np.asarray`` / ``np.array`` of
  a tensor; ``torch.cuda.synchronize()``; wall-clock reads
  (``time.time`` / ``perf_counter`` / ``monotonic``); and the ops whose
  output shape depends on the data, which sync on CUDA: ``nonzero``,
  indexing with a boolean mask, ``masked_select``, ``unique`` and
  ``repeat_interleave`` without ``output_size``;
- **Python branching on tensor values** (rule ``traced-branch``): an
  ``if`` / ``while`` whose test depends on a tensor's value (``is None``,
  membership tests and ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device``
  are static and exempt, as in JAX).

JAX's third rule, ``static-unhashable``, has no counterpart: eager torch
has no static arguments to hash.

Tracedness ("a tensor's value") is propagated interprocedurally as in
JAX: a root's parameters are tensors except its keyword-only ones and
those its entry names static; a function called with a tensor argument
is analysed with those parameters traced (memoised); closure variables
(``cfg``, ``run_cfg``, ``max_len``) are static; a closure handed to
another call (``torch.utils.checkpoint``, ``map_tree``) is analysed with
every parameter traced.

``# sync-ok: <reason>`` on the offending line suppresses a finding; the
reason is required.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding, rel

_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "sharding"}
#: tensor methods whose result is host metadata, not data
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "stride", "element_size",
                   "get_device", "is_contiguous", "is_floating_point",
                   "data_ptr", "storage_offset"}
_TIME_FUNCS = {"time", "perf_counter", "monotonic", "process_time"}
_STATIC_BUILTINS = {"len", "isinstance", "getattr", "hasattr", "type",
                    "range", "sorted", "min", "max", "enumerate", "zip",
                    "tuple", "list", "dict", "set", "str", "repr"}
_CAST_BUILTINS = {"float", "int", "bool", "complex"}
#: tensor methods that copy to the host
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
#: ops whose output shape depends on the data
_DATA_SHAPED = {"nonzero", "masked_select", "unique", "unique_consecutive",
                "argwhere", "nonzero_static"}
_MASK_METHODS = {"bool", "isnan", "isinf", "isfinite", "logical_not",
                 "logical_and", "logical_or", "logical_xor", "isin"}
_MARKER = re.compile(r"#\s*sync-ok:\s*\S")


@dataclass(frozen=True)
class Root:
    """One entry of the root table: ``name`` in port module ``module``.

    ``kind`` is ``"function"`` (the def itself), ``"factory"`` (the inner
    defs it returns, as JAX's ``_returned_defs`` resolves them), ``"var"``
    (a variable bound to a factory's result anywhere in the module) or
    ``"dispatch"`` (every factory the def names).  ``static`` lists
    parameters that are host values (JAX's static_argnames); keyword-only
    parameters are static too.  ``jax`` names the JAX jit roots
    (``module.function``) this entry stands for."""

    module: str
    name: str
    kind: str = "function"
    static: Tuple[str, ...] = ()
    jax: Tuple[str, ...] = ()


#: the port's counterparts of JAX's jit roots
ROOTS: Tuple[Root, ...] = (
    Root("repro_torch.train.step", "make_train_step", "factory",
         jax=("repro.train.step.train_step",)),
    Root("repro_torch.train.step", "make_loss_fn", "factory"),
    Root("repro_torch.train.step", "make_prefill_step", "factory",
         jax=("repro.train.step.prefill_step",)),
    Root("repro_torch.train.step", "make_prefill_chunk_step", "factory"),
    Root("repro_torch.train.step", "make_decode_step", "factory",
         jax=("repro.train.step.decode_step", "repro.serve.engine._step")),
    # jax.jit(sample_tokens) (repro/serve/engine.py:186); the engine's
    # jitted decode wrapper (:236) has no port counterpart: the engine
    # calls make_decode_step's closure, then this sampler
    Root("repro_torch.serve.sampling", "sample_tokens",
         jax=("repro.serve.engine._step",)),
    Root("repro_torch.bridge.loader", "_gather", static=("step",),
         jax=("repro.bridge.loader.gather_batch",)),
    Root("repro_torch.launch.train", "step_fn", "var"),
    Root("repro_torch.launch.dryrun", "_step_for", "dispatch"),
    Root("repro_torch.kernels.ops", "flash_attention",
         jax=("repro.kernels.flash_attention.flash_attention",)),
    Root("repro_torch.kernels.ops", "decode_attention",
         jax=("repro.kernels.decode_attention.decode_attention",)),
    Root("repro_torch.kernels.ops", "decode_attention_paged",
         jax=("repro.kernels.decode_attention.decode_attention_paged",)),
    Root("repro_torch.kernels.ops", "prefill_attention",
         jax=("repro.kernels.prefill_attention.prefill_attention",)),
    Root("repro_torch.kernels.ops", "prefill_attention_paged",
         jax=("repro.kernels.prefill_attention.prefill_attention_paged",)),
    Root("repro_torch.kernels.ops", "paged_append"),
    Root("repro_torch.kernels.ops", "rmsnorm",
         jax=("repro.kernels.rmsnorm.rmsnorm",)),
    Root("repro_torch.kernels.ops", "hash_partition_histogram",
         jax=("repro.kernels.hash_partition.hash_partition_histogram",)),
)

#: JAX jit roots with no entry above, and why
NO_COUNTERPART: Dict[str, str] = {}


@dataclass
class _Module:
    name: str                       # dotted module path
    path: Path
    tree: ast.Module
    lines: List[str]
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    # local alias -> ("module", dotted) or ("from", module, name)
    imports: Dict[str, Tuple] = field(default_factory=dict)
    # var name -> Call exprs assigned to it (``step = make_decode_step(...)``)
    var_calls: Dict[str, List[ast.Call]] = field(default_factory=dict)


def _index_module(name: str, path: Path) -> _Module:
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    mod = _Module(name=name, path=path, tree=tree, lines=source.splitlines())
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name not in mod.functions:
            mod.functions[node.name] = node
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            mod.var_calls.setdefault(node.targets[0].id, []).append(node.value)
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                mod.imports[a.asname or a.name.split(".")[0]] = ("module", a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                mod.imports[a.asname or a.name] = ("from", node.module, a.name)
    return mod


def _returned_defs(fn: ast.FunctionDef) -> List[ast.FunctionDef]:
    """Inner defs that a factory returns (the steps themselves)."""
    local_defs: Dict[str, List[ast.FunctionDef]] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.FunctionDef) and n is not fn:
            local_defs.setdefault(n.name, []).append(n)
    returned = {node.value.id for node in ast.walk(fn)
                if isinstance(node, ast.Return)
                and isinstance(node.value, ast.Name)}
    out: List[ast.FunctionDef] = []
    for name in sorted(returned):
        # a factory may define several same-named variants on different
        # branches: every one is a root
        out.extend(local_defs.get(name, []))
    return out


def _dotted(node: ast.expr) -> str:
    """``a.b.c`` of a Name/Attribute chain ('' otherwise)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class HostSyncPass:
    def __init__(self, files: Dict[str, Path], root: Path,
                 roots: Sequence[Root] = ROOTS) -> None:
        self.root = root
        self.roots = tuple(roots)
        self.modules: Dict[str, _Module] = {
            name: _index_module(name, p) for name, p in files.items()
        }
        self.findings: List[Finding] = []
        self._seen_keys: Set[Tuple] = set()
        #: (module, line, traced params) -> whether the def returns a tensor
        self._memo: Dict[Tuple, bool] = {}
        self._stack: Set[Tuple[str, int]] = set()

    # -- roots -----------------------------------------------------------
    def resolve_roots(self) -> List[Tuple[_Module, ast.FunctionDef, Set[str]]]:
        """(module, def, static parameters) of every table entry; raises
        for an entry that no longer resolves (the table must track the
        code)."""
        out: List[Tuple[_Module, ast.FunctionDef, Set[str]]] = []
        for r in self.roots:
            mod = self.modules.get(r.module)
            if mod is None:
                raise LookupError(f"root module {r.module} not indexed")
            defs: List[Tuple[_Module, ast.FunctionDef]] = []
            if r.kind == "var":
                for call in mod.var_calls.get(r.name, ()):
                    got = self._resolve_callable(mod, call.func)
                    if got is not None:
                        defs += [(got[0], d) for d in _returned_defs(got[1])]
            else:
                fn = mod.functions.get(r.name)
                if fn is None:
                    raise LookupError(f"root {r.module}.{r.name} not found")
                if r.kind == "function":
                    defs = [(mod, fn)]
                elif r.kind == "factory":
                    defs = [(mod, d) for d in _returned_defs(fn)]
                elif r.kind == "dispatch":
                    for node in ast.walk(fn):
                        if isinstance(node, ast.Name):
                            got = self._resolve_callable(mod, node)
                            if got is not None and _returned_defs(got[1]):
                                defs += [(got[0], d) for d in _returned_defs(got[1])]
                else:
                    raise ValueError(f"unknown root kind {r.kind!r}")
            if not defs:
                raise LookupError(f"root {r.module}.{r.name} ({r.kind}) "
                                  "resolves to no function")
            for m, d in defs:
                static = set(r.static) | {a.arg for a in d.args.kwonlyargs}
                out.append((m, d, static))
        return out

    def _resolve_callable(
        self, mod: _Module, func: ast.expr
    ) -> Optional[Tuple[_Module, ast.FunctionDef]]:
        """Resolve a called name/attribute to (module, def) across imports."""
        if isinstance(func, ast.Name):
            if func.id in mod.functions:
                return (mod, mod.functions[func.id])
            imp = mod.imports.get(func.id)
            if imp and imp[0] == "from":
                target = self.modules.get(imp[1])
                if target and imp[2] in target.functions:
                    return (target, target.functions[imp[2]])
            # calling a variable bound to a factory's return value:
            # ``step = make_decode_step(cfg); ... step(params, ...)``
            for assigned in mod.var_calls.get(func.id, ()):
                if (isinstance(assigned.func, ast.Name)
                        and assigned.func.id == func.id):
                    continue  # self-referential rebind, e.g. f = f(...)
                factory = self._resolve_callable(mod, assigned.func)
                if factory is not None:
                    fmod, fdef = factory
                    inner = _returned_defs(fdef)
                    if inner:
                        return (fmod, inner[0])
        elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            imp = mod.imports.get(func.value.id)
            modname = None
            if imp and imp[0] == "module":
                modname = imp[1]
            elif imp and imp[0] == "from":
                modname = f"{imp[1]}.{imp[2]}"
            if modname:
                target = self.modules.get(modname)
                if target and func.attr in target.functions:
                    return (target, target.functions[func.attr])
        return None

    # -- analysis --------------------------------------------------------
    def run(self) -> List[Finding]:
        for mod, fn, static in self.resolve_roots():
            traced = {a.arg for a in fn.args.args + fn.args.kwonlyargs
                      if a.arg not in static and a.arg != "self"}
            self._analyze(mod, fn, traced)
        return self.findings

    def _emit(self, mod: _Module, line: int, rule: str, symbol: str,
              message: str) -> None:
        if line <= len(mod.lines) and _MARKER.search(mod.lines[line - 1]):
            return
        key = (mod.name, line, rule, symbol)
        if key in self._seen_keys:
            return
        self._seen_keys.add(key)
        self.findings.append(Finding(
            pass_name="jit", rule=rule, file=rel(mod.path, self.root),
            line=line, symbol=symbol, message=message))

    def _analyze(self, mod: _Module, fn: ast.FunctionDef,
                 traced_params: Set[str]) -> bool:
        """Walk ``fn`` with ``traced_params`` tensors; returns whether it
        may return one (True while it is still on the stack)."""
        memo_key = (mod.name, fn.lineno, frozenset(traced_params))
        if memo_key in self._memo:
            return self._memo[memo_key]
        stack_key = (mod.name, fn.lineno)
        if stack_key in self._stack:
            return True
        self._memo[memo_key] = True
        self._stack.add(stack_key)
        try:
            sub = _FunctionAnalyzer(self, mod, fn, traced_params)
            sub.run()
            self._memo[memo_key] = sub.returns
        finally:
            self._stack.discard(stack_key)
        return self._memo[memo_key]


class _FunctionAnalyzer:
    """Single-function walk: propagates tracedness, reports findings,
    descends into resolvable callees that receive tensors."""

    def __init__(self, owner: HostSyncPass, mod: _Module,
                 fn: ast.FunctionDef, traced_params: Set[str],
                 local_defs: Optional[Dict[str, ast.FunctionDef]] = None) -> None:
        self.o = owner
        self.mod = mod
        self.fn = fn
        self.traced: Set[str] = set(traced_params)
        #: names bound to boolean tensors (a mask indexes by data)
        self.masks: Set[str] = set()
        # closures defined in an enclosing scope remain callable here
        self.local_defs: Dict[str, ast.FunctionDef] = dict(local_defs or {})
        #: whether a ``return`` hands back a tensor's data
        self.returns = False

    def run(self) -> None:
        # two passes so names assigned late but read in earlier loop
        # bodies still pick up tracedness
        for _ in range(2):
            for stmt in self.fn.body:
                self._stmt(stmt)

    def _sync(self, node: ast.AST, message: str) -> None:
        self.o._emit(self.mod, node.lineno, "host-sync", self.fn.name, message)

    # -- statements ------------------------------------------------------
    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # closures are analysed at their call sites (with the real arg
            # tracedness) or, when passed as callbacks, with every
            # parameter traced — see _call
            self.local_defs[node.name] = node
            return
        if isinstance(node, ast.Assign):
            t = self._expr(node.value)
            mask = t and self._is_mask(node.value)
            for tgt in node.targets:
                self._bind(tgt, t, mask)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            t = self._expr(node.value)
            self._bind(node.target, t, t and self._is_mask(node.value))
        elif isinstance(node, ast.AugAssign):
            t = self._expr(node.value) or self._expr(node.target)
            self._bind(node.target, t)
        elif isinstance(node, (ast.If, ast.While)):
            t = self._expr(node.test)
            if t and not self._exempt_test(node.test):
                self.o._emit(
                    self.mod, node.test.lineno, "traced-branch",
                    self.fn.name,
                    "Python `if`/`while` on a tensor's value reads it to the "
                    "host (use torch.where, or decide on a host value)")
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
        elif isinstance(node, ast.For):
            self._bind(node.target, self._expr(node.iter))
            for stmt in node.body + node.orelse:
                self._stmt(stmt)
        elif isinstance(node, ast.With):
            for item in node.items:
                self._expr(item.context_expr)
            for stmt in node.body:
                self._stmt(stmt)
        elif isinstance(node, ast.Try):
            for stmt in node.body:
                self._stmt(stmt)
            for h in node.handlers:
                for stmt in h.body:
                    self._stmt(stmt)
            for stmt in node.orelse + node.finalbody:
                self._stmt(stmt)
        elif isinstance(node, ast.Return) and node.value is not None:
            self.returns |= self._expr(node.value)
        elif isinstance(node, ast.Expr):
            self._expr(node.value)
        # asserts and raises: checks on the way out, as in JAX's pass

    def _bind(self, target: ast.expr, traced: bool, mask: bool = False) -> None:
        if isinstance(target, ast.Name):
            if traced:
                self.traced.add(target.id)
            else:
                self.traced.discard(target.id)
            if mask:
                self.masks.add(target.id)
            else:
                self.masks.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, traced)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, traced)
        # subscript/attribute writes don't change name tracedness

    def _analyze_local(self, cdef: ast.FunctionDef,
                       traced_params: Optional[Set[str]]) -> bool:
        """Analyse a closure; returns whether it may return a tensor.
        ``traced_params=None`` = callback semantics (every parameter
        traced).  Closure variables inherit the enclosing scope's
        tracedness; sibling closures stay callable."""
        key = (self.mod.name, cdef.lineno)
        if key in self.o._stack:
            return True
        params = {a.arg for a in cdef.args.args + cdef.args.kwonlyargs}
        if traced_params is None:
            traced_params = set(params)
        inherited = self.traced - params
        memo_key = (self.mod.name, cdef.lineno,
                    frozenset(traced_params | inherited))
        if memo_key in self.o._memo:
            return self.o._memo[memo_key]
        self.o._memo[memo_key] = True
        self.o._stack.add(key)
        try:
            sub = _FunctionAnalyzer(self.o, self.mod, cdef,
                                    traced_params | inherited,
                                    local_defs=self.local_defs)
            sub.run()
            self.o._memo[memo_key] = sub.returns
        finally:
            self.o._stack.discard(key)
        return self.o._memo[memo_key]

    @staticmethod
    def _exempt_test(test: ast.expr) -> bool:
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in test.ops):
            return True
        if isinstance(test, ast.BoolOp):
            return all(_FunctionAnalyzer._exempt_test(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return _FunctionAnalyzer._exempt_test(test.operand)
        return False

    def _is_mask(self, node: ast.expr) -> bool:
        """Whether a tensor-valued expression is a boolean mask."""
        if isinstance(node, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                           for op in node.ops)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr,
                                                                ast.BitXor)):
            return self._is_mask(node.left) or self._is_mask(node.right)
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            return node.func.attr in _MASK_METHODS
        return False

    # -- expressions -----------------------------------------------------
    def _expr(self, node: Optional[ast.expr]) -> bool:
        """Returns True if the expression's value is (possibly) a tensor's
        data, reporting findings encountered on the way."""
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.traced
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value)
            if node.attr in _STATIC_ATTRS:
                return False
            return base
        if isinstance(node, ast.Subscript):
            idx = self._expr(node.slice)
            base = self._expr(node.value)
            if base and idx and self._is_mask(node.slice):
                self._sync(node, "indexing with a boolean mask sizes its output "
                                 "by the data (a host sync on CUDA; use "
                                 "torch.where)")
            return base
        if isinstance(node, ast.BinOp):
            return self._expr(node.left) | self._expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._expr(v) for v in node.values)
        if isinstance(node, ast.Compare):
            t = self._expr(node.left)
            for c in node.comparators:
                t |= self._expr(c)
            # identity / membership tests inspect structure, not values
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return t
        if isinstance(node, ast.IfExp):
            t = self._expr(node.test)
            return self._expr(node.body) | self._expr(node.orelse) | t
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self._expr(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return any([self._expr(v) for v in list(node.keys) + list(node.values)
                        if v is not None])
        if isinstance(node, ast.Starred):
            return self._expr(node.value)
        if isinstance(node, ast.Lambda):
            return False
        # a comprehension's elements decide its tracedness (its targets
        # are tensors when it iterates over tensors)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for g in node.generators:
                self._bind(g.target, self._expr(g.iter))
            return self._expr(node.elt)
        if isinstance(node, ast.DictComp):
            for g in node.generators:
                self._bind(g.target, self._expr(g.iter))
            return self._expr(node.key) | self._expr(node.value)
        if isinstance(node, ast.JoinedStr):
            return False
        if isinstance(node, ast.Call):
            return self._call(node)
        return False

    def _call(self, node: ast.Call) -> bool:
        args_traced = [self._expr(a) for a in node.args]
        kw_traced = {kw.arg: self._expr(kw.value) for kw in node.keywords}
        any_traced = any(args_traced) or any(kw_traced.values())
        func = node.func
        name = _dotted(func)

        # a closure passed as a callback (checkpoint, map_tree): its
        # parameters are tensors
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name) and arg.id in self.local_defs:
                self._analyze_local(self.local_defs[arg.id], None)

        # direct call of a closure: map real arg tracedness onto params
        if isinstance(func, ast.Name) and func.id in self.local_defs:
            cdef = self.local_defs[func.id]
            params = [a.arg for a in cdef.args.args]
            traced_params = {params[i] for i, t in enumerate(args_traced)
                             if t and i < len(params)}
            traced_params |= {k for k, t in kw_traced.items() if t and k}
            return self._analyze_local(cdef, traced_params)

        # wall-clock reads and device syncs, whatever the arguments
        if (isinstance(func, ast.Attribute) and func.attr in _TIME_FUNCS
                and isinstance(func.value, ast.Name) and func.value.id == "time"):
            self._sync(node, f"`time.{func.attr}()` in a step reads the host "
                             f"clock (on CUDA it times the launch, not the work)")
            return False
        if name == "torch.cuda.synchronize":
            self._sync(node, "`torch.cuda.synchronize()` in a step blocks the "
                             "host on the device")
            return False

        if isinstance(func, ast.Attribute):
            on_tensor = self._expr(func.value)
            if func.attr in _STATIC_METHODS and on_tensor:
                return False
            if func.attr in _HOST_METHODS and on_tensor:
                self._sync(node, f"`.{func.attr}()` on a tensor copies it to "
                                 f"the host (a device sync on CUDA)")
                return False
            if func.attr == "to" and on_tensor and self._to_cpu(node):
                self._sync(node, "`.to(\"cpu\")` on a tensor copies it to the "
                                 "host (a device sync on CUDA)")
                return False
            if (isinstance(func.value, ast.Name) and func.value.id == "np"
                    and func.attr in ("asarray", "array") and any_traced):
                self._sync(node, f"`np.{func.attr}` of a tensor copies it to "
                                 f"the host")
                return False
            data_shaped = (on_tensor or (name.startswith("torch.") and any_traced))
            if data_shaped and (func.attr in _DATA_SHAPED or (
                    func.attr == "repeat_interleave"
                    and "output_size" not in kw_traced
                    and self._tensor_repeats(node, on_tensor, args_traced,
                                             kw_traced))):
                self._sync(node, f"`{func.attr}` sizes its output by the data "
                                 f"(a host sync on CUDA)")
                return True
            if on_tensor:
                return True  # method on a tensor (reshape/float/...) -> tensor

        if isinstance(func, ast.Name):
            if func.id in _CAST_BUILTINS and any_traced:
                self._sync(node, f"`{func.id}()` of a tensor reads its value "
                                 f"on the host (a device sync on CUDA)")
                return False
            if func.id in _STATIC_BUILTINS:
                return False

        # descend into resolvable callees when they receive tensors
        resolved = self.o._resolve_callable(self.mod, func)
        if resolved is not None:
            cmod, cdef = resolved
            params = [a.arg for a in cdef.args.args]
            traced_params: Set[str] = set()
            for i, t in enumerate(args_traced):
                if t and i < len(params):
                    traced_params.add(params[i])
            for kname, t in kw_traced.items():
                if t and kname:
                    traced_params.add(kname)
            # a def handed no tensor returns host values
            return bool(traced_params) and self.o._analyze(cmod, cdef, traced_params)
        return any_traced

    @staticmethod
    def _tensor_repeats(node: ast.Call, method: bool, args_traced: List[bool],
                        kw_traced: Dict) -> bool:
        """Whether ``repeat_interleave``'s ``repeats`` is a tensor (an int
        repeats sizes the output statically)."""
        if "repeats" in kw_traced:
            return bool(kw_traced["repeats"])
        i = 0 if method else 1
        return i < len(args_traced) and args_traced[i]

    @staticmethod
    def _to_cpu(node: ast.Call) -> bool:
        """``.to("cpu")``, ``.to(device="cpu")`` or ``.to(torch.device("cpu"))``."""
        vals = list(node.args) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
        for v in vals:
            if isinstance(v, ast.Constant) and v.value == "cpu":
                return True
            if (isinstance(v, ast.Call) and _dotted(v.func) == "torch.device"
                    and v.args and isinstance(v.args[0], ast.Constant)
                    and v.args[0].value == "cpu"):
                return True
        return False


def src_modules(src_root: Path) -> Dict[str, Path]:
    """{dotted module name: path} of every file of a package tree."""
    mods: Dict[str, Path] = {}
    for path in sorted(src_root.rglob("*.py")):
        relparts = path.relative_to(src_root.parent).with_suffix("").parts
        if relparts[-1] == "__init__":
            relparts = relparts[:-1]
        if relparts:
            mods[".".join(relparts)] = path
    return mods


def run(files: Dict[str, Path], root: Path,
        roots: Sequence[Root] = ROOTS) -> List[Finding]:
    return HostSyncPass(files, root, roots).run()
