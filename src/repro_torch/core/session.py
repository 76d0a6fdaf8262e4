"""Unified Session API: ONE facade over the whole Deep RC execution stack
(paper Fig. 2/3 — data engineering, DL training, and serving composing
over pilots), plus the composable stage-graph DSL.  Mirror of
``repro.core.session``.

Before this layer, callers juggled ``PilotManager`` / ``RemoteAgent`` /
``Pipeline`` / ``PipelineScheduler`` / ``MultiPilotScheduler`` plus raw
``fn(comm, upstream, *args)`` callables, and placement was per *pipeline*
only — a DAG that wanted its data-engineering stage on the data pod and
its train stage on the DL pod had to be split into two pipelines with a
blocking handoff.  The Session owns the :class:`PilotManager`, lazily
materializes pods (shared / ``pods=N`` / kind-specialised descriptions)
with one :class:`RemoteAgent` per pilot, and resolves every stage's agent
individually through a :class:`PlacementPolicy` — so one graph's stages
span pilots with real dependency edges crossing agents, and a degraded
pod migrates only the affected *stage*'s placement.

DSL::

    from repro_torch.core import Session, stage

    @stage(kind="data_engineering")
    def preprocess(ctx):
        return make_table()

    @stage(kind="train", checkpoint="results/ckpt/run0")
    def train(ctx):                       # ctx.resume_step on retries
        return fit(ctx.upstream["preprocess"])

    @stage(kind="inference")
    def report(ctx):
        return evaluate(ctx.upstream["train"])

    with Session(pods=2) as session:      # 2 disjoint pods, lazy pilots
        out = session.run(preprocess >> train >> report)

``>>`` chains (every sink of the left feeds every source of the right),
``|`` runs in parallel, and ``.after(...)`` adds explicit edges; graphs
compile down to :class:`repro_torch.core.pipeline.Pipeline`, so the
event-driven readiness model (stages submitted the moment their deps
complete) is unchanged.  ``session.start`` is the non-blocking variant,
``session.serve`` runs a service stage and returns its control handle,
and ``close()`` / context-manager exit recycles every agent AND pilot on
every exit path.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from repro_torch.core.agent import RemoteAgent
from repro_torch.core.communicator import device_id, device_type
from repro_torch.core.pilot import Pilot, PilotDescription, PilotManager
from repro_torch.core.pipeline import Pipeline, Stage, aggregate_metrics
from repro_torch.core.task import ServiceControl, Task
from repro_torch.core.transport import check_spec, make_transport

__all__ = [
    "Session", "ServiceHandle", "StageContext", "StageSpec", "StageGraph",
    "stage", "PlacementPolicy", "KindAwarePlacement",
]


# ---------------------------------------------------------------------------
# Stage DSL
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageContext:
    """What a DSL stage body receives — replaces the positional
    ``fn(comm, upstream, *args, **kw)`` contract of raw ``Stage`` fns.

    * ``comm`` — the communicator carved for this stage (mesh slice);
    * ``upstream`` — ``{dep stage name: its result}``;
    * ``resume_step`` — last completed checkpoint step, set by the agent
      on retried attempts of a ``checkpoint=...`` stage (else None);
    * ``control`` / ``resume_state`` — the :class:`ServiceControl` handle
      and checkpointed state of a ``service=True`` stage (else None).
    """

    comm: Any
    upstream: Mapping[str, Any]
    resume_step: Optional[int] = None
    control: Optional[ServiceControl] = None
    resume_state: Any = None

    def dep(self, name: Optional[str] = None) -> Any:
        """Result of the named dependency (or the single dependency)."""
        if name is None:
            if len(self.upstream) != 1:
                raise KeyError(
                    f"ctx.dep() needs a name with {len(self.upstream)} deps")
            return next(iter(self.upstream.values()))
        return self.upstream[name]


@dataclasses.dataclass(frozen=True, eq=False)
class StageSpec:
    """A typed, composable stage description produced by :func:`stage`.

    Immutable — every modifier (``after``/``named``/``options``/``bind``)
    returns a clone, so one decorated function can appear in many graphs
    with different wiring.  Composition operators lift the spec into a
    :class:`StageGraph`:  ``a >> b`` (b depends on a), ``a | b``
    (parallel).  Calling the spec invokes the raw body (handy in unit
    tests): ``spec(ctx)``.
    """

    fn: Callable[..., Any]
    name: str
    kind: str = "generic"
    num_devices: int = 1
    mesh_axes: Tuple[str, ...] = ("data",)
    mesh_shape: Optional[Tuple[int, ...]] = None
    deps: Tuple[str, ...] = ()
    priority: int = 0
    max_retries: int = 2
    checkpoint: Optional[str] = None
    service: bool = False
    bound_args: Tuple = ()
    bound_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- modifiers (all return clones) --------------------------------------

    def _clone(self, **over) -> "StageSpec":
        return dataclasses.replace(self, **over)

    def after(self, *deps: Union[str, "StageSpec"]) -> "StageSpec":
        """Add explicit dependency edges (by spec or by stage name)."""
        names = tuple(d.name if isinstance(d, StageSpec) else d for d in deps)
        merged = self.deps + tuple(n for n in names if n not in self.deps)
        return self._clone(deps=merged)

    def named(self, name: str) -> "StageSpec":
        """Rename — required to use one decorated fn twice in a graph."""
        return self._clone(name=name)

    def options(self, **over) -> "StageSpec":
        """Override any spec field (kind, num_devices, checkpoint, ...)."""
        return self._clone(**over)

    def bind(self, *args, **kwargs) -> "StageSpec":
        """Partially apply extra arguments: the body runs as
        ``fn(ctx, *args, **kwargs)``."""
        return self._clone(bound_args=self.bound_args + args,
                           bound_kwargs={**self.bound_kwargs, **kwargs})

    # -- composition ---------------------------------------------------------

    def __rshift__(self, other) -> "StageGraph":
        return StageGraph([self]) >> other

    def __rrshift__(self, other) -> "StageGraph":
        return StageGraph._lift(other) >> self

    def __or__(self, other) -> "StageGraph":
        return StageGraph([self]) | other

    def __ror__(self, other) -> "StageGraph":
        return StageGraph._lift(other) | self

    # -- pickling ------------------------------------------------------------
    # ``@stage`` rebinds the module attribute from the raw fn to this
    # spec, so the fn can no longer pickle by reference (``module.name``
    # resolves to the spec, not the function).  For the subprocess
    # transport the fn travels as a _SpecFnRef instead and is recovered
    # *through* the module-level spec on the worker side.

    def __getstate__(self):
        state = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        fn = state["fn"]
        mod = getattr(fn, "__module__", None)
        qn = getattr(fn, "__qualname__", None)
        if mod == "__main__":
            # a ``python -m pkg.mod`` entry module: the worker's __main__
            # is the worker daemon, so reference the importable name
            from repro_torch.core.exec.protocol import main_module_name
            mod = main_module_name() or mod
        if mod is not None and qn is not None and "<locals>" not in qn:
            try:
                owner = _resolve_qualname(mod, qn)
            except (ImportError, AttributeError):
                owner = None
            # identity for same-module resolution; qualname match for the
            # __main__ remap (the re-imported module re-decorates, so its
            # spec wraps an equal-but-distinct function object)
            if isinstance(owner, StageSpec) and (
                    owner.fn is fn
                    or getattr(owner.fn, "__qualname__", None) == qn):
                state["fn"] = _SpecFnRef(mod, qn)
        return state

    def __setstate__(self, state):
        fn = state.get("fn")
        if isinstance(fn, _SpecFnRef):
            state["fn"] = fn.resolve()
        for k, v in state.items():
            object.__setattr__(self, k, v)

    # -- execution -----------------------------------------------------------

    def __call__(self, ctx: StageContext, *args, **kwargs) -> Any:
        return self.fn(ctx, *self.bound_args, *args,
                       **{**self.bound_kwargs, **kwargs})

    def to_stage(self) -> Stage:
        """Compile to the runtime :class:`Stage` — the adapter builds a
        :class:`StageContext` from the raw ``(comm, upstream, **kw)``
        contract, so the agent-side plumbing (checkpoint resume, service
        control) is untouched."""
        runner = _StageRunner(self)
        return Stage(
            name=self.name, fn=runner, kind=self.kind,
            num_devices=self.num_devices, mesh_axes=self.mesh_axes,
            mesh_shape=self.mesh_shape, deps=self.deps,
            priority=self.priority, max_retries=self.max_retries,
            checkpoint_dir=self.checkpoint, service=self.service)


def _resolve_qualname(module: str, qualname: str) -> Any:
    import importlib
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class _SpecFnRef:
    """Pickle stand-in for a ``@stage``-decorated function: resolves the
    module attribute (the StageSpec) and returns its raw fn."""

    __slots__ = ("module", "qualname")

    def __init__(self, module: str, qualname: str):
        self.module = module
        self.qualname = qualname

    def resolve(self) -> Callable:
        obj = _resolve_qualname(self.module, self.qualname)
        return obj.fn if isinstance(obj, StageSpec) else obj


class _StageRunner:
    """Picklable adapter from the raw ``(comm, upstream, **kw)`` stage
    contract to :class:`StageContext`.  A module-level class instead of a
    closure so DSL stages cross the subprocess transport's pickle
    boundary whenever the decorated fn and its bound args do."""

    __slots__ = ("spec",)

    def __init__(self, spec: StageSpec):
        self.spec = spec

    @property
    def __name__(self) -> str:
        return f"stage:{self.spec.name}"


    def __call__(self, comm, upstream, **kw):
        ctx = StageContext(
            comm=comm, upstream=upstream,
            resume_step=kw.pop("resume_step", None),
            control=kw.pop("control", None),
            resume_state=kw.pop("resume_state", None))
        return self.spec.fn(ctx, *self.spec.bound_args,
                            **self.spec.bound_kwargs)


def stage(fn: Optional[Callable] = None, *, name: Optional[str] = None,
          kind: str = "generic", num_devices: int = 1,
          mesh_axes: Tuple[str, ...] = ("data",),
          mesh_shape: Optional[Tuple[int, ...]] = None, priority: int = 0,
          max_retries: int = 2, checkpoint: Optional[str] = None,
          service: bool = False):
    """Decorator producing a :class:`StageSpec`.

    ``@stage`` bare or ``@stage(kind="train", num_devices=4,
    checkpoint=dir)``; the decorated function receives a
    :class:`StageContext`.  ``checkpoint`` opts the stage into the
    agent's checkpoint-aware retry (``ctx.resume_step``); ``service=True``
    marks a long-running stage driven through ``ctx.control``.
    """
    def wrap(f: Callable) -> StageSpec:
        return StageSpec(
            fn=f, name=name or f.__name__, kind=kind,
            num_devices=num_devices, mesh_axes=tuple(mesh_axes),
            mesh_shape=mesh_shape, priority=priority,
            max_retries=max_retries, checkpoint=checkpoint, service=service)

    return wrap(fn) if fn is not None else wrap


class StageGraph:
    """An immutable DAG of :class:`StageSpec`\\ s built by composition.

    * ``a >> b`` — every *sink* of ``a`` becomes a dependency of every
      *source* of ``b`` (sinks/sources derived from the dep structure;
      service stages are excluded from sinks — they never complete);
    * ``a | b`` — disjoint union (parallel);
    * ``StageGraph([s1, s2.after(s1), ...])`` — explicit edges.

    ``compile(name)`` lowers to a runtime :class:`Pipeline`.
    """

    def __init__(self, specs: Iterable[Union[StageSpec, "StageGraph"]] = ()):
        self._specs: Dict[str, StageSpec] = {}
        for item in specs:
            for s in ([item] if isinstance(item, StageSpec) else list(item)):
                if s.name in self._specs:
                    raise ValueError(
                        f"duplicate stage name {s.name!r} in graph "
                        "(use .named() to reuse a decorated fn)")
                self._specs[s.name] = s

    # -- structure -----------------------------------------------------------

    def __iter__(self):
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def sources(self) -> Tuple[str, ...]:
        """Stages with no in-graph dependencies."""
        return tuple(n for n, s in self._specs.items()
                     if not (set(s.deps) & set(self._specs)))

    def sinks(self) -> Tuple[str, ...]:
        """Non-service stages nothing else depends on (the join points a
        chained graph hangs its edges off)."""
        depended = {d for s in self._specs.values() for d in s.deps}
        return tuple(n for n, s in self._specs.items()
                     if n not in depended and not s.service)

    @classmethod
    def _lift(cls, x) -> "StageGraph":
        if isinstance(x, StageGraph):
            return x
        if isinstance(x, StageSpec):
            return cls([x])
        if isinstance(x, (list, tuple)):
            return cls(x)
        raise TypeError(f"cannot compose {type(x).__name__} into a StageGraph")

    # -- composition ---------------------------------------------------------

    def __rshift__(self, other) -> "StageGraph":
        other = StageGraph._lift(other)
        joins = self.sinks()
        if not joins and len(self):
            raise ValueError(
                "left side of >> has no completing (non-service) sink "
                "stage to hang the dependency edge on")
        out = StageGraph()
        out._specs = dict(self._specs)
        for name, s in other._specs.items():
            if name in out._specs:
                raise ValueError(f"duplicate stage name {name!r} across >>")
            if name in other.sources():
                s = s.after(*joins)
            out._specs[name] = s
        return out

    def __or__(self, other) -> "StageGraph":
        other = StageGraph._lift(other)
        return StageGraph([self, other])

    def __ror__(self, other) -> "StageGraph":
        return StageGraph._lift(other) | self

    # -- lowering ------------------------------------------------------------

    def compile(self, name: str, *, quota: Optional[int] = None,
                placement: Optional[Callable[[Stage],
                                             Optional[RemoteAgent]]] = None,
                ) -> Pipeline:
        return Pipeline(name, [s.to_stage() for s in self._specs.values()],
                        quota=quota, placement=placement)


# ---------------------------------------------------------------------------
# Placement policy
# ---------------------------------------------------------------------------


class PlacementPolicy:
    """Resolves which pilot hosts a single stage.

    Called once per stage the moment the stage becomes ready (deps done),
    NOT once per pipeline — this is what lets one DAG span pods and what
    makes migration per-stage: a stage re-resolves at submit time, so a
    pod that degraded since planning is simply no longer chosen.
    """

    def place_stage(self, stg: Stage, *, manager: PilotManager,
                    pilots: Sequence[Pilot],
                    load: Optional[Dict[str, int]] = None) -> Optional[Pilot]:
        raise NotImplementedError


class KindAwarePlacement(PlacementPolicy):
    """Default policy: most effective free capacity among pilots that
    admit the stage's kind and still have ``num_devices`` alive devices
    (reuses :meth:`PilotManager.place`; ``load`` is the session's
    promised-but-not-yet-leased overlay so placement bursts spread)."""

    def place_stage(self, stg: Stage, *, manager: PilotManager,
                    pilots: Sequence[Pilot],
                    load: Optional[Dict[str, int]] = None) -> Optional[Pilot]:
        return manager.place(num_devices=stg.num_devices, kinds={stg.kind},
                             pilots=pilots, load=load)


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------


class ServiceHandle:
    """Returned by :meth:`Session.serve` — the caller-side face of one
    long-running service stage."""

    def __init__(self, pipeline: Pipeline, stage_name: str):
        self.pipeline = pipeline
        self.stage_name = stage_name

    @property
    def control(self) -> ServiceControl:
        return self.pipeline.control(self.stage_name)

    @property
    def task(self) -> Optional[Task]:
        return self.pipeline.tasks.get(self.stage_name)

    @property
    def result(self) -> Any:
        return self.pipeline.results.get(self.stage_name)

    def submit_request(self, request: Any) -> Any:
        return self.control.submit_request(request)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Drain (default) or hard-stop the service and wait for its task
        to finalize; False on timeout."""
        return self.pipeline.stop_services(drain=drain, timeout=timeout)


GraphLike = Union[StageGraph, StageSpec, Pipeline]


class Session:
    """One object that owns pilots, agents, and per-stage placement.

    * ``Session()`` — one shared pod over every device (lazy);
    * ``Session(pods=N)`` — N disjoint even pods;
    * ``Session(pods=[PilotDescription(...), ...])`` — explicit pods,
      e.g. kind-specialised (a ``task_kinds=("data_engineering",)`` pod
      beside a ``("train", "inference")`` pod);
    * ``Session(manager=pm)`` — adopt an existing manager; pilots it
      already holds are reused (and NOT canceled by ``close``).

    Pilots and agents materialize lazily on the first ``run`` / ``start``
    / ``serve``.  Every started pipeline resolves each stage's agent
    through ``placement`` (default :class:`KindAwarePlacement`), so a
    preprocess -> train DAG lands its stages on different pods with the
    dependency edge crossing agents; results flow through the pipeline's
    completion callbacks exactly as before.  ``close()`` (also run by the
    context manager, on every exit path) stops services, closes agents,
    and cancels every session-owned pilot so devices are recycled.
    """

    _uid = itertools.count()

    def __init__(self, *, manager: Optional[PilotManager] = None,
                 devices: Optional[Sequence] = None,
                 pods: Union[None, int, Sequence[PilotDescription]] = None,
                 placement: Optional[PlacementPolicy] = None,
                 max_workers_per_pilot: Optional[int] = None,
                 transport=None,
                 transport_options: Optional[Dict] = None):
        if manager is not None and devices is not None:
            raise ValueError("pass manager= or devices=, not both")
        self.manager = manager if manager is not None \
            else PilotManager(devices=devices)
        self.placement = placement or KindAwarePlacement()
        self._pods_spec = pods
        self._max_workers = max_workers_per_pilot
        # transport may be a Transport instance (shared, caller-owned) or
        # a spec string ("in-process" / "subprocess" / "jax-distributed")
        # resolved per pilot; PilotDescription(transport=...) overrides it
        # per pod.  transport_options are kwargs for spec-built transports
        # (e.g. worker_devices= for subprocess pools).
        self._transport = transport
        self._transport_options = dict(transport_options or {})
        self._owned_transports: List = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._pilots: List[Pilot] = []  # guarded-by: _lock
        self._owned_pilots: List[Pilot] = []  # guarded-by: _lock
        self._agents: Dict[str, RemoteAgent] = {}  # guarded-by: _lock  (pilot uid -> agent)
        # promised-not-yet-leased devices
        self._assigned: Dict[str, int] = {}  # guarded-by: _lock
        self._stage_pilot: Dict[Tuple[str, str], str] = {}  # guarded-by: _lock
        self._pipelines: List[Pipeline] = []  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # appended only by the single thread that wins the _closed
        # test-and-set in close(), so it needs no lock of its own
        self.close_errors: List[str] = []

    # -- lifecycle -----------------------------------------------------------

    @property
    def pilots(self) -> List[Pilot]:
        with self._lock:
            return list(self._pilots)

    def agent_for(self, pilot: Pilot) -> RemoteAgent:
        with self._lock:
            return self._agents[pilot.uid]

    def _ensure(self) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("Session is closed")
            if self._agents:
                return
            adopted = list(self.manager.pilots)
            if adopted and self._pods_spec is None:
                pilots, owned = adopted, []
                specs = [self._spec_for(None)] * len(pilots)
            else:
                descs = self._pod_descriptions()
                # checked before any pilot exists: an unknown spec leaves
                # no pilot behind
                specs = [self._spec_for(d) for d in descs]
                pilots = self.manager.submit_pilots(descs)
                owned = list(pilots)
            agents: Dict[str, RemoteAgent] = {}
            built: List = []
            try:
                for p, spec in zip(pilots, specs):
                    mw = self._max_workers if self._max_workers is not None \
                        else max(2, p.size)
                    tr = self._resolve_transport(spec, mw, p)
                    if isinstance(spec, str) and tr is not None:
                        built.append(tr)
                    agents[p.uid] = RemoteAgent(p, max_workers=mw, transport=tr)
            except BaseException:  # noqa: BLE001 — cleanup, then re-raise
                # a transport that failed to start leaves nothing behind
                for a in agents.values():
                    a.close()
                for tr in built:
                    tr.shutdown(wait=False)
                for p in owned:
                    self.manager.cancel_pilot(p)
                raise
            self._pilots = list(pilots)
            self._owned_pilots = owned
            self._owned_transports = built
            self._agents = agents
            self._assigned = {p.uid: 0 for p in pilots}

    def _spec_for(self, desc: Optional[PilotDescription]):
        """A pod's transport spec: its description's, else the session's;
        an unknown spec string raises ValueError."""
        spec = desc.transport if desc is not None and \
            desc.transport is not None else self._transport
        check_spec(spec)
        return spec

    def _resolve_transport(self, spec, max_workers: int, pilot: Pilot):
        """One pilot's transport: a Transport instance passes through
        (caller-owned); None and ``"in-process"`` keep the agent's own
        thread pool (None); ``"subprocess"`` / ``"jax-distributed"``
        build a worker pool the session owns and shuts down in close,
        its workers on the pilot's device type."""
        if not isinstance(spec, str):
            return spec
        opts = dict(self._transport_options)
        if spec != "in-process":
            # each worker carries a torch runtime (and a CUDA context):
            # default the pool small instead of one process per device,
            # but one worker a card, so a stage over every card of the
            # pilot runs as a gang
            alive = pilot.alive_devices()
            cards = {device_id(d) for d in alive if device_type(d) == "cuda"}
            opts.setdefault("max_workers", max(min(max_workers, 2), len(cards)))
            opts.setdefault("device", device_type(alive[0]))
        return make_transport(spec, **opts)

    def _pod_descriptions(self) -> List[PilotDescription]:
        pods = self._pods_spec
        if pods is None:
            return [PilotDescription(name="pod")]
        if isinstance(pods, int):
            total = self.manager.free_devices()
            n = max(1, min(pods, total))
            per, extra = divmod(total, n)
            return [PilotDescription(num_devices=per + (1 if i < extra else 0),
                                     name=f"pod{i}") for i in range(n)]
        return list(pods)

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop services, close every agent, and cancel every owned pilot
        (devices recycled into the manager's free pool).  Idempotent;
        failures are collected in ``close_errors`` instead of masking the
        exception that triggered the close."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pipelines = list(self._pipelines)
            agents = list(self._agents.values())
            owned = list(self._owned_pilots)
            owned_transports = list(self._owned_transports)
        for p in pipelines:
            for ctl in p.service_controls.values():
                ctl.stop()
        for a in agents:
            try:
                a.close(timeout)
            except Exception as e:  # noqa: BLE001 — keep closing the rest
                self.close_errors.append(f"agent {a.pilot.uid}: {e}")
        for tr in owned_transports:
            try:
                tr.shutdown(wait=timeout is None or timeout > 0)
            except Exception as e:  # noqa: BLE001 — keep closing the rest
                self.close_errors.append(f"transport {tr.name}: {e}")
        for pilot in owned:
            try:
                self.manager.cancel_pilot(pilot)
            except (RuntimeError, ValueError) as e:
                self.close_errors.append(f"pilot {pilot.uid}: {e}")

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- graph lowering + placement wiring ------------------------------------

    def _as_pipeline(self, graph: GraphLike, name: Optional[str],
                     quota: Optional[int]) -> Pipeline:
        if isinstance(graph, Pipeline):
            if name is not None and name != graph.name:
                raise ValueError(
                    f"pipeline already named {graph.name!r}; drop name=")
            if quota is not None:
                graph.quota = quota
            return graph
        if isinstance(graph, StageSpec):
            graph = StageGraph([graph])
        if not isinstance(graph, StageGraph):
            raise TypeError(
                f"expected StageGraph/StageSpec/Pipeline, got "
                f"{type(graph).__name__}")
        return graph.compile(name or f"session-pipe{next(self._uid)}",
                             quota=quota)

    def _prepare(self, pipe: Pipeline) -> bool:
        """Wire per-stage placement into a pipeline.  Returns False (after
        aborting the pipeline) when some stage could not run on ANY pod —
        kind admitted nowhere or wider than every pool."""
        with self._lock:
            pilots = list(self._pilots)
        for s in pipe.stages:
            if not any(p.admits({s.kind}) and p.alive_count() >= s.num_devices
                       for p in pilots):
                pipe.abort(
                    f"unplaceable: no pilot admits kind={s.kind!r} with >= "
                    f"{s.num_devices} alive devices (stage {s.name})")
                return False
        # the plan is advisory: resolution re-runs at submit time, and a
        # divergence caused by a degraded pod is recorded as a per-stage
        # migration (only the affected stage moves — in-flight siblings
        # and already-completed stages are untouched)
        plan: Dict[str, str] = {}
        by_uid = {p.uid: p for p in pilots}
        for s in pipe.stages:
            planned = self.placement.place_stage(
                s, manager=self.manager, pilots=pilots)
            if planned is not None:
                plan[s.name] = planned.uid
        # quota semantics: the device cap is enforced per agent, so a
        # quota'd pipeline whose stages spread over K pods could hold
        # quota*K devices.  Keep quota'd pipelines STICKY to their first
        # pod whenever it can host the stage — the cap then stays
        # pipeline-wide; only a kind/degradation mismatch forces a second
        # pod (where the cap applies per pod, documented on Pipeline).
        home: Dict[str, str] = {}

        def resolve(stg: Stage) -> Optional[RemoteAgent]:
            with self._lock:
                if self._closed:
                    return None
                load = dict(self._assigned)
            pilot = None
            if pipe.quota is not None and home.get("uid") is not None:
                hp = by_uid.get(home["uid"])
                if (hp is not None and hp.admits({stg.kind})
                        and hp.alive_count() >= stg.num_devices):
                    pilot = hp
            if pilot is None:
                pilot = self.placement.place_stage(
                    stg, manager=self.manager, pilots=pilots, load=load)
            if pilot is None:
                return None
            if pipe.quota is not None:
                home.setdefault("uid", pilot.uid)
            planned_uid = plan.get(stg.name)
            if planned_uid is not None and planned_uid != pilot.uid:
                planned_pilot = by_uid.get(planned_uid)
                if (planned_pilot is None
                        or planned_pilot.alive_count() < stg.num_devices
                        or not planned_pilot.admits({stg.kind})):
                    pipe.migrations.append({
                        "t": time.time(), "stage": stg.name,
                        "from": planned_uid, "to": pilot.uid,
                        "reason": f"pilot {planned_uid} degraded below "
                                  f"{stg.num_devices} alive devices",
                    })
            with self._lock:
                self._assigned[pilot.uid] = (
                    self._assigned.get(pilot.uid, 0) + stg.num_devices)
                self._stage_pilot[(pipe.name, stg.name)] = pilot.uid
                return self._agents[pilot.uid]

        def release(p: Pipeline, stg: Stage, task: Task) -> None:
            with self._lock:
                uid = self._stage_pilot.pop((p.name, stg.name), None)
                if uid is not None:
                    self._assigned[uid] = (
                        self._assigned.get(uid, 0) - stg.num_devices)

        pipe.placement = resolve
        pipe.add_stage_observer(release)
        return True

    # -- execution -----------------------------------------------------------

    def start(self, graph: GraphLike, *, name: Optional[str] = None,
              quota: Optional[int] = None,
              on_finish: Optional[Callable[[Pipeline], None]] = None,
              ) -> Pipeline:
        """Non-blocking: compile, place, and start the graph; returns the
        live :class:`Pipeline` handle (``wait()`` / ``results`` /
        ``tasks`` / ``stage_placements()``)."""
        self._ensure()
        pipe = self._as_pipeline(graph, name, quota)
        with self._lock:
            self._pipelines.append(pipe)
        if self._prepare(pipe):
            pipe.start(None, on_finish=on_finish)
        elif on_finish is not None:
            on_finish(pipe)
        return pipe

    def run(self, graph: GraphLike, *, name: Optional[str] = None,
            quota: Optional[int] = None,
            timeout: Optional[float] = None) -> Dict[str, Any]:
        """Blocking: run the graph to completion; raises on stage failure;
        returns ``{stage name: result}``."""
        pipe = self.start(graph, name=name, quota=quota)
        if not pipe.wait(timeout):
            raise TimeoutError(
                f"pipeline {pipe.name} did not finish within {timeout}s")
        if pipe.error is not None:
            raise RuntimeError(f"pipeline {pipe.name} {pipe.error}")
        return pipe.results

    def run_all(self, graphs: Sequence[GraphLike], *,
                quota: Optional[int] = None,
                timeout: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Run N graphs/pipelines concurrently (the Table-4 batch mode).

        Per-pipeline fault isolation: failures land in that pipeline's
        result dict (``_error`` / ``_failed_stage``), never raise.
        ``_meta`` carries the Table-2/4 decomposition plus the per-STAGE
        placement map, migrations, per-agent group peaks, and quota
        violations."""
        t0 = time.time()
        pipes = [self.start(g, quota=quota) for g in graphs]
        deadline = None if timeout is None else t0 + timeout
        for p in pipes:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.time())
            if not p.wait(remaining):
                raise TimeoutError(
                    f"pipeline {p.name} did not finish within {timeout}s")
        wall = time.time() - t0
        out: Dict[str, Dict[str, Any]] = {p.name: p.result_dict()
                                          for p in pipes}
        meta = aggregate_metrics(pipes, wall)
        meta["pilots"] = [p.uid for p in self.pilots]
        meta["placement"] = {p.name: p.stage_placements() for p in pipes}
        meta["migrations"] = [dict(m, pipeline=p.name)
                              for p in pipes for m in p.migrations]
        with self._lock:
            agents = dict(self._agents)
        meta["group_peaks"] = {uid: a.group_peaks()
                               for uid, a in agents.items()}
        meta["quota_violations"] = {
            uid: v for uid, a in agents.items() if (v := a.quota_violations())}
        out["_meta"] = meta
        return out

    def serve(self, graph: GraphLike, *, name: Optional[str] = None,
              quota: Optional[int] = None) -> ServiceHandle:
        """Start a graph containing exactly one ``service=True`` stage and
        return its :class:`ServiceHandle` (submit_request / stop).  The
        service holds its lease until stopped/drained; ``close()`` stops
        it on every exit path."""
        pipe = self._as_pipeline(graph, name, quota)
        services = [s.name for s in pipe.stages if s.service]
        if len(services) != 1:
            # validated BEFORE start: an invalid graph must not execute
            # (or leave an unreachable service holding its lease)
            raise ValueError(
                f"serve() expects exactly one service stage, got {services} "
                f"in pipeline {pipe.name}")
        self.start(pipe)
        return ServiceHandle(pipe, services[0])
