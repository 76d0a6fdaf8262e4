"""Deep RC pipelines: preprocess -> train/infer -> postprocess DAGs over
the pilot runtime (paper Fig. 2/3), plus the multi-pipeline batching mode
of Table 4 — N pipelines under one pilot (``PipelineScheduler``) or
spread across several disjoint pilots (``MultiPilotScheduler``).  Mirror
of ``repro.core.pipeline``.

The user-facing entry point is :class:`repro_torch.core.session.Session` with
the ``@stage`` graph DSL; it drives pipelines through the per-stage
``placement`` hook below, so one DAG's stages can resolve to *different*
agents (cross-pilot dependency edges).  ``run_pipelines`` /
``run_pipelines_multi`` remain as deprecated shims.

Stage readiness is **event-driven**: each stage is submitted the moment
its dependencies complete (a task-completion callback fires the next
wave), so independent stages of *different* pipelines overlap freely on
the shared device pool — the property Table 4 measures.  There is no
lock-step "submit a batch, wait for the whole batch" barrier.

``PipelineScheduler`` runs N pipelines concurrently under one agent with
per-pipeline fault isolation: a pipeline whose stage exhausts its retries
records the failure in its own result dict (``_error`` / ``_failed_stage``)
without poisoning sibling pipelines.

``MultiPilotScheduler`` is the layer above (the execution stack reads
``pipeline -> PilotManager -> {pilots} -> transport``): each pipeline is
*placed* on one of several disjoint pilots via ``PilotManager.place``
(most effective free capacity among pilots admitting the pipeline's task
kinds), runs there under that pilot's agent, and **migrates** its
remaining stages to a healthier pilot if its pilot degrades below the
pipeline's mesh requirement.  Per-pipeline device quotas (``Pipeline(...,
quota=n)``) are enforced by the agents' dispatchers and audited through
their lease traces.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.agent import RemoteAgent
from repro_torch.core.pilot import Pilot, PilotDescription, PilotManager
from repro_torch.core.task import ServiceControl, Task, TaskDescription, TaskState


@dataclasses.dataclass
class Stage:
    name: str
    fn: Callable  # fn(comm, upstream_results, *args[, resume_step=...])
    args: tuple = ()
    kind: str = "generic"
    num_devices: int = 1
    mesh_axes: tuple = ("data",)
    mesh_shape: Optional[tuple] = None
    deps: Sequence[str] = ()
    priority: int = 0
    max_retries: int = 2
    # checkpoint-aware retry: when set, fn must accept resume_step=None
    # and is handed the last completed step on every retried attempt
    checkpoint_dir: Optional[str] = None
    # service stage: a long-running task (fn must accept control= and
    # resume_state= kwargs) that is EXCLUDED from the pipeline's
    # stage-completion barrier — the pipeline finishes when its ordinary
    # stages do, while the service keeps running until its control handle
    # is told to drain/stop (see Pipeline.control / stop_services).  A
    # service stage may not be a dependency of another stage.
    service: bool = False


class _BoundStage:
    """Binding of a stage fn to its upstream results and static args (a
    module-level class, as in the JAX package, where it crosses the
    subprocess transport's pickle boundary).  ``**kw`` forwards the agent's
    ``resume_step`` on checkpointed stages (and ``control`` /
    ``resume_state`` on service stages); plain stages never receive
    extra kwargs."""

    __slots__ = ("fn", "upstream", "args")

    def __init__(self, fn, upstream, args):
        self.fn = fn
        self.upstream = upstream
        self.args = tuple(args)

    @property
    def __name__(self) -> str:
        return getattr(self.fn, "__name__", "stage")


    def __call__(self, comm, **kw):
        return self.fn(comm, self.upstream, *self.args, **kw)


class Pipeline:
    """A small DAG of stages executed on one RemoteAgent.

    Two entry points:

    * ``run(agent)`` — blocking; raises on stage failure (single-pipeline
      ergonomics, unchanged from the batch-mode predecessor);
    * ``start(agent, on_finish)`` — non-blocking; submits ready stages and
      returns.  Completion callbacks drive the DAG forward; failures are
      recorded on the pipeline (``error`` / ``failed_stage``), never raised
      into the caller.  Used by :class:`PipelineScheduler`.

    ``quota`` caps how many devices this pipeline's stages may hold at
    once on an agent (enforced by each agent's dispatcher; see
    ``RemoteAgent.set_quota``).  Enforcement is per agent: under
    per-stage placement the Session keeps quota'd pipelines sticky to
    one pod so the cap stays pipeline-wide; if kind constraints or
    degradation force stages onto K pods, the cap applies per pod
    (global bound quota*K).  ``rebind(agent)`` re-points not-yet-
    submitted stages at a different agent — the migration primitive used
    by :class:`MultiPilotScheduler`.

    Stages with ``service=True`` are long-running (e.g. a continuous-
    batching inference engine): they are excluded from the completion
    barrier — the pipeline finishes when its ordinary stages do — and are
    driven through their :class:`ServiceControl` (``control(name)`` /
    ``stop_services``).  The agent may preempt them for higher-priority
    work; they resume with their checkpointed state.
    """

    def __init__(self, name: str, stages: Sequence[Stage],
                 quota: Optional[int] = None,
                 placement: Optional[Callable[[Stage],
                                              Optional[RemoteAgent]]] = None):
        self.name = name
        self.stages = list(stages)
        self.quota = quota
        self.results: Dict[str, Any] = {}  # guarded-by: _lock
        self.tasks: Dict[str, Task] = {}  # guarded-by: _lock
        self.error: Optional[str] = None  # guarded-by: _lock
        self.failed_stage: Optional[str] = None  # guarded-by: _lock
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.migrations: List[Dict[str, Any]] = []
        # per-stage placement: when set, each stage resolves its OWN agent
        # through this callable the moment it becomes ready (deps done), so
        # one DAG's stages can span several pilots with real dependency
        # edges crossing agents.  ``None`` from the resolver marks the
        # stage unplaceable and fails the pipeline.  ``stage_agents``
        # records where each submitted stage actually ran.
        self.placement = placement
        self.stage_agents: Dict[str, RemoteAgent] = {}  # guarded-by: _lock
        # one control handle per service stage, created eagerly so callers
        # can hold the handle before (and across) the stage's task attempts
        self.service_controls: Dict[str, ServiceControl] = {
            s.name: ServiceControl() for s in self.stages if s.service}
        self._lock = threading.Lock()
        self._submitted: set = set()  # guarded-by: _lock
        self._quota_agents: set = set()  # guarded-by: _lock (agent ids already given our quota)
        self._agent: Optional[RemoteAgent] = None  # guarded-by: _lock
        self._on_finish: Optional[Callable[["Pipeline"], None]] = None  # guarded-by: _lock
        self._stage_observers: List[Callable[["Pipeline", Stage, Task], None]] = []  # guarded-by: _lock
        self._finishing = False  # guarded-by: _lock (test-and-set, see _finish)
        self._finished_evt = threading.Event()

    # -- public ----------------------------------------------------------------

    @property
    def wall_s(self) -> Optional[float]:
        if self.started_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.started_at

    @property
    def mesh_requirement(self) -> int:
        """Widest single-stage device ask — the floor a pilot must keep
        alive for this pipeline to run un-degraded."""
        return max((s.num_devices for s in self.stages), default=1)

    def remaining_mesh_requirement(self) -> int:
        """Widest device ask among stages not yet submitted (0 = nothing
        left to place).  Migration keys off this, not ``mesh_requirement``:
        a completed wide stage must not force a pointless move."""
        with self._lock:
            return max((s.num_devices for s in self.stages
                        if s.name not in self._submitted), default=0)

    def stage_kinds(self) -> set:
        return {s.kind for s in self.stages}

    @property
    def finished(self) -> bool:
        return self._finished_evt.is_set()

    def add_stage_observer(
            self, cb: Callable[["Pipeline", Stage, Task], None]) -> None:
        """Register ``cb(pipeline, stage, task)`` to fire whenever a stage's
        task finalizes (success or failure) — the per-stage hook Session's
        placement load accounting and live monitors key off."""
        with self._lock:
            self._stage_observers.append(cb)

    def start(self, agent: Optional[RemoteAgent] = None,
              on_finish: Optional[Callable[["Pipeline"], None]] = None) -> None:
        """Submit all currently-ready stages and return immediately.

        ``agent`` may be None when a per-stage ``placement`` resolver is
        set — every stage then resolves its own agent individually."""
        self._validate_dag()
        with self._lock:
            # first bind only: a rebind() that raced in between placement
            # and start (pilot degraded immediately) must not be undone
            if self._agent is None:
                self._agent = agent
            effective = self._agent
            self._on_finish = on_finish
        if effective is None and self.placement is None:
            raise RuntimeError(
                f"pipeline {self.name}: start() needs an agent or a "
                "per-stage placement resolver")
        if self.quota is not None and effective is not None:
            effective.set_quota(self.name, self.quota)
        self.started_at = time.time()
        if not self.stages:
            self._finish()
            return
        self._submit_ready()
        with self._lock:
            finished = self._is_finished_locked()
        if finished:
            # all stages are services: the barrier is trivially satisfied
            # the moment they are submitted (they run until drained/stopped)
            self._finish()

    def rebind(self, agent: RemoteAgent, reason: str = "") -> None:
        """Migrate: stages not yet submitted will go to ``agent``.
        In-flight tasks finish on the old agent (their results are still
        delivered through per-task callbacks)."""
        with self._lock:
            old = self._agent
            self._agent = agent
            self.migrations.append({
                "t": time.time(), "reason": reason,
                "from": old.pilot.uid if old is not None else None,
                "to": agent.pilot.uid,
            })
        if self.quota is not None:
            agent.set_quota(self.name, self.quota)

    def abort(self, reason: str) -> None:
        """Mark the pipeline failed without running it (e.g. no pilot can
        satisfy its placement requirements)."""
        with self._lock:
            if self.error is None:  # first error wins, like _stage_done
                self.error = reason
        if self.started_at is None:
            self.started_at = time.time()
        self._finish()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._finished_evt.wait(timeout)

    def control(self, stage_name: str) -> ServiceControl:
        """Control handle of a service stage (submit_request/drain/stop)."""
        return self.service_controls[stage_name]

    def stop_services(self, drain: bool = True,
                      timeout: Optional[float] = None) -> bool:
        """Drain (default) or hard-stop every service stage and wait for
        their tasks to finalize.  Returns False on timeout.  Service
        results land in ``results[<stage>]`` like any other stage — they
        are just never part of the completion barrier."""
        for ctl in self.service_controls.values():
            (ctl.drain if drain else ctl.stop)()
        deadline = None if timeout is None else time.time() + timeout
        for name in self.service_controls:
            with self._lock:
                task = self.tasks.get(name)
            if task is None:
                continue  # never submitted (deps unmet / pipeline aborted)
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.time()))
            if not task.wait(remaining):
                return False
        return True

    def run(self, agent: Optional[RemoteAgent] = None) -> Dict[str, Any]:
        """Blocking single-pipeline execution; raises on stage failure."""
        self.start(agent)
        self.wait()  # noqa: TMO001 — blocking-run API; per-task deadlines bound the stages
        with self._lock:
            error = self.error
            results = self.results
        if error is not None:
            raise RuntimeError(f"pipeline {self.name} {error}")
        return results

    # -- internals -------------------------------------------------------------

    def _validate_dag(self) -> None:
        names = {s.name for s in self.stages}
        if len(names) != len(self.stages):  # results are keyed by name; a
            # duplicate would make completion counting hang, not overwrite
            raise RuntimeError(
                f"pipeline {self.name}: duplicate stage names")
        for s in self.stages:
            missing = [d for d in s.deps if d not in names]
            if missing:  # distinct from a cycle: the stage waits on a name
                # that will never complete because it does not exist
                raise RuntimeError(
                    f"pipeline {self.name}: stage {s.name} depends on "
                    f"unknown stage(s) {sorted(missing)}")
        service_names = {s.name for s in self.stages if s.service}
        for s in self.stages:
            bad = service_names & set(s.deps)
            if bad:  # a service never "completes" in the barrier sense, so
                # a dependent stage would wait forever
                raise RuntimeError(
                    f"pipeline {self.name}: stage {s.name} depends on "
                    f"service stage(s) {sorted(bad)}")
        done: set = set()
        remaining = list(self.stages)
        while remaining:
            ready = [s for s in remaining if all(d in done for d in s.deps)]
            if not ready:
                raise RuntimeError(f"pipeline {self.name}: dependency cycle")
            done.update(s.name for s in ready)
            remaining = [s for s in remaining if s not in ready]

    def _resolve_agent(self, stage: Stage) -> Optional[RemoteAgent]:
        """Per-stage agent resolution (called OUTSIDE the pipeline lock —
        a placement policy takes pilot/session locks of its own)."""
        if self.placement is not None:
            agent = self.placement(stage)
        else:
            with self._lock:
                agent = self._agent  # rebind() may race; read under lock
        if agent is not None and self.quota is not None:
            with self._lock:
                first_touch = id(agent) not in self._quota_agents
                self._quota_agents.add(id(agent))
            if first_touch:
                agent.set_quota(self.name, self.quota)
        return agent

    def _mark_unplaceable(self, stage: Stage) -> None:
        """A ready stage no pilot can host fails the pipeline; the stage is
        un-marked from _submitted so the error barrier count stays exact."""
        with self._lock:
            self._submitted.discard(stage.name)
            if self.error is None:
                self.error = (
                    f"stage {stage.name} unplaceable: no pilot admits "
                    f"kind={stage.kind!r} with >= {stage.num_devices} "
                    "alive devices")
                self.failed_stage = stage.name
            finished = self._is_finished_locked()
        if finished:
            self._finish()

    def _submit_ready(self) -> None:
        with self._lock:
            if self.error is not None:
                return
            ready = [
                s for s in self.stages
                if s.name not in self._submitted
                and all(d in self.results for d in s.deps)
            ]
            self._submitted.update(s.name for s in ready)
            upstreams = [{d: self.results[d] for d in s.deps} for s in ready]
        for s, upstream in zip(ready, upstreams):
            with self._lock:
                failing = self.error is not None
            if failing:  # an earlier stage in this wave was unplaceable:
                # withdraw the rest of the wave and re-check the barrier
                self._mark_unplaceable_noop(s)
                continue
            agent = self._resolve_agent(s)
            if agent is None:
                self._mark_unplaceable(s)
                continue

            with self._lock:
                self.stage_agents[s.name] = agent
            tasks = agent.submit_async(
                [TaskDescription(
                    name=f"{self.name}/{s.name}",
                    fn=_BoundStage(s.fn, upstream, s.args),
                    kind=s.kind, num_devices=s.num_devices,
                    mesh_axes=s.mesh_axes, mesh_shape=s.mesh_shape,
                    priority=s.priority, max_retries=s.max_retries,
                    group=self.name, checkpoint_dir=s.checkpoint_dir,
                    service=s.service,
                    control=self.service_controls.get(s.name),
                )],
                on_complete=lambda task, s=s: self._stage_done(s, task),
            )
            # recorded at SUBMIT time (not completion) so live readers —
            # metrics, migration decisions, stop_services — can see
            # running stages; _stage_done re-records the same object
            with self._lock:
                self.tasks.setdefault(s.name, tasks[0])

    def _mark_unplaceable_noop(self, stage: Stage) -> None:
        """Withdraw a wave-mate of an unplaceable stage without touching
        the (already set) error."""
        with self._lock:
            self._submitted.discard(stage.name)
            finished = self._is_finished_locked()
        if finished:
            self._finish()

    def stage_placements(self) -> Dict[str, str]:
        """Pilot uid each submitted stage resolved to (live view)."""
        with self._lock:
            return {name: a.pilot.uid for name, a in self.stage_agents.items()}

    def _stage_done(self, stage: Stage, task: Task) -> None:
        with self._lock:
            self.tasks[stage.name] = task
            observers = list(self._stage_observers)
            if task.state == TaskState.DONE:
                self.results[stage.name] = task.result
            elif not stage.service and self.error is None:
                self.error = f"stage {stage.name} failed: {task.error}"
                self.failed_stage = stage.name
            elif stage.service:
                # service failure/cancellation is isolated: recorded on
                # the task (and absent from results), never poisons the
                # pipeline's ordinary stages or flips a finished pipeline
                # back into error state
                pass
            finished = self._is_finished_locked()
            error = self.error
        for cb in observers:  # outside the lock: observers take their own
            try:              # locks (e.g. Session's placement accounting)
                cb(self, stage, task)
            except Exception:  # noqa: BLE001 — observers must not poison
                pass           # the DAG's progress
        if finished:
            self._finish()
        elif error is None:
            # a stale None here is benign: _submit_ready rechecks under
            # the lock before submitting anything
            self._submit_ready()

    def _barrier_stages(self) -> List[Stage]:
        """Stages that participate in the completion barrier (everything
        except long-running service stages)."""
        return [s for s in self.stages if not s.service]

    def _is_finished_locked(self) -> bool:
        barrier = self._barrier_stages()
        if sum(1 for s in barrier if s.name in self.results) == len(barrier):
            return True
        if self.error is not None:
            # finished once every in-flight barrier task has reported back
            names = {s.name for s in barrier}
            reported = len([n for n in self.tasks
                            if n in names and self.tasks[n].finalized])
            return reported == len(self._submitted & names)
        return False

    def _finish(self) -> None:
        with self._lock:
            # idempotent AND race-free: _finish can arrive concurrently
            # from start()'s all-service recheck (caller thread) and from
            # _stage_done (worker threads) — exactly one may fire
            # on_finish, or scheduler completion counting corrupts
            if self._finishing:
                return
            self._finishing = True
            error = self.error
            on_finish = self._on_finish
        if error is not None:
            # a failed pipeline must not leak its services: nobody is
            # coming back to drain them, and a running service pins its
            # device lease (cancel_pilot would refuse forever)
            for ctl in self.service_controls.values():
                ctl.stop()
        self.finished_at = time.time()
        self._finished_evt.set()
        if on_finish is not None:
            on_finish(self)  # outside the lock: arbitrary user callback

    def result_dict(self) -> Dict[str, Any]:
        """Per-pipeline results; failures recorded, not raised (Table-4
        fault-isolation contract)."""
        with self._lock:
            out = dict(self.results)
            if self.error is not None:
                out["_error"] = self.error
                out["_failed_stage"] = self.failed_stage
        return out


class PipelineScheduler:
    """Run N pipelines concurrently under one RemoteAgent (Table-4 mode).

    All pipelines are started at once; their stages interleave on the
    shared pilot according to device availability and priority.  One
    pipeline failing (stage retries exhausted) is isolated to its own
    result dict and never aborts its siblings.
    """

    def __init__(self, agent: RemoteAgent):
        self.agent = agent

    def run(self, pipelines: Sequence[Pipeline],
            timeout: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        t0 = time.time()
        for p in pipelines:
            p.start(self.agent)
        deadline = None if timeout is None else t0 + timeout
        for p in pipelines:
            remaining = None if deadline is None else max(0.0, deadline - time.time())
            if not p.wait(remaining):
                raise TimeoutError(
                    f"pipeline {p.name} did not finish within {timeout}s")
        wall = time.time() - t0
        out: Dict[str, Dict[str, Any]] = {
            p.name: p.result_dict() for p in pipelines}
        out["_meta"] = aggregate_metrics(pipelines, wall)
        return out


def aggregate_metrics(pipelines: Sequence[Pipeline], wall: float) -> Dict[str, Any]:
    """Table-2/Table-4 decomposition: per-pipeline wall + overheads and
    the aggregate overlap factor (sum of task busy time / batch wall).

    Safe on LIVE pipelines: tasks are recorded at submit time, so a stage
    still running shows up here — it is listed under the pipeline's
    ``running`` key and counted in the aggregate ``n_running`` instead of
    being invisible until completion."""
    per_pipeline: Dict[str, Any] = {}
    agg = {"queue_s": 0.0, "communicator_s": 0.0, "task_busy_s": 0.0,
           "n_tasks": 0, "n_failed": 0, "n_running": 0}
    for p in pipelines:
        with p._lock:  # snapshot: submit-time recording mutates concurrently
            tasks = dict(p.tasks)
        running = sorted(n for n, t in tasks.items() if not t.finalized)
        ov = {"queue_s": 0.0, "communicator_s": 0.0, "task_busy_s": 0.0}
        for t in tasks.values():
            ov["queue_s"] += t.overhead_s.get("queue", 0.0)
            ov["communicator_s"] += t.overhead_s.get("communicator", 0.0)
            ov["task_busy_s"] += t.duration_s or 0.0
            agg["n_tasks"] += 1
            # a still-running service task is neither done nor failed
            agg["n_failed"] += int(t.finalized and t.state != TaskState.DONE)
        agg["n_running"] += len(running)
        per_pipeline[p.name] = {
            "wall_s": p.wall_s, "error": p.error, "running": running, **ov}
        for k in ("queue_s", "communicator_s", "task_busy_s"):
            agg[k] += ov[k]
    return {
        "wall_s": wall,
        "per_pipeline": per_pipeline,
        "overlap_factor": (agg["task_busy_s"] / wall) if wall > 0 else 0.0,
        **agg,
    }


def run_pipelines(
    pipelines: Sequence[Pipeline],
    *,
    pilot: Optional[Pilot] = None,
    max_workers: int = 8,
    transport=None,
) -> Dict[str, Dict[str, Any]]:
    """DEPRECATED shim — use :class:`repro_torch.core.session.Session` (its
    ``run_all``) instead; kept so pre-Session callers and tests keep
    working unchanged.

    Table-4 mode: N pipelines share one pilot/agent (vs N bare-metal
    runs re-acquiring resources per pipeline).  Thin wrapper over
    :class:`PipelineScheduler`; stages of different pipelines genuinely
    overlap, and ``_meta`` carries the per-pipeline + aggregate wall /
    overhead decomposition."""
    warnings.warn(
        "run_pipelines is deprecated; use repro_torch.core.Session "
        "(session.run_all) instead", DeprecationWarning, stacklevel=2)
    own = False
    if pilot is None:
        pilot = PilotManager().submit_pilot(PilotDescription())
        own = True
    agent = RemoteAgent(pilot, max_workers=max_workers, transport=transport)
    try:
        out = PipelineScheduler(agent).run(pipelines)
    finally:
        agent.close()
    out["_meta"].update({"pilot": pilot.uid, "owned": own})
    return out


class MultiPilotScheduler:
    """Place N pipelines across several disjoint pilots (per-pod pools).

    The full Table-4 stack: ``pipeline -> PilotManager.place -> {pilots}
    -> transport``.  One RemoteAgent runs per pilot; each pipeline is
    placed once up front (by effective free capacity among pilots that
    admit its task kinds and satisfy its mesh requirement) and re-placed
    — **migrated** — if its pilot's alive-device count degrades below the
    pipeline's mesh requirement while it still has unsubmitted stages.
    In-flight tasks drain on the old pilot; only remaining stages move.

    Per-pipeline fault isolation and quota semantics are inherited from
    Pipeline/RemoteAgent; ``run(...)['_meta']`` additionally reports the
    placement map, migrations, per-pilot lease peaks, and any quota
    violations (always ``{}`` unless the enforcement invariant broke).
    """

    def __init__(self, manager: PilotManager,
                 pilots: Optional[Sequence[Pilot]] = None, *,
                 max_workers_per_pilot: int = 4,
                 agent_factory: Callable[..., RemoteAgent] = RemoteAgent):
        self.manager = manager
        self.pilots = list(pilots if pilots is not None else manager.pilots)
        if not self.pilots:
            raise RuntimeError("MultiPilotScheduler needs at least one pilot")
        self.agents: Dict[str, RemoteAgent] = {
            p.uid: agent_factory(p, max_workers=max_workers_per_pilot)
            for p in self.pilots}
        self._lock = threading.Lock()
        self._pipelines: List[Pipeline] = []
        self._placement: Dict[str, Pilot] = {}  # pipeline name -> pilot
        # placement weight already promised to each pilot but possibly not
        # leased yet; keeps a burst of placements spread out.  Released
        # when a pipeline finishes so late migrations rank pilots on live
        # load, not the initial assignment.
        self._assigned: Dict[str, int] = {p.uid: 0 for p in self.pilots}
        self._released: set = set()  # pipeline names whose weight returned
        self._listeners = []
        for p in self.pilots:
            cb = (lambda p=p: self._on_capacity_change(p))
            p.add_capacity_listener(cb)
            self._listeners.append((p, cb))

    # -- placement -------------------------------------------------------------

    @staticmethod
    def _weight(pipe: Pipeline) -> int:
        return pipe.quota if pipe.quota is not None else pipe.mesh_requirement

    def _place_locked(self, pipe: Pipeline, exclude: Sequence[Pilot] = (),
                      num_devices: Optional[int] = None) -> Optional[Pilot]:
        return self.manager.place(
            num_devices=(num_devices if num_devices is not None
                         else pipe.mesh_requirement),
            kinds=pipe.stage_kinds(),
            pilots=self.pilots, load=self._assigned, exclude=exclude)

    def _release_weight(self, pipe: Pipeline) -> None:
        with self._lock:
            if pipe.name in self._released:
                return
            self._released.add(pipe.name)
            pilot = self._placement.get(pipe.name)
            if pilot is not None:
                self._assigned[pilot.uid] -= self._weight(pipe)

    def _on_capacity_change(self, pilot: Pilot) -> None:
        """Migrate pipelines whose pilot degraded below their mesh
        requirement (device failures shrink alive_count; releases never
        do, so this is cheap on the common path)."""
        moves: List[tuple] = []
        with self._lock:
            for pipe in self._pipelines:
                if self._placement.get(pipe.name) is not pilot or pipe.finished:
                    continue
                need = pipe.remaining_mesh_requirement()
                if need == 0 or pilot.alive_count() >= need:
                    continue
                target = self._place_locked(pipe, exclude=(pilot,),
                                            num_devices=need)
                if target is None:
                    continue  # nowhere better: stay and degrade elastically
                w = self._weight(pipe)
                self._assigned[pilot.uid] -= w
                self._assigned[target.uid] += w
                self._placement[pipe.name] = target
                moves.append((pipe, target, need))
        for pipe, target, need in moves:
            pipe.rebind(self.agents[target.uid],
                        reason=f"pilot {pilot.uid} degraded below "
                               f"{need} alive devices")

    # -- run -------------------------------------------------------------------

    def run(self, pipelines: Sequence[Pipeline],
            timeout: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        t0 = time.time()
        placed: List[tuple] = []
        with self._lock:
            self._pipelines = list(pipelines)
            for pipe in pipelines:
                pilot = self._place_locked(pipe)
                if pilot is not None:
                    self._assigned[pilot.uid] += self._weight(pipe)
                    self._placement[pipe.name] = pilot
                placed.append((pipe, pilot))
        for pipe, pilot in placed:
            if pilot is None:
                pipe.abort(
                    f"unplaceable: no pilot admits kinds={sorted(pipe.stage_kinds())} "
                    f"with >= {pipe.mesh_requirement} alive devices")
            else:
                pipe.start(self.agents[pilot.uid],
                           on_finish=self._release_weight)
        deadline = None if timeout is None else t0 + timeout
        for pipe in pipelines:
            remaining = None if deadline is None else max(0.0, deadline - time.time())
            if not pipe.wait(remaining):
                raise TimeoutError(
                    f"pipeline {pipe.name} did not finish within {timeout}s")
        wall = time.time() - t0
        out: Dict[str, Dict[str, Any]] = {
            p.name: p.result_dict() for p in pipelines}
        meta = aggregate_metrics(pipelines, wall)
        with self._lock:
            meta["placement"] = {name: pilot.uid
                                 for name, pilot in self._placement.items()}
        meta["pilots"] = [p.uid for p in self.pilots]
        meta["migrations"] = [dict(m, pipeline=p.name)
                              for p in pipelines for m in p.migrations]
        meta["group_peaks"] = {uid: a.group_peaks()
                               for uid, a in self.agents.items()}
        meta["quota_violations"] = {
            uid: v for uid, a in self.agents.items()
            if (v := a.quota_violations())}
        out["_meta"] = meta
        return out

    def close(self, timeout: Optional[float] = None) -> None:
        for p, cb in self._listeners:
            p.remove_capacity_listener(cb)
        self._listeners = []
        for a in self.agents.values():
            a.close(timeout)


def run_pipelines_multi(
    pipelines: Sequence[Pipeline],
    *,
    manager: Optional[PilotManager] = None,
    num_pilots: int = 2,
    max_workers_per_pilot: Optional[int] = None,
) -> Dict[str, Dict[str, Any]]:
    """DEPRECATED shim — use :class:`repro_torch.core.session.Session` with
    ``pods=num_pilots`` instead; kept so pre-Session callers and tests
    keep working unchanged.

    Multi-pilot Table-4 mode: split the machine into ``num_pilots``
    disjoint per-pod pools and spread N pipelines across them.  With a
    caller-supplied ``manager`` its existing pilots are used as-is
    (pre-shaped pools, e.g. kind-specialised pods); otherwise the free
    device inventory is split evenly."""
    warnings.warn(
        "run_pipelines_multi is deprecated; use repro_torch.core.Session "
        "(pods=N, session.run_all) instead", DeprecationWarning, stacklevel=2)
    if manager is None:
        manager = PilotManager()
    if not manager.pilots:
        total = manager.free_devices()
        num_pilots = max(1, min(num_pilots, total))
        per, extra = divmod(total, num_pilots)
        manager.submit_pilots([
            PilotDescription(num_devices=per + (1 if i < extra else 0),
                             name=f"pod{i}")
            for i in range(num_pilots)])
    if max_workers_per_pilot is None:
        max_workers_per_pilot = max(
            2, max(p.size for p in manager.pilots))
    sched = MultiPilotScheduler(
        manager, max_workers_per_pilot=max_workers_per_pilot)
    try:
        out = sched.run(pipelines)
    finally:
        sched.close()
    return out
