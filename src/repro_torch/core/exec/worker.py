"""Worker daemon: one long-lived process of a ``SubprocessTransport`` pool
(mirror of ``repro.core.exec.worker``).

Run as ``python -m repro_torch.core.exec.worker --host H --port P
--worker-id N --device cuda|cpu``.  The parent sets the environment
before spawn — ``CUDA_VISIBLE_DEVICES`` (the worker's share of the
machine's cards), the worker's logical CPU pool size
(``remote.POOL_ENV``), and ``PYTHONPATH`` so task fns pickled by
reference resolve here.  With ``--dist-init-method/--dist-world-size/
--dist-rank`` the worker joins a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU) before it serves a task.

Threads:

- **main**: blocking RPC read loop (task / control / shutdown frames);
- **heartbeat**: periodic liveness frames — started before torch is
  imported and the CUDA context created, so a slow boot never reads as
  a hung worker; if a send ever fails the parent is gone and the worker
  exits rather than orphan itself;
- **runner**: executes the current task (one at a time per worker);
- **streamer**: while a service task runs, polls its worker-side
  Request replicas and forwards token deltas / terminal transitions to
  the parent, which applies them to the client-held originals.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time
import traceback
from socket import create_connection
from typing import Any, Dict, Optional

from repro_torch.core.exec import protocol

_STREAM_POLL_S = 0.005
#: the package whose objects may hold Request replicas (resume states)
_PACKAGE = __name__.split(".")[0] + "."


def _error_payload(e: BaseException) -> Dict[str, str]:
    """Exceptions cross the wire as typed dicts, never pickled objects —
    custom ``__init__`` signatures (e.g. DeviceFailure) reconstruct
    wrongly under default exception pickling."""
    return {"etype": type(e).__name__,
            "message": str(e),
            "traceback": traceback.format_exc()[-2000:]}


class _Streamer:
    """Tracks live Request replicas for the running service task and
    mirrors their progress to the parent."""

    def __init__(self, chan: protocol.Channel, task_id: int):
        self._chan = chan
        self._task_id = task_id
        self._lock = threading.Lock()
        #: rid -> [request, tokens_already_sent, finish_sent]
        self._reqs: Dict[str, list] = {}  # guarded-by: _lock
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="rc-exec-streamer", daemon=True)
        self._thread.start()

    def register(self, req, sent: int = 0) -> None:
        with self._lock:
            self._reqs.setdefault(req.rid, [req, sent, False])

    def register_tree(self, obj: Any, _depth: int = 0,
                      _seen: Optional[set] = None) -> None:
        """Find Request instances anywhere inside a resume-state tree
        (engine checkpoints embed them in slots/queue/outbox) and track
        them as already-streamed up to their current token count."""
        from repro_torch.serve.request import Request
        seen = _seen if _seen is not None else set()
        if _depth > 8 or id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, Request):
            self.register(obj, sent=len(obj.tokens))
            return
        if isinstance(obj, dict):
            children = obj.values()
        elif isinstance(obj, (list, tuple, set)):
            children = obj
        elif hasattr(obj, "__dict__") and type(obj).__module__.startswith(_PACKAGE):
            children = vars(obj).values()
        else:
            return
        for c in children:
            self.register_tree(c, _depth + 1, seen)

    def _loop(self) -> None:
        while not self._done.wait(_STREAM_POLL_S):
            self.sweep()

    def sweep(self) -> None:
        """Forward any unsent tokens / terminal transitions.  Called from
        the poll loop and synchronously by the runner right before a
        preempted/final result, so parent and worker agree on the token
        count at every checkpoint boundary.

        ``done`` is read *before* the token count: the engine appends a
        request's last token before it finishes the request, so a sweep
        that saw ``done`` counts every token, and ``finish`` goes out
        only after the stream frame that carries the last one."""
        with self._lock:
            entries = list(self._reqs.values())
        for entry in entries:
            req, sent, finished_sent = entry
            done = req.done()
            n = len(req.tokens)
            try:
                if n > sent:
                    self._chan.send({
                        "type": "stream", "task_id": self._task_id,
                        "rid": req.rid,
                        "tokens": [int(t) for t in req.tokens[sent:n]],
                        "times": [float(t) for t in req.token_times[sent:n]],
                        "admitted_at": req.admitted_at,
                        "first_token_at": req.first_token_at,
                    })
                    entry[1] = n
                if done and not finished_sent:
                    self._chan.send({
                        "type": "finish", "task_id": self._task_id,
                        "rid": req.rid, "state": req.state.name,
                        "error": req.error,
                        "finished_at": req.finished_at,
                    })
                    entry[2] = True
            except protocol.ConnectionClosed:
                self._done.set()
                return

    def close(self) -> None:
        self._done.set()
        self._thread.join(timeout=1.0)
        self.sweep()


class _TaskRun:
    """State for the (single) in-flight task on this worker."""

    def __init__(self, chan: protocol.Channel, msg: Dict[str, Any]):
        self.chan = chan
        self.task_id = msg["task_id"]
        self.payload = protocol.loads(msg["payload"])
        #: a gang rank's part of its gang (the transport's ``submit_gang``):
        #: passed to the task fn ahead of its arguments
        self.rendezvous = msg.get("rendezvous")
        #: set just before the result frame goes out.  The busy check
        #: reads this, NOT thread.is_alive(): the parent marks the worker
        #: idle the instant the result frame lands, so a fast next
        #: dispatch can beat the runner thread's teardown.
        self.done = False
        self.control = None
        self.streamer: Optional[_Streamer] = None
        if self.payload.get("service"):
            from repro_torch.core.task import ServiceControl
            self.control = ServiceControl()
            self.streamer = _Streamer(chan, self.task_id)
        self.thread = threading.Thread(target=self._run,
                                       name="rc-exec-runner", daemon=True)

    def handle_control(self, msg: Dict[str, Any]) -> None:
        op = msg["op"]
        if self.control is None:
            return  # stale control frame for a non-service task
        if op == "submit_request":
            entry = protocol.loads(msg["data"])
            req = getattr(entry, "request", entry)  # KVHandoff carries one
            if self.streamer is not None and hasattr(req, "rid"):
                self.streamer.register(req)
            try:
                self.control.submit_request(entry)
            except RuntimeError as e:
                # raced a stop/drain the parent had not seen yet: fail the
                # replica so the streamer reports a terminal state instead
                # of the client-held original hanging forever
                if hasattr(req, "_finish"):
                    from repro_torch.serve.request import RequestState
                    req._finish(RequestState.FAILED, str(e))
        elif op == "stop":
            self.control.stop()
        elif op == "drain":
            self.control.drain()
        elif op == "preempt":
            self.control.request_preempt()

    def _run(self) -> None:
        from repro_torch.core.task import ServicePreempted
        fn = self.payload["fn"]
        args = tuple(self.payload["args"])
        if self.rendezvous is not None:
            args = (self.rendezvous,) + args
        kwargs = dict(self.payload["kwargs"])
        if self.control is not None:
            kwargs["control"] = self.control
            if self.streamer is not None:
                self.streamer.register_tree(kwargs.get("resume_state"))
        t0 = time.time()
        try:
            value = fn(*args, **kwargs)
            result = {"type": "result", "task_id": self.task_id,
                      "status": "ok", "value": value,
                      "elapsed": time.time() - t0}
        except ServicePreempted as e:
            result = {"type": "result", "task_id": self.task_id,
                      "status": "preempted", "state": e.state,
                      "elapsed": time.time() - t0}
        except BaseException as e:  # noqa: BLE001 — worker isolation boundary
            result = {"type": "result", "task_id": self.task_id,
                      "status": "error", "error": _error_payload(e),
                      "elapsed": time.time() - t0}
        if self.streamer is not None:
            # final sweep BEFORE the result frame: the parent must hold
            # every token the checkpointed state accounts for by the time
            # the preemption/completion lands
            self.streamer.close()
        self.done = True
        try:
            self.chan.send(result)
        except protocol.ConnectionClosed:
            pass  # parent gone; heartbeat thread will exit the process
        except Exception as e:  # noqa: BLE001 — any pickle failure lands here
            # unpicklable task *result* — report instead of dying silently
            try:
                self.chan.send({"type": "result", "task_id": self.task_id,
                                "status": "error",
                                "error": {"etype": "TypeError",
                                          "message": f"task result failed to "
                                                     f"pickle: {e}",
                                          "traceback": ""},
                                "elapsed": time.time() - t0})
            except protocol.ConnectionClosed:
                pass


class _Heartbeat:
    """Liveness frames every ``period_s`` on a thread of their own."""

    def __init__(self, chan: protocol.Channel, period_s: float):
        self._chan = chan
        self._period_s = period_s
        self._lock = threading.Lock()
        #: chaos: heartbeats are suppressed until this wall-clock time —
        #: set by a ``stall`` frame so the parent's heartbeat-timeout
        #: backstop can be exercised against a live, task-running worker
        self._stall_until = 0.0  # guarded-by: _lock
        threading.Thread(target=self._loop, name="rc-exec-heartbeat",
                         daemon=True).start()

    def stall(self, for_s: float) -> None:
        with self._lock:
            self._stall_until = time.time() + for_s

    def _loop(self) -> None:
        while True:
            time.sleep(self._period_s)
            with self._lock:
                stalled = time.time() < self._stall_until
            if stalled:
                continue  # alive but silent
            try:
                self._chan.send({"type": "heartbeat", "t": time.time()})
            except (protocol.ConnectionClosed, OSError):
                # the parent is gone: never linger as an orphan
                os._exit(0)


def _boot(device: str) -> Dict[str, Any]:
    """Import torch and, for ``device == "cuda"``, create the CUDA
    context on the worker's card; returns the ``ready`` frame's fields.
    A worker asked for the card without one raises."""
    t0 = time.time()
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "worker asked for the card but sees no GPU "
                f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        torch.zeros(1, device="cuda")  # the context, before any task
        return {"devices": torch.cuda.device_count(),
                "device_name": torch.cuda.get_device_name(0),
                "boot_s": time.time() - t0}
    return {"devices": 1, "device_name": "cpu", "boot_s": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--worker-id", type=int, required=True)
    ap.add_argument("--heartbeat-s", type=float, default=0.2)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    # torch.distributed hook: a process group across the pool's workers
    ap.add_argument("--dist-init-method", default=None)
    ap.add_argument("--dist-world-size", type=int, default=None)
    ap.add_argument("--dist-rank", type=int, default=None)
    args = ap.parse_args(argv)

    chan = protocol.Channel(create_connection((args.host, args.port),
                                              timeout=10))
    chan.send({"type": "hello", "worker_id": args.worker_id,
               "pid": os.getpid()})
    beat = _Heartbeat(chan, args.heartbeat_s)

    if os.environ.get("REPRO_FAULT_PLAN"):
        # worker-side chaos: the parent (a bench/test) shipped a fault
        # plan through the transport's env hook — sites that fire inside
        # the worker (e.g. checkpoint.save tears) arm here
        from repro_torch.core.resilience import faults as _faults
        _faults.install_from_env()

    # warm the runtime off the task path and tell the parent the pool
    ready = _boot(args.device)
    if args.dist_init_method is not None:
        import torch.distributed as dist
        dist.init_process_group(
            backend="nccl" if args.device == "cuda" else "gloo",
            init_method=args.dist_init_method,
            world_size=args.dist_world_size, rank=args.dist_rank)
    chan.send({"type": "ready", "worker_id": args.worker_id, **ready})

    current: Optional[_TaskRun] = None
    while True:
        try:
            msg = chan.recv()  # noqa: TMO001 — main RPC loop; heartbeat thread exits on a dead parent
        except protocol.ConnectionClosed:
            return 0  # parent closed the channel: clean exit
        mtype = msg.get("type")
        if mtype == "task":
            if current is not None and not current.done:
                chan.send({"type": "result", "task_id": msg["task_id"],
                           "status": "error",
                           "error": {"etype": "RuntimeError",
                                     "message": "worker is busy (protocol "
                                                "violation: one task per "
                                                "worker)",
                                     "traceback": ""}})
                continue
            current = _TaskRun(chan, msg)
            current.thread.start()
        elif mtype == "control":
            if current is not None:
                current.handle_control(msg)
        elif mtype == "die":
            # injected crash (FaultPlan.crash_worker): exit hard,
            # mid-task — the parent sees a real process death
            os._exit(3)
        elif mtype == "stall":
            # injected heartbeat stall: stay alive, go silent for a while
            beat.stall(float(msg.get("for_s", 1.0)))
        elif mtype == "shutdown":
            if current is not None and current.control is not None:
                current.control.stop()
            if current is not None:
                current.thread.join(timeout=5.0)
            return 0


if __name__ == "__main__":
    sys.exit(main())
