"""PilotManager / Pilot: resource acquisition + placement (RADICAL-Pilot
analogue; mirror of ``repro.core.pilot``).

A Pilot owns a pool of accelerator devices acquired once; tasks are
multiplexed onto slices of the pool without re-acquisition (the pilot
model's core idea).  Device failure marks devices dead; subsequent carves
come from survivors (elastic degradation).

The PilotManager is the layer above: it owns the machine's device
inventory and hands out **disjoint** pools — two pilots never share a
device, and submitting a pilot the machine cannot back raises instead of
silently aliasing (`devices[:n]` overlap was a seed bug).  It is also the
placement scheduler for the multi-pilot mode (paper Table 4 across
per-pod pools): ``place`` picks the pilot with the most effective free
capacity among those that admit a task kind and still satisfy a mesh
requirement.  Orchestration on top of ``place`` lives one layer up:
per-STAGE placement/migration in :class:`repro_torch.core.session.Session`
(the user-facing facade), whole-pipeline placement in
:class:`repro_torch.core.pipeline.MultiPilotScheduler`.

The inventory is the machine's CUDA devices.  Without a GPU it raises,
as ``launch.mesh.resolve_device`` does: only ``devices=`` (the CPU, or
stand-in devices in the tests) runs anywhere else.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.communicator import (Communicator, build_communicator,
                                           device_id)


def cuda_inventory() -> List[torch.device]:
    """Every CUDA device of the machine; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the pilot runtime leases the machine's GPUs; "
            "pass devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class PilotDescription:
    num_devices: int = -1  # -1 = all devices still free in the manager
    name: str = "pilot"
    # task kinds this pilot admits; () = any kind.  Placement only puts
    # work on a pilot whose kinds cover the work's kinds (e.g. a
    # CPU-worker pod that only takes "data_engineering" stages).
    task_kinds: Tuple[str, ...] = ()
    # where this pilot's agent executes attempts: None = the Session
    # default, "in-process" = thread pool in this process; "subprocess"
    # and "jax-distributed" (the JAX package's worker pools) raise until
    # the port's core/exec/ lands.  Resolved by Session._ensure.
    transport: Optional[str] = None


class Pilot:
    def __init__(self, uid: str, devices: Sequence,
                 task_kinds: Tuple[str, ...] = ()):
        self.uid = uid
        self.task_kinds = tuple(task_kinds)
        # _devices is append-never after construction; only the index sets
        # below change, so they carry the lock discipline.
        self._devices = list(devices)
        self._failed: set = set()  # guarded-by: _lock
        self._leased: dict = {}  # guarded-by: _lock  (device index -> task uid)
        self._lock = threading.Lock()
        # called (no args) when capacity frees/changes
        self._listeners: list = []  # guarded-by: _lock
        self.created_at = time.time()

    # -- capacity-change notification ----------------------------------------

    def add_capacity_listener(self, cb) -> None:
        """Register ``cb()`` to run whenever devices are released or marked
        failed.  Listeners are invoked OUTSIDE the pilot lock so they may
        take their own locks (e.g. an agent's scheduling condition)."""
        with self._lock:
            self._listeners.append(cb)

    def remove_capacity_listener(self, cb) -> None:
        with self._lock:
            if cb in self._listeners:
                self._listeners.remove(cb)

    def _notify(self) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for cb in listeners:  # outside the lock: callbacks take their own locks
            cb()

    # -- capacity ------------------------------------------------------------

    @property
    def size(self) -> int:
        return len(self._devices)

    def alive_devices(self) -> List:
        with self._lock:
            return self._alive_devices_locked()

    def _alive_devices_locked(self) -> List:
        return [d for i, d in enumerate(self._devices) if i not in self._failed]

    def alive_count(self) -> int:
        with self._lock:
            return len(self._devices) - len(self._failed)

    def free_count(self) -> int:
        with self._lock:
            return sum(
                1 for i in range(len(self._devices))
                if i not in self._failed and i not in self._leased
            )

    def admits(self, kinds: Iterable[str]) -> bool:
        """True if this pilot accepts every task kind in ``kinds``."""
        if not self.task_kinds:
            return True
        return set(kinds) <= set(self.task_kinds)

    # -- failure handling ----------------------------------------------------

    def mark_failed(self, device_ids: Sequence[int]) -> None:
        with self._lock:
            for d in device_ids:
                for i, dev in enumerate(self._devices):
                    if device_id(dev) == d:
                        self._failed.add(i)
                        self._leased.pop(i, None)
        self._notify()

    # -- leasing -------------------------------------------------------------

    def lease(self, n: int, task_uid: str) -> Optional[List]:
        """Reserve n alive+free devices for a task (None if unavailable)."""
        with self._lock:
            free = [
                i for i in range(len(self._devices))
                if i not in self._failed and i not in self._leased
            ]
            if len(free) < n:
                return None
            take = free[:n]
            for i in take:
                self._leased[i] = task_uid
            return [self._devices[i] for i in take]

    def release(self, task_uid: str) -> int:
        """Return the lease held under ``task_uid``; returns #devices freed."""
        freed = 0
        with self._lock:
            for i in [i for i, u in self._leased.items() if u == task_uid]:
                del self._leased[i]
                freed += 1
        if freed:
            self._notify()
        return freed

    def carve(self, devices: Sequence, mesh_shape=None,
              mesh_axes: Tuple[str, ...] = ("data",)) -> Communicator:
        return build_communicator(devices, mesh_shape, mesh_axes,
                                  pilot_uid=self.uid)


class PilotManager:
    """Acquires disjoint pilots and places work on them.

    ``devices`` defaults to the machine's CUDA devices, and raises without
    one (pass ``devices=`` for the CPU or for stand-in devices in tests).
    Every ``submit_pilot`` carves its pool out of the manager's remaining
    free devices; when the machine is exhausted the submit **raises**
    rather than handing out an overlapping slice.  ``cancel_pilot`` returns a pilot's surviving
    devices to the free pool (failed devices stay retired).
    """

    _uid = itertools.count()

    def __init__(self, devices: Optional[Sequence] = None,
                 pilot_factory=Pilot):
        self.pilots: List[Pilot] = []  # guarded-by: _lock
        self._pilot_factory = pilot_factory
        self._devices = list(devices) if devices is not None \
            else cuda_inventory()  # guarded-by: _lock
        self._free: List = list(self._devices)  # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def total_devices(self) -> int:
        with self._lock:
            return len(self._devices)

    def free_devices(self) -> int:
        with self._lock:
            return len(self._free)

    # -- pilot lifecycle -----------------------------------------------------

    def submit_pilot(self, desc: PilotDescription) -> Pilot:
        with self._lock:
            n = desc.num_devices if desc.num_devices > 0 else len(self._free)
            if n <= 0 or n > len(self._free):
                raise RuntimeError(
                    f"pilot {desc.name!r} requested {desc.num_devices} devices "
                    f"but only {len(self._free)}/{len(self._devices)} are free "
                    f"({len(self.pilots)} pilots already hold the rest)")
            take, self._free = self._free[:n], self._free[n:]
            pilot = self._pilot_factory(
                f"{desc.name}.{next(self._uid):04d}", take,
                task_kinds=desc.task_kinds)
            self.pilots.append(pilot)
            return pilot

    def submit_pilots(self, descs: Sequence[PilotDescription]) -> List[Pilot]:
        return [self.submit_pilot(d) for d in descs]

    def cancel_pilot(self, pilot: Pilot) -> int:
        """Tear a pilot down; its alive devices rejoin the free pool.
        Returns the number of devices recovered.  Refuses while any lease
        is outstanding — recycling a device another agent is still
        running on would re-create exactly the overlapping-pools bug the
        manager exists to prevent (close the pilot's agents first)."""
        with self._lock:
            if pilot not in self.pilots:
                raise ValueError(f"pilot {pilot.uid} is not managed here")
            leased = pilot.alive_count() - pilot.free_count()
            if leased:
                raise RuntimeError(
                    f"pilot {pilot.uid} still has {leased} leased device(s); "
                    "close its agent(s) before cancel_pilot")
            self.pilots.remove(pilot)
            recovered = pilot.alive_devices()
            self._free.extend(recovered)
            return len(recovered)

    # -- placement -----------------------------------------------------------

    def place(self, num_devices: int = 1, kinds: Iterable[str] = (),
              *, pilots: Optional[Sequence[Pilot]] = None,
              load: Optional[Dict[str, int]] = None,
              exclude: Sequence[Pilot] = ()) -> Optional[Pilot]:
        """Pick the pilot for a unit of work needing ``num_devices`` alive
        devices and admitting all of ``kinds``.

        Chooses by **effective free capacity**: current free devices minus
        the caller's already-assigned-but-not-yet-leased weight (``load``,
        a ``{pilot uid: device weight}`` overlay maintained by e.g.
        MultiPilotScheduler so a burst of placements spreads out instead
        of all landing on the momentarily-emptiest pilot).  Returns None
        when no pilot qualifies — the caller decides whether that is an
        error or a reason to wait.
        """
        need = max(num_devices, 1)
        if pilots is None:
            with self._lock:
                pilots = list(self.pilots)
        best, best_score = None, None
        for p in pilots:
            if p in exclude or not p.admits(kinds):
                continue
            if p.alive_count() < need:
                continue
            effective_free = p.free_count() - (load or {}).get(p.uid, 0)
            score = (effective_free, p.alive_count())
            if best_score is None or score > best_score:
                best, best_score = p, score
        return best
