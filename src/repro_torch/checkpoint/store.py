"""Checkpoint store (mirror of ``repro.checkpoint.store``): save and
restore a train state for checkpoint/restart, in the JAX package's
on-disk format 2, so a step written by either package restores in the
other.

Layout: ``<dir>/step_<N>/manifest.json`` plus one compressed file per
leaf (zstd where ``zstandard`` is installed, else zlib), each recorded in
the manifest with its shape, dtype (``bfloat16`` for bf16, which numpy
lacks), codec, byte count and crc32.  Leaf keys are the dict keys on the
leaf's path, sorted at each level and joined by ``__`` (JAX's tree
paths).  ``AsyncCheckpointer`` snapshots the state to host memory, then
writes on a background thread so the train loop never waits on disk.
Leaves are compressed and written by a small thread pool (zlib and zstd
release the interpreter lock), which a multi-gigabyte state needs.

Crash consistency: every file and the step directory are fsynced before
an atomic rename publishes the step, and readers verify byte counts and
crc32s.  A torn step is skipped with a warning by ``latest_step()`` and
``restore()``, which fall back to the newest intact step;
``verify_step`` is the explicit probe.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import sys
import threading
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

try:
    import zstandard
except ImportError:  # an installation without python-zstandard
    zstandard = None

PyTree = Any
_SEP = "__"
_WORKERS = min(8, os.cpu_count() or 1)
# a multi-gigabyte state compresses at tens of MB/s per thread
_CLOSE_TIMEOUT_S = 600.0


def _fault_injector():
    # lazy lookup, not an import (the runtime package imports this store):
    # a plan can only be armed once core.resilience.faults is loaded
    mod = sys.modules.get("repro_torch.core.resilience.faults")
    return mod.active() if mod is not None else None


def _compress(data) -> tuple:
    if zstandard is not None:
        return "zstd", zstandard.ZstdCompressor(level=3).compress(data)
    return "zlib", zlib.compress(data, 3)


def _decompress(codec: str, buf: bytes) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not installed")
        return zstandard.ZstdDecompressor().decompress(buf)
    if codec == "zlib":
        return zlib.decompress(buf)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _flatten(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    """``{key: leaf}`` in JAX's order: sorted dict keys, joined by ``__``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k in sorted(tree):
        flat.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return flat


def _unflatten(like: PyTree, flat: Dict[str, Any], prefix: str = "") -> PyTree:
    if not isinstance(like, dict):
        return flat[prefix]
    return {k: _unflatten(v, flat, f"{prefix}{_SEP}{k}" if prefix else str(k))
            for k, v in like.items()}


def _host_array(leaf) -> tuple:
    """A leaf (tensor or array) as a C-ordered numpy array and its dtype
    name; bf16 travels as its int16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf)
    return arr, str(arr.dtype)


def _from_bytes(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype))
                            .reshape(shape).copy())


class CheckpointCorrupt(RuntimeError):
    """A checkpoint step failed verification (torn write / bit rot)."""


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # directory fsync makes the rename itself durable; best-effort on
    # filesystems that refuse O_RDONLY dir fds
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _tear(path: str, manifest: dict, at_byte: int, leaf: int) -> None:
    """Simulate a crash that left ``path`` torn: truncate one file
    (``leaf < 0``: the manifest; else the ``leaf``-th leaf file)."""
    if leaf < 0:
        victim = os.path.join(path, "manifest.json")
    else:
        files = [m["file"] for m in manifest["leaves"].values()]
        victim = os.path.join(path, files[leaf % len(files)])
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.truncate(min(max(0, at_byte), max(0, size - 1)))


def _crc32(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def _write_leaf(tmp: str, key: str, leaf) -> dict:
    arr, dtype = _host_array(leaf)
    codec, payload = _compress(arr.reshape(-1).view(np.uint8))
    fn = re.sub(r"[^\w.\-]", "_", key) + (
        ".npy.zst" if codec == "zstd" else ".npy.zz")
    fpath = os.path.join(tmp, fn)
    with open(fpath, "wb") as f:
        f.write(payload)
    _fsync_file(fpath)
    return {"file": fn, "shape": list(arr.shape), "dtype": dtype,
            "codec": codec, "bytes": len(payload), "crc32": _crc32(payload)}


def save(directory: str, step: int, state: PyTree) -> str:
    """Synchronous save; returns the checkpoint path.

    Leaf files and the manifest are written and fsynced inside
    ``step_N.tmp``, the tmp dir is fsynced, then an atomic rename
    publishes the step and the parent dir is fsynced."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(state)
    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        metas = list(pool.map(lambda kv: _write_leaf(tmp, *kv), flat.items()))
    manifest = {"step": step, "format": 2, "leaves": dict(zip(flat, metas))}
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    _fsync_file(mpath)
    _fsync_dir(tmp)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _fsync_dir(directory)
    inj = _fault_injector()
    if inj is not None:
        act = inj.fire("checkpoint.save", step=step)
        if act is not None and act["action"] == "tear":
            _tear(path, manifest, int(act.get("at_byte", 0)),
                  int(act.get("leaf", 0)))
    return path


def verify_step(directory: str, step: int) -> bool:
    """True iff ``step`` is intact on disk: a readable manifest, every
    leaf file present and, for format 2, each file's byte count and
    crc32 as recorded."""
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        for meta in manifest["leaves"].values():
            fpath = os.path.join(path, meta["file"])
            if "bytes" in meta and os.path.getsize(fpath) != meta["bytes"]:
                return False
            if "crc32" in meta:
                with open(fpath, "rb") as f:
                    if _crc32(f.read()) != meta["crc32"]:
                        return False
            elif not os.path.exists(fpath):
                return False
    except (OSError, ValueError, KeyError):
        return False
    return True


def _steps_on_disk(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(
        (int(m.group(1))
         for m in (re.match(r"step_(\d+)$", d) for d in os.listdir(directory))
         if m),
        reverse=True,
    )


def latest_step(directory: str, *, verify: bool = True) -> Optional[int]:
    """The newest step; by default the newest *intact* one (a torn step
    is skipped with a warning, so a retry never resumes from it)."""
    for step in _steps_on_disk(directory):
        if not verify or verify_step(directory, step):
            return step
        warnings.warn(
            f"checkpoint step {step} under {directory} is torn/corrupt; "
            f"falling back to an older step", RuntimeWarning, stacklevel=2)
    return None


def _read_leaf(path: str, key: str, meta: dict, device) -> torch.Tensor:
    with open(os.path.join(path, meta["file"]), "rb") as f:
        payload = f.read()
    if "crc32" in meta and _crc32(payload) != meta["crc32"]:
        raise CheckpointCorrupt(f"crc mismatch for leaf {key!r} in {path}")
    try:
        t = _from_bytes(_decompress(meta.get("codec", "zstd"), payload),
                        meta["dtype"], meta["shape"])
    except Exception as e:  # noqa: BLE001 - any decode error = torn leaf
        raise CheckpointCorrupt(f"torn leaf {key!r} in {path}: {e}") from e
    return t.to(device)


def _read_step(path: str, manifest: dict, flat_like: Dict[str, Any]) -> Dict[str, Any]:
    wanted = [(key, meta) for key, meta in manifest["leaves"].items()
              if key in flat_like]

    def one(item):
        key, meta = item
        like = flat_like[key]
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
        return key, _read_leaf(path, key, meta, device)

    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        return dict(pool.map(one, wanted))


def restore(directory: str, like: PyTree, *, step: Optional[int] = None) -> PyTree:
    """Restore into the structure of ``like``, each leaf a tensor on the
    device of ``like``'s leaf at its key (the CPU where that is not a
    tensor), in the dtype it was saved in.

    With ``step=None`` a torn newest step is skipped (with a warning) in
    favour of the newest intact one; an explicitly requested step raises
    :class:`CheckpointCorrupt` instead."""
    candidates = [step] if step is not None else _steps_on_disk(directory)
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    flat_like = _flatten(like)
    last_err: Optional[Exception] = None
    for cand in candidates:
        path = os.path.join(directory, f"step_{cand:08d}")
        try:
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    manifest = json.load(f)
            except (OSError, ValueError) as e:
                raise CheckpointCorrupt(
                    f"unreadable manifest in {path}: {e}") from e
            out = _read_step(path, manifest, flat_like)
        except CheckpointCorrupt as e:
            if step is not None:
                raise
            warnings.warn(
                f"skipping torn/corrupt checkpoint step {cand}: {e}",
                RuntimeWarning, stacklevel=2)
            last_err = e
            continue
        missing = set(flat_like) - set(out)
        if missing:
            raise KeyError(
                f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
        return _unflatten(like, out)
    raise CheckpointCorrupt(
        f"every checkpoint step under {directory} is torn/corrupt "
        f"(last error: {last_err})")


class AsyncCheckpointer:
    """Snapshot-on-call, write-in-background checkpointing.  ``save``
    copies every leaf to host memory before it returns, so the train
    step may go on updating the state in place."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def save(self, step: int, state: PyTree) -> None:
        if self._err:
            raise self._err
        host_state = _unflatten(state, {
            key: (leaf.detach().to("cpu", copy=True)
                  if isinstance(leaf, torch.Tensor) else np.array(leaf))
            for key, leaf in _flatten(state).items()})
        self._q.put((step, host_state))  # blocks only if 2 writes queued

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, state = item
                save(self.directory, step, state)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - raised by wait/close
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(_steps_on_disk(self.directory))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        """Block until every queued save is on disk; re-raise a failure."""
        # deliberate: waits for the writes themselves (a caller restores or
        # exits next), however long the disk takes
        self._q.join()  # noqa: TMO001
        if self._err:
            raise self._err

    def close(self):
        """Finish the queued saves, stop the writer thread, re-raise a
        failure."""
        self._q.put(None)
        self._thread.join(timeout=_CLOSE_TIMEOUT_S)
        if self._thread.is_alive():
            raise TimeoutError(f"checkpoint writer still busy after "
                               f"{_CLOSE_TIMEOUT_S} s")
        if self._err:
            raise self._err
