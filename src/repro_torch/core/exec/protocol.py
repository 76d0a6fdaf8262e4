"""Length-prefixed pickle framing for the worker RPC channel (mirror of
``repro.core.exec.protocol``).

Every message on the wire is ``8-byte big-endian length || pickle
payload`` (JAX's header is 4 bytes and its frames stop at 2 GiB; a gang's
result may be larger).  Messages are plain dicts with a ``"type"`` key; the framing
layer knows nothing about their meaning.

Device tensors never cross the wire as device tensors: the pickler
lowers every ``torch.Tensor`` leaf to a CPU tensor of the same dtype and
shape at serialisation time (the receiving process has its own CUDA
context, and a CUDA tensor pickled by torch would rebuild on the
sender's card index).  The lowering is bitwise and, unlike numpy, keeps
bf16.  Only the tensor's own elements travel: torch's own pickling of a
view ships its whole base storage, so a view of a paged KV pool would
ship the pool.
"""
from __future__ import annotations

import io
import pickle
import socket
import struct
import sys
import threading
import time
import types
from typing import Any, Optional

# a frame's length, 8 bytes: a task's result may pass 4 GiB (a gang's
# rank 0 gathers every rank's rows: 3 GB at 2^26 rows over 4 cards)
_LEN = struct.Struct(">Q")
#: refuse absurd frames (corrupt length prefix) rather than allocating.
MAX_FRAME = 1 << 40
#: frames below this many bytes go out in one write with their header
_SMALL_FRAME = 1 << 16


class ConnectionClosed(ConnectionError):
    """Peer closed the socket (EOF mid-frame or between frames)."""


class _WireDump(pickle.Pickler):
    """Pickler that lowers torch.Tensor leaves to the raw bytes of their
    own elements (dtype and shape beside).

    Looks torch up through ``sys.modules`` so this module stays
    importable (and usable for pure-python messages) without forcing a
    torch import.
    """

    def reducer_override(self, obj: Any):
        if (isinstance(obj, types.FunctionType)
                and obj.__module__ == "__main__"
                and "<locals>" not in obj.__qualname__):
            # A fn from a ``python -m pkg.mod`` entry module pickles by
            # reference as ``__main__.name`` — which in the worker is the
            # worker daemon, not the caller's script.  runpy records the
            # real module name in __main__.__spec__; ship that instead.
            real = main_module_name()
            if real is not None:
                return (import_fn, (real, obj.__qualname__))
        torch = sys.modules.get("torch")
        if (torch is not None and isinstance(obj, torch.Tensor)
                and obj.layout == torch.strided and not obj.is_quantized):
            host = _host_tensor(obj)
            raw = host.reshape(-1).view(torch.uint8).numpy()
            return (_tensor_from_bytes,
                    (pickle.PickleBuffer(raw), str(host.dtype).split(".")[-1],
                     tuple(host.shape)))
        return NotImplemented


def _host_tensor(t):
    """``t`` as a detached, contiguous CPU tensor (a CUDA tensor copied
    to the host, a strided one made contiguous)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return t.contiguous()


def _tensor_from_bytes(buf, dtype: str, shape):
    """The receiving side of a lowered tensor: its bytes (a writable
    bytearray under pickle protocol 5, so no second copy) viewed as
    ``dtype`` and ``shape``."""
    import torch
    dt = getattr(torch, dtype)
    if len(buf) == 0:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dt).reshape(shape)


def main_module_name() -> Optional[str]:
    """The importable name behind ``__main__`` (``python -m pkg.mod``
    runs), or None for plain-script / REPL mains that workers cannot
    re-import."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    return getattr(spec, "name", None)


def import_fn(module: str, qualname: str):
    """Worker-side loader for a ``__main__``-remapped function: walk the
    qualname in the re-imported module, unwrapping a decorator object
    (e.g. a StageSpec) that holds the raw fn under ``.fn``."""
    import importlib
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if not isinstance(obj, types.FunctionType):
        inner = getattr(obj, "fn", None)
        if isinstance(inner, types.FunctionType):
            return inner
    return obj


def dumps(obj: Any) -> bytes:
    """Pickle ``obj`` for the wire (tensor leaves become host tensors)."""
    buf = io.BytesIO()
    _WireDump(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    return pickle.loads(data)


class Channel:
    """A framed, thread-safe-for-send message channel over a socket.

    Sends may come from several threads (heartbeat + task runner on the
    worker side; dispatcher + service bridges on the parent side), so
    each frame is written under a lock.  Receives are single-threaded by
    construction (one reader thread per channel) and unlocked.
    """

    #: optional chaos hook (repro_torch.core.resilience.faults): called
    #: with each decoded inbound message; may return ``{"action": "drop"}``
    #: to swallow the frame or ``{"action": "delay", "for_s": T}`` to
    #: hold it — simulating a lost / late RPC reply on a live socket.
    fault_filter = None

    def __init__(self, sock: socket.socket):
        # frames are request/reply: Nagle's algorithm would hold a small
        # frame back for the peer's delayed ACK (tens of ms a round trip)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._send_lock = threading.Lock()  # guards frame writes on _sock
        self._recv_buf = bytearray()
        #: when bytes last arrived, and whether a frame is being decoded: a
        #: peer whose long frame streams in or decodes is alive, though its
        #: heartbeats queue behind the frame (``quiet_s``)
        self.last_rx = time.time()
        self.decoding = False

    def quiet_s(self, now: float) -> float:
        """Seconds since a frame last made progress: 0 while one decodes."""
        return 0.0 if self.decoding else now - self.last_rx

    def fileno(self) -> int:
        return self._sock.fileno()

    def send(self, msg: Any) -> None:
        payload = dumps(msg)
        header = _LEN.pack(len(payload))
        with self._send_lock:
            if len(payload) < _SMALL_FRAME:
                self._sock.sendall(header + payload)
            else:  # no copy of a large payload to prepend 4 bytes
                self._sock.sendall(header)
                self._sock.sendall(payload)

    def recv(self, timeout: Optional[float] = None) -> Any:
        """Block for the next message; raise ConnectionClosed on EOF,
        socket.timeout on ``timeout`` expiry.  A timeout mid-frame keeps
        the partial bytes buffered, so the next recv resumes cleanly."""
        while True:
            self._sock.settimeout(timeout)
            header = self._recv_exact(_LEN.size)
            (n,) = _LEN.unpack(header[:_LEN.size])
            if n > MAX_FRAME:
                raise ConnectionClosed(f"corrupt frame length {n}")
            frame = self._recv_exact(_LEN.size + n)
            self._recv_buf = bytearray()
            self.decoding = True
            try:
                msg = loads(memoryview(frame)[_LEN.size:])
            finally:
                self.last_rx = time.time()
                self.decoding = False
            ff = self.fault_filter
            if ff is not None:
                act = ff(msg)
                if act is not None:
                    if act.get("action") == "drop":
                        continue  # the frame never "arrived"
                    if act.get("action") == "delay":
                        time.sleep(float(act.get("for_s", 0.0)))
            return msg

    def _recv_exact(self, n: int) -> bytearray:
        """Grow the resume buffer to ``n`` bytes total and return it."""
        while len(self._recv_buf) < n:
            try:
                chunk = self._sock.recv(min(n - len(self._recv_buf), 1 << 22))
            except socket.timeout:
                raise
            except OSError as e:
                raise ConnectionClosed(str(e)) from e
            if not chunk:
                raise ConnectionClosed("peer closed the channel")
            self.last_rx = time.time()
            self._recv_buf += chunk
        return self._recv_buf

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
