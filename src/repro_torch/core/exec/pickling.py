"""Submit-time picklability contract for cross-process transports (mirror
of ``repro.core.exec.pickling``).

A subprocess worker receives the task call by pickle, which means the
task fn travels *by reference* (module + qualname) and every argument
travels *by value*.  Anything that breaks that — a lambda, a nested
function, a closure over live runtime objects, an argument holding a
lock or a socket — would otherwise surface as an opaque pickle
traceback from deep inside the transport.  ``ensure_picklable`` runs
the same checks at ``submit`` time and raises a ``TypeError`` that
names the offending function, capture, or argument.
"""
from __future__ import annotations

import inspect
import pickle
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

from repro_torch.core.exec import protocol


def _describe_fn(fn: Callable) -> str:
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
    mod = getattr(fn, "__module__", None)
    return f"{mod}.{name}" if mod else str(name)


def _fn_problem(fn: Callable) -> Optional[str]:
    """Why ``fn`` cannot travel by reference to a worker, or None."""
    if not callable(fn):
        return f"{fn!r} is not callable"
    if inspect.ismethod(fn):
        owner = type(fn.__self__).__name__
        return (f"{_describe_fn(fn)} is a bound method of a live "
                f"{owner} instance; workers cannot receive the instance — "
                "pass a module-level function instead")
    code = getattr(fn, "__code__", None)
    name = getattr(fn, "__name__", "")
    qualname = getattr(fn, "__qualname__", name)
    if name == "<lambda>":
        return (f"lambda defined at {code.co_filename}:{code.co_firstlineno} "
                "cannot be pickled; workers import task fns by qualified "
                "name — define it as a module-level function"
                if code else "lambda cannot be pickled")
    if code is not None and "<locals>" in qualname:
        captures = ", ".join(code.co_freevars) or "its enclosing frame"
        return (f"{_describe_fn(fn)} is a nested function (captures: "
                f"{captures}); workers import task fns by qualified name — "
                "move it to module level and pass captured values as "
                "arguments")
    if code is not None and code.co_freevars:
        return (f"{_describe_fn(fn)} captures free variables "
                f"{code.co_freevars} from an enclosing scope; pass them as "
                "arguments instead")
    if getattr(fn, "__module__", None) == "__main__":
        real = protocol.main_module_name()
        if real is None:
            return (f"{_describe_fn(fn)} is defined in a __main__ script "
                    "with no importable module spec; workers import task "
                    "fns by qualified name — run the script with `python "
                    "-m pkg.mod`, or move the function into a module")
        try:
            protocol.import_fn(real, qualname)
        except Exception as e:  # noqa: BLE001 — reshaped into the TypeError
            return (f"{_describe_fn(fn)} does not resolve as "
                    f"{real}.{qualname} when the entry module is "
                    f"re-imported in a worker ({type(e).__name__}: {e})")
    return None


def _first_unpicklable(obj: Any, path: str) -> Optional[str]:
    """Locate the deepest unpicklable piece of ``obj``; None if clean."""
    try:
        protocol.dumps(obj)
        return None
    except Exception:  # noqa: BLE001 — any pickle failure means "explain it"
        pass
    # drill into common containers so the message points at the leaf
    if isinstance(obj, Mapping):
        for k, v in obj.items():
            found = _first_unpicklable(v, f"{path}[{k!r}]")
            if found:
                return found
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            found = _first_unpicklable(v, f"{path}[{i}]")
            if found:
                return found
    return f"{path} holds an unpicklable {type(obj).__name__}: {obj!r:.120}"


def ensure_picklable(fn: Callable,
                     args: Sequence[Any] = (),
                     kwargs: Optional[Mapping[str, Any]] = None,
                     *,
                     transport: str = "subprocess") -> None:
    """Raise TypeError naming the offending closure/capture/argument if
    ``fn(*args, **kwargs)`` cannot be shipped to a worker process."""
    problem = _fn_problem(fn)
    if problem is None:
        try:
            protocol.dumps(fn)
        except Exception as e:  # noqa: BLE001 — reshaped into the TypeError
            problem = (f"{_describe_fn(fn)} failed to pickle by reference "
                       f"({type(e).__name__}: {e}); it must resolve as "
                       "module.qualname in the worker process")
    if problem is None:
        for i, a in enumerate(args):
            problem = _first_unpicklable(a, f"args[{i}]")
            if problem:
                break
    if problem is None and kwargs:
        for k, v in kwargs.items():
            problem = _first_unpicklable(v, f"kwargs[{k!r}]")
            if problem:
                break
    if problem is not None:
        raise TypeError(
            f"task fn for {transport} transport violates the picklable-task "
            f"contract: {problem}")


def check_roundtrip(obj: Any) -> Any:
    """Pickle and unpickle ``obj`` (test helper for wire fidelity)."""
    return pickle.loads(protocol.dumps(obj))


def format_payload(fn: Callable, args: Tuple, kwargs: Mapping[str, Any],
                   service: bool) -> bytes:
    """Serialise a task call, converting pickle errors into the contract
    TypeError (callers that skipped ensure_picklable still get the
    readable message, not a worker-side traceback)."""
    try:
        return protocol.dumps({"fn": fn, "args": tuple(args),
                               "kwargs": dict(kwargs), "service": service})
    except TypeError:
        raise
    except Exception as e:  # noqa: BLE001 — reshaped into the TypeError
        ensure_picklable(fn, args, kwargs)
        raise TypeError(f"task payload failed to pickle: {e}") from e
