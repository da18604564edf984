"""Captured programs: the port's counterpart of jax.jit's executable cache.

The JAX package compiles each of its per-frame programs (the frame step,
the promotion probe, BA's rounds, the stale-frame refinement's
registration) into one executable per set of static arguments and input
shapes, and runs it with one dispatch. Here `program(name, fn)` declares
such a program: a `GraphCache` entered in the registry `PROGRAMS` under
its short name. A call on CUDA tensors looks up one captured CUDA graph
per key, the static keyword arguments plus the pytree structure, shapes,
dtypes and device of the tensor arguments (and any non-tensor leaves,
such as None), and replays it from one launch. A graph replays the eager
kernels exactly, with the same arguments in the same order, so a replay
computes the eager call's bits.

A new key: the call runs the function eagerly on its tensors (which
fills the first-use caches: core/exact.py's divisors, the feature
constants, the kernels' library and host constants) and returns that
result; then the inputs are copied into the program's own input tensors
and the function is captured on them with
`torch.cuda.graph(pool=<its own pool>, capture_error_mode="thread_local")`,
so launches of other threads on the card (the fusion thread's) are
neither refused nor captured. The capture runs under `HostSyncGuard`,
which names the first op that would read a tensor on the host, copy
between the host and the card, or give a shape that hangs on the data;
a capture that fails raises with the program's name and the op. Nothing
falls back to the eager function.

A call: each tensor argument is copied into the captured input, the
graph is replayed on the current stream, and each output is copied into
a fresh tensor, so a caller never holds a buffer the next replay
overwrites. The kernels a program launched while being captured are
counted in ops/cuda_kernels.LAUNCHES at each replay.

Every program counts its calls on CUDA tensors in the STOPWATCH: a call
with a new key is the span name + "_capture" (the eager call and the
capture, so its count is that of the captures), every other adds one to
the counter name + "_replay".

On CPU tensors a program calls its function directly.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from texturefusion_torch.ops import cuda_kernels
from texturefusion_torch.utils.stopwatch import STOPWATCH

# aten ops that read a tensor on the host, copy from host data, or give a
# shape that depends on the data: none may run inside a captured program
HOST_READS = frozenset({"_local_scalar_dense", "is_nonzero", "equal", "lift_fresh",
                        "lift_fresh_copy"})
DATA_SHAPES = frozenset({"nonzero", "nonzero_numpy", "argwhere", "masked_select",
                         "unique_dim", "unique_consecutive", "_unique", "_unique2",
                         "unique_dim_consecutive", "repeat_interleave"})
# linear algebra whose CUDA version checks its convergence on the host
HOST_SOLVERS = frozenset({"linalg_svd", "_linalg_svd", "linalg_eigh", "_linalg_eigh",
                          "linalg_eigvalsh", "svd"})
_BOOL_INDEXED = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})
_COPIES = frozenset({"_to_copy", "copy_", "copy"})


def host_sync_reason(func, args, kwargs) -> Optional[str]:
    """Why aten op `func` on `args` would stop a capture, or None."""
    name = func.overloadpacket.__name__
    if name in HOST_READS:
        return "reads a tensor on the host or copies host data"
    if name in DATA_SHAPES:
        return "gives a shape that depends on the data"
    if name in HOST_SOLVERS:
        return "a solver that checks its result on the host"
    if name in _BOOL_INDEXED and len(args) > 1:
        idx = args[1]
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx):
            return "boolean-mask indexing: a shape that depends on the data"
    if name in _COPIES:
        devs = {a.device.type for a in args if isinstance(a, torch.Tensor)}
        dev = (kwargs or {}).get("device")
        if dev is not None:
            devs.add(torch.device(dev).type)
        if "cpu" in devs and len(devs) > 1:
            return "a copy between the host and the card"
    return None


class HostSyncGuard(TorchDispatchMode):
    """A dispatch mode that raises on the first op host_sync_reason names,
    and remembers the last op run (`last`)."""

    def __init__(self):
        super().__init__()
        self.last: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        why = host_sync_reason(func, args, kwargs)
        if why is not None:
            raise RuntimeError(f"{func}: {why}")
        return func(*args, **(kwargs or {}))


_TENSOR = object()     # a tensor leaf's place in a structure


def flatten(x, leaves: List[torch.Tensor]):
    """The structure of `x` (tuples, lists and NamedTuples of tensors and
    hashable constants) as a hashable spec; its tensors appended to `leaves`."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(flatten(v, leaves) for v in x))
    hash(x)                 # a constant becomes part of the key
    return ("const", x)


def unflatten(spec, it):
    """The structure `spec` with its tensors taken from the iterator `it`."""
    if spec is _TENSOR:
        return next(it)
    kind, body = spec
    if kind == "const":
        return body
    vals = [unflatten(s, it) for s in body]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


class CapturedProgram:
    """One captured CUDA graph with its input and output tensors. The call
    that makes it runs eagerly on the caller's tensors (`first`, its
    result): that fills the first-use caches (core/exact.py's divisors,
    the feature constants, the kernels' library and host constants) and
    counts its kernels' launches as any eager call does. The capture then
    runs on copies of the inputs and launches nothing."""

    def __init__(self, fn: Callable, name: str, spec, args, tensors: List[torch.Tensor],
                 static: dict):
        self.fn, self.name, self.static = fn, name, static
        self.first = fn(*args, **static)
        self.inputs = [t.clone() for t in tensors]
        self.args = unflatten(spec, iter(self.inputs))
        self.launches: collections.Counter = collections.Counter()
        self.replays = 0
        guard = HostSyncGuard()
        cuda_kernels.CAPTURE.launches = self.launches
        try:
            with self._capturing(), self._guarding(guard):
                out = fn(*self.args, **static)
        except Exception as e:
            raise RuntimeError(f"{name}: the CUDA graph capture failed at {guard.last}: "
                               f"{e}") from e
        finally:
            cuda_kernels.CAPTURE.launches = None
        self.outputs: List[torch.Tensor] = []
        self.out_spec = flatten(out, self.outputs)
        self._record()

    def _capturing(self):
        self.graph = torch.cuda.CUDAGraph()
        self.done = torch.cuda.Event()
        return _capture(self.graph, self.inputs[0].device)

    def _guarding(self, guard: "HostSyncGuard"):
        return guard

    def _replay(self) -> None:
        self.graph.replay()

    def _wait(self) -> None:
        """The current stream waits for the last call's copies out."""
        torch.cuda.current_stream(self.inputs[0].device).wait_event(self.done)

    def _record(self) -> None:
        self.done.record(torch.cuda.current_stream(self.inputs[0].device))

    def __call__(self, tensors: List[torch.Tensor]):
        self._wait()
        for dst, src in zip(self.inputs, tensors):
            dst.copy_(src)
        self._replay()
        out = [t.clone() for t in self.outputs]
        self._record()
        for k, n in self.launches.items():
            cuda_kernels.LAUNCHES[k] += n
        self.replays += 1
        return unflatten(self.out_spec, iter(out))


@contextlib.contextmanager
def _capture(graph, device):
    """torch.cuda.graph on `device` into the program's own memory pool,
    refusing unsafe calls of this thread only."""
    with torch.cuda.device(device), torch.cuda.graph(
            graph, pool=torch.cuda.graph_pool_handle(), capture_error_mode="thread_local"):
        yield


def _captures(device: torch.device) -> bool:
    """Whether calls on `device` run as captured programs."""
    return device.type == "cuda"


class GraphCache:
    """fn(*args, **static) as one captured program per key on CUDA
    tensors, called directly on CPU tensors; its captures and replays
    counted in the STOPWATCH under `name`. Declared through `program`."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.programs: Dict[Tuple, CapturedProgram] = {}
        self._lock = threading.Lock()

    def __call__(self, *args, **static):
        tensors: List[torch.Tensor] = []
        spec = flatten(args, tensors)
        devs = {t.device for t in tensors}
        if not tensors or not any(_captures(d) for d in devs):
            return self.fn(*args, **static)
        if len(devs) > 1:
            raise ValueError(f"{self.name}: tensor arguments must all lie on one device, "
                             f"got {sorted(map(str, devs))}")
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
               tuple(sorted(static.items())))
        with self._lock:
            prog = self.programs.get(key)
            if prog is not None:
                STOPWATCH.count(self.name + "_replay")
                return prog(tensors)
            with STOPWATCH.time(self.name + "_capture"):
                prog = CapturedProgram(self.fn, self.name, spec, args, tensors, static)
            self.programs[key] = prog
            out, prog.first = prog.first, None
            return out

    def clear(self) -> None:
        with self._lock:
            self.programs.clear()


# the port's captured programs by name: frame_step, probe, ba, refine
PROGRAMS: Dict[str, GraphCache] = {}


def program(name: str, fn: Callable) -> GraphCache:
    """Declare fn as the captured program `name`: tensors are its
    positional arguments, statics its keyword arguments. Raises if the
    name is taken."""
    if name in PROGRAMS:
        raise ValueError(f"a captured program named {name!r} is declared already")
    PROGRAMS[name] = GraphCache(fn, name)
    return PROGRAMS[name]


def clear_programs() -> None:
    """Drop every registered program's captures."""
    for cache in PROGRAMS.values():
        cache.clear()


def program_count() -> int:
    """The captures held across the registry."""
    return sum(len(cache.programs) for cache in PROGRAMS.values())
