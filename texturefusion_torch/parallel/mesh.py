"""The device mesh of the multi-device layer, and its collectives.

Port of texturefusion_tpu/parallel/mesh.py. The JAX package is
single-controller: one process owns jax.devices(), arrays carry a
NamedSharding over a 1-D mesh and XLA inserts the collectives. The port
keeps that shape: a DeviceMesh is an ordered list of torch devices, one
per shard, driven by this one process. A device may repeat, so four
shards can sit on one GPU and eight on the CPU (the counterpart of the
JAX tests' eight host devices). The collectives are explicit copies
(`.to(device)`) and sums, all in this module, so that another transport
(NCCL) can take their place here alone. torch.cuda.comm is not used: it
refuses a device that repeats.

Not torch.distributed: the live pipeline is host-driven (one allocator,
tracking decisions made on the host), which SPMD ranks would each have
to re-derive, and NCCL refuses two ranks on one GPU. A single-controller
mesh cannot span hosts, so `init_distributed` with a coordinator raises.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

# virtual CPU devices: the CPU is one torch device, shared by this many
# shards, as the JAX tests force eight host devices
CPU_SHARDS = 8


class DeviceMesh:
    """A 1-D mesh: shard k runs on devices[k]; devices may repeat."""

    def __init__(self, devices: Sequence):
        if len(devices) == 0:
            raise ValueError("a DeviceMesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"

    # ------------------------------------------------------------ placement

    def shard_of(self, slots: np.ndarray) -> np.ndarray:
        """The shard that holds each chunk slot: s % n (round robin)."""
        return np.asarray(slots, np.int64) % self.size

    def local_row(self, slots: np.ndarray) -> np.ndarray:
        """Each slot's row in its shard: s // n."""
        return np.asarray(slots, np.int64) // self.size

    # ------------------------------------------------------------ collectives

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One copy of t on each shard's device (the same tensor where the
        device is t's)."""
        return [t.to(d) for d in self.devices]

    def _reduce(self, parts: Sequence[torch.Tensor],
                op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> List[torch.Tensor]:
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of {self.size}")
        acc = parts[0].to(self.devices[0])
        for p in parts[1:]:           # shard order: the same sums on every call
            acc = op(acc, p.to(acc.device))
        return self.replicate(acc)

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The per-shard tensors summed (in shard order) onto each shard's device."""
        return self._reduce(parts, torch.add)

    def pmax(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The per-shard tensors' elementwise maximum on each shard's device."""
        return self._reduce(parts, torch.maximum)

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
        """The per-shard tensors concatenated along `dim` (in shard order)
        on each shard's device."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of {self.size}")
        return self.replicate(torch.cat([p.to(self.devices[0]) for p in parts], dim=dim))


def same_device(a, b) -> bool:
    """Whether two device names are one device ("cuda" is the current GPU)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def visible_devices(device="cuda") -> List[torch.device]:
    """The devices of this type a mesh may use, in order: every visible
    GPU, or CPU_SHARDS virtual devices of the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")] * CPU_SHARDS
    raise ValueError(f"no mesh over {device}")


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DeviceMesh:
    """The first n_devices visible devices of this type (all when None), as
    jax.devices()[:n] does. Raises when fewer exist."""
    devs = visible_devices(device)
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devs):
        raise ValueError(f"a mesh of {n} {torch.device(device).type} devices: "
                         f"{len(devs)} visible")
    return DeviceMesh(devs[:n])


def config_mesh(n_devices: Optional[int], device, what: str) -> Optional[DeviceMesh]:
    """The mesh a config asks for, under the JAX package's rule: several
    devices when n_devices > 1 and that many exist (slam/gcslam.py:245),
    else None. Asking for more devices than exist warns, naming both
    counts, and runs on one."""
    if not n_devices or n_devices <= 1:
        return None
    have = len(visible_devices(device))
    if have < n_devices:
        warnings.warn(f"{what}: parallel.n_devices={n_devices} but {have} "
                      f"{torch.device(device).type} devices exist; running on one")
        return None
    return make_mesh(n_devices, device)


def tsdf_mesh(n_devices: Optional[int], device) -> Optional[DeviceMesh]:
    """The mesh parallel.tsdf_sharded asks for, under the JAX package's
    rule (fusion/pipeline.py:103-115): shard only when more than one
    device of this type exists, over the first n_devices (all when None);
    asking for more than exist warns, naming both counts, and takes them
    all, as jax.devices()[:n] does."""
    have = len(visible_devices(device))
    n = n_devices or have
    if n > have:
        warnings.warn(f"ReconstructionPipeline: parallel.n_devices={n} but {have} "
                      f"{torch.device(device).type} devices exist; "
                      + (f"sharding over {have}" if have > 1 else "running on one"))
        n = have
    return make_mesh(n, device) if n > 1 else None


def shard_leading(mesh: DeviceMesh, n: int) -> List[slice]:
    """The ranges of a leading dimension of size n that the shards hold
    when it is split in contiguous blocks (NamedSharding(P(axis))); n must
    divide by the mesh size."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} shards")
    b = n // mesh.size
    return [slice(k * b, (k + 1) * b) for k in range(mesh.size)]


def replicated(mesh: DeviceMesh, n: int) -> List[slice]:
    """Every shard holds the whole dimension (NamedSharding(P())). Kept
    beside shard_leading as the JAX module's other descriptor; nothing in
    the port calls it, since a replicated tensor is one `replicate` away."""
    return [slice(0, n)] * mesh.size


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up. A no-op in one process without a coordinator,
    as in the JAX package; with one it raises, because a single-controller
    mesh cannot span hosts (ROADMAP: multi-host)."""
    if coordinator is not None:
        raise NotImplementedError(
            "multi-host meshes are not ported: a DeviceMesh is driven by one process "
            f"(coordinator {coordinator!r}, {num_processes} processes, id {process_id})")
