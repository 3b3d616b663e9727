"""Device meshes (counterpart of ``repro.launch.mesh``): the 1-D mesh of
sharded spectral inference (``make_spectral_mesh``) and the named-axis
host mesh of the LM's expert parallelism (``make_host_mesh``).

A mesh is a grid of ``torch.device``s, driven from one process: the
sharded executor (``distributed.executor``) and ``models.moe.forward_ep``
run every shard themselves and move inputs and partial sums between the
devices.  A device may appear more than once, but only when the caller
names the devices: ``(cuda:0,) * 4`` runs four shards one after another
on one card, ``(cpu,) * 8`` runs them on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _cuda_devices(n: int, what: str) -> list[torch.device]:
    """The first ``n`` CUDA devices; ValueError when there are fewer."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"need {n} CUDA devices for the {what}, have {have}; to run "
            f"several shards on one device, name the devices "
            f"(devices=[torch.device('cuda', 0)] * {n})")
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class SpectralMesh:
    """A 1-D mesh: ``devices[d]`` runs shard d."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_spectral_mesh(n_shards: int, *, devices=None) -> SpectralMesh:
    """A mesh of ``n_shards`` devices.

    With ``devices=None`` it takes the first ``n_shards`` CUDA devices and
    raises ValueError when there are fewer (a mesh never repeats a device
    on its own).  ``devices`` names them explicitly, ``n_shards`` of them,
    and may repeat one (several shards on one card, or on the CPU).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = _cuda_devices(n_shards, "spectral mesh")
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_shards:
        raise ValueError(f"a mesh of {n_shards} shards needs {n_shards} "
                         f"devices, got {len(devices)}")
    return SpectralMesh(devices=devices)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A mesh with named axes: ``devices`` is a grid of nested tuples,
    one level per axis of ``axis_names``, in row-major order."""

    axis_names: tuple[str, ...]
    devices: tuple

    @property
    def shape(self) -> tuple[int, ...]:
        shape, level = [], self.devices
        for _ in self.axis_names:
            shape.append(len(level))
            level = level[0]
        return tuple(shape)

    def device_at(self, coord: tuple[int, ...]) -> torch.device:
        level = self.devices
        for i in coord:
            level = level[i]
        return level


def make_host_mesh(shape: tuple[int, ...] = (1, 1),
                   axes: tuple[str, ...] = ("data", "model"), *,
                   devices=None) -> HostMesh:
    """A mesh of ``shape`` over the named ``axes``.

    With ``devices=None`` it takes the first prod(shape) CUDA devices and
    raises ValueError when there are fewer.  ``devices`` names them
    explicitly, prod(shape) of them in row-major order, and may repeat
    one (several shards on one card, or on the CPU)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n = math.prod(shape)
    if devices is None:
        devices = _cuda_devices(n, "host mesh")
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, got "
                         f"{len(devices)}")
    grid = devices
    for size in reversed(shape[1:]):
        grid = [tuple(grid[i:i + size]) for i in range(0, len(grid), size)]
    return HostMesh(axis_names=axes, devices=tuple(grid))


def mesh_shape_dict(mesh: HostMesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))
