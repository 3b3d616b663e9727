"""The device mesh of sharded spectral inference (counterpart of
``repro.launch.mesh.make_spectral_mesh``).

The mesh is a tuple of ``torch.device``s, driven from one process: the
sharded executor (``distributed.executor``) runs every shard itself and
moves the bands, halo rows and partial sums between the devices.  A
device may appear more than once, but only when the caller names the
devices: ``(cuda:0,) * 4`` runs four shards one after another on one
card, ``(cpu,) * 8`` runs them on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


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
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise ValueError(
                f"need {n_shards} CUDA devices for the spectral mesh, have "
                f"{have}; to run several shards on one device, name the "
                f"devices (devices=[torch.device('cuda', 0)] * {n_shards})")
        devices = [torch.device("cuda", i) for i in range(n_shards)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_shards:
        raise ValueError(f"a mesh of {n_shards} shards needs {n_shards} "
                         f"devices, got {len(devices)}")
    return SpectralMesh(devices=devices)
