"""Device mesh of the 2-D lat-lon domain decomposition.

Port of ``climate_model_tpu/dist/mesh.py``. A ``(mesh_lat, mesh_lon)`` mesh
with longitude innermost: shard ``s`` is ``(lat_idx, lon_idx) =
divmod(s, mesh_lon)``. Placement is explicit, never guessed:

* ``torch.distributed`` initialised with ``world_size == mesh_lat *
  mesh_lon``: each rank owns the shard of its rank (NCCL on ``cuda``, gloo
  on ``cpu``, as the caller initialised the process group);
* not initialised: every shard runs in this process, on the one device the
  caller named (the counterpart of the reference's virtual-device mesh);
* any other world size raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as tdist

from ..core.config import ModelConfig

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(n_lat, n_lon)`` mesh and where its shards run."""

    n_lat: int
    n_lon: int
    device: torch.device
    rank: int | None = None      # this process's shard; None: all of them

    @property
    def size(self) -> int:
        return self.n_lat * self.n_lon

    def index(self, shard: int) -> tuple:
        """``(lat_idx, lon_idx)`` of ``shard``."""
        return divmod(shard, self.n_lon)

    def shard(self, lat_idx: int, lon_idx: int) -> int:
        """The shard at ``(lat_idx, lon_idx)``; lon is a periodic ring."""
        return lat_idx * self.n_lon + lon_idx % self.n_lon

    @property
    def local_shards(self) -> list:
        return list(range(self.size)) if self.rank is None else [self.rank]

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    def describe(self) -> str:
        if self.rank is None:
            return f"{self.size} shards on 1 device ({self.device})"
        return (f"1 shard per rank, {self.size} ranks "
                f"({tdist.get_backend()}), rank {self.rank} on "
                f"{self.device}")


def make_mesh(cfg: ModelConfig = None, mesh_lat: int = None,
              mesh_lon: int = None, device="cuda") -> Mesh:
    """The mesh of ``cfg`` (or of the extents given), placed by the rule of
    the module docstring."""
    if cfg is not None:
        mesh_lat = mesh_lat or cfg.sharding.mesh_lat
        mesh_lon = mesh_lon or cfg.sharding.mesh_lon
    mesh_lat, mesh_lon = mesh_lat or 1, mesh_lon or 1
    device = torch.device(device)
    if tdist.is_available() and tdist.is_initialized():
        world = tdist.get_world_size()
        if world != mesh_lat * mesh_lon:
            raise ValueError(
                f"mesh {mesh_lat}x{mesh_lon} needs {mesh_lat * mesh_lon} "
                f"ranks (one shard each), but torch.distributed has {world}")
        return Mesh(mesh_lat, mesh_lon, device, rank=tdist.get_rank())
    return Mesh(mesh_lat, mesh_lon, device)


def validate_divisibility(cfg: ModelConfig, mesh: Mesh):
    gc = cfg.grid
    if gc.ny % mesh.n_lat or gc.nx % mesh.n_lon:
        raise ValueError(f"grid {gc.ny}x{gc.nx} not divisible by mesh "
                         f"{mesh.n_lat}x{mesh.n_lon}")
