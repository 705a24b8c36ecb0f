"""Device mesh construction (counterpart of ggml_imax_tpu/parallel/mesh.py).

Where the JAX package lays out a jax.sharding.Mesh and lets GSPMD insert
the collectives, every rank here holds its own piece of each sharded array
and the parallel modules run the collectives themselves. The mesh is a
torch DeviceMesh over the ranks, dims ("dp", "tp"):

- "dp": data parallel (batch)
- "tp": tensor parallel (feature/head dims)

`named(mesh, *spec)` is the NamedSharding analog: a record of which mesh
axis cuts each dim and where this rank sits on it; `Named.piece` cuts this
rank's piece of an array.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .._device import resolve_device


def make_mesh(dp: int = 1, tp: int | None = None, device=None):
    """A (dp, tp) DeviceMesh over the process group's ranks (tp None: the
    ranks dp leaves)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    tp = tp or n // dp
    if dp * tp != n:
        raise ValueError(f"a ({dp}, {tp}) mesh over {n} ranks")
    return init_device_mesh(resolve_device(device).type, (dp, tp),
                            mesh_dim_names=("dp", "tp"))


def axis_coords(mesh, axis: str) -> tuple[int, int]:
    """(this rank's index along the mesh axis, the axis size)."""
    sub = mesh[axis]
    return sub.get_local_rank(), sub.size()


def piece(x: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    """Piece `index` of x cut evenly into `parts` along dim, as a fresh
    contiguous tensor (its own storage, so 16-byte aligned, and the whole
    is freed once its owner drops it)."""
    if x.shape[dim] % parts:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {parts}")
    w = x.shape[dim] // parts
    return x.narrow(dim, index * w, w).clone(
        memory_format=torch.contiguous_format)


@dataclass(frozen=True)
class Named:
    """Dim i of an array is cut evenly over mesh axis spec[i] (None: kept
    whole); coords[axis] is this rank's (index, size) on that axis."""
    spec: tuple
    coords: dict

    def piece(self, x: torch.Tensor) -> torch.Tensor:
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                x = piece(x, dim, *self.coords[axis])
        return x


def named(mesh, *spec) -> Named:
    return Named(tuple(spec),
                 {a: axis_coords(mesh, a) for a in spec if a is not None})
