"""Mesh shapes (mirrors src/repro/launch/mesh.py).

The reference builds jax meshes; the port's mesh is one process per
coordinate, joined into process groups by ``dist.groups.init_dp(rank,
shape.sizes, device, store, axes=shape.axis_names)``.  These functions
only describe the shape: calling them starts no process and touches no
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names (outermost first) and sizes."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512).

    Axes:
      pod   — inter-pod data parallelism (gradient reduction only)
      data  — intra-pod DP / FSDP
      model — tensor / expert / sequence parallelism
    """
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_test_mesh(ndev: int = 8) -> MeshShape:
    """The reference's small mesh: "model" is the first of 4, 2, 1 that
    divides ``ndev`` and "data" takes the rest (ndev=1 -> 1x1)."""
    if ndev < 1:
        raise ValueError(f"a mesh needs at least one device, got {ndev}")
    model = next(m for m in (4, 2, 1) if ndev % m == 0)
    return MeshShape((ndev // model, model), ("data", "model"))
