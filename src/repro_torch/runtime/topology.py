"""Cluster topology: the Galapagos cluster-description analogue, its
pure-Python half.

Galapagos turns user configuration files into a deployed cluster of
CPU/FPGA nodes, each holding one or more kernels.  A :class:`ClusterSpec`
describes such a cluster as named axes (pods x chips x ...); a Shoal
kernel's ID is its row-major index over the kernel axes.  The port keeps
the kernels on one device's leading axis, so there is no mesh to build:
the spec only places kernels, for link classification
(:mod:`repro_torch.runtime.router`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Static description of a cluster (the Galapagos config-file analogue).

    Attributes:
      mesh_shape: devices per named axis, e.g. ``(2, 16, 16)``.
      axis_names: names per axis, e.g. ``("pod", "data", "model")``.
      kernel_axes: the axes over which Shoal kernels are enumerated.  By
        default all axes: every device is one kernel.
      pod_axis: name of the inter-pod (DCN) axis, or None for single-pod.
    """

    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    kernel_axes: tuple[str, ...] | None = None
    pod_axis: str | None = None

    def __post_init__(self):
        if len(self.mesh_shape) != len(self.axis_names):
            raise ValueError("mesh_shape and axis_names must have equal length")
        if self.kernel_axes is None:
            object.__setattr__(self, "kernel_axes", tuple(self.axis_names))
        for ax in self.kernel_axes:
            if ax not in self.axis_names:
                raise ValueError(f"kernel axis {ax!r} not in {self.axis_names}")
        if self.pod_axis is not None and self.pod_axis not in self.axis_names:
            raise ValueError(f"pod axis {self.pod_axis!r} not in {self.axis_names}")

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh_shape)

    @property
    def num_kernels(self) -> int:
        n = 1
        for ax, size in zip(self.axis_names, self.mesh_shape):
            if ax in self.kernel_axes:
                n *= size
        return n

    def axis_size(self, name: str) -> int:
        return self.mesh_shape[self.axis_names.index(name)]


def kernel_coords(spec: ClusterSpec, kernel_id: int) -> dict[str, int]:
    """kernel ID -> per-axis coordinates (row-major over kernel_axes)."""
    sizes = [spec.axis_size(a) for a in spec.kernel_axes]
    coords: dict[str, int] = {}
    rem = kernel_id
    for ax, size in zip(reversed(spec.kernel_axes), reversed(sizes)):
        coords[ax] = rem % size
        rem //= size
    if rem:
        raise ValueError(f"kernel id {kernel_id} out of range")
    return coords


def pod_of(spec: ClusterSpec, kernel_id: int) -> int:
    """Which pod a kernel lives on (0 if single-pod)."""
    if spec.pod_axis is None or spec.pod_axis not in spec.kernel_axes:
        return 0
    return kernel_coords(spec, kernel_id)[spec.pod_axis]


def neighbors_ring(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """Ring permutation pattern (the workhorse of ring collectives)."""
    return [(i, (i + shift) % n) for i in range(n)]


def pairwise(pairs: Sequence[tuple[int, int]]) -> list[tuple[int, int]]:
    """Validate an explicit src->dst pattern (each src/dst at most once,
    mirroring one outstanding AM per kernel per call)."""
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError("pattern must have unique sources and destinations")
    return list(pairs)
