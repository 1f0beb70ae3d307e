"""Disaggregated-serving slices of the kernel axis (the port of
``ServingSlices`` in ``repro.launch.mesh``).

On one card the kernel axis is the leading dimension of every state
leaf, so ``num_kernels`` sizes the ``ShoalContext`` and there is no
mesh.  The JAX package's mesh builders (``make_production_mesh``,
``dp_axes_of``, ``make_serving_mesh``) build XLA device meshes and have
no counterpart here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServingSlices:
    """Prefill/decode split of one kernel axis for disaggregated serving.

    The first ``n_prefill`` kernel IDs form the prefill slice, the next
    ``n_decode`` the decode slice; both live on ONE kernel axis, so a
    finished prefill's KV migrates decode-ward as a single one-sided
    vectored put along ``migration_pattern``.
    """

    n_prefill: int
    n_decode: int
    axis: str = "kernel"

    def __post_init__(self):
        if self.n_prefill < 1 or self.n_decode < 1:
            raise ValueError(
                f"serving slices need >= 1 kernel each, got "
                f"prefill={self.n_prefill} decode={self.n_decode}")

    @property
    def num_kernels(self) -> int:
        return self.n_prefill + self.n_decode

    @property
    def prefill_ids(self) -> tuple[int, ...]:
        return tuple(range(self.n_prefill))

    @property
    def decode_ids(self) -> tuple[int, ...]:
        return tuple(range(self.n_prefill, self.n_prefill + self.n_decode))

    def role_of(self, kernel: int) -> str:
        if kernel in self.prefill_ids:
            return "prefill"
        if kernel in self.decode_ids:
            return "decode"
        raise ValueError(f"kernel {kernel} outside the serving mesh "
                         f"({self.num_kernels} kernels)")

    def migration_pattern(self, prefill: int, decode: int):
        """The static ``[(src, dst)]`` a finished prefill's KV rides."""
        if prefill not in self.prefill_ids:
            raise ValueError(f"kernel {prefill} is not in the prefill "
                             f"slice {self.prefill_ids}")
        if decode not in self.decode_ids:
            raise ValueError(f"kernel {decode} is not in the decode "
                             f"slice {self.decode_ids}")
        return [(prefill, decode)]
