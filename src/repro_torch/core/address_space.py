"""The partitioned global address space (paper Sec. II-A3).

A ``GlobalAddressSpace`` names a global word array of
``num_kernels * segment_words`` words; kernel *k* owns words
``[k*segment_words, (k+1)*segment_words)``.  Locality is explicit: a
global address resolves to (owner kernel, local offset), and only
accesses to non-owned partitions become AMs.

Host-side helpers move data between a numpy/global view and the stacked
``(K, segment_words)`` segments on the context's device, which is how
applications (e.g. Jacobi) load initial conditions and read results.
Programs are written over the kernel axis directly, so there is no
per-kernel ``spmd`` wrapper.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.state import PgasState, ShoalContext, replace


@dataclasses.dataclass(frozen=True)
class GlobalAddressSpace:
    ctx: ShoalContext
    dtype: torch.dtype = torch.float32

    @property
    def segment_words(self) -> int:
        return self.ctx.segment_words

    @property
    def total_words(self) -> int:
        return self.ctx.num_kernels * self.ctx.segment_words

    # -- addressing -------------------------------------------------------

    def owner_of(self, gaddr: int) -> int:
        return gaddr // self.segment_words

    def local_offset(self, gaddr: int) -> int:
        return gaddr % self.segment_words

    def global_addr(self, kernel: int, offset: int) -> int:
        if not 0 <= kernel < self.ctx.num_kernels:
            raise ValueError(
                f"global_addr: kernel {kernel} out of range "
                f"(num_kernels={self.ctx.num_kernels})")
        if not 0 <= offset < self.segment_words:
            # an out-of-range offset would silently alias into another
            # kernel's partition of the flat global word array
            would_own = (kernel * self.segment_words + offset) \
                // self.segment_words
            raise ValueError(
                f"global_addr: offset {offset} outside the "
                f"{self.segment_words}-word segment owned by kernel "
                f"{kernel}; the aliased address would land in kernel "
                f"{would_own}'s partition at local offset "
                f"{offset % self.segment_words}")
        return kernel * self.segment_words + offset

    def check_local_range(self, kernel: int, offset: int, nwords: int) -> int:
        """Validate that ``[offset, offset + nwords)`` stays inside
        ``kernel``'s segment; returns ``offset``."""
        self.global_addr(kernel, offset)
        if nwords < 0 or offset + nwords > self.segment_words:
            raise ValueError(
                f"range [{offset}, {offset + nwords}) overruns kernel "
                f"{kernel}'s {self.segment_words}-word segment")
        return offset

    def vectored_addrs(self, kernel: int, base: int, block_words,
                       *, stride: int | None = None) -> list[int]:
        """Per-block local addresses for a vectored put into ``kernel``:
        blocks land back-to-back from ``base`` unless ``stride`` pins a
        fixed distance between block starts.  Every block is validated
        against the segment bounds."""
        addrs, off = [], base
        for i, w in enumerate(block_words):
            a = base + i * stride if stride is not None else off
            self.check_local_range(kernel, a, int(w))
            addrs.append(a)
            off = a + int(w)
        return addrs

    # -- host <-> device views ---------------------------------------------

    def make_global_state(self, init: np.ndarray | None = None) -> PgasState:
        """A zero state for all kernels on the context's device, its
        segments optionally loaded from the flat ``init`` array."""
        st = self.ctx.make_state(self.dtype)
        if init is None:
            return st
        init = np.asarray(init)
        if init.size != self.total_words:
            raise ValueError(
                f"init has {init.size} words, address space has "
                f"{self.total_words}")
        seg = torch.from_numpy(np.ascontiguousarray(init).reshape(
            self.ctx.num_kernels, self.segment_words))
        return replace(st, segment=seg.to(device=self.ctx.device,
                                          dtype=self.dtype))

    def read_global(self, state: PgasState) -> np.ndarray:
        """The whole address space on the host, kernel order."""
        return state.segment.detach().cpu().numpy().reshape(-1)
