"""The Jacobi stencil application on Shoal (paper Sec. IV-C).

The grid (N x N) is row-partitioned over kernels.  Each iteration:

  1. every kernel one-sided-puts its first/last owned row into its
     neighbors' halo slots (Shoal Long puts -- *not* send/recv pairs;
     boundary kernels simply aren't in the pattern),
  2. waits for its own halos' replies (wait_replies = GASNet quiet),
  3. runs the von Neumann stencil over its band: one launch of the
     Jacobi kernel for all K bands (:mod:`repro_torch.kernels.jacobi`).

Segment layout per kernel: [0, N) = top halo row, [N, 2N) = bottom halo.
The bands live in a ``(K, rows+2, N)`` buffer whose first and last row
of every band hold the halos; the stencil writes the interior of a
second such buffer and the two swap every iteration.

Halo rows longer than the transport's MTU (the paper's footnote-2 case:
a 4096-word row exceeds the 9000-byte jumbo frame) are segmented by
:func:`repro_torch.core.ops.put_long_multi`.

Steady-state wire plan on an acked transport (TCP): both halo puts go
through one ``put_long_multi`` call with ``defer_ack``; each
direction's data packet carries the *opposite* direction's acks home in
its piggyback lane (token 1 = up puts, token 2 = down puts).  An
iteration then costs exactly 2 exchanges, with iteration *k*'s acks
arriving on iteration *k+1*'s packets, so the waits are gated past the
first iteration and a pair of ``drain_deferred_acks`` after the loop
balances the books.  On an async transport (UDP) the halo puts go out
unacked: 2 exchanges per iteration and no drain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import handlers as hd
from repro_torch.core import ops
from repro_torch.core.address_space import GlobalAddressSpace
from repro_torch.core.state import PgasState, ShoalContext, resolve_device
from repro_torch.kernels.jacobi import jacobi_band_step, jacobi_step_ref
from repro_torch.runtime.transport import TCP, Transport


@dataclasses.dataclass
class JacobiApp:
    n: int                    # grid is n x n
    kernels: int
    iters: int
    transport: Transport = TCP
    device: object = None     # None: the CUDA card

    def __post_init__(self):
        if self.n % self.kernels:
            raise ValueError(f"grid {self.n} does not split over "
                             f"{self.kernels} kernels")
        self.rows = self.n // self.kernels
        self.ctx = ShoalContext(self.kernels, transport=self.transport,
                                segment_words=2 * self.n,
                                device=self.device)
        k = self.kernels
        self.up = [(i, i - 1) for i in range(1, k)]      # send top row up
        self.down = [(i, i + 1) for i in range(k - 1)]   # send bottom row down

    @property
    def _use_piggyback(self) -> bool:
        return self.transport.acked and self.kernels > 1

    def _halo_exchange(self, st: PgasState, block: torch.Tensor,
                       it=None) -> PgasState:
        n = self.n
        if self.kernels == 1:
            return st
        # my top row -> upper neighbor's *bottom* halo [n, 2n);
        # my bottom row -> lower neighbor's *top* halo [0, n)
        items = [(block[:, 0], self.up, n), (block[:, -1], self.down, 0)]
        if not self._use_piggyback:
            # async transport: fire-and-forget halos, no credit to wait on
            return ops.put_long_multi(self.ctx, st, items, handler=hd.H_WRITE,
                                      tokens=[1, 2], asynchronous=True)
        me = self.ctx.my_id()
        has_down = (me < self.kernels - 1).to(torch.int32)
        has_up = (me > 0).to(torch.int32)
        # Steady state: no reply exchanges at all.  Receivers ledger the
        # acks and each direction's data packet carries the OPPOSITE
        # direction's ledgered acks home (pb_token=2 on up).
        st = ops.put_long_multi(self.ctx, st, items, handler=hd.H_WRITE,
                                tokens=[1, 2], defer_ack=True,
                                piggyback_tokens=[2, 1])
        # iteration k's ack rides iteration k+1's packet: wait only from
        # the second iteration on (drain after the loop)
        ready = int(it is not None and it > 0)
        st = ops.wait_replies(self.ctx, st, 1, has_up * ready)
        return ops.wait_replies(self.ctx, st, 2, has_down * ready)

    def _drain_acks(self, st: PgasState) -> PgasState:
        """Loop exit for the piggyback plan: the last iteration's acks
        are still ledgered at the halo receivers; ship them home and
        consume the final credit."""
        if not self._use_piggyback:
            return st
        me = self.ctx.my_id()
        st = ops.drain_deferred_acks(self.ctx, st, self.down, token=1)
        st = ops.drain_deferred_acks(self.ctx, st, self.up, token=2)
        st = ops.wait_replies(self.ctx, st, 1, (me > 0).to(torch.int32))
        st = ops.wait_replies(self.ctx, st, 2,
                              (me < self.kernels - 1).to(torch.int32))
        return st

    def _stencil(self, block_pad: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        """block_pad: (K, rows+2, n) with halo rows attached; band k is
        global rows k*rows ...  One kernel launch for all bands."""
        return jacobi_band_step(block_pad, out)

    def _iteration(self, st: PgasState, pad: torch.Tensor,
                   nxt: torch.Tensor, it=None) -> PgasState:
        """Exchange halos, attach them to ``pad``'s bands and write the
        swept bands into the interior of ``nxt``."""
        n = self.n
        kid = self.ctx.my_id()[:, None]
        st = self._halo_exchange(st, pad[:, 1:-1], it)
        # boundary kernels have no halo: zero rows (masked anyway)
        pad[:, 0] = torch.where(kid > 0, st.segment[:, :n], 0)
        pad[:, -1] = torch.where(kid < self.kernels - 1,
                                 st.segment[:, n:2 * n], 0)
        self._stencil(pad, nxt[:, 1:-1])
        return ops.barrier(self.ctx, st)

    # -- host-level driver --------------------------------------------------

    def run_blocks(self, st: PgasState, blocks: torch.Tensor):
        """All iterations on ``blocks (K, rows, n)``; returns the final
        ``(state, blocks)``."""
        pad = torch.zeros((self.kernels, self.rows + 2, self.n),
                          dtype=blocks.dtype, device=self.ctx.device)
        pad[:, 1:-1] = blocks
        nxt = torch.zeros_like(pad)
        for it in range(self.iters):
            st = self._iteration(st, pad, nxt, it)
            pad, nxt = nxt, pad
        return self._drain_acks(st), pad[:, 1:-1]

    def run(self, grid: np.ndarray) -> np.ndarray:
        """Run on a host grid (n, n); returns the final grid."""
        gas = GlobalAddressSpace(self.ctx)
        st = gas.make_global_state()
        blocks = torch.from_numpy(np.ascontiguousarray(grid, np.float32))
        blocks = blocks.reshape(self.kernels, self.rows, self.n).to(
            self.ctx.device)
        _, out = self.run_blocks(st, blocks)
        return out.cpu().numpy().reshape(self.n, self.n)


def jacobi_reference(grid: np.ndarray, iters: int,
                     device=None) -> np.ndarray:
    """Single-kernel oracle: the plain full-grid step, ``iters`` times,
    on ``device`` (default: the CUDA card)."""
    x = torch.from_numpy(np.ascontiguousarray(grid, np.float32)).to(
        resolve_device(device))
    for _ in range(iters):
        x = jacobi_step_ref(x)
    return x.cpu().numpy()
