"""HUMboldt: the two-sided baseline (paper Sec. II-C3), PyTorch port.

HUMboldt is the MPI-like protocol previously built on Galapagos that the
paper contrasts with Shoal's one-sided AMs.  Its exchange is a 4-phase
rendezvous:

    1. sender  -> receiver : request
    2. receiver -> sender  : clear-to-send (ack)
    3. sender  -> receiver : data
    4. receiver -> sender  : completion

i.e. four link traversals (two round trips) where an async Shoal put
needs one and an acked put two -- the one-sided advantage the PGAS
model buys, the paper's central performance argument (Secs. II-A3,
II-C3).
"""

from __future__ import annotations

import torch

from repro_torch.core import am
from repro_torch.core import gascore as gc
from repro_torch.core import ops
from repro_torch.core.state import PgasState, ShoalContext


def sendrecv(ctx: ShoalContext, state: PgasState, payload: torch.Tensor,
             pattern: ops.Pattern, *, token: int = 0):
    """HUM_Send/HUM_Recv pair, collectivised: kernels on the source side
    of ``pattern`` send their row of ``payload (K, ...)``; destination
    kernels receive it.

    Returns ``(state, received)`` with ``received (K, nwords)``, zero on
    kernels that receive nothing.  Costs 4 link traversals per packet
    (vs 1-2 for a Shoal put); the completion bumps the sender's credit
    on ``token``, so ``ops.wait_replies`` works as after an acked put.
    """
    K = ctx.num_kernels
    flat = payload.reshape(K, -1)
    nwords = flat.shape[1]
    limit = ctx.transport.max_packet_words
    rev = ops._reverse(pattern)
    parts = []
    for off, w in ops._segments(nwords, limit):
        # 1. request (header-only, async: the protocol's own acks follow)
        hdr = am.encode(
            type=am.make_type(am.SHORT, asynchronous=True),
            src=ctx.my_id(), dst=ops._dst_of(ctx, pattern), nwords=w,
            token=token, seq=off)
        hdr = ops._mask_nonparticipants(ctx, pattern, hdr)
        req, _ = ops._exchange(ctx, pattern, hdr, None)
        # 2. clear-to-send back to the sender
        req_h = am.decode(req)
        cts = am.encode(
            type=am.make_type(am.SHORT, asynchronous=True),
            src=req_h.dst, dst=req_h.src, nwords=req_h.nwords, token=token)
        cts = torch.where((req_h.msg_class == am.SHORT)[:, None], cts, 0)
        cts_back, _ = ops._exchange(ctx, rev, cts, None)
        # 3. data (sender may proceed only once cleared: data dependence
        #    on the CTS header enforces the ordering the threads had)
        cleared = am.decode(cts_back).msg_class == am.SHORT
        chunk = flat[:, off:off + w]
        data_hdr = am.encode(
            type=am.make_type(am.MEDIUM, asynchronous=True, fifo=True),
            src=ctx.my_id(), dst=ops._dst_of(ctx, pattern), nwords=w,
            token=token, seq=off)
        data_hdr = torch.where(cleared[:, None], data_hdr, 0)
        data_hdr = ops._mask_nonparticipants(ctx, pattern, data_hdr)
        buf = chunk * cleared.to(chunk.dtype)[:, None]
        dh, dp = ops._exchange(ctx, pattern, data_hdr, buf)
        dhh = am.decode(dh)
        state, part = gc.ingress_medium(state, dhh, dp, w)
        # 4. completion back to the sender (bumps the sender's credits,
        #    so wait_replies works identically across both libraries)
        comp = am.encode(
            type=am.make_type(am.SHORT, asynchronous=True, reply=True),
            src=dhh.dst, dst=dhh.src, token=token)
        comp = torch.where((dhh.msg_class == am.MEDIUM)[:, None], comp, 0)
        comp_back, _ = ops._exchange(ctx, rev, comp, None)
        state = gc.ingress_reply(state, am.decode(comp_back))
        parts.append(part)
    received = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return state, received


HOPS_PER_MESSAGE = 4  # link traversals per segment, for latency models
