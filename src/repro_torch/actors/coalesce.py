"""Bit-exact metadata-lane packing.

A recurring small-message pattern is an int sideband that travels next
to a payload exchange: MoE expert IDs alongside routed tokens, slot
indices alongside activations.  Shipping the sideband as its own
exchange doubles the message count; casting it into the payload dtype
silently corrupts values the mantissa cannot hold.  These helpers
*bitcast* ints into payload-typed lanes instead -- the same lossless
trick the fused wire format uses for payloads
(:func:`repro_torch.core.am.to_wire`) -- so the metadata rides INSIDE
the existing exchange as one extra lane, bit-exact both ways.

4-byte payload dtypes (float32/int32) carry a full int32 per lane;
2-byte dtypes (bfloat16/float16) carry an int16 per lane, so values
must fit in [-32768, 32767] (callers own the range contract; a value
outside it keeps its low 16 bits, as a cast to int16 does).
"""

from __future__ import annotations

import torch


def pack_meta_lane(meta: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Bitcast int metadata into lanes of ``dtype`` (the payload dtype).

    Returns a tensor of ``meta.shape`` and ``dtype`` whose *bits* are the
    metadata -- pass it through any bit-preserving transport and recover
    it with :func:`unpack_meta_lane`.
    """
    size = dtype.itemsize
    if size == 4:
        return meta.to(torch.int32).view(dtype)
    if size == 2:
        return meta.to(torch.int16).view(dtype)
    raise TypeError(
        f"cannot pack int metadata into {dtype} lanes (need 2- or 4-byte "
        "payload dtype)")


def unpack_meta_lane(lane: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_meta_lane`; always returns int32."""
    size = lane.dtype.itemsize
    if size == 4:
        return lane.view(torch.int32)
    if size == 2:
        return lane.view(torch.int16).to(torch.int32)
    raise TypeError(f"cannot unpack int metadata from {lane.dtype} lanes")
