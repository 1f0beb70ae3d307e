"""Active Message wire format (paper Sec. III-A): fused single packets.

On the wire a Shoal message is ``header ++ payload`` in ONE typed
stream, as the hardware GAScore parses a single AXIS burst.  A *packet*
is one int32 vector

    [ header (16 words) | extra (optional int32 section) | payload bits ]

where the payload's 32-bit lanes are bitcast to int32 (lossless both
ways), so a whole AM crosses a link in a single exchange.  For >MTU AMs
the op layer stacks ``nseg`` such packets into a
``(..., nseg, HDR_WORDS + packet_words)`` matrix and still ships them
with one exchange.  Every function here takes leading batch axes (the
kernel axis ``K``, the segment axis) and works on the last one.

Word layout::

    0  type      class (NOP/SHORT/MEDIUM/LONG) | flag bits
    1  src       source kernel ID
    2  dst       destination kernel ID
    3  nwords    payload length in words
    4  dst_addr  destination segment word offset (Long), handler arg0 (Short)
    5  src_addr  source segment word offset (get / memory-sourced put)
    6  handler   handler-table index
    7  token     reply/credit counter index
    8  stride    words between strided blocks
    9  blk_words words per strided block
    10 nblocks   number of strided blocks
    11 seq       segment sequence number (word offset) for >MTU segmentation
    12 pb_token  piggyback lane: token whose deferred acks ride this packet
    13 pb_count  piggyback lane: number of deferred acks carried
    14 epoch     send epoch: per-(src, token) message counter for dedup
    15 crc       integrity word over the whole packet (see seal_packet)

An all-zero header is an explicit NOP: kernels that do not take part in
an exchange receive zeros and must take no action and send no reply.
Replies coalesce across segmentation (every segment but the last is
async); a ``FLAG_DEFER_ACK`` message asks the receiver to ledger its
ack, and a later packet on the reverse link carries it home in the
piggyback lane (``FLAG_PIGGYBACK`` + ``pb_token``/``pb_count``).
"""

from __future__ import annotations

import dataclasses

import torch

HDR_WORDS = 16

# -- message classes (word 0, low 3 bits) ------------------------------------
NOP = 0
SHORT = 1
MEDIUM = 2
LONG = 3
_CLASS_MASK = 0x7

# -- flags (word 0, high bits) ------------------------------------------------
FLAG_ASYNC = 1 << 3      # no auto-reply (UDP-like; paper Sec. III-A)
FLAG_GET = 1 << 4        # get request (data flows dst -> src)
FLAG_FIFO = 1 << 5       # payload from kernel, not from shared memory
FLAG_STRIDED = 1 << 6    # strided Long
FLAG_VECTORED = 1 << 7   # vectored Long
FLAG_REPLY = 1 << 8      # this message is an auto-generated reply
FLAG_PIGGYBACK = 1 << 9  # pb_token/pb_count carry deferred acks home
FLAG_DEFER_ACK = 1 << 10  # receiver ledgers the ack instead of replying

FIELDS = (
    "type", "src", "dst", "nwords", "dst_addr", "src_addr",
    "handler", "token", "stride", "blk_words", "nblocks", "seq",
    "pb_token", "pb_count", "epoch", "crc",
)
if len(FIELDS) != HDR_WORDS:
    raise AssertionError("header layout must have HDR_WORDS fields")


@dataclasses.dataclass(frozen=True)
class Header:
    """Decoded header; every field is an int32 tensor of the batch shape
    (``()``, ``(K,)`` or ``(K, nseg)``)."""

    type: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    nwords: torch.Tensor
    dst_addr: torch.Tensor
    src_addr: torch.Tensor
    handler: torch.Tensor
    token: torch.Tensor
    stride: torch.Tensor
    blk_words: torch.Tensor
    nblocks: torch.Tensor
    seq: torch.Tensor
    pb_token: torch.Tensor
    pb_count: torch.Tensor
    epoch: torch.Tensor
    crc: torch.Tensor

    @property
    def msg_class(self) -> torch.Tensor:
        return self.type & _CLASS_MASK

    def flag(self, bit: int) -> torch.Tensor:
        return (self.type & bit) != 0


def make_type(msg_class: int, *, asynchronous=False, get=False, fifo=False,
              strided=False, vectored=False, reply=False,
              defer_ack=False) -> int:
    t = msg_class & _CLASS_MASK
    if asynchronous:
        t |= FLAG_ASYNC
    if get:
        t |= FLAG_GET
    if fifo:
        t |= FLAG_FIFO
    if strided:
        t |= FLAG_STRIDED
    if vectored:
        t |= FLAG_VECTORED
    if reply:
        t |= FLAG_REPLY
    if defer_ack:
        t |= FLAG_DEFER_ACK
    return t


def _assemble(fields: dict, tail: tuple[int, ...]) -> torch.Tensor:
    """Headers from int fields (filled on the device: no host-to-device
    copy) and tensor fields (one column copy each), broadcast together
    with ``tail``."""
    unknown = set(fields) - set(FIELDS)
    if unknown:
        raise ValueError(f"unknown header fields: {unknown}")
    device = next((v.device for v in fields.values() if torch.is_tensor(v)),
                  None)
    consts = [0] * HDR_WORDS
    cols = {}
    for i, f in enumerate(FIELDS):
        v = fields.get(f, 0)
        if isinstance(v, int):
            consts[i] = v
        else:
            cols[i] = torch.as_tensor(v, dtype=torch.int32, device=device)
    shape = torch.broadcast_shapes(*(c.shape for c in cols.values()), tail)
    out = torch.zeros((*shape, HDR_WORDS), dtype=torch.int32, device=device)
    for i, v in enumerate(consts):
        if v:
            out[..., i] = v
    for i, c in cols.items():
        out[..., i] = c
    return out


def encode(**fields) -> torch.Tensor:
    """Build int32 headers, ``(..., HDR_WORDS)``; every field is an int
    or a tensor and the fields broadcast together (``(K,)`` fields give
    one header per kernel).  Unspecified fields are zero."""
    return _assemble(fields, ())


def encode_batch(n: int, **fields) -> torch.Tensor:
    """Build ``n`` headers per batch entry: ``(..., n, HDR_WORDS)``.

    ``(n,)`` fields are per-row (per-segment offsets, types, ...), and
    per-kernel fields are passed as ``(K, 1)`` columns; scalars
    broadcast.  This is the header side of the batched >MTU
    segmentation plan: one matrix, one exchange.
    """
    return _assemble(fields, (n,))


def decode(hdr: torch.Tensor) -> Header:
    if hdr.shape[-1] != HDR_WORDS:
        raise ValueError(f"header must be (..., {HDR_WORDS}), "
                         f"got {tuple(hdr.shape)}")
    return Header(*(hdr[..., i] for i in range(HDR_WORDS)))


# --------------------------------------------------------------------------
# fused packets: header ++ [extra ++] payload in one int32 stream
# --------------------------------------------------------------------------

def wire_dtype_ok(dtype: torch.dtype) -> bool:
    """Payload dtypes that bitcast losslessly onto the int32 wire."""
    return dtype.itemsize == 4


def wire_words(dtype: torch.dtype, nwords) -> int:
    """32-bit words a payload of ``nwords`` ``dtype`` elements occupies
    on the wire (sub-32-bit payloads ship fewer words than elements)."""
    return -(-int(nwords) * dtype.itemsize // 4)


def to_wire(payload: torch.Tensor) -> torch.Tensor:
    """Bitcast a 32-bit payload onto int32 wire lanes (bit-exact)."""
    if payload.dtype == torch.int32:
        return payload
    if not wire_dtype_ok(payload.dtype):
        raise TypeError(
            f"fused packets need a 32-bit payload dtype, got {payload.dtype}")
    return payload.view(torch.int32)


def from_wire(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_wire`."""
    if dtype == torch.int32:
        return words
    return words.view(dtype)


def pack_packet(hdr: torch.Tensor, payload: torch.Tensor | None = None,
                extra: torch.Tensor | None = None) -> torch.Tensor:
    """Fuse ``header ++ [extra ++] payload`` into one int32 packet along
    the last axis (single packets and segment stacks alike)."""
    parts = [hdr.to(torch.int32)]
    if extra is not None:
        parts.append(extra.to(torch.int32))
    if payload is not None:
        parts.append(to_wire(payload))
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def unpack_packet(pkt: torch.Tensor, dtype: torch.dtype, n_extra: int = 0):
    """Split a fused packet back into ``(header, [extra,] payload)``;
    ``dtype`` is the payload dtype the trailing lanes bitcast back to."""
    hdr = pkt[..., :HDR_WORDS]
    pay = from_wire(pkt[..., HDR_WORDS + n_extra:], dtype)
    if n_extra:
        return hdr, pkt[..., HDR_WORDS:HDR_WORDS + n_extra], pay
    return hdr, pay


def reply_for(hdr: Header) -> torch.Tensor:
    """The automatic reply: a Short AM back to the source that bumps the
    source's credit counter for ``token`` (paper Sec. III-A)."""
    return encode(
        type=make_type(SHORT, asynchronous=True, reply=True),
        src=hdr.dst, dst=hdr.src, token=hdr.token,
    )


def is_nop(hdr: Header) -> torch.Tensor:
    return hdr.msg_class == NOP


# --------------------------------------------------------------------------
# packet integrity: the crc header word (lossy-transport seal)
# --------------------------------------------------------------------------

_I_CRC = FIELDS.index("crc")
_U32 = 0xFFFFFFFF


def packet_crc(pkt: torch.Tensor) -> torch.Tensor:
    """Integrity word for a fused packet: XOR-fold of every lane, each
    rotated left by a lane-dependent amount in [1, 31]; the crc lane is
    excluded and an all-zero NOP packet folds to 0.

    The rotation runs on uint32 values held in int64 (torch's ``>>`` on
    int32 is arithmetic), then the fold is bitcast back to int32.
    Accepts ``(..., W)`` packets; returns the ``(...,)`` int32 fold.
    """
    u = pkt.to(torch.int32).to(torch.int64) & _U32
    lanes = torch.arange(pkt.shape[-1], dtype=torch.int64, device=pkt.device)
    rot = lanes % 31 + 1                        # in [1, 31]: both shifts legal
    rolled = ((u << rot) | (u >> (32 - rot))) & _U32
    rolled = torch.where(lanes == _I_CRC, 0, rolled)
    while rolled.shape[-1] > 1:                 # XOR tree over the lanes
        if rolled.shape[-1] % 2:
            rolled = torch.nn.functional.pad(rolled, (0, 1))
        half = rolled.shape[-1] // 2
        rolled = rolled[..., :half] ^ rolled[..., half:]
    fold = rolled[..., 0]
    return torch.where(fold >= 1 << 31, fold - (1 << 32), fold).to(
        torch.int32)


def seal_packet(pkt: torch.Tensor) -> torch.Tensor:
    """Stamp the crc header word of a fused ``(..., W)`` packet (or
    segment stack).  Idempotent: the crc lane is excluded from the fold."""
    out = pkt.clone()
    out[..., _I_CRC] = packet_crc(pkt)
    return out


def packet_crc_ok(pkt: torch.Tensor) -> torch.Tensor:
    """Per-packet bool: does the stored crc word match the fold?"""
    return pkt[..., _I_CRC] == packet_crc(pkt)
