"""The PyTorch port's AM wire format against the JAX package's: headers,
fused packets and CRC seals must be bit-identical (tolerance: none)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import am as jam
from repro_torch.core import am as tam

field_vals = st.integers(min_value=0, max_value=2**20)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_layout_constants_match():
    assert tam.FIELDS == jam.FIELDS and tam.HDR_WORDS == jam.HDR_WORDS
    for name in ("NOP", "SHORT", "MEDIUM", "LONG", "FLAG_ASYNC", "FLAG_GET",
                 "FLAG_FIFO", "FLAG_STRIDED", "FLAG_VECTORED", "FLAG_REPLY",
                 "FLAG_PIGGYBACK", "FLAG_DEFER_ACK"):
        assert getattr(tam, name) == getattr(jam, name), name


@settings(max_examples=15, deadline=None)
@given(
    msg_class=st.sampled_from([jam.NOP, jam.SHORT, jam.MEDIUM, jam.LONG]),
    src=field_vals, dst=field_vals, nwords=field_vals, dst_addr=field_vals,
    handler=st.integers(0, 31), token=st.integers(0, 15),
    asynchronous=st.booleans(), get=st.booleans(), reply=st.booleans(),
    defer_ack=st.booleans(),
)
def test_header_bits_identical(msg_class, src, dst, nwords, dst_addr,
                               handler, token, asynchronous, get, reply,
                               defer_ack):
    flags = dict(asynchronous=asynchronous, get=get, reply=reply,
                 defer_ack=defer_ack)
    t = jam.make_type(msg_class, **flags)
    assert tam.make_type(msg_class, **flags) == t
    fields = dict(type=t, src=src, dst=dst, nwords=nwords,
                  dst_addr=dst_addr, handler=handler, token=token)
    want = np.asarray(jam.encode(**fields))
    got = tam.encode(**fields)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    h = tam.decode(got)
    for f in tam.FIELDS:
        assert int(getattr(h, f)) == int(getattr(jam.decode(
            jnp.asarray(want)), f)), f
    np.testing.assert_array_equal(_np(tam.reply_for(h)),
                                  np.asarray(jam.reply_for(jam.decode(
                                      jnp.asarray(want)))))


def test_encode_batch_kernel_axis():
    """Per-kernel ``(K, 1)`` columns and per-row ``(n,)`` fields broadcast
    to a ``(K, n, HDR)`` stack equal to the reference's per-kernel rows."""
    K, n = 3, 4
    me = torch.arange(K, dtype=torch.int32)
    offs = torch.arange(n, dtype=torch.int32) * 16
    got = tam.encode_batch(n, type=tam.make_type(tam.LONG), src=me[:, None],
                           dst=(me[:, None] + 1) % K, nwords=16,
                           dst_addr=offs + 7, seq=offs)
    assert tuple(got.shape) == (K, n, tam.HDR_WORDS)
    for k in range(K):
        want = jam.encode_batch(n, type=jam.make_type(jam.LONG), src=k,
                                dst=(k + 1) % K, nwords=16,
                                dst_addr=jnp.arange(n) * 16 + 7,
                                seq=jnp.arange(n) * 16)
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want))
    with pytest.raises(ValueError):
        tam.encode_batch(2, bogus=1)


_DTYPES = ((np.float32, torch.float32, jnp.float32),
           (np.int32, torch.int32, jnp.int32))


@settings(max_examples=8, deadline=None)
@given(dtype_i=st.integers(0, 1), n_extra=st.integers(0, 4),
       nseg=st.integers(1, 4), width=st.integers(1, 9))
def test_packets_and_crc_bit_identical(dtype_i, n_extra, nseg, width):
    """Fused packets, their CRC fold, the sealed packet and the seal
    check equal the reference bit for bit over dtype x extra-section
    length x segment count x width, for payload bit patterns that are
    NaN/denormal as f32 (the wire is a bitcast)."""
    np_dt, t_dt, j_dt = _DTYPES[dtype_i]
    rng = np.random.default_rng(
        7 + dtype_i * 1000 + n_extra * 100 + nseg * 10 + width)
    pay_np = rng.integers(0, 2**32, size=(nseg, width),
                          dtype=np.uint32).view(np_dt)
    extra_np = rng.integers(0, 2**20, size=(nseg, n_extra), dtype=np.int32)
    t = jam.make_type(jam.LONG, fifo=True, vectored=n_extra > 0)
    kw = dict(type=t, nblocks=n_extra, epoch=int(rng.integers(0, 2**31)),
              token=3)
    jhdr = jam.encode_batch(nseg, nwords=jnp.full((nseg,), width),
                            seq=jnp.arange(nseg) * width, **kw)
    thdr = tam.encode_batch(nseg, nwords=width,
                            seq=torch.arange(nseg) * width, **kw)
    jextra = jnp.asarray(extra_np) if n_extra else None
    textra = torch.from_numpy(extra_np) if n_extra else None
    jpkt = jam.pack_packet(jhdr, jnp.asarray(pay_np, j_dt), jextra)
    tpkt = tam.pack_packet(thdr, torch.from_numpy(pay_np), textra)
    assert tpkt.dtype == torch.int32
    np.testing.assert_array_equal(_np(tpkt), np.asarray(jpkt))
    out = tam.unpack_packet(tpkt, t_dt, n_extra)
    pay2 = out[-1]
    assert pay2.dtype == t_dt
    assert _np(pay2).tobytes() == pay_np.tobytes()
    if n_extra:
        np.testing.assert_array_equal(_np(out[1]), extra_np)
    np.testing.assert_array_equal(_np(tam.packet_crc(tpkt)),
                                  np.asarray(jam.packet_crc(jpkt)))
    sealed = tam.seal_packet(tpkt)
    np.testing.assert_array_equal(_np(sealed),
                                  np.asarray(jam.seal_packet(jpkt)))
    assert bool(tam.packet_crc_ok(sealed).all())
    flipped = sealed.clone()
    flipped[..., -1] ^= 1 << int(rng.integers(0, 31))
    assert not bool(tam.packet_crc_ok(flipped).any())


@pytest.mark.parametrize("width", [1, 33, 2266])
def test_crc_wide_packets_bit_identical(width):
    """The XOR fold over long packets (a full 9000-byte frame plus its
    header is 2266 lanes) keeps every rotation amount's bits."""
    rng = np.random.default_rng(width)
    pkt = rng.integers(-2**31, 2**31, size=(3, width), dtype=np.int64)
    pkt = pkt.astype(np.int32)
    np.testing.assert_array_equal(
        _np(tam.packet_crc(torch.from_numpy(pkt))),
        np.asarray(jam.packet_crc(jnp.asarray(pkt))))
    assert int(tam.packet_crc(torch.zeros(width, dtype=torch.int32))) == 0


def test_wire_dtype_guard():
    assert tam.wire_dtype_ok(torch.float32) and tam.wire_dtype_ok(torch.int32)
    assert not tam.wire_dtype_ok(torch.bfloat16)
    with pytest.raises(TypeError):
        tam.to_wire(torch.zeros(4, dtype=torch.bfloat16))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        assert tam.wire_words(dt, 37) == jam.wire_words(jdt, 37)
