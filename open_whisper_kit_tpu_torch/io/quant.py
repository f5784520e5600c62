# Source: open_whisper_kit_tpu/io/quant.py, copied as it stands (pure Python and numpy, no JAX).
"""Block-quantized tensor decoding (ggml quant formats) in pure numpy.

The ggml family stores quantized tensors as contiguous arrays of fixed-size
blocks.  Layouts re-derived from the public format documentation mirrored in
the reference (ggml/src/ggml-common.h; type ids ggml/include/ggml.h:389-430).
Dequantization here is the *host-side* path used at checkpoint load time; the
fused dequant-matmul TPU path lives in `ops/quant_matmul.py` and consumes the
raw block bytes re-packed into TPU-friendly planes (see `unpack_planes`).

Decode covers EVERY ggml block-quant format the reference dequantizes:
the simple quants (q4_0/q4_1/q5_0/q5_1/q8_0), all K-quants (q2_K..q8_K),
the IQ codebook families (iq1_s/iq1_m, iq2_xxs/xs/s, iq3_xxs/s,
iq4_nl/iq4_xs), the ternary packings (tq1_0/tq2_0) and MXFP4 — each
golden-tested byte-for-byte against the ggml library's own coder
(tests/test_ref_golden_quant.py). Encode covers the formats whisper.cpp
`quantize` emits.
"""

from __future__ import annotations

import numpy as np

# ggml_type ids (ggml/include/ggml.h:389-430)
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q5_1 = 7
GGML_TYPE_Q8_0 = 8
GGML_TYPE_Q2_K = 10
GGML_TYPE_Q3_K = 11
GGML_TYPE_Q4_K = 12
GGML_TYPE_Q5_K = 13
GGML_TYPE_Q6_K = 14
GGML_TYPE_Q8_K = 15
GGML_TYPE_IQ2_XXS = 16
GGML_TYPE_IQ2_XS = 17
GGML_TYPE_IQ3_XXS = 18
GGML_TYPE_IQ1_S = 19
GGML_TYPE_IQ4_NL = 20
GGML_TYPE_IQ3_S = 21
GGML_TYPE_IQ2_S = 22
GGML_TYPE_IQ4_XS = 23
GGML_TYPE_IQ1_M = 29
GGML_TYPE_I8 = 24
GGML_TYPE_I16 = 25
GGML_TYPE_I32 = 26
GGML_TYPE_I64 = 27
GGML_TYPE_F64 = 28
GGML_TYPE_BF16 = 30
GGML_TYPE_TQ1_0 = 34
GGML_TYPE_TQ2_0 = 35
GGML_TYPE_MXFP4 = 39

QK = 32       # simple-quant block size
QK_K = 256    # K-quant super-block size

TYPE_NAMES = {
    GGML_TYPE_F32: "f32", GGML_TYPE_F16: "f16", GGML_TYPE_BF16: "bf16",
    GGML_TYPE_Q4_0: "q4_0", GGML_TYPE_Q4_1: "q4_1", GGML_TYPE_Q5_0: "q5_0",
    GGML_TYPE_Q5_1: "q5_1", GGML_TYPE_Q8_0: "q8_0",
    GGML_TYPE_Q2_K: "q2_K", GGML_TYPE_Q3_K: "q3_K", GGML_TYPE_Q4_K: "q4_K",
    GGML_TYPE_Q5_K: "q5_K", GGML_TYPE_Q6_K: "q6_K", GGML_TYPE_Q8_K: "q8_K",
    GGML_TYPE_IQ2_XXS: "iq2_xxs", GGML_TYPE_IQ2_XS: "iq2_xs",
    GGML_TYPE_IQ2_S: "iq2_s", GGML_TYPE_IQ3_XXS: "iq3_xxs",
    GGML_TYPE_IQ3_S: "iq3_s", GGML_TYPE_IQ1_S: "iq1_s",
    GGML_TYPE_IQ1_M: "iq1_m",
    GGML_TYPE_IQ4_NL: "iq4_nl", GGML_TYPE_IQ4_XS: "iq4_xs",
    GGML_TYPE_TQ1_0: "tq1_0", GGML_TYPE_TQ2_0: "tq2_0",
    GGML_TYPE_MXFP4: "mxfp4",
    GGML_TYPE_I8: "i8", GGML_TYPE_I16: "i16", GGML_TYPE_I32: "i32",
    GGML_TYPE_I64: "i64", GGML_TYPE_F64: "f64",
}

# (block_size_elems, block_size_bytes)
_BLOCK_INFO = {
    GGML_TYPE_F32: (1, 4),
    GGML_TYPE_F16: (1, 2),
    GGML_TYPE_BF16: (1, 2),
    GGML_TYPE_F64: (1, 8),
    GGML_TYPE_I8: (1, 1),
    GGML_TYPE_I16: (1, 2),
    GGML_TYPE_I32: (1, 4),
    GGML_TYPE_I64: (1, 8),
    GGML_TYPE_Q4_0: (QK, 2 + QK // 2),            # fp16 d + 16B nibbles
    GGML_TYPE_Q4_1: (QK, 4 + QK // 2),            # fp16 d,m + 16B nibbles
    GGML_TYPE_Q5_0: (QK, 2 + 4 + QK // 2),        # fp16 d + u32 qh + 16B ql
    GGML_TYPE_Q5_1: (QK, 4 + 4 + QK // 2),        # fp16 d,m + u32 qh + 16B ql
    GGML_TYPE_Q8_0: (QK, 2 + QK),                 # fp16 d + 32 int8
    GGML_TYPE_Q2_K: (QK_K, QK_K // 16 + QK_K // 4 + 4),
    GGML_TYPE_Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGML_TYPE_Q4_K: (QK_K, 4 + 12 + QK_K // 2),
    GGML_TYPE_Q5_K: (QK_K, 4 + 12 + QK_K // 8 + QK_K // 2),
    GGML_TYPE_Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGML_TYPE_Q8_K: (QK_K, 4 + QK_K + QK_K // 16 * 2),
    GGML_TYPE_IQ2_XXS: (QK_K, 2 + QK_K // 4),
    GGML_TYPE_IQ2_XS: (QK_K, 2 + QK_K // 4 + QK_K // 32),
    GGML_TYPE_IQ2_S: (QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGML_TYPE_IQ3_XXS: (QK_K, 2 + 3 * QK_K // 8),
    GGML_TYPE_IQ3_S: (QK_K, 2 + 13 * (QK_K // 32) + QK_K // 64),
    GGML_TYPE_IQ1_S: (QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGML_TYPE_IQ1_M: (QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    GGML_TYPE_IQ4_NL: (QK, 2 + QK // 2),          # fp16 d + 16B nl nibbles
    GGML_TYPE_IQ4_XS: (QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    GGML_TYPE_TQ1_0: (QK_K, 2 + QK_K // 64 + (QK_K - 4 * QK_K // 64) // 5),
    GGML_TYPE_TQ2_0: (QK_K, 2 + QK_K // 4),
    GGML_TYPE_MXFP4: (QK, 1 + QK // 2),           # u8 e8m0 + 16B e2m1
}

QUANTIZED_TYPES = frozenset(
    t for t, (bs, _) in _BLOCK_INFO.items() if bs > 1
)


def type_name(t: int) -> str:
    return TYPE_NAMES.get(t, f"type{t}")


def block_info(t: int) -> tuple[int, int]:
    return _BLOCK_INFO[t]


def nbytes_for(t: int, n_elems: int) -> int:
    bs, bb = _BLOCK_INFO[t]
    assert n_elems % bs == 0, (type_name(t), n_elems, bs)
    return n_elems // bs * bb


def _f16(u16: np.ndarray) -> np.ndarray:
    return u16.view(np.float16).astype(np.float32)


def dequantize(raw: bytes | np.ndarray, ggml_type: int, n_elems: int) -> np.ndarray:
    """Decode `n_elems` values of `ggml_type` from raw bytes → float32 1-D array."""
    buf = np.frombuffer(raw, dtype=np.uint8, count=nbytes_for(ggml_type, n_elems))
    t = ggml_type
    if t == GGML_TYPE_F32:
        return buf.view(np.float32).copy()
    if t == GGML_TYPE_F16:
        return buf.view(np.float16).astype(np.float32)
    if t == GGML_TYPE_BF16:
        return (buf.view(np.uint16).astype(np.uint32) << 16).view(np.float32).copy()
    if t == GGML_TYPE_F64:
        return buf.view(np.float64).astype(np.float32)
    if t in (GGML_TYPE_I8, GGML_TYPE_I16, GGML_TYPE_I32, GGML_TYPE_I64):
        dt = {GGML_TYPE_I8: np.int8, GGML_TYPE_I16: np.int16,
              GGML_TYPE_I32: np.int32, GGML_TYPE_I64: np.int64}[t]
        return buf.view(dt).astype(np.float32)

    bs, bb = _BLOCK_INFO[t]
    nb = n_elems // bs
    blocks = buf.reshape(nb, bb)

    if t == GGML_TYPE_Q4_0:
        d = _f16(blocks[:, :2].copy().view(np.uint16))            # (nb,1)
        q = blocks[:, 2:]
        lo = (q & 0x0F).astype(np.int8) - 8
        hi = (q >> 4).astype(np.int8) - 8
        vals = np.concatenate([lo, hi], axis=1).astype(np.float32)  # (nb,32)
        return (vals * d).reshape(-1)

    if t == GGML_TYPE_Q4_1:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        m = _f16(blocks[:, 2:4].copy().view(np.uint16))
        q = blocks[:, 4:]
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        vals = np.concatenate([lo, hi], axis=1)
        return (vals * d + m).reshape(-1)

    if t == GGML_TYPE_Q5_0:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        qh = blocks[:, 2:6].copy().view(np.uint32)                # (nb,1)
        ql = blocks[:, 6:]
        sh = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> sh) & 1).astype(np.uint8)                 # (nb,32)
        lo = (ql & 0x0F)
        hi = (ql >> 4)
        q4 = np.concatenate([lo, hi], axis=1)                     # (nb,32)
        vals = (q4 | (hbits << 4)).astype(np.int16) - 16
        return (vals.astype(np.float32) * d).reshape(-1)

    if t == GGML_TYPE_Q5_1:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        m = _f16(blocks[:, 2:4].copy().view(np.uint16))
        qh = blocks[:, 4:8].copy().view(np.uint32)
        ql = blocks[:, 8:]
        sh = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> sh) & 1).astype(np.uint8)
        q4 = np.concatenate([ql & 0x0F, ql >> 4], axis=1)
        vals = (q4 | (hbits << 4)).astype(np.float32)
        return (vals * d + m).reshape(-1)

    if t == GGML_TYPE_Q8_0:
        d = _f16(blocks[:, 0:2].copy().view(np.uint16))
        q = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
        return (q * d).reshape(-1)

    if t == GGML_TYPE_Q2_K:
        return _dequant_q2_k(blocks)
    if t == GGML_TYPE_Q3_K:
        return _dequant_q3_k(blocks)
    if t == GGML_TYPE_Q4_K:
        return _dequant_q4_k(blocks)
    if t == GGML_TYPE_Q5_K:
        return _dequant_q5_k(blocks)
    if t == GGML_TYPE_Q6_K:
        return _dequant_q6_k(blocks)
    if t == GGML_TYPE_Q8_K:
        return _dequant_q8_k(blocks)
    if t == GGML_TYPE_IQ2_XXS:
        return _dequant_iq2_xxs(blocks)
    if t == GGML_TYPE_IQ2_XS:
        return _dequant_iq2_xs(blocks)
    if t == GGML_TYPE_IQ2_S:
        return _dequant_iq2_s(blocks)
    if t == GGML_TYPE_IQ3_XXS:
        return _dequant_iq3_xxs(blocks)
    if t == GGML_TYPE_IQ3_S:
        return _dequant_iq3_s(blocks)
    if t == GGML_TYPE_IQ1_S:
        return _dequant_iq1_s(blocks)
    if t == GGML_TYPE_IQ1_M:
        return _dequant_iq1_m(blocks)
    if t == GGML_TYPE_IQ4_NL:
        return _dequant_iq4_nl(blocks)
    if t == GGML_TYPE_IQ4_XS:
        return _dequant_iq4_xs(blocks)
    if t == GGML_TYPE_TQ1_0:
        return _dequant_tq1_0(blocks)
    if t == GGML_TYPE_TQ2_0:
        return _dequant_tq2_0(blocks)
    if t == GGML_TYPE_MXFP4:
        return _dequant_mxfp4(blocks)

    raise NotImplementedError(f"dequantize: unsupported ggml type {type_name(t)}")


def _dequant_q2_k(blocks: np.ndarray) -> np.ndarray:
    """block_q2_K: u8 scales[16] (4-bit scale | 4-bit min per 16-elem
    group), u8 qs[64] (2-bit), f16 d, f16 dmin
    (dequantize_row_q2_K, ggml/src/ggml-quants.c)."""
    nb = blocks.shape[0]
    scales = blocks[:, :16]                       # (nb, 16)
    qs = blocks[:, 16:80]                         # (nb, 64)
    d = _f16(blocks[:, 80:82].copy().view(np.uint16))     # (nb, 1)
    dmin = _f16(blocks[:, 82:84].copy().view(np.uint16))

    out = np.empty((nb, 256), np.float32)
    # two 128-halves; within each: shifts 0,2,4,6 over the same 32 q-bytes,
    # two 16-element groups per shift, sequential scale bytes
    for h in range(2):
        qb = qs[:, 32 * h:32 * h + 32]
        for j in range(4):
            for g in range(2):
                sc = scales[:, 8 * h + 2 * j + g]
                dl = d[:, 0] * (sc & 0xF)
                ml = dmin[:, 0] * (sc >> 4)
                q2 = ((qb[:, 16 * g:16 * g + 16] >> (2 * j)) & 3
                      ).astype(np.float32)
                base = 128 * h + 32 * j + 16 * g
                out[:, base:base + 16] = dl[:, None] * q2 - ml[:, None]
    return out.reshape(-1)


def _dequant_q3_k(blocks: np.ndarray) -> np.ndarray:
    """block_q3_K: u8 hmask[32] (high bit, inverted), u8 qs[64] (2-bit),
    u8 scales[12] (16 packed 6-bit signed-ish), f16 d
    (dequantize_row_q3_K, ggml/src/ggml-quants.c)."""
    nb = blocks.shape[0]
    hmask = blocks[:, :32]
    qs = blocks[:, 32:96]
    packed = blocks[:, 96:108].copy().view(np.uint32)     # (nb, 3) LE words
    d = _f16(blocks[:, 108:110].copy().view(np.uint16))

    kmask1, kmask2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    a0, a1, tmp = packed[:, 0], packed[:, 1], packed[:, 2]
    aux = np.empty((nb, 4), np.uint32)
    aux[:, 0] = (a0 & kmask2) | (((tmp >> np.uint32(0)) & kmask1) << np.uint32(4))
    aux[:, 1] = (a1 & kmask2) | (((tmp >> np.uint32(2)) & kmask1) << np.uint32(4))
    aux[:, 2] = ((a0 >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(4)) & kmask1) << np.uint32(4))
    aux[:, 3] = ((a1 >> np.uint32(4)) & kmask2) | (((tmp >> np.uint32(6)) & kmask1) << np.uint32(4))
    scales = aux.view(np.int8).astype(np.int32) - 32      # (nb, 16)

    out = np.empty((nb, 256), np.float32)
    m = 1
    idx = 0
    for h in range(2):
        qb = qs[:, 32 * h:32 * h + 32]
        for j in range(4):
            for g in range(2):
                dl = d[:, 0] * scales[:, idx]
                idx += 1
                lo = ((qb[:, 16 * g:16 * g + 16] >> (2 * j)) & 3
                      ).astype(np.int32)
                hb = (hmask[:, 16 * g:16 * g + 16] & m) != 0
                vals = lo - np.where(hb, 0, 4)
                base = 128 * h + 32 * j + 16 * g
                out[:, base:base + 16] = dl[:, None] * vals
            m <<= 1
    return out.reshape(-1)


def _dequant_q8_k(blocks: np.ndarray) -> np.ndarray:
    """block_q8_K: f32 d, i8 qs[256], i16 bsums[16] (dot-product helper,
    ignored on decode)."""
    d = blocks[:, :4].copy().view(np.float32)             # (nb, 1)
    q = blocks[:, 4:260].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


# ---- IQ codebook formats (iq1/iq2/iq3 families) ----
# The grids/sign tables are format-defining constants (_iq_tables,
# generated by tools/gen_iq_tables.py from ggml-common.h). Sign
# convention shared by iq2_xxs/iq2_xs/iq2_s/iq3_xxs/iq3_s: a 7-bit sign
# index selects ksigns_iq2xs, bit j of which (via kmask) negates
# element j.

_IQ1S_DELTA = 0.125    # ggml-common.h IQ1S_DELTA/IQ1M_DELTA


def _iq_luts():
    from . import _iq_tables as T
    if not hasattr(_iq_luts, "_c"):
        sign = np.where(
            (T.KSIGNS_IQ2XS[:, None] & T.KMASK_IQ2XS[None, :]) != 0,
            np.float32(-1), np.float32(1))               # (128, 8)
        g2xxs = T.IQ2XXS_GRID.view(np.uint8).reshape(256, 8)
        g2xs = T.IQ2XS_GRID.view(np.uint8).reshape(512, 8)
        g2s = T.IQ2S_GRID.view(np.uint8).reshape(1024, 8)
        g3xxs = T.IQ3XXS_GRID.view(np.uint8).reshape(256, 4)
        g3s = T.IQ3S_GRID.view(np.uint8).reshape(512, 4)
        g1s = T.IQ1S_GRID.view(np.int8).reshape(2048, 8)
        _iq_luts._c = (sign, g2xxs, g2xs, g2s, g3xxs, g3s, g1s)
    return _iq_luts._c


def _dequant_iq2_xxs(blocks: np.ndarray) -> np.ndarray:
    """block_iq2_xxs: f16 d + u16 qs[32]; per 32-elem group two u32 pack
    4 grid-256 indices (bytes of the first) and 4x7-bit sign indices +
    4-bit scale (second) (dequantize_row_iq2_xxs, ggml-quants.c:2275)."""
    sign, g2xxs, *_ = _iq_luts()
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))[:, 0]
    q32 = blocks[:, 2:].copy().view(np.uint32).reshape(nb, 8, 2)
    idx = q32[:, :, 0].copy().view(np.uint8).reshape(nb, 8, 4)
    meta = q32[:, :, 1]                                 # (nb, 8)
    db = d[:, None] * (0.5 + (meta >> 28)) * 0.25       # (nb, 8)
    shifts = np.arange(4, dtype=np.uint32) * 7
    sidx = (meta[:, :, None] >> shifts[None, None, :]) & 127
    vals = (g2xxs[idx].astype(np.float32)               # (nb, 8, 4, 8)
            * sign[sidx])
    return (vals * db[:, :, None, None]).reshape(-1)


def _dequant_iq2_xs(blocks: np.ndarray) -> np.ndarray:
    """block_iq2_xs: f16 d + u16 qs[32] (9-bit grid-512 index + 7-bit
    sign index) + u8 scales[8] (nibble per 16-elem half)
    (dequantize_row_iq2_xs, ggml-quants.c:2303)."""
    sign, _, g2xs, *_ = _iq_luts()
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))[:, 0]
    qs = blocks[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4)
    scales = blocks[:, 66:74]                           # (nb, 8)
    db = np.stack([d[:, None] * (0.5 + (scales & 0xF)) * 0.25,
                   d[:, None] * (0.5 + (scales >> 4)) * 0.25,
                   ], axis=2)                           # (nb, 8, 2)
    vals = (g2xs[qs & 511].astype(np.float32)
            * sign[qs >> 9])                            # (nb, 8, 4, 8)
    dl = db[:, :, [0, 0, 1, 1]]                         # (nb, 8, 4)
    return (vals * dl[:, :, :, None]).reshape(-1)


def _dequant_iq2_s(blocks: np.ndarray) -> np.ndarray:
    """block_iq2_s: f16 d + u8 qs[32 index bytes + 32 sign bytes] +
    u8 qh[8] (2 high index bits per 8-elem group) + u8 scales[8]
    (dequantize_row_iq2_s, ggml-quants.c:2330)."""
    sign, _, _, g2s, *_ = _iq_luts()
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))[:, 0]
    qs = blocks[:, 2:34].reshape(nb, 8, 4).astype(np.uint32)
    sg = blocks[:, 34:66].reshape(nb, 8, 4)
    qh = blocks[:, 66:74].astype(np.uint32)             # (nb, 8)
    scales = blocks[:, 74:82]
    sh = np.array([8, 6, 4, 2], np.uint32)
    idx = qs | ((qh[:, :, None] << sh[None, None, :]) & 0x300)
    db = np.stack([d[:, None] * (0.5 + (scales & 0xF)) * 0.25,
                   d[:, None] * (0.5 + (scales >> 4)) * 0.25], axis=2)
    dl = db[:, :, [0, 0, 1, 1]]
    # iq2_s stores FULL 8-bit sign masks (tested directly against
    # kmask), not 7-bit ksigns indices
    bits = np.unpackbits(sg.reshape(nb, 8, 4, 1), axis=3,
                         bitorder="little")             # (nb, 8, 4, 8)
    vals = g2s[idx].astype(np.float32) * np.where(bits, -1.0, 1.0)
    return (vals * dl[:, :, :, None]).reshape(-1)


def _dequant_iq3_xxs(blocks: np.ndarray) -> np.ndarray:
    """block_iq3_xxs: f16 d + u8 qs[64 grid-256 bytes, 4 values each] +
    u32 scale/sign word per 32-elem group
    (dequantize_row_iq3_xxs, ggml-quants.c:2362)."""
    sign, _, _, _, g3xxs, *_ = _iq_luts()
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))[:, 0]
    qs = blocks[:, 2:66].reshape(nb, 8, 4, 2)           # grid byte pairs
    meta = blocks[:, 66:98].copy().view(np.uint32)      # (nb, 8)
    db = d[:, None] * (0.5 + (meta >> 28)) * 0.5        # (nb, 8)
    shifts = np.arange(4, dtype=np.uint32) * 7
    sidx = (meta[:, :, None] >> shifts[None, None, :]) & 127
    vals = g3xxs[qs].astype(np.float32).reshape(nb, 8, 4, 8)
    vals = vals * sign[sidx]
    return (vals * db[:, :, None, None]).reshape(-1)


def _dequant_iq3_s(blocks: np.ndarray) -> np.ndarray:
    """block_iq3_s: f16 d + u8 qs[64 grid-512 bytes] + qh[8] (9th index
    bit per 8-elem group) + signs[32] (direct 8-bit masks) + scales[4]
    (nibbles, one per 64 elems)
    (dequantize_row_iq3_s, ggml-quants.c:2394)."""
    _, _, _, _, _, g3s, _ = _iq_luts()
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))[:, 0]
    qs = blocks[:, 2:66].reshape(nb, 8, 8).astype(np.uint32)
    qh = blocks[:, 66:74].astype(np.uint32)             # (nb, 8)
    sg = blocks[:, 74:106].reshape(nb, 8, 4)
    scales = blocks[:, 106:110]                         # (nb, 4)
    nib = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 8)
    db = d[:, None] * (1 + 2 * nib.astype(np.float32))  # (nb, 8)
    l = np.arange(4, dtype=np.uint32)
    idx1 = qs[:, :, 0::2] | ((qh[:, :, None] << (8 - 2 * l)) & 256)
    idx2 = qs[:, :, 1::2] | ((qh[:, :, None] << (7 - 2 * l)) & 256)
    bits = np.unpackbits(sg[..., None], axis=3,
                         bitorder="little")             # (nb, 8, 4, 8)
    sgn = np.where(bits, np.float32(-1), np.float32(1))
    out = np.empty((nb, 8, 4, 8), np.float32)
    out[..., :4] = g3s[idx1].astype(np.float32) * sgn[..., :4]
    out[..., 4:] = g3s[idx2].astype(np.float32) * sgn[..., 4:]
    return (out * db[:, :, None, None]).reshape(-1)


def _dequant_iq1_s(blocks: np.ndarray) -> np.ndarray:
    """block_iq1_s: f16 d + u8 qs[32] + u16 qh[8] (3 high index bits per
    8-elem group, 3-bit scale, delta-sign bit 15)
    (dequantize_row_iq1_s, ggml-quants.c:2437)."""
    *_, g1s = _iq_luts()
    nb = blocks.shape[0]
    d = _f16(blocks[:, :2].copy().view(np.uint16))[:, 0]
    qs = blocks[:, 2:34].reshape(nb, 8, 4).astype(np.uint32)
    qh = blocks[:, 34:50].copy().view(np.uint16).astype(np.uint32)
    dl = d[:, None] * (2 * ((qh >> 12) & 7) + 1)        # (nb, 8)
    delta = np.where((qh & 0x8000) != 0,
                     np.float32(-_IQ1S_DELTA), np.float32(_IQ1S_DELTA))
    sh = np.arange(4, dtype=np.uint32) * 3
    idx = qs | (((qh[:, :, None] >> sh[None, None, :]) & 7) << 8)
    vals = g1s[idx].astype(np.float32) + delta[:, :, None, None]
    return (vals * dl[:, :, None, None]).reshape(-1)


def _dequant_iq1_m(blocks: np.ndarray) -> np.ndarray:
    """block_iq1_m: u8 qs[32] + u8 qh[16] (3 high index bits + delta bit
    per 8-elem group) + u8 scales[8] packing 3-bit scales and the f16
    super-scale in the top nibbles
    (dequantize_row_iq1_m, ggml-quants.c:2462)."""
    *_, g1s = _iq_luts()
    nb = blocks.shape[0]
    qs = blocks[:, :32].reshape(nb, 8, 4).astype(np.uint32)
    qh = blocks[:, 32:48].reshape(nb, 8, 2).astype(np.uint32)
    sc = blocks[:, 48:56].copy().view(np.uint16)        # (nb, 4)
    scale_u16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0)
                 | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000))
    d = _f16(scale_u16.astype(np.uint16).reshape(nb, 1))[:, 0]
    ib = np.arange(8)
    dl1 = d[:, None] * (2 * ((sc[:, ib // 2] >> (6 * (ib % 2))) & 7) + 1)
    dl2 = d[:, None] * (2 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 3)) & 7)
                        + 1)                            # (nb, 8)
    idx = np.empty((nb, 8, 4), np.uint32)
    idx[:, :, 0] = qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700)
    idx[:, :, 1] = qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700)
    idx[:, :, 2] = qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700)
    idx[:, :, 3] = qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)
    dbit = np.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80,
                     qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80], axis=2)
    delta = np.where(dbit != 0, np.float32(-_IQ1S_DELTA),
                     np.float32(_IQ1S_DELTA))           # (nb, 8, 4)
    dl = np.stack([dl1, dl1, dl2, dl2], axis=2)         # (nb, 8, 4)
    vals = g1s[idx].astype(np.float32) + delta[:, :, :, None]
    return (vals * dl[:, :, :, None]).reshape(-1)


# IQ4 non-linear 4-bit grid and MXFP4 e2m1 value table (doubled), both
# fixed by the formats (ggml/src/ggml-common.h kvalues_iq4nl/kvalues_mxfp4)
_KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89,
     113], np.float32)
_KVALUES_MXFP4 = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12], np.float32)


def _dequant_iq4_nl(blocks: np.ndarray) -> np.ndarray:
    """block_iq4_nl: f16 d + u8 qs[16]; nibble indexes the fixed non-linear
    16-value grid (dequantize_row_iq4_nl, ggml/src/ggml-quants.c:2512)."""
    d = _f16(blocks[:, :2].copy().view(np.uint16))        # (nb, 1)
    q = blocks[:, 2:]
    vals = _KVALUES_IQ4NL[
        np.concatenate([q & 0x0F, q >> 4], axis=1)]       # (nb, 32)
    return (vals * d).reshape(-1)


def _dequant_iq4_xs(blocks: np.ndarray) -> np.ndarray:
    """block_iq4_xs: f16 d, u16 scales_h, u8 scales_l[4], u8 qs[128];
    per-32 sub-block 6-bit scale (4 low bits from scales_l nibbles, 2 high
    from scales_h), values on the iq4_nl grid
    (dequantize_row_iq4_xs, ggml/src/ggml-quants.c:2530)."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))[:, 0]     # (nb,)
    scales_h = blocks[:, 2:4].copy().view(np.uint16)[:, 0].astype(np.uint32)
    scales_l = blocks[:, 4:8]                                  # (nb, 4)
    qs = blocks[:, 8:]                                         # (nb, 128)
    out = np.empty((nb, 256), np.float32)
    for ib in range(8):
        ls = (((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF).astype(
            np.uint32) | (((scales_h >> (2 * ib)) & 3) << 4))
        dl = d * (ls.astype(np.float32) - 32.0)
        qb = qs[:, 16 * ib:16 * ib + 16]
        vals = _KVALUES_IQ4NL[np.concatenate([qb & 0x0F, qb >> 4], axis=1)]
        out[:, 32 * ib:32 * ib + 32] = vals * dl[:, None]
    return out.reshape(-1)


def _dequant_tq1_0(blocks: np.ndarray) -> np.ndarray:
    """block_tq1_0: u8 qs[48] (5 ternary digits per byte, base-3 packed),
    u8 qh[4] (4 digits per byte), f16 d; digit extraction is the
    fixed-point trick ((q * 3) >> 8 over q pre-multiplied by 3^n)
    (dequantize_row_tq1_0, ggml/src/ggml-quants.c:2215)."""
    nb = blocks.shape[0]
    qs = blocks[:, :48]
    qh = blocks[:, 48:52]
    d = _f16(blocks[:, 52:54].copy().view(np.uint16))[:, 0]   # (nb,)
    pow3 = np.array([1, 3, 9, 27, 81], np.uint8)
    out = np.empty((nb, 256), np.float32)

    def digits(qbytes, n_digits):
        # (nb, W) bytes -> (nb, n_digits, W) ternary digits - 1
        q = (qbytes[:, None, :] * pow3[None, :n_digits, None])  # u8 wraps
        return (((q.astype(np.uint16) * 3) >> 8).astype(np.int8) - 1)

    out[:, :160] = digits(qs[:, :32], 5).reshape(nb, 160)
    out[:, 160:240] = digits(qs[:, 32:48], 5).reshape(nb, 80)
    out[:, 240:256] = digits(qh, 4).reshape(nb, 16)
    return (out * d[:, None]).reshape(-1)


def _dequant_tq2_0(blocks: np.ndarray) -> np.ndarray:
    """block_tq2_0: u8 qs[64] (2 bits per element), f16 d; element order is
    [32-byte group][bit-pair plane][byte]
    (dequantize_row_tq2_0, ggml/src/ggml-quants.c:2254)."""
    nb = blocks.shape[0]
    qs = blocks[:, :64]
    d = _f16(blocks[:, 64:66].copy().view(np.uint16))[:, 0]
    out = np.empty((nb, 256), np.float32)
    for half, j in enumerate((0, 32)):
        qb = qs[:, j:j + 32]
        for l in range(4):
            q2 = ((qb >> (2 * l)) & 3).astype(np.float32) - 1.0
            base = 128 * half + 32 * l
            out[:, base:base + 32] = q2
    return (out * d[:, None]).reshape(-1)


def _dequant_mxfp4(blocks: np.ndarray) -> np.ndarray:
    """block_mxfp4: u8 e (E8M0 shared scale), u8 qs[16] (e2m1 nibbles on
    the doubled-value table, so the effective scale is 2^(e-128))
    (dequantize_row_mxfp4, ggml/src/ggml-quants.c:417)."""
    e = blocks[:, 0].astype(np.int32)
    q = blocks[:, 1:]
    d = np.ldexp(1.0, e - 128).astype(np.float32)         # (nb,)
    vals = _KVALUES_MXFP4[np.concatenate([q & 0x0F, q >> 4], axis=1)]
    return (vals * d[:, None]).reshape(-1)


def _kquant_scales_mins(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode the 12-byte packed 6-bit scales/mins of q4_K/q5_K → (nb,8),(nb,8)."""
    sc = sc.astype(np.uint8)
    scales = np.empty(sc.shape[:1] + (8,), np.uint8)
    mins = np.empty_like(scales)
    for j in range(8):
        if j < 4:
            scales[:, j] = sc[:, j] & 63
            mins[:, j] = sc[:, j + 4] & 63
        else:
            scales[:, j] = (sc[:, j + 4] & 0x0F) | ((sc[:, j - 4] >> 6) << 4)
            mins[:, j] = (sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)
    return scales, mins


def _dequant_q4_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))       # super-block scale
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
    scales, mins = _kquant_scales_mins(blocks[:, 4:16])
    qs = blocks[:, 16:]                                   # 128 bytes
    out = np.empty((nb, QK_K), np.float32)
    # 4 chunks of 32B nibbles; each chunk yields 2 groups of 32 (low then high)
    for chunk in range(4):
        q = qs[:, chunk * 32:(chunk + 1) * 32]
        for half, qv in ((0, q & 0x0F), (1, q >> 4)):
            g = chunk * 2 + half
            dl = d[:, 0] * scales[:, g].astype(np.float32)
            ml = dmin[:, 0] * mins[:, g].astype(np.float32)
            out[:, g * 32:(g + 1) * 32] = qv.astype(np.float32) * dl[:, None] - ml[:, None]
    return out.reshape(-1)


def _dequant_q5_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
    scales, mins = _kquant_scales_mins(blocks[:, 4:16])
    qh = blocks[:, 16:48]                                 # 32 bytes of high bits
    qs = blocks[:, 48:]                                   # 128 bytes nibbles
    out = np.empty((nb, QK_K), np.float32)
    u = np.uint8(1)
    for chunk in range(4):
        q = qs[:, chunk * 32:(chunk + 1) * 32]
        for half, qv in ((0, q & 0x0F), (1, q >> 4)):
            g = chunk * 2 + half
            hbit = ((qh >> np.uint8(g)) & u).astype(np.uint8)
            qfull = qv.astype(np.float32) + hbit.astype(np.float32) * 16.0
            dl = d[:, 0] * scales[:, g].astype(np.float32)
            ml = dmin[:, 0] * mins[:, g].astype(np.float32)
            out[:, g * 32:(g + 1) * 32] = qfull * dl[:, None] - ml[:, None]
    return out.reshape(-1)


def _dequant_q6_k(blocks: np.ndarray) -> np.ndarray:
    nb = blocks.shape[0]
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].copy().view(np.int8)          # 16 int8 scales
    d = _f16(blocks[:, 208:210].copy().view(np.uint16))   # (nb,1)
    out = np.empty((nb, QK_K), np.float32)
    for half in range(2):  # two 128-element halves
        ql_h = ql[:, half * 64:half * 64 + 64]
        qh_h = qh[:, half * 32:half * 32 + 32]
        base = half * 128
        q1 = ((ql_h[:, :32] & 0x0F) | ((qh_h & 0x03) << 4)).astype(np.int16) - 32
        q2 = ((ql_h[:, 32:] & 0x0F) | (((qh_h >> 2) & 0x03) << 4)).astype(np.int16) - 32
        q3 = ((ql_h[:, :32] >> 4) | (((qh_h >> 4) & 0x03) << 4)).astype(np.int16) - 32
        q4 = ((ql_h[:, 32:] >> 4) | (((qh_h >> 6) & 0x03) << 4)).astype(np.int16) - 32
        for i, q in enumerate((q1, q2, q3, q4)):
            # scale index: group of 16 within the 256-block
            g0 = base + i * 32
            s_idx = (g0 // 16) + (np.arange(32) // 16)
            s = sc[np.arange(nb)[:, None], s_idx[None, :]].astype(np.float32)
            out[:, g0:g0 + 32] = d * s * q.astype(np.float32)
    return out.reshape(-1)


def quantize_q8_0(x: np.ndarray) -> bytes:
    """Encode float array (size % 32 == 0) as q8_0 blocks (for tests/tools)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.round(x * inv[:, None]).astype(np.int8)
    out = bytearray()
    d16 = d.astype(np.float16)
    for i in range(x.shape[0]):
        out += d16[i].tobytes() + q[i].tobytes()
    return bytes(out)


def quantize_q5_0(x: np.ndarray) -> bytes:
    """Encode float array as q5_0 blocks (round-trip testing of the decoder)."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    amax_i = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), amax_i]
    d = (maxv / -16.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 16, 0, 31).astype(np.uint8)
    out = bytearray()
    for i in range(x.shape[0]):
        d16 = np.float16(d[i]).tobytes()
        lo = (q[i, :16] & 0x0F) | ((q[i, 16:] & 0x0F) << 4)
        qh = np.uint32(0)
        for j in range(16):
            qh |= np.uint32(q[i, j] >> 4) << np.uint32(j)
            qh |= np.uint32(q[i, j + 16] >> 4) << np.uint32(j + 16)
        out += d16 + qh.tobytes() + lo.tobytes()
    return bytes(out)


# -- K-quant encoders (reference algorithms: ggml-quants.c quantize_row_q*_K_ref
#    / make_qx_quants:451 / make_qkx2_quants:622, re-implemented vectorized) ---

_GROUP_EPS = np.float32(1e-15)


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int: round-half-to-even (the 12582912.0f float trick)."""
    return np.rint(x).astype(np.int32)


def _seq_sum(a: np.ndarray) -> np.ndarray:
    """(G, n) float32 -> (G,) float32, accumulated STRICTLY left-to-right
    over n.  numpy's .sum() uses 8-way-unrolled pairwise accumulation even
    for tiny n, which differs from the reference coder's sequential C
    loops at the last ulp — enough to flip nearest_int/grid-search
    decisions and break byte parity with quantize_row_*_ref."""
    acc = a[:, 0].astype(np.float32).copy()
    for i in range(1, a.shape[1]):
        acc += a[:, i]
    return acc


def _make_qx_quants(x: np.ndarray, nmax: int):
    """Signed symmetric quant with weighted-RMSE scale search (rmse_type=1).

    x: (G, n) float32 groups. Returns (scale (G,), L (G, n) in [0, 2*nmax-1]).
    """
    x = x.astype(np.float32)
    G, _ = x.shape
    aidx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(G), aidx]
    dead = np.abs(maxv) < _GROUP_EPS
    maxv_safe = np.where(dead, np.float32(1), maxv)
    w = x * x

    def trial(iscale):
        l = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
        lf = l.astype(np.float32)
        sumlx = _seq_sum(w * x * lf)
        suml2 = _seq_sum(w * lf * lf)
        return l, sumlx, suml2

    L, sumlx, suml2 = trial((np.float32(-nmax) / maxv_safe).astype(np.float32))
    L = L + nmax
    safe2 = np.where(suml2 == 0, np.float32(1), suml2)
    scale = np.where(suml2 != 0, sumlx / safe2, np.float32(0)).astype(np.float32)
    best = scale * sumlx
    for step in range(-9, 10):
        if step == 0:
            continue
        isc = (-(nmax + np.float32(0.1) * step) / maxv_safe).astype(np.float32)
        l, sumlx, suml2 = trial(isc)
        upd = (suml2 > 0) & (sumlx * sumlx > best * suml2)
        safe2 = np.where(suml2 == 0, np.float32(1), suml2)
        news = (sumlx / safe2).astype(np.float32)
        L = np.where(upd[:, None], l + nmax, L)
        scale = np.where(upd, news, scale)
        best = np.where(upd, news * sumlx, best)
    return (np.where(dead, np.float32(0), scale),
            np.where(dead[:, None], 0, L))


def _make_qkx2_quants(x: np.ndarray, weights: np.ndarray, nmax: int,
                      rmin: float, rdelta: float, nstep: int,
                      use_mad: bool = False):
    """Asymmetric (scale, min) quant with grid search over iscale candidates.

    x, weights: (G, n) float32. Returns (scale (G,), the_min (G,), L (G, n)).
    use_mad selects weighted |err| instead of err^2 (q2_K's variant).
    """
    x = x.astype(np.float32)
    weights = weights.astype(np.float32)
    minv = np.minimum(x.min(axis=1), np.float32(0))
    maxv = x.max(axis=1)
    sum_w = _seq_sum(weights)
    sum_x = _seq_sum(weights * x)
    flat = maxv == minv
    rng = np.where(flat, np.float32(1), maxv - minv)

    def err_of(diff):
        e = np.abs(diff) if use_mad else diff * diff
        return _seq_sum(weights * e)

    iscale = (np.float32(nmax) / rng).astype(np.float32)
    scale = np.float32(1) / iscale
    L = np.clip(_nearest_int(iscale[:, None] * (x - minv[:, None])), 0, nmax)
    best_err = err_of(scale[:, None] * L.astype(np.float32)
                      + minv[:, None] - x)

    for step in range(nstep + 1):
        # the C coder mutates `min` on every accepted step, so the range
        # (max - min) must be recomputed per step, and the whole iscale
        # expression must stay float32 with the C's association
        # (rmin + rdelta*is + nmax)/(max - min) — both details flip
        # nearest_int decisions and break byte parity otherwise
        denom = np.where(flat, np.float32(1), maxv - minv)
        isc = ((np.float32(rmin) + np.float32(rdelta) * np.float32(step)
                + np.float32(nmax)) / denom).astype(np.float32)
        Laux = np.clip(_nearest_int(isc[:, None] * (x - minv[:, None])), 0, nmax)
        lf = Laux.astype(np.float32)
        sum_l = _seq_sum(weights * lf)
        sum_l2 = _seq_sum(weights * lf * lf)
        sum_xl = _seq_sum(weights * lf * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        Dok = D > 0
        Dsafe = np.where(Dok, D, np.float32(1))
        ts = (sum_w * sum_xl - sum_x * sum_l) / Dsafe
        tm = (sum_l2 * sum_x - sum_l * sum_xl) / Dsafe
        pos = tm > 0
        l2safe = np.where(sum_l2 == 0, np.float32(1), sum_l2)
        ts = np.where(pos, sum_xl / l2safe, ts).astype(np.float32)
        tm = np.where(pos, np.float32(0), tm).astype(np.float32)
        cur_err = err_of(ts[:, None] * lf + tm[:, None] - x)
        upd = Dok & (cur_err < best_err) & ~flat
        L = np.where(upd[:, None], Laux, L)
        best_err = np.where(upd, cur_err, best_err)
        scale = np.where(upd, ts, scale)
        minv = np.where(upd, tm, minv)

    return (np.where(flat, np.float32(0), scale).astype(np.float32),
            (-minv).astype(np.float32),
            np.where(flat[:, None], 0, L))


def _pack_kquant_scales(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """Pack 8x 6-bit (scale, min) pairs into the 12-byte q4_K/q5_K layout."""
    nb = ls.shape[0]
    sb = np.zeros((nb, 12), np.uint8)
    sb[:, 0:4] = ls[:, 0:4]
    sb[:, 4:8] = lm[:, 0:4]
    for j in range(4, 8):
        sb[:, j + 4] = (ls[:, j] & 0x0F) | ((lm[:, j] & 0x0F) << 4)
        sb[:, j - 4] |= (ls[:, j] >> 4) << 6
        sb[:, j] |= (lm[:, j] >> 4) << 6
    return sb


def _kquant_scales_requant(x3, scales, mins, L, inv_max, nmax):
    """Shared q4_K/q5_K tail: 6-bit code the scales/mins, requantize L."""
    nb = x3.shape[0]
    # C runs `if (v > max) max = v` from max=+0.0f, so an all-flat group
    # row keeps +0.0 — np.max over [-0.0, ...] yields -0.0, whose f16 is
    # 0x8000 and breaks byte parity with the reference coder
    max_scale = np.where(scales.max(axis=1) > 0, scales.max(axis=1),
                         np.float32(0.0))
    max_min = np.where(mins.max(axis=1) > 0, mins.max(axis=1),
                       np.float32(0.0))
    inv_scale = np.where(max_scale > 0, np.float32(inv_max)
                         / np.where(max_scale <= 0, 1, max_scale), 0)
    inv_min = np.where(max_min > 0, np.float32(inv_max)
                       / np.where(max_min <= 0, 1, max_min), 0)
    ls = np.minimum(inv_max, _nearest_int(inv_scale[:, None] * scales)).astype(np.uint8)
    lm = np.minimum(inv_max, _nearest_int(inv_min[:, None] * mins)).astype(np.uint8)
    d16 = (max_scale / np.float32(inv_max)).astype(np.float16)
    dmin16 = (max_min / np.float32(inv_max)).astype(np.float16)
    deff = d16.astype(np.float32)[:, None] * ls.astype(np.float32)
    dm = dmin16.astype(np.float32)[:, None] * lm.astype(np.float32)
    lq = np.clip(_nearest_int((x3 + dm[:, :, None])
                              / np.where(deff == 0, 1, deff)[:, :, None]), 0, nmax)
    L = np.where((deff != 0)[:, :, None], lq, L).reshape(nb, QK_K).astype(np.uint8)
    return d16, dmin16, _pack_kquant_scales(ls, lm), L


def _qkx2_groups(x3: np.ndarray, nmax, rmin, rdelta, nstep):
    g = x3.reshape(-1, 32)
    av = np.sqrt(_seq_sum(g * g) / np.float32(32))
    w = av[:, None] + np.abs(g)
    scale, the_min, L = _make_qkx2_quants(g, w, nmax, rmin, rdelta, nstep)
    nb = x3.shape[0]
    return scale.reshape(nb, 8), the_min.reshape(nb, 8), L.reshape(nb, 8, 32)


def _make_q3_quants_rmse(x: np.ndarray, nmax: int):
    """Signed quant with per-element coordinate-descent RMSE refinement
    (make_q3_quants do_rmse=true, ggml-quants.c:520). x: (G, n) float32.
    Returns (scale (G,), L (G, n) in [0, 2*nmax-1])."""
    x = x.astype(np.float32)
    G, n = x.shape
    aidx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(G), aidx]
    dead = np.abs(maxv) < _GROUP_EPS
    iscale = np.float32(-nmax) / np.where(dead, np.float32(1), maxv)
    L = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
    w = x * x
    lf = L.astype(np.float32)
    sumlx = _seq_sum(w * x * lf)
    suml2 = _seq_sum(w * lf * lf)
    # 5 sweeps of sequential per-element improvement; groups vectorized.
    # (A group that converges early just no-ops through later sweeps.)
    for _ in range(5):
        for i in range(n):
            wi, xi = w[:, i], x[:, i]
            li = L[:, i].astype(np.float32)
            slx = sumlx - wi * xi * li
            sl2 = suml2 - wi * li * li
            pos = slx > 0
            new_l = np.clip(
                _nearest_int(xi * sl2 / np.where(pos, slx, np.float32(1))),
                -nmax, nmax - 1)
            nlf = new_l.astype(np.float32)
            slx2 = slx + wi * xi * nlf
            sl22 = sl2 + wi * nlf * nlf
            accept = (pos & (new_l != L[:, i]) & (sl22 > 0)
                      & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22))
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx)
            suml2 = np.where(accept, sl22, suml2)
    scale = np.where(suml2 > 0,
                     sumlx / np.where(suml2 > 0, suml2, np.float32(1)),
                     np.float32(0)).astype(np.float32)
    L = L + nmax
    return (np.where(dead, np.float32(0), scale),
            np.where(dead[:, None], 0, L))


def _pack_2bit(Lf: np.ndarray) -> np.ndarray:
    """(nb, 256) codes in [0,3] -> (nb, 64) qs bytes (two 128-halves,
    each byte packing elements l, l+32, l+64, l+96)."""
    nb = Lf.shape[0]
    qs = np.zeros((nb, 64), np.uint8)
    for h in range(2):
        b = Lf[:, 128 * h:128 * (h + 1)]
        qs[:, 32 * h:32 * h + 32] = (b[:, :32] | (b[:, 32:64] << 2)
                                     | (b[:, 64:96] << 4) | (b[:, 96:128] << 6))
    return qs


def quantize_q2_K(x: np.ndarray) -> bytes:
    """Encode as q2_K super-blocks (ggml-quants.c:714 quantize_row_q2_K_ref):
    16x 16-elem groups, MAD-metric (scale,min) search at nmax=3, 4-bit coded
    group scales/mins, requantized 2-bit codes."""
    x3 = np.ascontiguousarray(x, np.float32).reshape(-1, 16, 16)
    nb = x3.shape[0]
    g = x3.reshape(-1, 16)
    scale, the_min, L = _make_qkx2_quants(
        g, np.abs(g), 3, -0.5, 0.1, 15, use_mad=True)
    scales = scale.reshape(nb, 16)
    mins = the_min.reshape(nb, 16)
    L = L.reshape(nb, 16, 16)

    q4scale = np.float32(15)
    max_scale, max_min = scales.max(axis=1), mins.max(axis=1)
    has_s, has_m = max_scale > 0, max_min > 0
    isc = q4scale / np.where(has_s, max_scale, np.float32(1))
    ls = np.where(has_s[:, None], _nearest_int(isc[:, None] * scales), 0)
    d16 = np.where(has_s, (max_scale / q4scale).astype(np.float16),
                   np.float16(0))
    ism = q4scale / np.where(has_m, max_min, np.float32(1))
    lm = np.where(has_m[:, None], _nearest_int(ism[:, None] * mins), 0)
    dmin16 = np.where(has_m, (max_min / q4scale).astype(np.float16),
                      np.float16(0))
    sb = (ls.astype(np.uint8) | (lm.astype(np.uint8) << 4))

    deff = d16.astype(np.float32)[:, None] * (sb & 0xF)
    dm = dmin16.astype(np.float32)[:, None] * (sb >> 4)
    lq = np.clip(_nearest_int((x3 + dm[:, :, None])
                              / np.where(deff == 0, 1, deff)[:, :, None]),
                 0, 3)
    L = np.where((deff != 0)[:, :, None], lq, L)
    qs = _pack_2bit(L.reshape(nb, 256).astype(np.uint8))
    blk = np.concatenate([sb, qs, d16.reshape(nb, 1).view(np.uint8),
                          dmin16.reshape(nb, 1).view(np.uint8)], axis=1)
    return blk.tobytes()


def quantize_q3_K(x: np.ndarray) -> bytes:
    """Encode as q3_K super-blocks (ggml-quants.c:1052 quantize_row_q3_K_ref):
    16x 16-elem signed groups at nmax=4 with RMSE refinement, 6-bit packed
    group scales, high bits split into hmask."""
    x3 = np.ascontiguousarray(x, np.float32).reshape(-1, 16, 16)
    nb = x3.shape[0]
    scale, L = _make_q3_quants_rmse(x3.reshape(-1, 16), 4)
    scales = scale.reshape(nb, 16)
    L = L.reshape(nb, 16, 16)

    aidx = np.abs(scales).argmax(axis=1)
    max_scale = scales[np.arange(nb), aidx]
    nz = max_scale != 0
    iscale = np.float32(-32) / np.where(nz, max_scale, np.float32(1))
    l6 = np.where(nz[:, None],
                  np.clip(_nearest_int(iscale[:, None] * scales), -32, 31)
                  + 32, 0).astype(np.uint8)
    sb = np.zeros((nb, 12), np.uint8)
    for j in range(16):
        lj = l6[:, j]
        if j < 8:
            sb[:, j] |= lj & 0xF
        else:
            sb[:, j - 8] |= (lj & 0xF) << 4
        sb[:, 8 + j % 4] |= (lj >> 4) << (2 * (j // 4))
    d16 = np.where(nz, (np.float32(1) / iscale).astype(np.float16),
                   np.float16(0))

    # decode the 6-bit scales back exactly as the requant pass does
    sc = np.empty((nb, 16), np.int32)
    for j in range(16):
        base = (sb[:, j] & 0xF) if j < 8 else (sb[:, j - 8] >> 4)
        hi = (sb[:, 8 + j % 4] >> (2 * (j // 4))) & 3
        sc[:, j] = (base.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32
    deff = d16.astype(np.float32)[:, None] * sc
    lq = np.clip(_nearest_int(x3 / np.where(deff == 0, 1, deff)[:, :, None]),
                 -4, 3) + 4
    L = np.where((deff != 0)[:, :, None], lq, L)

    Lf = L.reshape(nb, 256)
    high = Lf > 3
    Lf = np.where(high, Lf - 4, Lf).astype(np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    for bit in range(8):
        hmask |= (high[:, 32 * bit:32 * (bit + 1)].astype(np.uint8) << bit)
    qs = _pack_2bit(Lf)
    blk = np.concatenate([hmask, qs, sb,
                          d16.reshape(nb, 1).view(np.uint8)], axis=1)
    return blk.tobytes()


def quantize_q4_K(x: np.ndarray) -> bytes:
    """Encode as q4_K super-blocks (ggml-quants.c:1280 quantize_row_q4_K_ref)."""
    x3 = np.ascontiguousarray(x, np.float32).reshape(-1, 8, 32)
    nb = x3.shape[0]
    scales, mins, L = _qkx2_groups(x3, 15, -1.0, 0.1, 20)
    d16, dmin16, sb, Lf = _kquant_scales_requant(x3, scales, mins, L, 63, 15)
    qs = np.zeros((nb, 128), np.uint8)
    for c in range(4):  # 64-element chunks -> 32 nibble-pair bytes
        lo, hi = Lf[:, c * 64:c * 64 + 32], Lf[:, c * 64 + 32:c * 64 + 64]
        qs[:, c * 32:(c + 1) * 32] = lo | (hi << 4)
    blk = np.concatenate([d16.reshape(nb, 1).view(np.uint8),
                          dmin16.reshape(nb, 1).view(np.uint8), sb, qs], axis=1)
    return blk.tobytes()


def quantize_q5_K(x: np.ndarray) -> bytes:
    """Encode as q5_K super-blocks (ggml-quants.c:1467 quantize_row_q5_K_ref)."""
    x3 = np.ascontiguousarray(x, np.float32).reshape(-1, 8, 32)
    nb = x3.shape[0]
    scales, mins, L = _qkx2_groups(x3, 31, -0.5, 0.1, 15)
    d16, dmin16, sb, Lf = _kquant_scales_requant(x3, scales, mins, L, 63, 31)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    for c in range(4):
        l1, l2 = Lf[:, c * 64:c * 64 + 32], Lf[:, c * 64 + 32:c * 64 + 64]
        h1, h2 = (l1 > 15).astype(np.uint8), (l2 > 15).astype(np.uint8)
        qh |= (h1 << (2 * c)) | (h2 << (2 * c + 1))
        ql[:, c * 32:(c + 1) * 32] = (l1 - 16 * h1) | ((l2 - 16 * h2) << 4)
    blk = np.concatenate([d16.reshape(nb, 1).view(np.uint8),
                          dmin16.reshape(nb, 1).view(np.uint8), sb, qh, ql], axis=1)
    return blk.tobytes()


def quantize_q6_K(x: np.ndarray) -> bytes:
    """Encode as q6_K super-blocks (ggml-quants.c:1692 quantize_row_q6_K_ref)."""
    x3 = np.ascontiguousarray(x, np.float32).reshape(-1, 16, 16)
    nb = x3.shape[0]
    scales, L = _make_qx_quants(x3.reshape(-1, 16), 32)
    scales, L = scales.reshape(nb, 16), L.reshape(nb, 16, 16)
    aidx = np.abs(scales).argmax(axis=1)
    max_scale = scales[np.arange(nb), aidx]
    dead = np.abs(max_scale) < _GROUP_EPS
    iscale = np.float32(-128) / np.where(dead, np.float32(1), max_scale)
    d16 = (np.float32(1) / iscale).astype(np.float16)
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)).astype(np.int8)
    deff = d16.astype(np.float32)[:, None] * sc8.astype(np.float32)
    lq = np.clip(_nearest_int(x3 / np.where(deff == 0, 1, deff)[:, :, None]),
                 -32, 31) + 32
    L = np.where((deff != 0)[:, :, None], lq, L)
    L = np.where(dead[:, None, None], 0, L).reshape(nb, QK_K).astype(np.uint8)
    sc8 = np.where(dead[:, None], 0, sc8)
    d16 = np.where(dead, np.float16(0), d16)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for half in range(2):  # two 128-element halves
        b = L[:, half * 128:(half + 1) * 128]
        q1, q2, q3, q4 = b[:, :32], b[:, 32:64], b[:, 64:96], b[:, 96:128]
        ql[:, half * 64:half * 64 + 32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        ql[:, half * 64 + 32:half * 64 + 64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
        qh[:, half * 32:(half + 1) * 32] = ((q1 >> 4) | ((q2 >> 4) << 2)
                                            | ((q3 >> 4) << 4) | ((q4 >> 4) << 6))
    blk = np.concatenate([ql, qh, sc8.view(np.uint8),
                          d16.reshape(nb, 1).view(np.uint8)], axis=1)
    return blk.tobytes()
