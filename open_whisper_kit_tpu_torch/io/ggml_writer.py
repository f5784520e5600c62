# Source: open_whisper_kit_tpu/io/ggml_writer.py, copied with one change: the q8_0, q5_0 and q4_0 block encoders are numpy array ops (byte-identical output; the source loops per 32-value block).
"""Whisper ggml-bin writer + requantizer.

Counterpart of the reference converter output format
(models/convert-pt-to-ggml.py:268-337) and the `quantize` tool
(examples/quantize/quantize.cpp): writes hparams + mel filters + vocab +
tensor records, optionally block-quantizing the eligible 2-D weights.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import quant
from .ggml_whisper import GGML_MAGIC, QNT_VERSION_FACTOR, WhisperHParams

GGML_QNT_VERSION = 2

# tensors kept in f32/f16 regardless of quantization (1-D + special cases;
# mirrors common-ggml.cpp quantization rules: only 2-D weights quantize)
_NO_QUANT_SUFFIXES = (".bias",)
_NO_QUANT_NAMES = {
    "encoder.positional_embedding",
    "decoder.positional_embedding",
    "encoder.conv1.bias",
    "encoder.conv2.bias",
}


def _encode_tensor(data: np.ndarray, ttype: int) -> bytes:
    flat = np.ascontiguousarray(data, np.float32).reshape(-1)
    if ttype == quant.GGML_TYPE_F32:
        return flat.tobytes()
    if ttype == quant.GGML_TYPE_F16:
        return flat.astype(np.float16).tobytes()
    if ttype == quant.GGML_TYPE_Q8_0:
        return _quantize_q8_0(flat)
    if ttype == quant.GGML_TYPE_Q5_0:
        return _quantize_q5_0(flat)
    if ttype == quant.GGML_TYPE_Q4_0:
        return _quantize_q4_0(flat)
    if ttype == quant.GGML_TYPE_Q4_1:
        return _quantize_q4_1(flat)
    if ttype == quant.GGML_TYPE_Q5_1:
        return _quantize_q5_1(flat)
    if ttype == quant.GGML_TYPE_Q2_K:
        return quant.quantize_q2_K(flat)
    if ttype == quant.GGML_TYPE_Q3_K:
        return quant.quantize_q3_K(flat)
    if ttype == quant.GGML_TYPE_Q4_K:
        return quant.quantize_q4_K(flat)
    if ttype == quant.GGML_TYPE_Q5_K:
        return quant.quantize_q5_K(flat)
    if ttype == quant.GGML_TYPE_Q6_K:
        return quant.quantize_q6_K(flat)
    raise NotImplementedError(f"quantize to {quant.type_name(ttype)}")


def _blocks(d: np.ndarray, *parts: np.ndarray) -> bytes:
    """One ggml block per row: the f16 scale `d`, then each (n, bytes)
    part in order, as one contiguous byte string."""
    cols = [d.astype(np.float16).reshape(-1, 1).view(np.uint8)]
    cols += [np.ascontiguousarray(p).view(np.uint8) for p in parts]
    return np.concatenate(cols, axis=1).tobytes()


def _quantize_q8_0(x: np.ndarray) -> bytes:
    """quant.quantize_q8_0, the same bytes, with no per-block loop."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.round(x * inv[:, None]).astype(np.int8)
    return _blocks(d, q)


def _quantize_q5_0(x: np.ndarray) -> bytes:
    """quant.quantize_q5_0, the same bytes, with no per-block loop: bit j of
    the u32 qh is bit 4 of value j."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, 32)
    amax_i = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), amax_i]
    d = (maxv / -16.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 16, 0, 31).astype(np.uint8)
    lo = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    qh = ((q >> 4).astype(np.uint32) << np.arange(32, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32)
    return _blocks(d, qh.astype("<u4").reshape(-1, 1), lo)


def _quantize_q4_0(x: np.ndarray) -> bytes:
    x = x.reshape(-1, 32)
    amax_i = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), amax_i]
    d = (maxv / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(x * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    return _blocks(d, (q[:, :16] & 0x0F) | (q[:, 16:] << 4))


def _quantize_q4_1(x: np.ndarray) -> bytes:
    x = x.reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / 15.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv[:, None]), 0, 15).astype(np.uint8)
    out = bytearray()
    for i in range(x.shape[0]):
        out += np.float16(d[i]).tobytes() + np.float16(mn[i]).tobytes()
        out += ((q[i, :16] & 0x0F) | (q[i, 16:] << 4)).tobytes()
    return bytes(out)


def _quantize_q5_1(x: np.ndarray) -> bytes:
    x = x.reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = ((mx - mn) / 31.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv[:, None]), 0, 31).astype(np.uint8)
    out = bytearray()
    for i in range(x.shape[0]):
        qh = np.uint32(0)
        for j in range(16):
            qh |= np.uint32(q[i, j] >> 4) << np.uint32(j)
            qh |= np.uint32(q[i, j + 16] >> 4) << np.uint32(j + 16)
        out += np.float16(d[i]).tobytes() + np.float16(mn[i]).tobytes()
        out += qh.tobytes()
        out += ((q[i, :16] & 0x0F) | ((q[i, 16:] & 0x0F) << 4)).tobytes()
    return bytes(out)


FTYPE_FOR_TYPE = {
    quant.GGML_TYPE_F32: 0, quant.GGML_TYPE_F16: 1, quant.GGML_TYPE_Q4_0: 2,
    quant.GGML_TYPE_Q4_1: 3, quant.GGML_TYPE_Q8_0: 7, quant.GGML_TYPE_Q5_0: 8,
    quant.GGML_TYPE_Q5_1: 9, quant.GGML_TYPE_Q2_K: 10,
    quant.GGML_TYPE_Q3_K: 11, quant.GGML_TYPE_Q4_K: 12,
    quant.GGML_TYPE_Q5_K: 13,
    quant.GGML_TYPE_Q6_K: 14,   # ggml.h:448-454 GGML_FTYPE_MOSTLY_Q*_K
}

TYPE_FOR_NAME = {
    "f32": quant.GGML_TYPE_F32, "f16": quant.GGML_TYPE_F16,
    "q4_0": quant.GGML_TYPE_Q4_0, "q4_1": quant.GGML_TYPE_Q4_1,
    "q5_0": quant.GGML_TYPE_Q5_0, "q5_1": quant.GGML_TYPE_Q5_1,
    "q8_0": quant.GGML_TYPE_Q8_0, "q2_k": quant.GGML_TYPE_Q2_K,
    "q3_k": quant.GGML_TYPE_Q3_K, "q4_k": quant.GGML_TYPE_Q4_K,
    "q5_k": quant.GGML_TYPE_Q5_K, "q6_k": quant.GGML_TYPE_Q6_K,
}


def write_checkpoint(path: str | Path, hparams: WhisperHParams,
                     mel_filters: np.ndarray, tokens: list[bytes],
                     tensors: dict[str, np.ndarray],
                     wtype: int = quant.GGML_TYPE_F16):
    """Write a whisper ggml-bin. `tensors` maps reference names to float
    arrays in their torch shapes; 2-D (or larger) weights get `wtype`,
    everything else f32 (conv biases already reshaped (n,1) as the
    reference converter does)."""
    path = Path(path)
    ftype = FTYPE_FOR_TYPE[wtype]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", GGML_MAGIC))
        f.write(struct.pack(
            "<11i", hparams.n_vocab, hparams.n_audio_ctx,
            hparams.n_audio_state, hparams.n_audio_head,
            hparams.n_audio_layer, hparams.n_text_ctx, hparams.n_text_state,
            hparams.n_text_head, hparams.n_text_layer, hparams.n_mels,
            ftype + GGML_QNT_VERSION * QNT_VERSION_FACTOR
            if ftype not in (0, 1) else ftype))
        f.write(struct.pack("<2i", mel_filters.shape[0], mel_filters.shape[1]))
        f.write(np.ascontiguousarray(mel_filters, np.float32).tobytes())
        f.write(struct.pack("<i", len(tokens)))
        for t in tokens:
            f.write(struct.pack("<i", len(t)))
            f.write(t)

        for name, data in tensors.items():
            data = np.asarray(data, np.float32)
            use = wtype
            if (data.ndim < 2 or name.endswith(_NO_QUANT_SUFFIXES)
                    or name in _NO_QUANT_NAMES):
                use = quant.GGML_TYPE_F32
            elif use not in (quant.GGML_TYPE_F32, quant.GGML_TYPE_F16):
                blk, _ = quant.block_info(use)
                if data.shape[-1] % blk != 0:
                    # every ggml row op assumes a row is a whole number of
                    # blocks (ne[0] % block == 0; ggml_quantize_chunk
                    # asserts n_per_row % QK_K), so gate per ROW — a
                    # size-divisible 384-row K-quant tensor would encode
                    # but misparse in the reference runtime. Fall back to
                    # f16 (e.g. tiny's d=384 attn weights under K-quants);
                    # the reference tool itself just aborts here.
                    use = quant.GGML_TYPE_F16
            blob = _encode_tensor(data, use)
            dims = list(reversed(data.shape))
            name_b = name.encode("utf-8")
            f.write(struct.pack("<3i", len(dims), len(name_b), use))
            for d in dims:
                f.write(struct.pack("<i", d))
            f.write(name_b)
            f.write(blob)


def random_reference_tensors(hparams: WhisperHParams, seed: int = 0,
                             scale: float = 0.05) -> dict[str, np.ndarray]:
    """Complete random-weight tensor set in the reference's names/shapes
    (src/whisper-arch.h:42-141, torch dim order; conv biases (n,1) as the
    converter writes them). Used to author full checkpoints that BOTH this
    framework and the reference C++ runtime can load — the basis of the
    cross-implementation golden tests."""
    rng = np.random.default_rng(seed)
    s, v = hparams.n_audio_state, hparams.n_vocab
    ts = hparams.n_text_state

    def w(*shape, sc=scale):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    def ones(n):
        return np.ones(n, np.float32) + w(n, sc=0.02)

    t: dict[str, np.ndarray] = {
        "encoder.positional_embedding": w(hparams.n_audio_ctx, s),
        "encoder.conv1.weight": w(s, hparams.n_mels, 3),
        "encoder.conv1.bias": w(s, 1),
        "encoder.conv2.weight": w(s, s, 3),
        "encoder.conv2.bias": w(s, 1),
        "encoder.ln_post.weight": ones(s), "encoder.ln_post.bias": w(s),
        "decoder.positional_embedding": w(hparams.n_text_ctx, ts),
        "decoder.token_embedding.weight": w(v, ts),
        "decoder.ln.weight": ones(ts), "decoder.ln.bias": w(ts),
    }
    for i in range(hparams.n_audio_layer):
        p = f"encoder.blocks.{i}"
        t.update({
            f"{p}.attn_ln.weight": ones(s), f"{p}.attn_ln.bias": w(s),
            f"{p}.attn.query.weight": w(s, s), f"{p}.attn.query.bias": w(s),
            f"{p}.attn.key.weight": w(s, s),
            f"{p}.attn.value.weight": w(s, s), f"{p}.attn.value.bias": w(s),
            f"{p}.attn.out.weight": w(s, s), f"{p}.attn.out.bias": w(s),
            f"{p}.mlp_ln.weight": ones(s), f"{p}.mlp_ln.bias": w(s),
            f"{p}.mlp.0.weight": w(4 * s, s), f"{p}.mlp.0.bias": w(4 * s),
            f"{p}.mlp.2.weight": w(s, 4 * s), f"{p}.mlp.2.bias": w(s),
        })
    for i in range(hparams.n_text_layer):
        p = f"decoder.blocks.{i}"
        t.update({
            f"{p}.attn_ln.weight": ones(ts), f"{p}.attn_ln.bias": w(ts),
            f"{p}.attn.query.weight": w(ts, ts), f"{p}.attn.query.bias": w(ts),
            f"{p}.attn.key.weight": w(ts, ts),
            f"{p}.attn.value.weight": w(ts, ts), f"{p}.attn.value.bias": w(ts),
            f"{p}.attn.out.weight": w(ts, ts), f"{p}.attn.out.bias": w(ts),
            f"{p}.cross_attn_ln.weight": ones(ts), f"{p}.cross_attn_ln.bias": w(ts),
            f"{p}.cross_attn.query.weight": w(ts, ts), f"{p}.cross_attn.query.bias": w(ts),
            f"{p}.cross_attn.key.weight": w(ts, ts),
            f"{p}.cross_attn.value.weight": w(ts, ts), f"{p}.cross_attn.value.bias": w(ts),
            f"{p}.cross_attn.out.weight": w(ts, ts), f"{p}.cross_attn.out.bias": w(ts),
            f"{p}.mlp_ln.weight": ones(ts), f"{p}.mlp_ln.bias": w(ts),
            f"{p}.mlp.0.weight": w(4 * ts, ts), f"{p}.mlp.0.bias": w(4 * ts),
            f"{p}.mlp.2.weight": w(ts, 4 * ts), f"{p}.mlp.2.bias": w(ts),
        })
    return t


def requantize(src_path: str | Path, dst_path: str | Path, type_name: str):
    """ggml-bin -> ggml-bin with re-quantized weights (the `quantize` tool)."""
    from .ggml_whisper import load_checkpoint
    ck = load_checkpoint(src_path)
    wtype = TYPE_FOR_NAME[type_name]
    tensors = {name: t.to_float() for name, t in ck.tensors.items()}
    write_checkpoint(dst_path, ck.hparams, ck.mel_filters, ck.tokens,
                     tensors, wtype)
