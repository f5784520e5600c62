"""Whisper encoder-decoder as PyTorch functions over a params dict.

Port of open_whisper_kit_tpu/models/whisper/model.py. It follows the same
compute graph and rounding points:

* params are nested dicts of tensors; per-layer weights are stacked on a
  leading layer axis; linears are stored (in, out) and convs (k, in, out),
  the JAX package's layouts, so forward matmuls are plain x @ W,
* a matmul's result is cast to the activation dtype before its bias add
  (`_mm`); the convs, the attention scores and the logits keep f32 results,
* the decoder self-attention Q and K are pre-scaled by d_head**-0.25, the
  cross K too (in `cross_kv`), and the cross scores are scaled by
  d_head**-0.25 again,
* the encoder pads once to a multiple of 128 when n_ctx >= 256 and masks
  the padded keys; its attention goes through ops.attention.mha_full
  (kernel K1 on CUDA tensors),
* the self-KV cache and the cross-KV are kept in the natural layout
  (L, B, T, S), the layout the later decode-step kernel reads; the JAX
  package keeps both head-major (L, B, H, T, dh),
* a linear may be a QuantLinear / QuantLinear4 plane (ops/quant_matmul.py):
  from a q8_0/q5_0/q4_0 checkpoint (`params_from_checkpoint`) or the
  runtime W8/W4 decoder (`quantize_decoder_int8`). `_mm` sends it to
  kernel K3 or K4, and the decoder MLP pair of unpadded int8 planes to K5,
* the cross-KV may be int8 (`FullParams.cross_kv_int8`): `quantize_cross_kv`
  turns the natural float cross-KV into JAX's head-major QuantKV planes,
  `quantize_cross_kv_nat` into its natural QuantKVNat slabs. `decode_impl`
  sends a one-row call over QuantKV to kernel K9b and one over QuantKVNat to
  K9a (ops/experiments.py); a multi-row call over QuantKV (prompt ingest,
  the speculative verify pass) takes `_attention_hm_q`, JAX's XLA einsum.
  The JAX package sends QuantKV to that einsum at every row count.

`decode_impl(collect_cross_qk=True)` also returns the softmax
cross-attention probabilities (the DTW timestamp signal), formed by
explicit products over the float or QuantKV cross-KV, never by a fused
kernel. The int8 self-cache (`init_kv_cache_q8`) is still to come.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ...io.ggml_whisper import WhisperCheckpoint, WhisperHParams
from ...ops.attention import mha_full
from ...ops.encoder_int8 import _INV127
from ...ops.experiments import (cross_attention_q8, cross_attention_q8_nat,
                                cross_attention_q8_plain)
from ...ops.layers import layer_norm as _ln
from ...ops.quant_matmul import (QuantLinear, QuantLinear4, QuantPlanes,
                                 concat_quant, fused_ffn_int8, qmatmul,
                                 quantize_linear, quantize_linear4, repack)
from ...ops.quant_matmul import stack as stack_quant

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    n_mels: int
    eps: float = 1e-5

    @classmethod
    def from_hparams(cls, hp: WhisperHParams) -> "WhisperConfig":
        return cls(hp.n_vocab, hp.n_audio_ctx, hp.n_audio_state, hp.n_audio_head,
                   hp.n_audio_layer, hp.n_text_ctx, hp.n_text_state,
                   hp.n_text_head, hp.n_text_layer, hp.n_mels)

    @property
    def d_audio_head(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def d_text_head(self) -> int:
        return self.n_text_state // self.n_text_head


# presets matching the OpenAI model family (for random init / benches)
PRESETS: dict[str, WhisperConfig] = {
    "tiny": WhisperConfig(51865, 1500, 384, 6, 4, 448, 384, 6, 4, 80),
    "tiny.en": WhisperConfig(51864, 1500, 384, 6, 4, 448, 384, 6, 4, 80),
    "base": WhisperConfig(51865, 1500, 512, 8, 6, 448, 512, 8, 6, 80),
    "small": WhisperConfig(51865, 1500, 768, 12, 12, 448, 768, 12, 12, 80),
    "medium": WhisperConfig(51865, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80),
    "large-v2": WhisperConfig(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80),
    "large-v3": WhisperConfig(51866, 1500, 1280, 20, 32, 448, 1280, 20, 32, 128),
    "large-v3-turbo": WhisperConfig(51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128),
}


# ---------------------------------------------------------------------------
# Param construction
# ---------------------------------------------------------------------------

def init_params(cfg: WhisperConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16, *,
                device: str | torch.device) -> Params:
    """Random-init params with the real model shapes.

    Draw for draw the same numbers as the JAX package's
    `init_params(cfg, seed, dtype, device=False)`: one numpy generator,
    the same draw order (dict order; a decoder block draws its encoder-block
    part first) and the same `* 0 + 1` layer-norm weights, which still
    consume their draws. Each array is cast to `dtype` as it is drawn, on
    `device`."""
    rng = np.random.default_rng(seed)
    s, v = cfg.n_audio_state, cfg.n_vocab

    def w(*shape, scale=None):
        scale = scale if scale is not None else (shape[-2] if len(shape) > 1 else 1) ** -0.5
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def enc_block():
        return {
            "attn_ln_w": w(s, scale=1.0) * 0 + 1, "attn_ln_b": w(s, scale=0.02),
            "q_w": w(s, s), "q_b": w(s, scale=0.02), "k_w": w(s, s),
            "v_w": w(s, s), "v_b": w(s, scale=0.02),
            "o_w": w(s, s), "o_b": w(s, scale=0.02),
            "mlp_ln_w": w(s, scale=1.0) * 0 + 1, "mlp_ln_b": w(s, scale=0.02),
            "mlp0_w": w(s, 4 * s), "mlp0_b": w(4 * s, scale=0.02),
            "mlp1_w": w(4 * s, s), "mlp1_b": w(s, scale=0.02),
        }

    def dec_block():
        d = enc_block()
        d.update({
            "cross_ln_w": w(s, scale=1.0) * 0 + 1, "cross_ln_b": w(s, scale=0.02),
            "cq_w": w(s, s), "cq_b": w(s, scale=0.02), "ck_w": w(s, s),
            "cv_w": w(s, s), "cv_b": w(s, scale=0.02),
            "co_w": w(s, s), "co_b": w(s, scale=0.02),
        })
        return d

    enc = {
        "conv1_w": w(3, cfg.n_mels, s, scale=(3 * cfg.n_mels) ** -0.5),
        "conv1_b": w(s, scale=0.02),
        "conv2_w": w(3, s, s, scale=(3 * s) ** -0.5),
        "conv2_b": w(s, scale=0.02),
        "pos": w(cfg.n_audio_ctx, s, scale=0.02),
        "blocks": _stack([enc_block() for _ in range(cfg.n_audio_layer)]),
        "ln_post_w": w(s, scale=1.0) * 0 + 1, "ln_post_b": w(s, scale=0.02),
    }
    dec = {
        "te": w(v, s, scale=0.02),
        "pe": w(cfg.n_text_ctx, s, scale=0.02),
        "blocks": _stack([dec_block() for _ in range(cfg.n_text_layer)]),
        "ln_w": w(s, scale=1.0) * 0 + 1, "ln_b": w(s, scale=0.02),
    }
    return {"encoder": enc, "decoder": dec}


def _stack(blocks: list[Params]) -> Params:
    """Per-layer dicts -> one dict of per-name stacks (tensors or planes)."""
    def one(xs):
        return stack_quant(xs) if isinstance(xs[0], QuantPlanes) else torch.stack(xs)
    return {k: one([b[k] for b in blocks]) for k in blocks[0]}


def params_from_checkpoint(ck: WhisperCheckpoint,
                           dtype: torch.dtype = torch.bfloat16,
                           keep_quant: bool = True) -> Params:
    """Build the params dict (CPU tensors) from a parsed ggml-bin checkpoint.

    Tensor names follow the reference table (src/whisper-arch.h:42-141).
    2-D ggml weights are stored (out,in); they are kept transposed (in,out)
    so forward matmuls are plain x @ W. With `keep_quant`, symmetric
    block-quantized matmul weights stay QuantLinear planes (kernel K3/K5);
    other formats dequantize to `dtype`."""
    cfg = WhisperConfig.from_hparams(ck.hparams)

    def get(name, transpose=False):
        raw = ck.tensors[name]
        if keep_quant and transpose and len(raw.shape) == 2:
            ql = repack(raw.data, raw.ggml_type, raw.shape[0], raw.shape[1])
            if ql is not None:
                return ql
        t = raw.to_float()
        if transpose:
            t = t.T
        return torch.from_numpy(np.ascontiguousarray(t)).to(dtype)

    def enc_block(i):
        p = f"encoder.blocks.{i}"
        return {
            "attn_ln_w": get(f"{p}.attn_ln.weight"), "attn_ln_b": get(f"{p}.attn_ln.bias"),
            "q_w": get(f"{p}.attn.query.weight", True), "q_b": get(f"{p}.attn.query.bias"),
            "k_w": get(f"{p}.attn.key.weight", True),
            "v_w": get(f"{p}.attn.value.weight", True), "v_b": get(f"{p}.attn.value.bias"),
            "o_w": get(f"{p}.attn.out.weight", True), "o_b": get(f"{p}.attn.out.bias"),
            "mlp_ln_w": get(f"{p}.mlp_ln.weight"), "mlp_ln_b": get(f"{p}.mlp_ln.bias"),
            "mlp0_w": get(f"{p}.mlp.0.weight", True), "mlp0_b": get(f"{p}.mlp.0.bias"),
            "mlp1_w": get(f"{p}.mlp.2.weight", True), "mlp1_b": get(f"{p}.mlp.2.bias"),
        }

    def dec_block(i):
        p = f"decoder.blocks.{i}"
        return {
            "attn_ln_w": get(f"{p}.attn_ln.weight"), "attn_ln_b": get(f"{p}.attn_ln.bias"),
            "q_w": get(f"{p}.attn.query.weight", True), "q_b": get(f"{p}.attn.query.bias"),
            "k_w": get(f"{p}.attn.key.weight", True),
            "v_w": get(f"{p}.attn.value.weight", True), "v_b": get(f"{p}.attn.value.bias"),
            "o_w": get(f"{p}.attn.out.weight", True), "o_b": get(f"{p}.attn.out.bias"),
            "cross_ln_w": get(f"{p}.cross_attn_ln.weight"), "cross_ln_b": get(f"{p}.cross_attn_ln.bias"),
            "cq_w": get(f"{p}.cross_attn.query.weight", True), "cq_b": get(f"{p}.cross_attn.query.bias"),
            "ck_w": get(f"{p}.cross_attn.key.weight", True),
            "cv_w": get(f"{p}.cross_attn.value.weight", True), "cv_b": get(f"{p}.cross_attn.value.bias"),
            "co_w": get(f"{p}.cross_attn.out.weight", True), "co_b": get(f"{p}.cross_attn.out.bias"),
            "mlp_ln_w": get(f"{p}.mlp_ln.weight"), "mlp_ln_b": get(f"{p}.mlp_ln.bias"),
            "mlp0_w": get(f"{p}.mlp.0.weight", True), "mlp0_b": get(f"{p}.mlp.0.bias"),
            "mlp1_w": get(f"{p}.mlp.2.weight", True), "mlp1_b": get(f"{p}.mlp.2.bias"),
        }

    # conv weights: ggml/torch (out, in, k) -> the JAX package's (k, in, out)
    def conv(name):
        c = ck.to_float(name).transpose(2, 1, 0)
        return torch.from_numpy(np.ascontiguousarray(c)).to(dtype)

    enc = {
        "conv1_w": conv("encoder.conv1.weight"),
        "conv1_b": get("encoder.conv1.bias").reshape(-1),
        "conv2_w": conv("encoder.conv2.weight"),
        "conv2_b": get("encoder.conv2.bias").reshape(-1),
        "pos": get("encoder.positional_embedding"),
        "blocks": _stack([enc_block(i) for i in range(cfg.n_audio_layer)]),
        "ln_post_w": get("encoder.ln_post.weight"), "ln_post_b": get("encoder.ln_post.bias"),
    }
    dec = {
        "te": get("decoder.token_embedding.weight"),
        "pe": get("decoder.positional_embedding"),
        "blocks": _stack([dec_block(i) for i in range(cfg.n_text_layer)]),
        "ln_w": get("decoder.ln.weight"), "ln_b": get("decoder.ln.bias"),
    }
    return {"encoder": enc, "decoder": dec}


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable: jax hands out read-only views
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16 from a jax array
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: dict, *, device: str | torch.device) -> Params:
    """The JAX package's params pytree (nested dicts of numpy arrays, e.g.
    `jax.tree.map(np.asarray, tree)`) -> the port's params, bit for bit.

    The layouts carry over unchanged: linears (in, out), convs
    (k, in, out), per-layer weights stacked on a leading layer axis. The
    JAX package's QuantLinear / QuantLinear4 planes become the port's."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    kind = {"QuantLinear": QuantLinear, "QuantLinear4": QuantLinear4}.get(
        type(tree).__name__)
    if kind is not None:
        return kind(qs=_from_numpy(np.asarray(tree.qs)).to(device),
                    scales=_from_numpy(np.asarray(tree.scales)).to(device),
                    n=tree.n)
    return _from_numpy(np.asarray(tree)).to(device)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w with f32 accumulation, result in x's dtype; quantized planes
    go through qmatmul (kernels K3/K4 on the card). Mixed dtypes (the W8A8
    encoder's bf16 output against f32 weights) multiply in the wider one,
    as jnp.dot promotes."""
    if isinstance(w, QuantPlanes):
        return qmatmul(x, w).to(x.dtype)
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(t), w.to(t)).to(x.dtype)
    return torch.matmul(x, w).to(x.dtype)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result (the JAX side's preferred_element_type=f32):
    16-bit operands are exact in f32, so upcasting first keeps every
    product exact."""
    return torch.matmul(a.float(), b.float())


def _layer(blocks: Params, il: int) -> Params:
    return {k: v[il] for k, v in blocks.items()}


def _attention(q, k, v, n_head, scale, mask=None, with_probs: bool = False):
    """q (B,Tq,S), k (B,Tk,S), v (B,Tk,S) -> (B,Tq,S); f32 scores and
    softmax, probabilities cast to q's dtype before P.V. `with_probs`: also
    return the f32 probabilities (B,H,Tq,Tk)."""
    B, Tq, S = q.shape
    Tk = k.shape[1]
    d = S // n_head
    scores = torch.einsum("bqhd,bkhd->bhqk",
                          q.reshape(B, Tq, n_head, d).float(),
                          k.reshape(B, Tk, n_head, d).float()) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype),
                       v.reshape(B, Tk, n_head, d)).reshape(B, Tq, S)
    return (out, probs) if with_probs else out


_ENC_PAD_MIN_T = 256   # pad-once threshold (the JAX package's, attention._MIN_FLASH_T)


def conv1d_mm(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """1-D conv (kernel 3, pad 1) as an im2col matmul, f32 result.

    x (B, T, Cin), w (3, Cin, Cout) -> (B, T_out, Cout); tap order
    [t-1 | t | t+1] matches w's (3, Cin, Cout) row-major flatten."""
    B, T, Ci = x.shape
    Co = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1))
    To = (T - 1) // stride + 1
    taps = [xp[:, k:k + (To - 1) * stride + 1:stride] for k in range(3)]
    xw = torch.cat(taps, dim=-1)               # (B, To, 3*Ci)
    return _dot_f32(xw, w.reshape(3 * Ci, Co))


def _encoder_block(cfg: WhisperConfig, p: Params, x: torch.Tensor,
                   n_valid: int | None = None) -> torch.Tensor:
    scale = 1.0 / np.sqrt(cfg.d_audio_head)
    h = _ln(x, p["attn_ln_w"], p["attn_ln_b"], cfg.eps)
    q = _mm(h, p["q_w"]) + p["q_b"]
    k = _mm(h, p["k_w"])  # no key bias (whisper.cpp:2125)
    v = _mm(h, p["v_w"]) + p["v_b"]
    a = mha_full(q, k, v, cfg.n_audio_head, scale, kv_valid=n_valid)
    x = x + _mm(a, p["o_w"]) + p["o_b"]
    h = _ln(x, p["mlp_ln_w"], p["mlp_ln_b"], cfg.eps)
    h = F.gelu(_mm(h, p["mlp0_w"]) + p["mlp0_b"], approximate="tanh")
    return x + _mm(h, p["mlp1_w"]) + p["mlp1_b"]


def encode(cfg: WhisperConfig, enc: Params, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, 2*n_ctx, n_mels) -> encoder output (B, n_ctx, n_state).

    conv1(s1)+gelu, conv2(s2)+gelu (gelu on the f32 conv result, then cast),
    + positional embedding, pre-LN blocks, final layernorm. W8A8 params
    (`ops.encoder_int8.prepare_encoder_int8`, told apart by their int8
    `qkv_q` planes) go to `encode_int8`, as the JAX package routes them."""
    if "qkv_q" in enc["blocks"]:
        from ...ops.encoder_int8 import encode_int8
        return encode_int8(cfg, enc, mel)
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)
    x = conv1d_mm(x, enc["conv1_w"], 1)
    x = F.gelu(x + enc["conv1_b"].float(), approximate="tanh").to(dtype)
    x = conv1d_mm(x, enc["conv2_w"], 2)
    x = F.gelu(x + enc["conv2_b"].float(), approximate="tanh").to(dtype)

    n_ctx = x.shape[1]
    x = x + enc["pos"][:n_ctx].to(dtype)

    # pad ONCE to a multiple of 128; padded keys are masked in attention,
    # padded query rows never feed live positions and are sliced off below
    n_pad = -n_ctx % 128 if n_ctx >= _ENC_PAD_MIN_T else 0
    if n_pad:
        x = F.pad(x, (0, 0, 0, n_pad))
    for il in range(cfg.n_audio_layer):
        x = _encoder_block(cfg, _layer(enc["blocks"], il), x,
                           n_valid=n_ctx if n_pad else None)
    if n_pad:
        x = x[:, :n_ctx]
    return _ln(x, enc["ln_post_w"], enc["ln_post_b"], cfg.eps)


def cross_kv(cfg: WhisperConfig, dec: Params, enc_out: torch.Tensor):
    """enc_out (B,Ta,S) -> (xk, xv) each (L,B,Ta,S), natural layout; xk
    pre-scaled d**-0.25."""
    kscale = float(cfg.d_text_head) ** -0.25
    blocks = dec["blocks"]
    ks, vs = [], []
    for il in range(cfg.n_text_layer):
        ks.append(_mm(enc_out, blocks["ck_w"][il]) * kscale)
        vs.append(_mm(enc_out, blocks["cv_w"][il]) + blocks["cv_b"][il])
    return torch.stack(ks), torch.stack(vs)


def encode_with_cross_kv(cfg: WhisperConfig, enc: Params, dec: Params,
                         mel: torch.Tensor):
    """encode + cross-KV precompute -> (enc_out, xk, xv)."""
    enc_out = encode(cfg, enc, mel)
    xk, xv = cross_kv(cfg, dec, enc_out)
    return enc_out, xk, xv


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: WhisperConfig, n_beams: int,
                  dtype: torch.dtype = torch.bfloat16, *,
                  device: str | torch.device, width: int | None = None):
    """Static self-attention cache, natural layout (L, B, width, S); `width`
    defaults to n_text_ctx. A decode that never passes position `width`
    may allocate narrower: the masked columns add exact zeros to the
    softmax (see widen_kv_cache)."""
    shape = (cfg.n_text_layer, n_beams, width or cfg.n_text_ctx, cfg.n_text_state)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def widen_kv_cache(kv: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad a (L, B, C, S) cache on the position axis to `width` (the
    stage change of a staged-width decode loop)."""
    C = kv.shape[2]
    return kv if C >= width else F.pad(kv, (0, 0, 0, width - C))


def reorder_kv(kv_k: torch.Tensor, kv_v: torch.Tensor, src: torch.Tensor):
    """Beam shuffle of (L, B, n_ctx, S) caches: new beam b = old beam
    src[b] (replaces the reference's kv_seq_cp cell surgery,
    whisper.cpp:7301-7352). `src` a long tensor on the caches' device."""
    return kv_k.index_select(1, src), kv_v.index_select(1, src)


def prepare_decoder(dec: Params) -> Params:
    """Fuse the self-attention q/k/v projections into one matmul per layer
    (K gets a zero bias); quantized weights fuse by concatenating their
    planes. Returns a new decoder dict; the original q/k/v names are
    dropped for the fused ones."""
    blocks = dict(dec["blocks"])
    q_w, k_w, v_w = blocks.pop("q_w"), blocks.pop("k_w"), blocks.pop("v_w")
    q_b, v_b = blocks.pop("q_b"), blocks.pop("v_b")
    if isinstance(q_w, QuantLinear):
        blocks["qkv_w"] = concat_quant([q_w, k_w, v_w])
    else:
        blocks["qkv_w"] = torch.cat([q_w, k_w, v_w], dim=-1)
    blocks["qkv_b"] = torch.cat([q_b, torch.zeros_like(q_b), v_b], dim=-1)
    out = dict(dec)
    out["blocks"] = blocks
    return out


class QuantKV(NamedTuple):
    """Int8 cross-KV with per-position scales in JAX's head-major layout:
    qs (L, B, H, Ta, dh) int8, scale (L, B, H, Ta) f32. Halves the bytes
    each decoder step reads from the cross-KV."""
    qs: torch.Tensor
    scale: torch.Tensor


class QuantKVNat(NamedTuple):
    """Int8 cross-KV in the natural layout (JAX's QuantKVNat): qs
    (L, B, Tap, S) int8 slabs, Ta padded with zero rows to a multiple of 32;
    scale (L, B, Hs, Tap) f32 per (head, position), H padded to a multiple
    of 8; `ta_valid` the live positions before the pad."""
    qs: torch.Tensor
    scale: torch.Tensor
    ta_valid: int


def _quantize_head_rows(x: torch.Tensor, n_head: int):
    """Natural (L, B, Ta, S) float -> head-major int8 (L, B, H, Ta, dh) and
    f32 scales (L, B, H, Ta): symmetric per row over dh, scale = amax / 127,
    q = round(x / scale) half to even, clipped to +-127, an all-zero row
    giving zeros with scale 0 (JAX's quantize_cross_kv, bit for bit)."""
    L, B, Ta, S = x.shape
    x32 = x.float().reshape(L, B, Ta, n_head, S // n_head).transpose(2, 3).contiguous()
    scale = x32.abs().amax(dim=-1) * _INV127    # a jitted amax / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    inv = torch.where(scale > 0, torch.ones_like(scale) / safe, 0.0)   # IEEE division
    qs = torch.clamp(torch.round(x32 * inv[..., None]), -127, 127).to(torch.int8)
    return qs, scale


def quantize_cross_kv(x: torch.Tensor, n_head: int) -> QuantKV:
    """The port's natural (L, B, Ta, S) float cross-KV -> QuantKV, equal to
    JAX's quantize_cross_kv of the same tensor in its head-major layout."""
    qs, scale = _quantize_head_rows(x, n_head)
    return QuantKV(qs=qs, scale=scale)


def quantize_cross_kv_nat(x: torch.Tensor, n_head: int) -> QuantKVNat:
    """The natural (L, B, Ta, S) float cross-KV -> QuantKVNat with JAX's
    pads (Ta to a multiple of 32, H to a multiple of 8): the same numbers
    as quantize_cross_kv, laid out as JAX's quantize_cross_kv_nat."""
    L, B, Ta, S = x.shape
    q, scale = _quantize_head_rows(x, n_head)
    Tap, Hs = -(-Ta // 32) * 32, -(-n_head // 8) * 8
    qs = F.pad(q.transpose(2, 3).reshape(L, B, Ta, S), (0, 0, 0, Tap - Ta))
    sc = F.pad(scale, (0, Tap - Ta, 0, Hs - n_head))
    return QuantKVNat(qs=qs.contiguous(), scale=sc.contiguous(), ta_valid=Ta)


# JAX's `_attention_hm_q` (without its self-cache mask) is K9b's plain
# version at any row count: attention over head-major int8 K/V planes with
# their scales folded into the scores and the probabilities
_attention_hm_q = cross_attention_q8_plain


def _rows_probs(probs: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """(Bk, H, B*T/Bk, Ta) probabilities of rows folded onto a batch-Bk
    cross-KV -> (B, H, T, Ta)."""
    Bk, H, _, Ta = probs.shape
    return probs.reshape(Bk, H, B // Bk, T, Ta).transpose(1, 2).reshape(B, H, T, Ta)


def decode_impl(cfg: WhisperConfig, dec: Params, tokens: torch.Tensor,
                kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                xk: torch.Tensor, xv: torch.Tensor, logits_pos=None,
                collect_cross_qk: bool = False):
    """One decoder forward over `tokens` (B,T) starting at cache slot
    `kv_head` (an int or a 0-d integer tensor; a tensor keeps the host out
    of the loop).

    Writes this call's K/V rows into kv_k/kv_v (L,B,n_ctx,S) IN PLACE and
    returns (logits (B,T,n_vocab) f32, kv_k, kv_v). `logits_pos` (int or
    0-d tensor): compute logits for that token position only, shape
    (B,1,V). xk/xv (L, B or 1, Ta, S), or QuantKV / QuantKVNat planes of
    batch B or 1: with batch 1 all B rows share one cross-KV. A QuantKVNat
    drives one-row steps only. Takes `dec` after prepare_decoder (fused
    qkv).

    `collect_cross_qk`: also return cross_qk, the (L, B, H, T, Ta) f32
    softmax cross-attention probabilities (whisper.cpp:2720-2736), as a
    fourth element; their layer's cross-attention then runs on explicit
    products (never K9b), and a QuantKVNat cross-KV is refused."""
    dtype = kv_k.dtype
    dev = tokens.device
    B, T = tokens.shape
    if isinstance(xk, QuantKVNat) and (T != 1 or collect_cross_qk):
        raise ValueError("QuantKVNat drives the single-token serving step only")
    C = kv_k.shape[2]
    S, H = cfg.n_text_state, cfg.n_text_head
    kqscale = float(cfg.d_text_head) ** -0.25
    positions = torch.as_tensor(kv_head, device=dev).long() + torch.arange(T, device=dev)

    # positions past the table take its last row, as JAX's gather clamps
    # (the speculative verify pass may run a few rows past n_text_ctx)
    pe = dec["pe"].index_select(0, positions.clamp(max=dec["pe"].shape[0] - 1))
    x = dec["te"][tokens].to(dtype) + pe[None].to(dtype)

    # causal-with-cache mask: token at global pos p attends kv cols <= p
    mask = torch.where(torch.arange(C, device=dev)[None, :] <= positions[:, None],
                       0.0, float("-inf"))

    blocks = dec["blocks"]
    cross_probs = []
    for il in range(cfg.n_text_layer):
        p = _layer(blocks, il)
        h = _ln(x, p["attn_ln_w"], p["attn_ln_b"], cfg.eps)
        qkv = _mm(h, p["qkv_w"]) + p["qkv_b"]
        q = qkv[..., :S] * kqscale
        k = qkv[..., S:2 * S] * kqscale
        v = qkv[..., 2 * S:]
        kv_k[il].index_copy_(1, positions, k.to(dtype))
        kv_v[il].index_copy_(1, positions, v.to(dtype))
        a = _attention(q, kv_k[il], kv_v[il], H, 1.0, mask)
        x = x + _mm(a, p["o_w"]) + p["o_b"]

        h = _ln(x, p["cross_ln_w"], p["cross_ln_b"], cfg.eps)
        cq = _mm(h, p["cq_w"]) + p["cq_b"]
        if isinstance(xk, QuantKVNat):      # kernel K9a
            ca = cross_attention_q8_nat(cq, xk.qs[il], xk.scale[il], xv.qs[il],
                                        xv.scale[il], H, kqscale, xk.ta_valid)
        elif isinstance(xk, QuantKV) and T == 1 and not collect_cross_qk:   # kernel K9b
            ca = cross_attention_q8(cq, xk.qs[il], xk.scale[il], xv.qs[il],
                                    xv.scale[il], H, kqscale)
        else:
            # a cross-KV of batch 1 serves every row: fold the rows into queries
            if isinstance(xk, QuantKV):
                ca = _attention_hm_q(cq.reshape(xk.qs.shape[1], -1, S), xk.qs[il],
                                     xk.scale[il], xv.qs[il], xv.scale[il], H, kqscale,
                                     with_probs=collect_cross_qk)
            else:
                ca = _attention(cq.reshape(xk.shape[1], -1, S), xk[il], xv[il], H,
                                kqscale, with_probs=collect_cross_qk)
            if collect_cross_qk:
                ca, probs = ca
                cross_probs.append(_rows_probs(probs, B, T))
            ca = ca.reshape(B, T, S)
        x = x + _mm(ca, p["co_w"]) + p["co_b"]

        h = _ln(x, p["mlp_ln_w"], p["mlp_ln_b"], cfg.eps)
        w0, w1 = p["mlp0_w"], p["mlp1_w"]
        if (isinstance(w0, QuantLinear) and isinstance(w1, QuantLinear)
                and w0.qs.shape[-1] == w0.n_out):   # kernel K5
            x = x + fused_ffn_int8(h, w0, p["mlp0_b"], w1).to(x.dtype) + p["mlp1_b"]
        else:
            h = F.gelu(_mm(h, w0) + p["mlp0_b"], approximate="tanh")
            x = x + _mm(h, w1) + p["mlp1_b"]

    x = _ln(x, dec["ln_w"], dec["ln_b"], cfg.eps)
    if logits_pos is not None:
        x = x.index_select(1, torch.as_tensor(logits_pos, device=dev).long().reshape(1))
    if "te_logits" in dec:   # quantized planes of te.T (quantize_decoder_int8)
        logits = qmatmul(x, dec["te_logits"])
    else:
        logits = _dot_f32(x, dec["te"].t())
    if collect_cross_qk:
        return logits, kv_k, kv_v, torch.stack(cross_probs)
    return logits, kv_k, kv_v


# weights on the per-token decode path; ck/cv (per-window cross-KV build)
# and the encoder stay dense: they are compute-bound, not stream-bound
_INT8_DECODE_WEIGHTS = ("qkv_w", "q_w", "k_w", "v_w", "o_w", "cq_w", "co_w",
                        "mlp0_w", "mlp1_w")


def quantize_decoder_int8(dec: Params, scope: str = "logits",
                          logits_bits: int = 8) -> Params:
    """Runtime W8: repack decoder matmul weights into int8 QuantLinear
    planes (q8_0-level error). The token-embedding gather keeps the dense
    `te`. Apply after prepare_decoder.

    scope="logits" quantizes only the vocab projection (`te_logits`, the
    one plane big enough that halving its bytes matters); "mlp" also the
    MLP pair, which then runs through kernel K5 (mlp0 keeps its logical
    width); "all" also the attention matmuls. logits_bits=4 makes
    `te_logits` a split-half int4 plane (q4_0-level error, kernel K4)."""
    out = dict(dec)
    if scope in ("all", "mlp"):
        blocks = dict(dec["blocks"])
        names = (_INT8_DECODE_WEIGHTS if scope == "all"
                 else ("mlp0_w", "mlp1_w"))
        for name in names:
            w = blocks.get(name)
            if w is None or isinstance(w, QuantLinear):
                continue
            if w.shape[-2] % 32 or w.shape[-1] % 32:
                continue   # not block-divisible (tiny test configs)
            # mlp0 feeds the fused FFN kernel: unpadded logical width
            blocks[name] = quantize_linear(w, pad=(name != "mlp0_w"))
        out["blocks"] = blocks
    te = dec["te"]
    if te.shape[-1] % 32 == 0 and "te_logits" not in dec:
        q = quantize_linear4 if logits_bits == 4 else quantize_linear
        out["te_logits"] = q(te.t())
    return out
