"""Streaming SortFormer diarization model (NVIDIA, 117 M params) as PyTorch
functions over a params dict, on an explicit device.

Port of open_whisper_kit_tpu/models/sortformer/model.py, a re-derivation of
the reference engine's compute pipeline (streaming-sortformer/src/
sortformer.cpp):

* NeMo mel front-end (:779-894) -- preemphasis 0.97, constant pad 256,
  400-tap Hann centered in 512-point frames, log(x + 2^-24), frames beyond
  seq_len zeroed, padded to a multiple of 16,
* pre-encoder (:900-1049) -- conv2d(1->256,k3,s2) + 2x depthwise-separable
  conv2d subsampling (8x), flatten (C,F)-major, linear to d_model=512,
* 17-layer Conformer (:1100-1345) -- macaron FFN halves (SiLU), rel-pos
  multi-head attention with pos_bias_u/v and the Transformer-XL rel-shift,
  GLU + depthwise-conv(k=9, BN-fused) module, per-layer final LN,
* 512->192 projection, 18-layer post-LN Transformer (:1412-1560),
* prediction head (:1566-1650) -- ReLU, linear, ReLU, linear(192->4), sigmoid.

The params keep the JAX package's layouts: linears (in, out), the
pre-encoder convs HWIO (kh, kw, in, out), per-layer weights stacked on a
leading layer axis (the JAX side's lax.scan over the stacks is a loop over
their layers here). The convs are im2col products and sums of shifted
products, not F.conv2d: matmuls stay f32 on the card (torch's default),
where cuDNN convolutions would run in TF32 under torch's default
`cudnn.allow_tf32`. Like the JAX model, a 16-bit model's head runs f32
activations against its rounded weights (the xscale promotes them). The
head is host-paced (thousands of small launches a chunk), so a linear is
one GEMM with its bias in the epilogue and a LayerNorm one launch; each is
an ulp from the JAX graph's rounding order.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ...audio.mel import _rdft_mats
from ...io.gguf import GGUFFile
from ..whisper.model import _from_numpy

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SortformerConfig:
    n_mels: int = 128
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    sample_rate: int = 16000
    preemph: float = 0.97
    log_guard: float = 2.0 ** -24
    pad_to: int = 16

    d_model: int = 512
    n_layers: int = 17
    n_heads: int = 8
    conv_kernel: int = 9
    ff_expansion: int = 4
    subsampling: int = 8
    subsampling_channels: int = 256

    tf_layers: int = 18
    tf_d_model: int = 192
    tf_heads: int = 8
    tf_ff: int = 768

    n_spk: int = 4
    eps: float = 1e-5

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def tf_d_head(self) -> int:
        return self.tf_d_model // self.tf_heads

    @classmethod
    def from_gguf(cls, g: GGUFFile) -> "SortformerConfig":
        md = g.metadata
        def u(key, default):
            return int(md.get(key, default))
        return cls(
            n_mels=u("sortformer.mel.n_mels", 128),
            n_fft=u("sortformer.mel.n_fft", 512),
            hop_length=u("sortformer.mel.hop_length", 160),
            win_length=u("sortformer.mel.win_length", 400),
            sample_rate=u("sortformer.mel.sample_rate", 16000),
            d_model=u("sortformer.encoder.d_model", 512),
            n_layers=u("sortformer.encoder.n_layers", 17),
            n_heads=u("sortformer.encoder.n_heads", 8),
            conv_kernel=u("sortformer.encoder.conv_kernel_size", 9),
            ff_expansion=u("sortformer.encoder.ff_expansion", 4),
            subsampling=u("sortformer.encoder.subsampling_factor", 8),
            subsampling_channels=u("sortformer.encoder.subsampling_conv_channels", 256),
            tf_layers=u("sortformer.transformer.n_layers", 18),
            tf_d_model=u("sortformer.transformer.d_model", 192),
            tf_heads=u("sortformer.transformer.n_heads", 8),
            tf_ff=u("sortformer.transformer.ff_inner", 768),
            n_spk=u("sortformer.n_speakers", 4),
        )


_F32_KEYS = ("mel_fb", "mel_window")   # read as raw floats by the front-end


def _to_torch(tree, dtype: torch.dtype, device, key: str = ""):
    """A nested dict of f32 numpy arrays -> tensors in `dtype` on `device`
    (the mel filterbank and window stay f32)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype, device, k) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree, np.float32))
    return t.to(device=device, dtype=torch.float32 if key in _F32_KEYS else dtype)


def params_from_gguf(g: GGUFFile, dtype: torch.dtype = torch.float32, *,
                     device: str | torch.device) -> tuple[SortformerConfig, Params]:
    cfg = SortformerConfig.from_gguf(g)

    def t(name, transpose=False):
        a = g.to_float(name)
        return a.T if transpose else a

    def conf_layer(i):
        p = f"encoder.layers.{i}"
        return {
            "norm_ff1_w": t(f"{p}.norm_feed_forward1.weight"),
            "norm_ff1_b": t(f"{p}.norm_feed_forward1.bias"),
            "ff1_up_w": t(f"{p}.feed_forward1.linear1.weight", True),
            "ff1_up_b": t(f"{p}.feed_forward1.linear1.bias"),
            "ff1_down_w": t(f"{p}.feed_forward1.linear2.weight", True),
            "ff1_down_b": t(f"{p}.feed_forward1.linear2.bias"),
            "norm_sa_w": t(f"{p}.norm_self_att.weight"),
            "norm_sa_b": t(f"{p}.norm_self_att.bias"),
            "q_w": t(f"{p}.self_attn.linear_q.weight", True),
            "q_b": t(f"{p}.self_attn.linear_q.bias"),
            "k_w": t(f"{p}.self_attn.linear_k.weight", True),
            "k_b": t(f"{p}.self_attn.linear_k.bias"),
            "v_w": t(f"{p}.self_attn.linear_v.weight", True),
            "v_b": t(f"{p}.self_attn.linear_v.bias"),
            "out_w": t(f"{p}.self_attn.linear_out.weight", True),
            "out_b": t(f"{p}.self_attn.linear_out.bias"),
            "pos_w": t(f"{p}.self_attn.linear_pos.weight", True),
            "pos_bias_u": t(f"{p}.self_attn.pos_bias_u"),   # (H, d_head)
            "pos_bias_v": t(f"{p}.self_attn.pos_bias_v"),
            "norm_conv_w": t(f"{p}.norm_conv.weight"),
            "norm_conv_b": t(f"{p}.norm_conv.bias"),
            # pointwise convs stored (out, in, 1) -> (in, out) matmul form
            "pw1_w": g.to_float(f"{p}.conv.pointwise_conv1.weight")
                      .reshape(2 * cfg.d_model, cfg.d_model).T,
            "pw1_b": t(f"{p}.conv.pointwise_conv1.bias"),
            # depthwise (512, 1, 9) -> (9, 512) kernel-major
            "dw_w": g.to_float(f"{p}.conv.depthwise_conv.weight")
                     .reshape(cfg.d_model, cfg.conv_kernel).T,
            "dw_b": t(f"{p}.conv.depthwise_conv.bias"),
            "pw2_w": g.to_float(f"{p}.conv.pointwise_conv2.weight")
                      .reshape(cfg.d_model, cfg.d_model).T,
            "pw2_b": t(f"{p}.conv.pointwise_conv2.bias"),
            "norm_ff2_w": t(f"{p}.norm_feed_forward2.weight"),
            "norm_ff2_b": t(f"{p}.norm_feed_forward2.bias"),
            "ff2_up_w": t(f"{p}.feed_forward2.linear1.weight", True),
            "ff2_up_b": t(f"{p}.feed_forward2.linear1.bias"),
            "ff2_down_w": t(f"{p}.feed_forward2.linear2.weight", True),
            "ff2_down_b": t(f"{p}.feed_forward2.linear2.bias"),
            "norm_out_w": t(f"{p}.norm_out.weight"),
            "norm_out_b": t(f"{p}.norm_out.bias"),
        }

    def tf_layer(i):
        p = f"transformer_encoder.layers.{i}"
        return {
            "q_w": t(f"{p}.first_sub_layer.query_net.weight", True),
            "q_b": t(f"{p}.first_sub_layer.query_net.bias"),
            "k_w": t(f"{p}.first_sub_layer.key_net.weight", True),
            "k_b": t(f"{p}.first_sub_layer.key_net.bias"),
            "v_w": t(f"{p}.first_sub_layer.value_net.weight", True),
            "v_b": t(f"{p}.first_sub_layer.value_net.bias"),
            "out_w": t(f"{p}.first_sub_layer.out_projection.weight", True),
            "out_b": t(f"{p}.first_sub_layer.out_projection.bias"),
            "ln1_w": t(f"{p}.layer_norm_1.weight"), "ln1_b": t(f"{p}.layer_norm_1.bias"),
            "ff_up_w": t(f"{p}.second_sub_layer.dense_in.weight", True),
            "ff_up_b": t(f"{p}.second_sub_layer.dense_in.bias"),
            "ff_down_w": t(f"{p}.second_sub_layer.dense_out.weight", True),
            "ff_down_b": t(f"{p}.second_sub_layer.dense_out.bias"),
            "ln2_w": t(f"{p}.layer_norm_2.weight"), "ln2_b": t(f"{p}.layer_norm_2.bias"),
        }

    # pre-encoder conv weights: torch (out, in, kh, kw) -> HWIO (kh, kw, in, out)
    def conv2d_w(name):
        return g.to_float(name).transpose(2, 3, 1, 0)

    tree = {
        "mel_fb": g.to_float("preprocessor.featurizer.fb"),
        "mel_window": g.to_float("preprocessor.featurizer.window"),
        "preenc": {
            "conv0_w": conv2d_w("encoder.pre_encode.conv.0.weight"),
            "conv0_b": t("encoder.pre_encode.conv.0.bias"),
            "conv2_w": conv2d_w("encoder.pre_encode.conv.2.weight"),   # depthwise
            "conv2_b": t("encoder.pre_encode.conv.2.bias"),
            "conv3_w": conv2d_w("encoder.pre_encode.conv.3.weight"),   # pointwise
            "conv3_b": t("encoder.pre_encode.conv.3.bias"),
            "conv5_w": conv2d_w("encoder.pre_encode.conv.5.weight"),
            "conv5_b": t("encoder.pre_encode.conv.5.bias"),
            "conv6_w": conv2d_w("encoder.pre_encode.conv.6.weight"),
            "conv6_b": t("encoder.pre_encode.conv.6.bias"),
            "out_w": t("encoder.pre_encode.out.weight", True),
            "out_b": t("encoder.pre_encode.out.bias"),
        },
        "conformer": _stack([conf_layer(i) for i in range(cfg.n_layers)]),
        "proj_w": t("sortformer_modules.encoder_proj.weight", True),
        "proj_b": t("sortformer_modules.encoder_proj.bias"),
        "transformer": _stack([tf_layer(i) for i in range(cfg.tf_layers)]),
        "pred_hidden_w": t("sortformer_modules.first_hidden_to_hidden.weight", True),
        "pred_hidden_b": t("sortformer_modules.first_hidden_to_hidden.bias"),
        "pred_spk_w": t("sortformer_modules.single_hidden_to_spks.weight", True),
        "pred_spk_b": t("sortformer_modules.single_hidden_to_spks.bias"),
    }
    return cfg, _to_torch(tree, dtype, device)


def _stack(layers: list[dict]) -> dict:
    return {k: np.stack([np.asarray(layer[k], np.float32) for layer in layers])
            for k in layers[0]}


def params_from_jax(tree: dict, *, device: str | torch.device) -> Params:
    """The JAX package's SortFormer params pytree (nested dicts of numpy
    arrays, e.g. `jax.tree.map(np.asarray, tree)`) -> the port's params,
    bit for bit. The layouts carry over unchanged (layer-stacked)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    return _from_numpy(np.asarray(tree)).to(device)


# ---------------------------------------------------------------------------
# Mel front-end (NeMo semantics; sortformer.cpp:779-894)
# ---------------------------------------------------------------------------

def compute_mel(cfg: SortformerConfig, params: Params,
                samples: np.ndarray) -> tuple[torch.Tensor, int]:
    """-> (mel (n_frames_out, n_mels) f32 on the params' device, seq_len).

    Frames beyond seq_len are zero; n_frames_out is padded to pad_to. Each
    frame is computed on its own (the JAX package runs 2048-frame chunks;
    a frame's value does not depend on the chunk it falls in)."""
    x = np.asarray(samples, np.float32)
    n = x.shape[0]
    y = np.empty_like(x)
    if n > 0:
        y[0] = x[0]
        y[1:] = x[1:] - cfg.preemph * x[:-1]
    pad = cfg.n_fft // 2
    padded = np.concatenate([np.zeros(pad, np.float32), y,
                             np.zeros(pad, np.float32)])
    n_stft = 1 + (padded.shape[0] - cfg.n_fft) // cfg.hop_length
    seq_len = n // cfg.hop_length
    n_out = -(-n_stft // cfg.pad_to) * cfg.pad_to
    n_compute = min(n_stft, seq_len)

    device = params["mel_fb"].device
    out = torch.zeros(n_out, cfg.n_mels, dtype=torch.float32, device=device)
    if n_compute > 0:
        off = (cfg.n_fft - cfg.win_length) // 2
        win = F.pad(params["mel_window"][:cfg.win_length].float(),
                    (off, cfg.n_fft - off - cfg.win_length))
        need = (n_compute - 1) * cfg.hop_length + cfg.n_fft
        buf = torch.from_numpy(np.ascontiguousarray(padded[:need])).to(device)
        frames = buf.unfold(0, cfg.n_fft, cfg.hop_length) * win
        out[:n_compute] = _log_mel(frames, params["mel_fb"].float(), cfg.n_fft,
                                   float(cfg.log_guard))
    return out, seq_len


def _log_mel(frames: torch.Tensor, fb: torch.Tensor, n_fft: int,
             log_guard: float) -> torch.Tensor:
    """log(|rFFT(frames)|^2 @ fb.T + guard): the power spectrum as the two
    real-DFT f32 products of audio/mel.py (the JAX side's rdft_power)."""
    c, s = _rdft_mats(n_fft)
    re = frames @ torch.from_numpy(c).to(frames.device)
    im = frames @ torch.from_numpy(s).to(frames.device)
    power = re * re + im * im
    return torch.log(power @ fb.t() + log_guard)


# ---------------------------------------------------------------------------
# Pre-encoder
# ---------------------------------------------------------------------------

def _live(T: int, n_valid, device) -> torch.Tensor:
    """(1 or B, T) bool: frame t < n_valid (an int, a 0-d or a (B,) tensor)."""
    t = torch.arange(T, device=device)
    if isinstance(n_valid, torch.Tensor):
        return t[None, :] < n_valid.reshape(-1, 1)
    return (t < n_valid)[None, :]


def _conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int,
             depthwise: bool) -> torch.Tensor:
    """3x3 conv, pad 1, over (B, T, F, Ci) with an HWIO weight -> f32.

    Full: an im2col product (taps in (kh, kw, ci) order, w's row-major
    flatten). Depthwise (w (3, 3, 1, C)): the sum of the nine shifted
    products in tap order."""
    B, T, Fr, Ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    To, Fo = (T - 1) // stride + 1, (Fr - 1) // stride + 1
    taps = [xp[:, i:i + stride * (To - 1) + 1:stride,
               j:j + stride * (Fo - 1) + 1:stride]
            for i in range(3) for j in range(3)]
    if not depthwise:
        cols = torch.cat(taps, dim=-1)
        return torch.matmul(cols.float(), w.reshape(9 * Ci, -1).float())
    wf = w.float().reshape(9, -1)
    acc = taps[0].float() * wf[0]
    for k in range(1, 9):
        acc = acc + taps[k].float() * wf[k]
    return acc


def preencode(cfg: SortformerConfig, params: Params, mel: torch.Tensor,
              n_valid=None) -> torch.Tensor:
    """mel (B, T, n_mels) -> (B, ceil3(T/8), d_model).

    `n_valid` (an int or a tensor) marks the live prefix when T is padded
    to a bucket: frames beyond it are zeroed between stages so boundary
    outputs equal the unpadded computation."""
    p = params["preenc"]
    dtype = p["out_w"].dtype
    x = mel.to(dtype)[..., None]          # NHWC: (B, time, freq, 1)

    def zero_tail(x, n):
        if n is None:
            return x
        return torch.where(_live(x.shape[1], n, x.device)[:, :, None, None], x, 0)

    def bias(y, b):
        return (y + b.float()).to(dtype)

    def pointwise(x, w, b):
        return bias(torch.matmul(x.float(), w.reshape(w.shape[2], w.shape[3]).float()), b)

    n1 = None if n_valid is None else (n_valid - 1) // 2 + 1
    n2 = None if n1 is None else (n1 - 1) // 2 + 1
    n3 = None if n2 is None else (n2 - 1) // 2 + 1
    x = zero_tail(x, n_valid)
    x = torch.relu(bias(_conv3x3(x, p["conv0_w"], 2, False), p["conv0_b"]))
    x = zero_tail(x, n1)
    x = bias(_conv3x3(x, p["conv2_w"], 2, True), p["conv2_b"])
    x = torch.relu(pointwise(x, p["conv3_w"], p["conv3_b"]))
    x = zero_tail(x, n2)
    x = bias(_conv3x3(x, p["conv5_w"], 2, True), p["conv5_b"])
    x = torch.relu(pointwise(x, p["conv6_w"], p["conv6_b"]))
    x = zero_tail(x, n3)

    # flatten channel-major: (B, T', F', C) -> (B, T', C, F') -> (B, T', C*F')
    B, T, Fr, C = x.shape
    x = x.permute(0, 1, 3, 2).reshape(B, T, C * Fr)
    return bias(torch.matmul(x.float(), p["out_w"].float()), p["out_b"])


def preenc_out_len(T_in: int) -> int:
    T = T_in
    for _ in range(3):
        T = (T - 1) // 2 + 1
    return T


# ---------------------------------------------------------------------------
# Conformer + projection + transformer + head
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, result in x's dtype; mixed dtypes multiply in the wider one,
    as jnp.dot promotes."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(t), w.to(t)).to(x.dtype)
    return torch.matmul(x, w)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b in x's dtype (the head's activations are f32; 16-bit
    weights are widened as jnp.dot promotes), one GEMM with the bias in its
    epilogue: one launch where the JAX graph has two, the bias added before
    the product's rounding (an ulp from JAX's order)."""
    if w.dtype != x.dtype:
        w, b = w.to(x.dtype), b.to(x.dtype)
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics (the JAX side's ops.layers.layer_norm),
    as one F.layer_norm launch instead of the elementwise chain."""
    y = F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(), eps)
    return y.to(x.dtype)


def sinusoid_pos_emb(T: int, d_model: int,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """NeMo rel-pos table: positions T-1 .. -(T-1), interleaved sin/cos
    (sortformer.cpp:1052-1070)."""
    n_pos = 2 * T - 1
    pos = (T - 1 - torch.arange(n_pos, device=device)).float()
    j = torch.arange(d_model // 2, device=device, dtype=torch.float32)
    freq = torch.pow(10000.0, -(2.0 * j) / d_model)
    angle = pos[:, None] * freq[None, :]
    pe = torch.zeros(n_pos, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


@functools.lru_cache(maxsize=16)
def _pos_table(T: int, d_model: int, device: torch.device) -> torch.Tensor:
    return sinusoid_pos_emb(T, d_model, device)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift; x (B, H, T, n_pos) -> same shape
    (sortformer.cpp:1206-1222 / NeMo rel_shift)."""
    B, H, T, P = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(B, H, P + 1, T)
    return x[:, :, 1:, :].reshape(B, H, T, P)


def _layers(blocks: Params) -> list[Params]:
    """Stacked per-layer weights -> one dict of views per layer (one unbind
    per weight instead of one select per weight and layer)."""
    cols = {k: v.unbind(0) for k, v in blocks.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[il] for k, c in cols.items()} for il in range(n)]


def _attend(scores: torch.Tensor, v: torch.Tensor, dtype: torch.dtype,
            kbias) -> torch.Tensor:
    """softmax over keys (f32), probabilities in the activation dtype, P.V;
    v (B, T, H, dh) -> (B, T, H*dh)."""
    if kbias is not None:
        scores = scores + kbias
    attn = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v.to(dtype)).to(dtype)
    B, T = out.shape[:2]
    return out.reshape(B, T, -1)


def _conformer_block(cfg: SortformerConfig, p: Params, x: torch.Tensor,
                     pos: torch.Tensor, kbias=None, valid=None) -> torch.Tensor:
    """x (B, T, D); pos (n_pos, D) pre-computed sinusoid table.

    kbias (B|1, 1, 1, T): additive key mask (0 / -1e9) for padded frames;
    valid (B|1, T, 1): multiplicative frame mask for the conv module."""
    B, T, D = x.shape
    H, dh = cfg.n_heads, cfg.d_head

    # FFN1 half-step
    h = _ln(x, p["norm_ff1_w"], p["norm_ff1_b"])
    h = F.silu(_linear(h, p["ff1_up_w"], p["ff1_up_b"]))
    h = _linear(h, p["ff1_down_w"], p["ff1_down_b"])
    x = torch.add(x, h, alpha=0.5)      # x + 0.5 * h: the halving is exact

    # rel-pos self-attention
    h = _ln(x, p["norm_sa_w"], p["norm_sa_b"])
    q = _linear(h, p["q_w"], p["q_b"]).reshape(B, T, H, dh)
    k = _linear(h, p["k_w"], p["k_b"]).reshape(B, T, H, dh)
    v = _linear(h, p["v_w"], p["v_b"]).reshape(B, T, H, dh)
    pos_p = _mm(pos.to(h.dtype), p["pos_w"]).reshape(-1, H, dh)   # (n_pos,H,dh)

    q_u = q + p["pos_bias_u"][None, None]      # (B,T,H,dh)
    q_v = q + p["pos_bias_v"][None, None]
    ac = torch.einsum("bqhd,bkhd->bhqk", q_u.float(), k.float())
    bd = torch.einsum("bqhd,phd->bhqp", q_v.float(), pos_p.float())
    bd = _rel_shift(bd)[:, :, :, :T]
    scores = (ac + bd) / math.sqrt(dh)
    out = _attend(scores, v, h.dtype, kbias)
    x = x + _linear(out, p["out_w"], p["out_b"])

    # conv module
    h = _ln(x, p["norm_conv_w"], p["norm_conv_b"])
    h = _linear(h, p["pw1_w"], p["pw1_b"])                 # (B,T,2D)
    a, g = h[..., :D], h[..., D:]
    h = a * torch.sigmoid(g)                               # GLU
    if valid is not None:
        h = h * valid
    # depthwise conv k over time, symmetric pad: the products of the k
    # shifted windows with the taps, summed over k (no cuDNN, no TF32)
    pad = (cfg.conv_kernel - 1) // 2
    hp = F.pad(h, (0, 0, pad, pad))
    dw = p["dw_w"]                                         # (k, D)
    h = (hp.unfold(1, cfg.conv_kernel, 1) * dw.t().to(h.dtype)).sum(dim=-1)
    h = F.silu(h + p["dw_b"])
    h = _linear(h, p["pw2_w"], p["pw2_b"])
    x = x + h

    # FFN2 half-step
    h = _ln(x, p["norm_ff2_w"], p["norm_ff2_b"])
    h = F.silu(_linear(h, p["ff2_up_w"], p["ff2_up_b"]))
    h = _linear(h, p["ff2_down_w"], p["ff2_down_b"])
    x = torch.add(x, h, alpha=0.5)      # x + 0.5 * h: the halving is exact

    return _ln(x, p["norm_out_w"], p["norm_out_b"])


def _transformer_block(cfg: SortformerConfig, p: Params, x: torch.Tensor,
                       kbias=None) -> torch.Tensor:
    """Post-LN transformer layer (sortformer.cpp:1470-1528)."""
    B, T, D = x.shape
    H, dh = cfg.tf_heads, cfg.tf_d_head
    q = _linear(x, p["q_w"], p["q_b"]).reshape(B, T, H, dh)
    k = _linear(x, p["k_w"], p["k_b"]).reshape(B, T, H, dh)
    v = _linear(x, p["v_w"], p["v_b"]).reshape(B, T, H, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    out = _attend(scores, v, x.dtype, kbias)
    x = _ln(x + _linear(out, p["out_w"], p["out_b"]), p["ln1_w"], p["ln1_b"])
    h = torch.relu(_linear(x, p["ff_up_w"], p["ff_up_b"]))
    h = _linear(h, p["ff_down_w"], p["ff_down_b"])
    return _ln(x + h, p["ln2_w"], p["ln2_b"])


def head(cfg: SortformerConfig, params: Params, x: torch.Tensor,
         n_valid=None) -> torch.Tensor:
    """Conformer + projection + transformer + prediction head.

    x (B, T, d_model) pre-encoded frames -> speaker probs (B, T, n_spk) f32.
    Equivalent to sortformer_compute_streaming_prediction
    (sortformer.cpp:1924-2266). `n_valid` (an int, or a (B,) tensor of
    per-row lengths) masks padded frames so a padded call equals the
    exact-length one on the live prefix (-1e9 key bias keeps padded-query
    softmax finite)."""
    T = x.shape[1]
    pos = _pos_table(T, cfg.d_model, x.device)
    kbias = None
    valid = None
    if n_valid is not None:
        live = _live(T, n_valid, x.device)
        kbias = torch.where(live, 0.0, -1e9)[:, None, None, :]
        valid = live[:, :, None].to(x.dtype)
        x = x * valid
    x = x.float() * math.sqrt(cfg.d_model)   # xscale (f32, as JAX promotes)

    for p in _layers(params["conformer"]):
        x = _conformer_block(cfg, p, x, pos, kbias, valid)

    x = _linear(x, params["proj_w"], params["proj_b"])

    for p in _layers(params["transformer"]):
        x = _transformer_block(cfg, p, x, kbias)

    h = torch.relu(x)
    h = torch.relu(_linear(h, params["pred_hidden_w"], params["pred_hidden_b"]))
    h = _linear(h, params["pred_spk_w"], params["pred_spk_b"])
    return torch.sigmoid(h.float())


def init_params(cfg: SortformerConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32, *,
                device: str | torch.device) -> Params:
    """Random params with real shapes (tests / benches): the JAX package's
    init_params draws, in its order, from the same seed."""
    rng = np.random.default_rng(seed)
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    ff = cfg.ff_expansion * D
    C = cfg.subsampling_channels

    def w(*shape, scale=None):
        scale = scale if scale is not None else (shape[-2] if len(shape) > 1 else 1) ** -0.5
        return rng.standard_normal(shape).astype(np.float32) * scale

    def ones(*shape):
        return np.ones(shape, np.float32)

    def conf_layer():
        return {
            "norm_ff1_w": ones(D), "norm_ff1_b": w(D, scale=0.01),
            "ff1_up_w": w(D, ff), "ff1_up_b": w(ff, scale=0.01),
            "ff1_down_w": w(ff, D), "ff1_down_b": w(D, scale=0.01),
            "norm_sa_w": ones(D), "norm_sa_b": w(D, scale=0.01),
            "q_w": w(D, D), "q_b": w(D, scale=0.01),
            "k_w": w(D, D), "k_b": w(D, scale=0.01),
            "v_w": w(D, D), "v_b": w(D, scale=0.01),
            "out_w": w(D, D), "out_b": w(D, scale=0.01),
            "pos_w": w(D, D),
            "pos_bias_u": w(H, dh, scale=0.02), "pos_bias_v": w(H, dh, scale=0.02),
            "norm_conv_w": ones(D), "norm_conv_b": w(D, scale=0.01),
            "pw1_w": w(D, 2 * D), "pw1_b": w(2 * D, scale=0.01),
            "dw_w": w(cfg.conv_kernel, D, scale=0.2), "dw_b": w(D, scale=0.01),
            "pw2_w": w(D, D), "pw2_b": w(D, scale=0.01),
            "norm_ff2_w": ones(D), "norm_ff2_b": w(D, scale=0.01),
            "ff2_up_w": w(D, ff), "ff2_up_b": w(ff, scale=0.01),
            "ff2_down_w": w(ff, D), "ff2_down_b": w(D, scale=0.01),
            "norm_out_w": ones(D), "norm_out_b": w(D, scale=0.01),
        }

    TD, TFF = cfg.tf_d_model, cfg.tf_ff

    def tf_layer():
        return {
            "q_w": w(TD, TD), "q_b": w(TD, scale=0.01),
            "k_w": w(TD, TD), "k_b": w(TD, scale=0.01),
            "v_w": w(TD, TD), "v_b": w(TD, scale=0.01),
            "out_w": w(TD, TD), "out_b": w(TD, scale=0.01),
            "ln1_w": ones(TD), "ln1_b": w(TD, scale=0.01),
            "ff_up_w": w(TD, TFF), "ff_up_b": w(TFF, scale=0.01),
            "ff_down_w": w(TFF, TD), "ff_down_b": w(TD, scale=0.01),
            "ln2_w": ones(TD), "ln2_b": w(TD, scale=0.01),
        }

    F3 = cfg.n_mels
    for _ in range(3):
        F3 = (F3 - 1) // 2 + 1

    from .mel_fb import mel_filterbank

    tree = {
        "mel_fb": mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate),
        "mel_window": (np.hanning(cfg.win_length + 1)[:-1].astype(np.float32)
                       if cfg.win_length > 1 else np.ones(1, np.float32)),
        "preenc": {
            "conv0_w": w(3, 3, 1, C, scale=0.2), "conv0_b": w(C, scale=0.01),
            "conv2_w": w(3, 3, 1, C, scale=0.2), "conv2_b": w(C, scale=0.01),
            "conv3_w": w(1, 1, C, C, scale=C ** -0.5), "conv3_b": w(C, scale=0.01),
            "conv5_w": w(3, 3, 1, C, scale=0.2), "conv5_b": w(C, scale=0.01),
            "conv6_w": w(1, 1, C, C, scale=C ** -0.5), "conv6_b": w(C, scale=0.01),
            "out_w": w(C * F3, D), "out_b": w(D, scale=0.01),
        },
        "conformer": _stack([conf_layer() for _ in range(cfg.n_layers)]),
        "proj_w": w(D, TD), "proj_b": w(TD, scale=0.01),
        "transformer": _stack([tf_layer() for _ in range(cfg.tf_layers)]),
        "pred_hidden_w": w(TD, TD), "pred_hidden_b": w(TD, scale=0.01),
        "pred_spk_w": w(TD, cfg.n_spk), "pred_spk_b": w(cfg.n_spk, scale=0.01),
    }
    return _to_torch(tree, dtype, device)
