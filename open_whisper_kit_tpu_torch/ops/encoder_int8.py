"""The W8A8 encoder: int8 x int8 matmuls for the transformer stack.

Port of open_whisper_kit_tpu/ops/encoder_int8.py. The encoder of a batched
round (B windows of 1500 positions) is compute-bound, and the H100's int8
tensor-core rate is twice its bf16 rate, which is what W8A8 is for:

* weights: symmetric int8 per output column, one f32 scale per column
  (`quantize_w_cols`, the division form s = amax / 127, q = round(w / s));
* activations: symmetric int8 per row, computed inside the matmul
  (`quantize_act_rows`, the reciprocal form round(x * (127 / amax)),
  scale amax * f32(1/127));
* s8 x s8 -> s32 accumulation, then (f32(acc) * row scale) * column scale
  rounded to bf16.

The conv front-end, positional add, layernorms, attention (kernel K1) and
the residual stream stay dense; the stack runs in bf16 whatever the
context's dtype, as the JAX package runs it.

`w8a8_mm` is kernel K6 (csrc/w8a8.cu: a row-quantize launch, then a
persistent TMA + wgmma s8 GEMM at `gemm.w8a8_plan`'s tile, a dependent
launch) on CUDA tensors and `w8a8_mm_plain`,
the same integer formula in plain torch (a float64 product, exact below
2^53), on CPU tensors. The port stores each weight plane transposed,
(N, K) int8 with K contiguous: the layout the tensor cores' B operand
takes. `prepare_encoder_int8`'s planes are JAX's, transposed.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .attention import mha_full
from .gemm import _sms, w8a8_plan
from .layers import layer_norm as _ln
from .quant_matmul import QuantLinear, QuantLinear4, dequantize_dense

_WIDE_K = 2048          # wider inputs are rounded to bf16 before quantizing
_INV127 = float(np.float32(1.0 / 127.0))   # JAX's amax * (1.0 / 127.0), in f32
_ALIGN_K, _ALIGN_N = 16, 8   # the kernel's K (16-byte int8 rows for TMA), N (16-byte stores)


# -- quantizers --------------------------------------------------------------

def quantize_w_cols(w: torch.Tensor):
    """(K, N) float weight -> (int8 (K, N), f32 (1, N)), per column."""
    w32 = w.float()
    amax = w32.abs().amax(dim=0, keepdim=True)
    s = amax / torch.full_like(amax, 127.0)    # IEEE division, as JAX divides
    q = torch.clamp(torch.round(w32 / torch.where(s == 0, 1.0, s)), -127, 127)
    return q.to(torch.int8), s


def quantize_act_rows(x: torch.Tensor, pre_bf16: bool = False):
    """(M, K) float activation -> (int8 (M, K), f32 (M, 1)), per row:
    round(x * (127 / amax)) clipped to +-127 (an all-zero row gives zeros)
    and the scale amax * f32(1/127). `pre_bf16` rounds x to bf16 first,
    the kernel's wide-K mode."""
    if pre_bf16:
        x = x.to(torch.bfloat16)
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # IEEE 127 / amax (`127.0 / t` would be a reciprocal times 127)
    r = torch.where(amax == 0, 0.0, torch.full_like(amax, 127.0) / amax)
    q = torch.clamp(torch.round(x32 * r), -127, 127)
    return q.to(torch.int8), amax * _INV127


# -- K6 ------------------------------------------------------------------------

def w8a8_mm_plain(x: torch.Tensor, wq_t: torch.Tensor, ws: torch.Tensor
                  ) -> torch.Tensor:
    """K6's function: x (M, K) float, wq_t (N, K) int8, ws (1, N) f32 ->
    bf16 (M, N) = bf16((f32(quantize_rows(x) @ wq) * xs) * ws). The integer
    product is taken in float64, exact for K * 127^2 < 2^53."""
    xq, xs = quantize_act_rows(x)
    acc = (xq.double() @ wq_t.double().t()).float()
    return (acc * xs * ws.float()).to(torch.bfloat16)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("w8a8")
    for fn in (lib.owk_w8a8_bf16, lib.owk_w8a8_f32):
        # x, xq, xs, wq_t, ws, out, M, K, N, 1/127, bn, grid, stream
        fn.argtypes = [_P] * 6 + [_I] * 3 + [ctypes.c_float] + [_I] * 2 + [_P]
        fn.restype = ctypes.c_int
    # x, is_f32, xq, xs, M, K, 1/127, stream: the quantize launch alone
    # (kernel_times.py times it apart from the GEMM)
    lib.owk_quantize_rows.argtypes = [_P, _I, _P, _P, _I, _I, ctypes.c_float, _P]
    lib.owk_quantize_rows.restype = ctypes.c_int
    return lib


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    pr, pc = rows - t.shape[0], cols - t.shape[1]
    return F.pad(t, (0, pc, 0, pr)).contiguous() if pr or pc else t


def w8a8_mm(x: torch.Tensor, wq_t: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Kernel K6: x (M, K) bf16 or f32 @ int8 planes wq_t (N, K) with
    column scales ws (1, N) -> bf16 (M, N), quantizing each row of x once.

    CPU tensors take `w8a8_mm_plain`; CUDA tensors launch csrc/w8a8.cu on
    the current stream (a row-quantize launch, then the s8 TMA + wgmma GEMM
    with the scale epilogue at `gemm.w8a8_plan`'s tile, a dependent launch)
    or raise. A K that is not a multiple of 16, or N of 8, is zero-padded
    per call (no preset has one). `launches` counts calls on the card."""
    if x.device.type == "cpu":
        return w8a8_mm_plain(x, wq_t, ws)
    M, N, xc, wq_p, ws_p = _w8a8_operands(x, wq_t, ws)
    out = torch.empty(M, wq_p.shape[0], dtype=torch.bfloat16, device=x.device)
    if M:
        xq = torch.empty(M, xc.shape[1], dtype=torch.int8, device=x.device)
        xs = torch.empty(M, dtype=torch.float32, device=x.device)
        plan = w8a8_plan(M, wq_p.shape[0], _sms(x.device.index if x.device.index is not None
                                                else torch.cuda.current_device()))
        lib = _kernel_lib()
        fn = lib.owk_w8a8_bf16 if x.dtype == torch.bfloat16 else lib.owk_w8a8_f32
        rc = fn(xc.data_ptr(), xq.data_ptr(), xs.data_ptr(), wq_p.data_ptr(), ws_p.data_ptr(),
                out.data_ptr(), M, xc.shape[1], wq_p.shape[0], _INV127, plan.tile[1], plan.grid,
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"w8a8_mm: kernel launch failed (cudaError {rc})")
        w8a8_mm.launches += 1
    return out[:, :N] if out.shape[1] != N else out


def _w8a8_operands(x: torch.Tensor, wq_t: torch.Tensor, ws: torch.Tensor):
    """Check K6's operands on the card; x, the planes and the scales as the
    kernel takes them (K padded to 16, N to 8, where they are not)."""
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_mm: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w8a8_mm: x must be a 2-D bf16 or f32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    M, K = x.shape
    N = wq_t.shape[0]
    if (wq_t.dim() != 2 or wq_t.shape[1] != K or wq_t.dtype != torch.int8
            or tuple(ws.shape) != (1, N) or ws.dtype != torch.float32
            or wq_t.device != x.device or ws.device != x.device):
        raise ValueError(f"w8a8_mm: planes {tuple(wq_t.shape)} {wq_t.dtype}, scales "
                         f"{tuple(ws.shape)} {ws.dtype} do not fit x {tuple(x.shape)}")
    Kp, Np = -(-K // _ALIGN_K) * _ALIGN_K, -(-N // _ALIGN_N) * _ALIGN_N
    # zero columns change no amax and add nothing to a sum
    xc = _pad_to(x.contiguous(), M, Kp)
    wq_p = _pad_to(wq_t.contiguous(), Np, Kp)
    ws_p = _pad_to(ws.contiguous(), 1, Np)
    xc, wq_p, ws_p = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xc, wq_p, ws_p))
    return M, N, xc, wq_p, ws_p


w8a8_mm.launches = 0


def w8a8_matmul(x: torch.Tensor, wq_t: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """y = quantize_rows(x) @ wq, rescaled to bf16; x (..., K) float. Inputs
    wider than 2048 are rounded to bf16 first (the TPU kernel's wide-K
    blocks, which the JAX package streams in bf16), narrower ones to f32."""
    lead, K = x.shape[:-1], x.shape[-1]
    # bf16 -> f32 is exact, so a bf16 x goes in as it is and the kernel widens it
    blk = torch.bfloat16 if K > _WIDE_K or x.dtype == torch.bfloat16 else torch.float32
    out = w8a8_mm(x.reshape(-1, K).to(blk), wq_t, ws)
    return out.reshape(*lead, out.shape[-1])


# -- encoder params + forward ----------------------------------------------------

def _dense(w) -> torch.Tensor:
    if isinstance(w, (QuantLinear, QuantLinear4)):
        return dequantize_dense(w, torch.float32)     # logical columns
    return w.float()


def _planes(w: torch.Tensor):
    q, s = quantize_w_cols(w)
    return q.t().contiguous(), s


def prepare_encoder_int8(cfg, enc: dict) -> dict:
    """Dense (or q8_0/q5_0/q4_0-plane) encoder params -> W8A8 params. QKV
    fuses into one (3S, S) plane per block; the K projection has no bias,
    so a zero segment keeps the fused bias exact. Conv, positions and
    layernorms stay as they are. Planes are stacked per layer: qkv_q
    (L, 3S, S) int8 and qkv_s (L, 1, 3S) f32, and so on."""
    b = enc["blocks"]
    per_layer = []
    for il in range(cfg.n_audio_layer):
        qkv = torch.cat([_dense(b[n][il]) for n in ("q_w", "k_w", "v_w")], dim=-1)
        d = {"attn_ln_w": b["attn_ln_w"][il], "attn_ln_b": b["attn_ln_b"][il],
             "qkv_b": torch.cat([b["q_b"][il], torch.zeros_like(b["q_b"][il]),
                                 b["v_b"][il]], dim=-1),
             "o_b": b["o_b"][il], "mlp_ln_w": b["mlp_ln_w"][il],
             "mlp_ln_b": b["mlp_ln_b"][il], "mlp0_b": b["mlp0_b"][il],
             "mlp1_b": b["mlp1_b"][il]}
        d["qkv_q"], d["qkv_s"] = _planes(qkv)
        for n in ("o", "mlp0", "mlp1"):
            d[n + "_q"], d[n + "_s"] = _planes(_dense(b[n + "_w"][il]))
        per_layer.append(d)
    blocks = {k: torch.stack([d[k] for d in per_layer]) for k in per_layer[0]}
    keep = ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "pos", "ln_post_w", "ln_post_b")
    return {**{k: enc[k] for k in keep}, "blocks": blocks}


def _encoder_block_int8(cfg, p: dict, x: torch.Tensor, n_valid: int | None):
    S = cfg.n_audio_state
    dtype = x.dtype
    scale = 1.0 / np.sqrt(cfg.d_audio_head)
    h = _ln(x, p["attn_ln_w"], p["attn_ln_b"], cfg.eps)
    qkv = (w8a8_matmul(h, p["qkv_q"], p["qkv_s"]) + p["qkv_b"]).to(dtype)
    q, k, v = (qkv[..., i * S:(i + 1) * S].contiguous() for i in range(3))
    a = mha_full(q, k, v, cfg.n_audio_head, scale, kv_valid=n_valid)
    x = (x + w8a8_matmul(a, p["o_q"], p["o_s"]) + p["o_b"]).to(dtype)
    h = _ln(x, p["mlp_ln_w"], p["mlp_ln_b"], cfg.eps)
    h = F.gelu(w8a8_matmul(h, p["mlp0_q"], p["mlp0_s"]).float() + p["mlp0_b"].float(),
               approximate="tanh")
    return (x + w8a8_matmul(h, p["mlp1_q"], p["mlp1_s"]) + p["mlp1_b"]).to(dtype)


def encode_int8(cfg, enc8: dict, mel: torch.Tensor) -> torch.Tensor:
    """The W8A8 counterpart of model.encode: mel (B, 2*n_ctx, n_mels) ->
    (B, n_ctx, S) bf16 (the same conv front-end, pad-once masking, pre-LN
    stack and final layernorm; kernel K6 in every linear of the stack)."""
    from ..models.whisper.model import _ENC_PAD_MIN_T, _layer, conv1d_mm

    dtype = torch.bfloat16
    x = mel.to(dtype)
    x = conv1d_mm(x, enc8["conv1_w"].to(dtype), 1)
    x = F.gelu(x + enc8["conv1_b"].float(), approximate="tanh").to(dtype)
    x = conv1d_mm(x, enc8["conv2_w"].to(dtype), 2)
    x = F.gelu(x + enc8["conv2_b"].float(), approximate="tanh").to(dtype)

    n_ctx = x.shape[1]
    x = x + enc8["pos"][:n_ctx].to(dtype)
    n_pad = -n_ctx % 128 if n_ctx >= _ENC_PAD_MIN_T else 0
    if n_pad:
        x = F.pad(x, (0, 0, 0, n_pad))
    for il in range(cfg.n_audio_layer):
        x = _encoder_block_int8(cfg, _layer(enc8["blocks"], il), x,
                                n_valid=n_ctx if n_pad else None)
    if n_pad:
        x = x[:, :n_ctx]
    return _ln(x, enc8["ln_post_w"], enc8["ln_post_b"], cfg.eps)
