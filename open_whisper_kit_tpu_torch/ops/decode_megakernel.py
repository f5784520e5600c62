"""The decode-step kernel K2: the whole per-token decoder in one call.

Port of open_whisper_kit_tpu/ops/decode_megakernel.py (the greedy,
one-row `mega_decode_step`; the beam, batched-stream and speculative-verify
variants are not ported yet). One step takes the (1, S) bf16 token plus
position row and runs every layer (layernorm, fused QKV with the K/V row
written at `kv_head`, self-attention, cross-attention, the tanh-GELU MLP),
the final layernorm and the vocab projection to f32 logits.

Each weight field is dense bf16, int8 `QPlanes` (per-32-row f32 scales) or
split-half int4 `Q4Planes` (bf16 scales), chosen by `prepare_mega`:

* "none"   - every weight dense bf16 (the prepared decoder's arrays);
* "logits" - layers dense, the vocab projection int8 (reusing a
             `te_logits` int8 plane when the decoder has one);
* "all"    - every weight int8 (checkpoint planes reused, dense weights
             quantized; the W8 serving mode);
* "int4"   - every weight split-half int4 (the W4 serving mode).

`mega_decode_step` launches csrc/mega_step.cu on CUDA tensors (33 launches
per large-v3-turbo token, one wrapper call) and takes
`mega_decode_step_plain`, the same rounding points in plain torch, on CPU
tensors. The caches are the port's natural layout: the self-cache
(L, Tc, S) and the cross-KV (L, Ta, S) are views of the (L, 1, T, S)
tensors `init_kv_cache` and `cross_kv` return, so no conversion copy is
made. Planes are padded to what the kernel needs (a multiple of 128
columns); the logits come back sliced to the vocabulary.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .layers import layer_norm
from .quant_matmul import (QuantLinear, QuantLinear4, _quantize_planes,
                           dequantize_dense)

QK = 32             # quant block size along the contraction dim
_VP_MULTIPLE = 128  # the vocab projection's columns are padded to this
_KINDS = {None: 0, "int8": 1, "int4": 2}
WEIGHTS = ("qkv_w", "o_w", "cq_w", "co_w", "mlp0_w", "mlp1_w", "teT")
_BIASES = ("qkv_b", "o_b", "cq_b", "co_b", "mlp0_b", "mlp1_b")


@dataclasses.dataclass
class QPlanes:
    """Int8 weight planes: qs (..., K, N) int8, sc (..., K//32, N) f32."""
    qs: torch.Tensor
    sc: torch.Tensor


@dataclasses.dataclass
class Q4Planes:
    """Int4 planes, split-half packed: qs (..., K//2, N) uint8 whose low
    nibble holds rows [0, K/2) and high nibble rows [K/2, K) (value + 8);
    sc (..., K//32, N) bf16 per-32-row scales over the original rows. Not
    the even/odd layout of quant_matmul.QuantLinear4."""
    qs: torch.Tensor
    sc: torch.Tensor


@dataclasses.dataclass
class MegaParams:
    """Decoder weights arranged for K2. Weight fields are dense bf16
    tensors, QPlanes or Q4Planes; stacked per layer (L, K, N) except `teT`,
    the transposed vocab projection (S, Vp). lnw/lnb hold the three
    per-layer layernorms and the final one as rows [3*il + 0: attn,
    + 1: cross, + 2: mlp, last: final]."""
    qkv_w: object
    qkv_b: torch.Tensor
    o_w: object
    o_b: torch.Tensor
    cq_w: object
    cq_b: torch.Tensor
    co_w: object
    co_b: torch.Tensor
    mlp0_w: object
    mlp0_b: torch.Tensor
    mlp1_w: object
    mlp1_b: torch.Tensor
    lnw: torch.Tensor
    lnb: torch.Tensor
    teT: object

    @property
    def vp(self) -> int:
        return getattr(self.teT, "qs", self.teT).shape[-1]


def _kind(w) -> str | None:
    if isinstance(w, Q4Planes):
        return "int4"
    return "int8" if isinstance(w, QPlanes) else None


def _to_planes(w) -> QPlanes:
    """Dense stacked weight or QuantLinear -> unpadded QPlanes."""
    if isinstance(w, QuantLinear):
        n = w.n_out
        return QPlanes(qs=w.qs[..., :n].contiguous(), sc=w.scales[..., :n].contiguous())
    qs, sc = _quantize_planes(w)
    return QPlanes(qs=qs, sc=sc)


def _quantize_planes4(w: torch.Tensor):
    """Dense (..., K, N) -> split-half int4 planes (see Q4Planes), scales
    amax / 7 rounded to bf16."""
    *lead, K, N = w.shape
    x32 = w.float().reshape(*lead, K // QK, QK, N)
    amax = x32.abs().amax(dim=-2)                            # (..., K/32, N)
    # the JAX side's jitted amax / 7 compiles to a multiply by f32(1/7);
    # the same product here keeps the scales bit-equal to its planes
    scale = (amax * np.float32(1.0 / 7.0).item()).to(torch.bfloat16)
    s32 = scale.float()
    inv = torch.where(s32 > 0, 1.0 / torch.where(s32 == 0, 1.0, s32), 0.0)
    q = torch.clamp(torch.round(x32 * inv[..., None, :]), -8, 7) + 8
    q = q.reshape(*lead, K, N).to(torch.uint8)
    return (q[..., :K // 2, :] | (q[..., K // 2:, :] << 4)).contiguous(), scale.contiguous()


def _to_planes4(w) -> Q4Planes:
    """Dense stacked weight or QuantLinear/QuantLinear4 -> Q4Planes
    (quantized checkpoints are dequantized to f32 first)."""
    if isinstance(w, (QuantLinear, QuantLinear4)):
        w = dequantize_dense(w, dtype=torch.float32)
    qs, sc = _quantize_planes4(w)
    return Q4Planes(qs=qs, sc=sc)


def prepare_mega(cfg, dec, quant: str = "none") -> MegaParams:
    """Prepared decoder params (after model.prepare_decoder) -> MegaParams;
    `quant` is one of "none", "logits", "all", "int4" (module docstring)."""
    b = dec["blocks"]
    if "qkv_w" not in b:
        raise ValueError("run prepare_decoder first (fused qkv required)")
    if quant not in ("none", "logits", "all", "int4"):
        raise ValueError(f"unknown megakernel quant mode {quant!r}")
    bf = torch.bfloat16
    rows_w, rows_b = [], []
    for il in range(cfg.n_text_layer):
        for ln in ("attn_ln", "cross_ln", "mlp_ln"):
            rows_w.append(b[ln + "_w"][il])
            rows_b.append(b[ln + "_b"][il])
    rows_w.append(dec["ln_w"])
    rows_b.append(dec["ln_b"])

    def weight(name):
        w = b[name]
        if quant == "all":
            return _to_planes(w)
        if quant == "int4":
            return _to_planes4(w)
        if isinstance(w, (QuantLinear, QuantLinear4)):
            raise ValueError(f"{name} is quantized; use quant='all'")
        return w.to(bf).contiguous()

    te = dec["te"]
    V = te.shape[0]
    Vp = -(-V // _VP_MULTIPLE) * _VP_MULTIPLE

    def te_padded(dtype):
        return torch.nn.functional.pad(te.t().to(dtype), (0, Vp - V)).contiguous()

    if quant == "int4":
        teT = _to_planes4(te_padded(torch.float32))
    elif quant in ("logits", "all"):
        tl = dec.get("te_logits")
        if isinstance(tl, QuantLinear) and tl.qs.shape[-1] == Vp:
            teT = QPlanes(qs=tl.qs, sc=tl.scales)   # the decode_impl path's planes
        else:
            teT = _to_planes(te_padded(torch.float32))
    else:
        teT = te_padded(bf)

    return MegaParams(
        **{n: weight(n) for n in WEIGHTS[:6]},
        **{n: b[n].to(bf).contiguous() for n in _BIASES},
        lnw=torch.stack([r.to(bf) for r in rows_w]),
        lnb=torch.stack([r.to(bf) for r in rows_b]),
        teT=teT)


# -- the plain version -------------------------------------------------------

def _matvec(x16: torch.Tensor, w, il: int | None) -> torch.Tensor:
    """x16 (1, K) bf16 @ field plane (layer il) -> (1, N) f32: each weight
    dequantized in f32 and rounded to bf16, every product exact, f32 sums."""
    if il is not None:
        w = type(w)(qs=w.qs[il], sc=w.sc[il]) if _kind(w) else w[il]
    x = x16.float()
    kind = _kind(w)
    if kind is None:
        return x @ w.float()
    if kind == "int8":
        K, N = w.qs.shape
        w16 = (w.qs.float().reshape(K // QK, QK, N) * w.sc[:, None, :].float()
               ).reshape(K, N).to(torch.bfloat16)
        return x @ w16.float()
    K2, N = w.qs.shape
    q = w.qs.to(torch.int32)
    sc = w.sc.float().reshape(2, K2 // QK, 1, N)
    lo = (((q & 0x0F) - 8).float().reshape(K2 // QK, QK, N) * sc[0]).reshape(K2, N)
    hi = (((q >> 4) - 8).float().reshape(K2 // QK, QK, N) * sc[1]).reshape(K2, N)
    return (x[:, :K2] @ lo.to(torch.bfloat16).float()
            + x[:, K2:] @ hi.to(torch.bfloat16).float())


def _attend(q16: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int,
            scale: float, n_head: int) -> torch.Tensor:
    """(1, S) bf16 query over keys [0, n_valid) of natural (T, S) k/v:
    f32 scores times `scale`, full-row f32 softmax, probabilities rounded
    to bf16, P.V summed in f32, rounded to bf16."""
    S = q16.shape[-1]
    dh = S // n_head
    qh = q16.float().reshape(n_head, 1, dh)
    kh = k[:n_valid].float().reshape(n_valid, n_head, dh).transpose(0, 1)
    vh = v[:n_valid].float().reshape(n_valid, n_head, dh).transpose(0, 1)
    s = (qh @ kh.transpose(1, 2)) * scale                     # (H, 1, n)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
    return (p.float() @ vh).reshape(1, S).to(torch.bfloat16)


def _ln16(x16, w, b, eps):
    return layer_norm(x16.float(), w, b, eps).to(torch.bfloat16)


def mega_decode_step_plain(cfg, mp: MegaParams, x0: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                           xk: torch.Tensor, xv: torch.Tensor):
    """K2's function in plain torch, the kernel's reference (and the CPU
    path). Same arguments and results as `mega_decode_step`."""
    S, H, L = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer
    dh = S // H
    eps = float(cfg.eps)
    head = int(kv_head)
    kq16 = torch.tensor(float(dh) ** -0.25, dtype=torch.bfloat16, device=x0.device)
    cross_scale = float(np.float32(float(dh) ** -0.25))
    bias = lambda name, il: getattr(mp, name)[il][None]       # noqa: E731
    x = x0.to(torch.bfloat16)
    for il in range(L):
        h16 = _ln16(x, mp.lnw[3 * il], mp.lnb[3 * il], eps)
        qkv = _matvec(h16, mp.qkv_w, il).to(torch.bfloat16) + bias("qkv_b", il)
        q = qkv[:, :S] * kq16
        kv_k[il, head] = (qkv[:, S:2 * S] * kq16)[0]
        kv_v[il, head] = qkv[0, 2 * S:]
        a16 = _attend(q, kv_k[il], kv_v[il], head + 1, 1.0, H)
        x = x + (_matvec(a16, mp.o_w, il).to(torch.bfloat16) + bias("o_b", il))

        h16 = _ln16(x, mp.lnw[3 * il + 1], mp.lnb[3 * il + 1], eps)
        cq = _matvec(h16, mp.cq_w, il).to(torch.bfloat16) + bias("cq_b", il)
        a16 = _attend(cq, xk[il], xv[il], xk.shape[1], cross_scale, H)
        x = x + (_matvec(a16, mp.co_w, il).to(torch.bfloat16) + bias("co_b", il))

        h16 = _ln16(x, mp.lnw[3 * il + 2], mp.lnb[3 * il + 2], eps)
        pre = (_matvec(h16, mp.mlp0_w, il).to(torch.bfloat16) + bias("mlp0_b", il))
        g = torch.nn.functional.gelu(pre.float(), approximate="tanh").to(torch.bfloat16)
        x = x + (_matvec(g, mp.mlp1_w, il).to(torch.bfloat16) + bias("mlp1_b", il))
    xf = _ln16(x, mp.lnw[3 * L], mp.lnb[3 * L], eps)
    return _matvec(xf, mp.teT, None)[:, :cfg.n_vocab], kv_k, kv_v


# -- the kernel ----------------------------------------------------------------

_P = ctypes.c_void_p


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("mega_step")
    lib.owk_mega_step.argtypes = [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_float, ctypes.c_float, ctypes.c_float, _P]
    lib.owk_mega_step.restype = ctypes.c_int
    lib.owk_mega_step_workspace.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.owk_mega_step_workspace.restype = ctypes.c_longlong
    return lib


_WORKSPACES: dict = {}


def _workspace(lib, dims, device) -> torch.Tensor:
    """Zeroed scratch for one step (residual row, partial sums, attention
    scores, split counters), kept per device and shape: every launch
    leaves its counters at zero again."""
    key = (str(device), tuple(dims))
    ws = _WORKSPACES.get(key)
    if ws is None:
        n = lib.owk_mega_step_workspace((ctypes.c_int * len(dims))(*dims))
        ws = _WORKSPACES[key] = torch.zeros(n, dtype=torch.uint8, device=device)
    return ws


def _check_tensor(what: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"mega_decode_step: {what} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {device} at a 16-byte "
                         f"boundary, got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


_PLANE_DTYPES = {None: (torch.bfloat16, None), "int8": (torch.int8, torch.float32),
                 "int4": (torch.uint8, torch.bfloat16)}


def _field_args(name: str, w, K: int, N: int, L: int | None, device):
    kind = _kind(w)
    lead = () if L is None else (L,)
    qdt, sdt = _PLANE_DTYPES[kind]
    if kind is None:
        _check_tensor(name, w, qdt, (*lead, K, N), device)
        return [w.data_ptr(), None]
    _check_tensor(name + ".qs", w.qs, qdt,
                  (*lead, K // 2 if kind == "int4" else K, N), device)
    _check_tensor(name + ".sc", w.sc, sdt, (*lead, K // QK, N), device)
    return [w.qs.data_ptr(), w.sc.data_ptr()]


def mega_decode_step(cfg, mp: MegaParams, x0: torch.Tensor,
                     kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                     xk: torch.Tensor, xv: torch.Tensor):
    """Kernel K2: one decode step for one token.

    x0 (1, S) bf16 token + position row for position kv_head; kv_k/kv_v
    (L, Tc, S) bf16 self-cache, written in place at row kv_head; kv_head a
    0-d integer tensor on x0's device (the kernel reads it there, so a step
    never waits on the host) or an int; xk/xv (L, Ta, S) bf16 cross-KV, xk
    pre-scaled by dh^-0.25. Returns (logits (1, V) f32, kv_k, kv_v).

    CPU tensors take `mega_decode_step_plain`; CUDA tensors launch
    csrc/mega_step.cu on the current stream or raise. `launches` counts
    steps run on the card. More than one row (the speculative verify pass)
    is not ported yet."""
    if x0.dim() != 2 or x0.shape[0] != 1:
        raise NotImplementedError(
            f"mega_decode_step: {tuple(x0.shape)} rows; the multi-row verify "
            "pass of speculative decoding is not ported to the PyTorch package yet")
    if x0.device.type == "cpu":
        return mega_decode_step_plain(cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv)
    dev = x0.device
    if dev.type != "cuda":
        raise ValueError(f"mega_decode_step: unsupported device {dev}")
    S, H, L, V = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer, cfg.n_vocab
    if S % 128 or S // H != 64:
        raise ValueError(f"mega_decode_step: S={S} with {H} heads; the kernel "
                         "takes S % 128 == 0 and 64-wide heads")
    Tc, Ta, Vp = kv_k.shape[1], xk.shape[1], mp.vp
    if Vp % 64 or Vp < V:
        raise ValueError(f"mega_decode_step: vocab plane width {Vp}")
    x0b = x0.to(torch.bfloat16).contiguous()
    _check_tensor("x0", x0b, torch.bfloat16, (1, S), dev)
    for name, t in (("kv_k", kv_k), ("kv_v", kv_v)):
        _check_tensor(name, t, torch.bfloat16, (L, Tc, S), dev)
    for name, t in (("xk", xk), ("xv", xv)):
        _check_tensor(name, t, torch.bfloat16, (L, Ta, S), dev)
    head = torch.as_tensor(kv_head, device=dev).to(torch.int64).reshape(())
    _check_tensor("lnw", mp.lnw, torch.bfloat16, (3 * L + 1, S), dev)
    _check_tensor("lnb", mp.lnb, torch.bfloat16, (3 * L + 1, S), dev)
    ptrs = [x0b.data_ptr(), head.data_ptr(), mp.lnw.data_ptr(), mp.lnb.data_ptr()]
    kn = {"qkv_w": (S, 3 * S), "o_w": (S, S), "cq_w": (S, S), "co_w": (S, S),
          "mlp0_w": (S, 4 * S), "mlp1_w": (4 * S, S), "teT": (S, Vp)}
    for name, bname in zip(WEIGHTS, _BIASES):
        b = getattr(mp, bname)
        _check_tensor(bname, b, torch.bfloat16, (L, kn[name][1]), dev)
        ptrs.append(b.data_ptr())
    kinds = []
    for name in WEIGHTS:
        w = getattr(mp, name)
        if _kind(w) == "int4" and S % 256:
            raise ValueError(f"mega_decode_step: int4 planes need S % 256 == 0, S={S}")
        ptrs += _field_args(name, w, *kn[name], None if name == "teT" else L, dev)
        kinds.append(_KINDS[_kind(w)])
    logits = torch.empty(1, Vp, dtype=torch.float32, device=dev)
    dims = [L, S, H, Tc, Ta, Vp, *kinds]
    lib = _kernel_lib()
    ws = _workspace(lib, dims, dev)
    ptrs += [kv_k.data_ptr(), kv_v.data_ptr(), xk.data_ptr(), xv.data_ptr(),
             logits.data_ptr(), ws.data_ptr()]
    dh = S // H
    kq = float(torch.tensor(float(dh) ** -0.25, dtype=torch.bfloat16))
    rc = lib.owk_mega_step((_P * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
                           float(cfg.eps), kq, float(dh) ** -0.25,
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mega_decode_step: kernel launch failed (cudaError {rc})")
    mega_decode_step.launches += 1
    return logits[:, :V], kv_k, kv_v


mega_decode_step.launches = 0
