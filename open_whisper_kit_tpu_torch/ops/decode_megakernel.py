"""The decode-step kernels: K2, the whole per-token decoder in one call;
K7, the same step for B <= 8 beams through one weight stream; K8, the
same for B <= 8 independent streams (batched serving).

Port of open_whisper_kit_tpu/ops/decode_megakernel.py: `mega_decode_step`
for one token or, in the speculative verify pass, R <= 8 consecutive
tokens of one stream; the beam-search `mega_decode_step_beam` and the
batched-stream `mega_decode_step_batch`. One step takes the (R, S) bf16
token plus position rows and runs every layer (layernorm, fused QKV with
the new K/V rows written at `kv_head`, self-attention, cross-attention,
the tanh-GELU MLP), the final layernorm and the vocab projection to f32
logits.

Each weight field is dense bf16, int8 `QPlanes` (per-32-row f32 scales) or
split-half int4 `Q4Planes` (bf16 scales), chosen by `prepare_mega`:

* "none"   - every weight dense bf16 (the prepared decoder's arrays);
* "logits" - layers dense, the vocab projection int8 (reusing a
             `te_logits` int8 plane when the decoder has one);
* "all"    - every weight int8 (checkpoint planes reused, dense weights
             quantized; the W8 serving mode);
* "int4"   - every weight split-half int4 (the W4 serving mode).

`mega_decode_step` launches csrc/mega_step.cu on CUDA tensors (a chain of
33 dependent launches per large-v3-turbo token from one wrapper call,
planned by `mega_step_plan`; the argument pack and the planes' tensor maps
are cached, so a call does work only for x0, kv_head and the logits) and
takes
`mega_decode_step_plain`, the same rounding points in plain torch, on CPU
tensors. The caches are the port's natural layout: the self-cache
(L, Tc, S) and the cross-KV (L, Ta, S) are views of the (L, 1, T, S)
tensors `init_kv_cache` and `cross_kv` return, so no conversion copy is
made. Planes are padded to what the kernel needs (a multiple of 128
columns); the logits come back sliced to the vocabulary.

`mega_decode_step_beam` (csrc/mega_beam.cu on CUDA, `mega_decode_step_beam_
plain` on the CPU) takes B beam rows, a shared (L, Ta, S) cross-KV and a
row-flat, time-major self-cache (L, Tc * B, S) whose row t * B + b is slot
b at time t. Beams never move their cache rows: lineage is an origin table
(B, Tc), origin[b, t] the slot that holds beam b's row for time t. The TPU
kernel takes it as the 0/-inf bias `beam_attn_bias` builds, which the plain
version consumes as JAX does; the CUDA kernel reads the table itself. The
self-attention is an online softmax over 128-row time blocks, as the TPU
kernel runs it; the cross-attention K2's full-row softmax. On the card it
is K2's chain at R = B (K2's GEMVs and cross-attention, planned by
`mega_beam_plan`) with the lineage self-attention of K8's block kernel,
from the same cached argument pack and tensor maps as K2 (the origin
table's address is passed in each call).

`mega_decode_step_batch` (csrc/mega_batch.cu on CUDA, `mega_decode_step_
batch_plain` on the CPU) takes B streams on the same time-major
self-cache with the identity lineage (stream b owns slot b; the CUDA
kernel needs no table) and a per-stream (L, B, Ta, S) cross-KV, which it
attends with the TPU kernel's chunked online softmax over 256-row key
chunks; its self-attention is the same online softmax over 128-row time
blocks. On the card it is K2's chain at R = B (K2's GEMVs, planned by
`mega_batch_plan`) with its own cluster attention kernels, from the same
cached argument pack and tensor maps as K2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

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

def _matvec(x16: torch.Tensor, w, il: int | None, rowwise: bool = False) -> torch.Tensor:
    """x16 (R, K) bf16 @ field plane (layer il) -> (R, N) f32: each weight
    dequantized in f32 and rounded to bf16, every product exact, f32 sums.
    `rowwise`: one product per row, each the one-row product bit for bit
    (a CPU matmul may block its sums by the row count)."""
    if il is not None:
        w = type(w)(qs=w.qs[il], sc=w.sc[il]) if _kind(w) else w[il]
    x = x16.float()
    kind = _kind(w)
    if kind is None:
        planes = (w.float(),)
    elif kind == "int8":
        K, N = w.qs.shape
        planes = ((w.qs.float().reshape(K // QK, QK, N) * w.sc[:, None, :].float()
                   ).reshape(K, N).to(torch.bfloat16).float(),)
    else:
        K2, N = w.qs.shape
        q = w.qs.to(torch.int32)
        sc = w.sc.float().reshape(2, K2 // QK, 1, N)
        lo = (((q & 0x0F) - 8).float().reshape(K2 // QK, QK, N) * sc[0]).reshape(K2, N)
        hi = (((q >> 4) - 8).float().reshape(K2 // QK, QK, N) * sc[1]).reshape(K2, N)
        planes = (lo.to(torch.bfloat16).float(), hi.to(torch.bfloat16).float())

    def product(x):
        if len(planes) == 1:
            return x @ planes[0]
        K2 = planes[0].shape[0]
        return x[:, :K2] @ planes[0] + x[:, K2:] @ planes[1]
    if rowwise:
        return torch.cat([product(x[r:r + 1]) for r in range(x.shape[0])])
    return product(x)


def _attend(q16: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int,
            scale: float, n_head: int) -> torch.Tensor:
    """(R, S) bf16 queries over keys [0, n_valid) of natural (T, S) k/v:
    f32 scores times `scale`, full-row f32 softmax, probabilities rounded
    to bf16, P.V summed in f32, rounded to bf16."""
    R, S = q16.shape
    dh = S // n_head
    qh = q16.float().reshape(R, n_head, dh).transpose(0, 1).contiguous()  # (H, R, dh)
    kh = k[:n_valid].float().reshape(n_valid, n_head, dh).transpose(0, 1)
    vh = v[:n_valid].float().reshape(n_valid, n_head, dh).transpose(0, 1)
    s = (qh @ kh.transpose(1, 2)) * scale                     # (H, R, n)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
    return (p.float() @ vh).transpose(0, 1).reshape(R, S).to(torch.bfloat16)


BT = 128          # self-attention time-block rows of the beam step
_BIAS_ROWS = 8    # bias rows per time block (the TPU kernel's sublane rows)


def beam_attn_bias(origin: torch.Tensor, head, Tc: int, M: int = _BIAS_ROWS
                   ) -> torch.Tensor:
    """Origin (lineage) table -> the beam step's additive self-attention
    bias, as the JAX package builds it.

    origin (B, Tc) long: origin[b, t] = the cache slot that holds beam b's
    K/V row for position t. The beam loop keeps it instead of gathering
    the caches on every reorder: origin = origin[src], then
    origin[:, head] = arange(B). `head` (int or 0-d tensor): this step
    attends t <= head. Returns (ceil(Tc/128)*M, 128*B) f32 of 0 / -inf,
    block-major: element [t*M + row, tl*B + j] gates row `row` attending
    slot j at time t*128 + tl. Rows >= B reuse beam B-1's lineage."""
    B, Tc0 = origin.shape
    assert Tc0 == Tc, (Tc0, Tc)
    dev = origin.device
    Tcp = -(-Tc // BT) * BT
    nblk = Tcp // BT
    org = torch.nn.functional.pad(origin.long(), (0, Tcp - Tc, 0, M - B), value=-1)
    org = torch.where(torch.arange(M, device=dev)[:, None] >= B, org[B - 1][None, :], org)
    head = torch.as_tensor(head, device=dev)
    ok = ((org[:, :, None] == torch.arange(B, device=dev)[None, None, :])
          & (torch.arange(Tcp, device=dev)[None, :, None] <= head))   # (M, Tcp, B)
    ok = ok.reshape(M, nblk, BT, B).permute(1, 0, 2, 3)
    return torch.where(ok.reshape(nblk * M, BT * B), 0.0, float("-inf")).float()


def _attend_beams(q16: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head: int,
                  bias: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, S) bf16 beam queries against the row-flat time-major (Tc*B, S)
    self-cache, the TPU kernel's blocked online softmax: over time blocks
    0 .. head // 128 in order, m from -1e30, per block mn = max(m, max s),
    a = exp(m - mn), e = bf16(exp(s - mn)), l = l*a + sum(e), o = o*a +
    e.V in f32 (scores masked where the bias is < 0); bf16(o / l)."""
    B, S = q16.shape
    dh = S // n_head
    W = BT * B
    qh = q16.float().reshape(B, n_head, dh).transpose(0, 1)   # (H, B, dh)
    m = torch.full((n_head, B, 1), -1e30, device=q16.device)
    l = torch.zeros(n_head, B, 1, device=q16.device)
    o = torch.zeros(n_head, B, dh, device=q16.device)
    for t in range((head + BT) // BT):
        kb, vb = k[t * W:(t + 1) * W].float(), v[t * W:(t + 1) * W].float()
        if kb.shape[0] < W:   # the cache's last, partial time block: zero rows
            kb = torch.nn.functional.pad(kb, (0, 0, 0, W - kb.shape[0]))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, W - vb.shape[0]))
        kh = kb.reshape(W, n_head, dh).transpose(0, 1)        # (H, W, dh)
        vh = vb.reshape(W, n_head, dh).transpose(0, 1)
        s = qh @ kh.transpose(1, 2)                           # (H, B, W)
        s = torch.where(bias[t * _BIAS_ROWS:t * _BIAS_ROWS + B][None] < 0,
                        float("-inf"), s)
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        a = torch.exp(m - mn)
        e = torch.exp(s - mn).to(torch.bfloat16).float()
        l = l * a + e.sum(dim=-1, keepdim=True)
        o = o * a + e @ vh
        m = mn
    return (o / l).transpose(0, 1).reshape(B, S).to(torch.bfloat16)


def _ln16(x16, w, b, eps):
    return layer_norm(x16.float(), w, b, eps).to(torch.bfloat16)


def _cross_scale(cfg) -> float:
    """The cross scores' scale dh^-0.25, as the f32 the TPU kernel uses."""
    return float(np.float32(float(cfg.d_text_head) ** -0.25))


def _shared_cross(cfg, xk: torch.Tensor, xv: torch.Tensor):
    """cross_attend for rows that share one (L, Ta, S) cross-KV (K2, K7):
    full-row softmax over the Ta keys."""
    return lambda il, cq: _attend(cq, xk[il], xv[il], xk.shape[1], _cross_scale(cfg),
                                  cfg.n_text_head)


def _step_rows_plain(cfg, mp: MegaParams, x0: torch.Tensor, self_attend,
                     cross_attend, rowwise: bool = False) -> torch.Tensor:
    """The decoder step for the R rows of x0, each row alone, as the TPU
    kernel body rounds it; `self_attend(il, q, k, v)` writes the layer's
    new K/V rows and returns the (R, S) bf16 self-attention output,
    `cross_attend(il, cq)` the (R, S) bf16 cross-attention output.
    `rowwise`: every matmul and layernorm one row at a time (see _matvec).
    Returns the (R, V) f32 logits."""
    S, H, L = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer
    dh = S // H
    eps = float(cfg.eps)
    kq16 = torch.tensor(float(dh) ** -0.25, dtype=torch.bfloat16, device=x0.device)
    bias = lambda name, il: getattr(mp, name)[il][None]       # noqa: E731

    mm = functools.partial(_matvec, rowwise=rowwise)

    def ln(x, w, b, eps):
        if rowwise:
            return torch.cat([_ln16(x[r:r + 1], w, b, eps) for r in range(x.shape[0])])
        return _ln16(x, w, b, eps)
    x = x0.to(torch.bfloat16)
    for il in range(L):
        h16 = ln(x, mp.lnw[3 * il], mp.lnb[3 * il], eps)
        qkv = mm(h16, mp.qkv_w, il).to(torch.bfloat16) + bias("qkv_b", il)
        q = qkv[:, :S] * kq16
        a16 = self_attend(il, q, qkv[:, S:2 * S] * kq16, qkv[:, 2 * S:])
        x = x + (mm(a16, mp.o_w, il).to(torch.bfloat16) + bias("o_b", il))

        h16 = ln(x, mp.lnw[3 * il + 1], mp.lnb[3 * il + 1], eps)
        cq = mm(h16, mp.cq_w, il).to(torch.bfloat16) + bias("cq_b", il)
        a16 = cross_attend(il, cq)
        x = x + (mm(a16, mp.co_w, il).to(torch.bfloat16) + bias("co_b", il))

        h16 = ln(x, mp.lnw[3 * il + 2], mp.lnb[3 * il + 2], eps)
        pre = (mm(h16, mp.mlp0_w, il).to(torch.bfloat16) + bias("mlp0_b", il))
        g = torch.nn.functional.gelu(pre.float(), approximate="tanh").to(torch.bfloat16)
        x = x + (mm(g, mp.mlp1_w, il).to(torch.bfloat16) + bias("mlp1_b", il))
    xf = ln(x, mp.lnw[3 * L], mp.lnb[3 * L], eps)
    return mm(xf, mp.teT, None)[:, :cfg.n_vocab]


def mega_decode_step_plain(cfg, mp: MegaParams, x0: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                           xk: torch.Tensor, xv: torch.Tensor):
    """K2's function in plain torch, the kernel's reference (and the CPU
    path). Same arguments and results as `mega_decode_step`. Every layer
    writes all R rows' K/V, then row r attends rows up to kv_head + r; each
    row's products, layernorms and attention run alone, so R rows equal R
    sequential one-row calls bit for bit. A row at or past the cache's Tc
    rows writes nothing and attends all Tc."""
    head, Tc = int(kv_head), kv_k.shape[1]
    R = x0.shape[0]
    keep = max(min(R, Tc - head), 0)
    cross = _shared_cross(cfg, xk, xv)

    def self_attend(il, q, k, v):
        kv_k[il, head:head + keep] = k[:keep]
        kv_v[il, head:head + keep] = v[:keep]
        return torch.cat([_attend(q[r:r + 1], kv_k[il], kv_v[il], min(head + r + 1, Tc), 1.0,
                                  cfg.n_text_head) for r in range(R)])

    def cross_rows(il, cq):
        return torch.cat([cross(il, cq[r:r + 1]) for r in range(R)])
    return _step_rows_plain(cfg, mp, x0, self_attend, cross_rows, rowwise=True), kv_k, kv_v


def mega_decode_step_beam_plain(cfg, mp: MegaParams, x0: torch.Tensor,
                                kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                                xk: torch.Tensor, xv: torch.Tensor,
                                origin: torch.Tensor):
    """K7's function in plain torch for B > 1 beams, the kernel's
    reference (and the CPU path): the TPU kernel's body with n_beams = B,
    the lineage bias `beam_attn_bias(origin, kv_head, Tc)` and the blocked
    self-attention. Same arguments and results as `mega_decode_step_beam`."""
    B = x0.shape[0]
    head = int(kv_head)
    attn_bias = beam_attn_bias(origin, head, kv_k.shape[1] // B)

    def self_attend(il, q, k, v):
        kv_k[il, head * B:(head + 1) * B] = k
        kv_v[il, head * B:(head + 1) * B] = v
        return _attend_beams(q, kv_k[il], kv_v[il], head, attn_bias, cfg.n_text_head)
    return _step_rows_plain(cfg, mp, x0, self_attend, _shared_cross(cfg, xk, xv)), kv_k, kv_v


TAC = 256         # cross-attention key rows per chunk of the batch step


def _cross_chunked(q16: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, n_head: int) -> torch.Tensor:
    """(B, S) bf16 queries, stream b against its own natural (Ta, S) keys
    k[b] / values v[b]: the TPU kernel's chunked online softmax over
    TAC-row key chunks in order, m from -1e30, per chunk mn = max(m,
    max s), a = exp(m - mn), e = bf16(exp(s - mn)), l = l*a + sum(e),
    o = o*a + e.V in f32; bf16(o / l). Keys past Ta, which the TPU kernel
    pads and scores -1e30, add exact zeros, so the last chunk is cut."""
    B, S = q16.shape
    Ta, dh = k.shape[1], S // n_head
    qh = q16.float().reshape(B, n_head, 1, dh)
    m = torch.full((B, n_head, 1, 1), -1e30, device=q16.device)
    l = torch.zeros(B, n_head, 1, 1, device=q16.device)
    o = torch.zeros(B, n_head, 1, dh, device=q16.device)
    for t0 in range(0, Ta, TAC):
        kc = k[:, t0:t0 + TAC].float().reshape(B, -1, n_head, dh).transpose(1, 2)
        vc = v[:, t0:t0 + TAC].float().reshape(B, -1, n_head, dh).transpose(1, 2)
        sc = (qh @ kc.transpose(-1, -2)) * scale                     # (B, H, 1, c)
        mn = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        a = torch.exp(m - mn)
        e = torch.exp(sc - mn).to(torch.bfloat16).float()
        l = l * a + e.sum(dim=-1, keepdim=True)
        o = o * a + e @ vc
        m = mn
    return (o / l).reshape(B, S).to(torch.bfloat16)


def mega_decode_step_batch_plain(cfg, mp: MegaParams, x0: torch.Tensor,
                                 kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                                 xk: torch.Tensor, xv: torch.Tensor):
    """K8's function in plain torch for B > 1 independent streams, the
    kernel's reference (and the CPU path): the TPU kernel's body with B
    rows, the identity lineage (stream b owns slot b at every time: its
    bias `beam_attn_bias(arange(B) per time, kv_head, Tc)`), the blocked
    self-attention and each stream's chunked cross-attention over its own
    (Ta, S) cross-KV. Same arguments and results as
    `mega_decode_step_batch`."""
    B = x0.shape[0]
    head = int(kv_head)
    Tc = kv_k.shape[1] // B
    origin = torch.arange(B, device=x0.device)[:, None].expand(B, Tc)
    attn_bias = beam_attn_bias(origin, head, Tc)

    def self_attend(il, q, k, v):
        kv_k[il, head * B:(head + 1) * B] = k
        kv_v[il, head * B:(head + 1) * B] = v
        return _attend_beams(q, kv_k[il], kv_v[il], head, attn_bias, cfg.n_text_head)

    def cross_attend(il, cq):
        return _cross_chunked(cq, xk[il], xv[il], _cross_scale(cfg), cfg.n_text_head)
    return _step_rows_plain(cfg, mp, x0, self_attend, cross_attend), kv_k, kv_v


# -- K2's launch plan ------------------------------------------------------------

# csrc/mega_stream.cuh: a GEMV block makes MEGA_BN output columns from a ring
# of 32-row stages (at most MEGA_MAX_DEPTH) and holds 8 x rows; a tile's
# splits of K and a head's key chunks are each one thread-block cluster of
# at most MEGA_MAX_CLUSTER blocks (the portable size); a block may ask for
# MEGA_MAX_SMEM bytes of shared memory (what the kernels opt in to, kMaxSmem)
# and a multiprocessor holds MEGA_SM_SMEM for its blocks (the H100's 227
# KB); a key chunk is at
# most MEGA_MAX_CHUNK keys, a multiple of 16. The plan is for the H100's
# MEGA_SMS multiprocessors.
MEGA_BN = 128
MEGA_MAX_CLUSTER = 8
MEGA_MAX_DEPTH = 20
MEGA_MAX_SMEM = 200 << 10
MEGA_SM_SMEM = 227 << 10
MEGA_MAX_CHUNK = 256
MEGA_SMS = 132
_MEGA_X_ROWS = 8
# about this many blocks a GEMV launch at least (K3's rows route's number)
MEGA_BLOCKS = 100
# the ring depth a field's splits are sized for (dense 64 KB, int8 / int4
# 54 KB), so that a split's stages are all in flight before its launch waits
# on the one in front of it; and the deepest ring a format takes where the
# cluster limit leaves longer splits (mlp1: dense 80 KB, int8 90 KB)
_RING_DEPTH = {None: 8, "int8": 12, "int4": 12}
_RING_MAX = {None: 10, "int8": 20, "int4": 20}
_LN_FIELDS = ("qkv_w", "cq_w", "mlp0_w", "teT")   # the fields with a layernorm prologue


@dataclasses.dataclass(frozen=True)
class MegaField:
    """One weight field's GEMV launch in K2's chain: `tiles` column tiles of
    MEGA_BN (the grid's x) times `splits` of K (its y, one cluster a tile),
    each block streaming its split through a ring of `depth` stages. K is
    split in stages of 32 rows (int4: 32 packed rows, whose nibbles hold K
    rows p and p + K/2); split s takes the stages [s * n // splits,
    (s + 1) * n // splits) of n."""
    name: str
    kind: str | None
    K: int
    N: int
    splits: int
    depth: int = 1

    @property
    def stages(self) -> int:
        return (self.K // 2 if self.kind == "int4" else self.K) // QK

    @property
    def tiles(self) -> int:
        return self.N // MEGA_BN

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def split_stages(self) -> int:
        """Stages of the longest split."""
        return -(-self.stages // self.splits)

    def split_rows(self) -> list[tuple[int, int]]:
        """The K rows [start, stop) of each split, in split order (int4: the
        low run; the high run is the same K/2 rows on)."""
        n = self.stages
        return [(s * n // self.splits * QK, (s + 1) * n // self.splits * QK)
                for s in range(self.splits)]

    def smem(self, rows: int) -> int:
        """Bytes of shared memory a block asks for at `rows` rows
        (csrc/mega_stream.cuh::gemv_layout): 1024 of alignment, the ring
        (dense 8 KB a stage; int8 and int4 4 KB of values and 512 bytes of
        scales), its barriers, 8 x rows of the longest split (int4: two
        runs) padded by 8 values, the partial sums the first split gathers,
        and with a layernorm the split's weights and (with more than one
        split; one split stages them in x's rows) the input rows whole."""
        w, s = (8192, 0) if self.kind is None else (4096, 512)
        runs = 2 if self.kind == "int4" else 1
        run = self.split_stages * QK
        ln = 0
        if self.name in _LN_FIELDS:   # one split: the rows are staged in x's
            ln = 2 * runs * run * 2 + (rows * (self.K + 8) * 2 if self.splits > 1 else 0)
        return (1024 + self.depth * (w + s) + 16 * MEGA_MAX_DEPTH + 16
                + _MEGA_X_ROWS * (runs * run + 8) * 2 + (self.splits - 1) * rows * MEGA_BN * 4
                + ln)


def _attn_smem(chunk: int, chunks: int, rows: int) -> int:
    """csrc/mega_stream.cuh::attn_layout: K, V and q (144-byte rows), the
    scores, P, the statistics (the block's and the cluster's), the warps'
    P.V sums, this chunk's partial and the other chunks'."""
    return (2 * chunk * 144 + _MEGA_X_ROWS * 144 + _MEGA_X_ROWS * chunk * 4
            + _MEGA_X_ROWS * (chunk + 8) * 2 + _MEGA_X_ROWS * 8 + MEGA_MAX_CLUSTER * _MEGA_X_ROWS * 8
            + 4 * _MEGA_X_ROWS * 64 * 4 + rows * 64 * 4 + (chunks - 1) * rows * 64 * 4 + 16)


def _attn_chunk(T: int, parts: int) -> int:
    """Keys a block: T keys over `parts` chunks, rounded up to 16."""
    return max(16, -(-(-(-T // parts)) // 16) * 16)


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    """K2's launches for one step: the seven fields' GEMVs (qkv, o, cq, co,
    mlp0, mlp1, logits) and the key chunks of the self- and
    cross-attention, each head's chunks one cluster."""
    rows: int
    fields: tuple[MegaField, ...]
    self_chunk: int
    self_chunks: int
    cross_chunk: int
    cross_chunks: int

    @property
    def ints(self) -> tuple[int, ...]:
        """What the kernel takes: the seven fields' splits, their ring
        depths, then the self and the cross key chunk."""
        return (*(f.splits for f in self.fields), *(f.depth for f in self.fields),
                self.self_chunk, self.cross_chunk)

    @property
    def attn_smem(self) -> tuple[int, int]:
        """Shared memory of a self- and of a cross-attention block."""
        return (_attn_smem(self.self_chunk, self.self_chunks, self.rows),
                _attn_smem(self.cross_chunk, self.cross_chunks, self.rows))


@functools.cache
def _gemv_fields(S: int, Vp: int, kinds: tuple) -> tuple[MegaField, ...]:
    """The seven fields' GEMV launches (K2's and K8's): splits and ring depths
    from each field's kind, K and N only."""
    kn = {"qkv_w": (S, 3 * S), "o_w": (S, S), "cq_w": (S, S), "co_w": (S, S),
          "mlp0_w": (S, 4 * S), "mlp1_w": (4 * S, S), "teT": (S, Vp)}
    fields = []
    for name, kind in zip(WEIGHTS, kinds):
        K, N = kn[name]
        f = MegaField(name, kind, K, N, 1)
        # enough splits for MEGA_BLOCKS blocks, and for rings that hold a
        # whole split where the grid then still fits the card at two blocks
        # a multiprocessor (not the logits: their plane is streamed)
        ring = _RING_DEPTH[kind]
        splits = -(-MEGA_BLOCKS // f.tiles)
        if f.tiles * -(-f.stages // ring) <= 2 * MEGA_SMS:
            splits = max(splits, -(-f.stages // ring))
        f = dataclasses.replace(f, splits=max(1, min(splits, f.stages, MEGA_MAX_CLUSTER)))
        f = dataclasses.replace(f, depth=min(f.split_stages, _RING_MAX[kind]))
        # a grid of more blocks than the card holds at two a multiprocessor
        # (the logits) keeps a shallower ring, so that all its blocks are
        # resident at once (at 8 rows)
        per_sm = -(-f.blocks // MEGA_SMS)
        while per_sm > 2 and f.depth > 2 and f.smem(8) * per_sm > MEGA_SM_SMEM:
            f = dataclasses.replace(f, depth=f.depth - 1)
        fields.append(f)
    return tuple(fields)


@functools.cache
def _mega_step_plan(S: int, Vp: int, n_text_ctx: int, kinds: tuple, Tc: int, Ta: int,
                    rows: int) -> MegaPlan:
    fields = _gemv_fields(S, Vp, kinds)
    # the self-attention's chunk from Tp = min(Tc, n_text_ctx) keys over 7
    # chunks: the greedy loop's cache (Tp rows) and the speculative loop's
    # (Tp + gamma + 4) then split every row's keys alike, and the eighth
    # chunk holds the speculative loop's extra rows
    sc = _attn_chunk(min(Tc, n_text_ctx), MEGA_MAX_CLUSTER - 1)
    cc = _attn_chunk(Ta, MEGA_MAX_CLUSTER)
    plan = MegaPlan(rows, fields, sc, -(-Tc // sc), cc, -(-Ta // cc))
    if (max(plan.self_chunks, plan.cross_chunks) > MEGA_MAX_CLUSTER
            or max(sc, cc) > MEGA_MAX_CHUNK):
        raise ValueError(f"mega_decode_step: no plan for {Tc} cache rows and {Ta} audio "
                         f"positions (at most {MEGA_MAX_CLUSTER} chunks of "
                         f"{MEGA_MAX_CHUNK} keys)")
    if (max(f.smem(rows) for f in fields) > MEGA_MAX_SMEM
            or max(plan.attn_smem) > MEGA_MAX_SMEM):
        raise ValueError(f"mega_decode_step: no plan fits shared memory at S={S}")
    return plan


def mega_step_plan(cfg, kinds, Tc: int, Ta: int | None = None, rows: int = 1,
                   Vp: int | None = None) -> MegaPlan:
    """K2's launch plan (csrc/mega_step.cu) for a decoder whose seven weight
    fields have `kinds` (None dense, "int8", "int4"; the order of WEIGHTS),
    a self-cache of Tc rows and Ta audio positions (default
    cfg.n_audio_ctx), at `rows` rows (1..8; only the shared memory of the
    partial sums the first split gathers depends on it). The splits depend
    on each field's kind, K and N only, the self-attention's key chunk on
    min(Tc, n_text_ctx) only: every row's sums run in the same order
    whatever the row count, so a verify row equals the one-row step."""
    if not 1 <= rows <= 8:
        raise ValueError(f"mega_decode_step: {rows} rows; 1 to 8")
    S = cfg.n_text_state
    Vp = Vp or -(-cfg.n_vocab // _VP_MULTIPLE) * _VP_MULTIPLE
    return _mega_step_plan(S, Vp, cfg.n_text_ctx, tuple(kinds), Tc,
                           cfg.n_audio_ctx if Ta is None else Ta, rows)


def mega_step_max_cache(cfg) -> int:
    """The most self-cache rows K2 plans for: MEGA_MAX_CLUSTER key chunks
    of the chunk that n_text_ctx keys over MEGA_MAX_CLUSTER - 1 give (512
    at n_text_ctx 448). A longer cache has no plan: the wrapper raises."""
    return MEGA_MAX_CLUSTER * _attn_chunk(cfg.n_text_ctx, MEGA_MAX_CLUSTER - 1)


# -- K8's and K7's launch plans ---------------------------------------------------

# csrc/mega_blocks.cuh (K8's attention, K7's self-attention): a block takes BT
# time rows (self) or TAC audio positions (cross) of one (head, row) pair,
# one thread a key row; a pair's blocks are one cluster
_PART = 64 + 4        # a partial: o (64 f32), l and padding


def _block_smem(rows: int) -> int:
    """csrc/mega_blocks.cuh::block_layout: K and V of the block (128-byte
    rows), q, e, the warps' P.V sums, the partial and the other blocks', the
    block's max and the cluster's, the warps' maxima or sums, the gather
    barrier, a lineage's slots, the 128-byte alignment."""
    return (2 * rows * 128 + 64 * 2 + rows * 4 + rows // 32 * 64 * 4 + _PART * 4
            + (MEGA_MAX_CLUSTER - 1) * _PART * 4 + 16 + MEGA_MAX_CLUSTER * 4 + 32 + 16
            + rows * 4 + 128)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """K8's launches for one step of `rows` = B streams: K2's seven GEMV
    fields at B rows, the self-attention's time blocks of BT rows and the
    cross-attention's chunks of TAC audio positions (each a grid of heads x
    blocks x streams, a (head, stream) pair's blocks one cluster)."""
    rows: int
    fields: tuple[MegaField, ...]
    self_blocks: int
    cross_chunks: int

    @property
    def ints(self) -> tuple[int, ...]:
        """What the kernel takes: the seven fields' splits, their ring
        depths, then the self-attention's time block and the cross chunk."""
        return (*(f.splits for f in self.fields), *(f.depth for f in self.fields), BT, TAC)

    @property
    def attn_smem(self) -> tuple[int, int]:
        """Shared memory of a self- and of a cross-attention block."""
        return _block_smem(BT), _block_smem(TAC)


def mega_batch_plan(cfg, kinds, Tc: int, Ta: int | None = None, streams: int = 8,
                    Vp: int | None = None) -> BatchPlan:
    """K8's launch plan (csrc/mega_batch.cu) for B = `streams` (2..8) streams
    of a decoder whose seven weight fields have `kinds` (as mega_step_plan),
    a self-cache of Tc rows a stream and Ta audio positions (default
    cfg.n_audio_ctx). The GEMVs are K2's at R = B. A cluster holds at most
    MEGA_MAX_CLUSTER time blocks of BT rows (Tc <= 1024) and as many chunks
    of TAC positions (Ta <= 2048); past that there is no plan (ValueError)."""
    if not 2 <= streams <= 8:
        raise ValueError(f"mega_decode_step_batch: {streams} streams; 2 to 8")
    S = cfg.n_text_state
    Vp = Vp or -(-cfg.n_vocab // _VP_MULTIPLE) * _VP_MULTIPLE
    Ta = cfg.n_audio_ctx if Ta is None else Ta
    plan = BatchPlan(streams, _gemv_fields(S, Vp, tuple(kinds)), -(-Tc // BT), -(-Ta // TAC))
    if max(plan.self_blocks, plan.cross_chunks) > MEGA_MAX_CLUSTER:
        raise ValueError(
            f"mega_decode_step_batch: no plan for {Tc} cache rows a stream and {Ta} audio "
            f"positions: a cluster holds at most {MEGA_MAX_CLUSTER} time blocks of {BT} rows "
            f"({MEGA_MAX_CLUSTER * BT}) and {MEGA_MAX_CLUSTER} chunks of {TAC} positions "
            f"({MEGA_MAX_CLUSTER * TAC})")
    if (max(f.smem(streams) for f in plan.fields) > MEGA_MAX_SMEM
            or max(plan.attn_smem) > MEGA_MAX_SMEM):
        raise ValueError(f"mega_decode_step_batch: no plan fits shared memory at S={S}")
    return plan


@dataclasses.dataclass(frozen=True)
class BeamPlan:
    """K7's launches for one step of `rows` = B beams: K2's seven GEMV
    fields at B rows, the lineage self-attention's time blocks of BT rows
    (a grid of heads x blocks x beams, a (head, beam) pair's blocks one
    cluster) and K2's cross-attention over the shared cross-KV, `cross_chunk`
    keys a block, a head's `cross_chunks` blocks one cluster."""
    rows: int
    fields: tuple[MegaField, ...]
    self_blocks: int
    cross_chunk: int
    cross_chunks: int

    @property
    def ints(self) -> tuple[int, ...]:
        """What the kernel takes: the seven fields' splits, their ring
        depths, then the self-attention's time block and the cross chunk."""
        return (*(f.splits for f in self.fields), *(f.depth for f in self.fields), BT,
                self.cross_chunk)

    @property
    def attn_smem(self) -> tuple[int, int]:
        """Shared memory of a self- and of a cross-attention block."""
        return _block_smem(BT), _attn_smem(self.cross_chunk, self.cross_chunks, self.rows)


def mega_beam_plan(cfg, kinds, Tc: int, Ta: int | None = None, beams: int = 5,
                   Vp: int | None = None) -> BeamPlan:
    """K7's launch plan (csrc/mega_beam.cu) for B = `beams` (2..8) beams of
    a decoder whose seven weight fields have `kinds` (as mega_step_plan), a
    self-cache of Tc rows a beam and Ta audio positions (default
    cfg.n_audio_ctx). The GEMVs are K2's at R = B, the cross-attention's
    chunks K2's (Ta over MEGA_MAX_CLUSTER chunks). A cluster holds at most
    MEGA_MAX_CLUSTER time blocks of BT rows (Tc <= 1024) and as many cross
    chunks of at most MEGA_MAX_CHUNK positions (Ta <= 2048); past that
    there is no plan (ValueError)."""
    if not 2 <= beams <= 8:
        raise ValueError(f"mega_decode_step_beam: {beams} beams; 2 to 8")
    S = cfg.n_text_state
    Vp = Vp or -(-cfg.n_vocab // _VP_MULTIPLE) * _VP_MULTIPLE
    Ta = cfg.n_audio_ctx if Ta is None else Ta
    cc = _attn_chunk(Ta, MEGA_MAX_CLUSTER)
    plan = BeamPlan(beams, _gemv_fields(S, Vp, tuple(kinds)), -(-Tc // BT), cc, -(-Ta // cc))
    if plan.self_blocks > MEGA_MAX_CLUSTER or cc > MEGA_MAX_CHUNK:
        raise ValueError(
            f"mega_decode_step_beam: no plan for {Tc} cache rows a beam and {Ta} audio "
            f"positions: a cluster holds at most {MEGA_MAX_CLUSTER} time blocks of {BT} rows "
            f"({MEGA_MAX_CLUSTER * BT}) and {MEGA_MAX_CLUSTER} chunks of {MEGA_MAX_CHUNK} "
            f"positions ({MEGA_MAX_CLUSTER * MEGA_MAX_CHUNK})")
    if (max(f.smem(beams) for f in plan.fields) > MEGA_MAX_SMEM
            or max(plan.attn_smem) > MEGA_MAX_SMEM):
        raise ValueError(f"mega_decode_step_beam: no plan fits shared memory at S={S}")
    return plan


# -- the kernel ----------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


_ENTRIES = {"mega_step": "owk_mega_step", "mega_beam": "owk_mega_beam",
            "mega_batch": "owk_mega_batch"}
_WHAT = {"mega_step": "mega_decode_step", "mega_beam": "mega_decode_step_beam",
         "mega_batch": "mega_decode_step_batch"}
_PTRS, _INTS = ctypes.POINTER(_P), ctypes.POINTER(_I)
_F = ctypes.c_float
# the C entries and their arguments: K2 and K8 take (p, dims, plan, maps,
# x0, head, logits, eps, kq, cross_scale, stream), K7 the origin table after
# head; each library's tensor maps (p, dims, maps out)
_ARGTYPES = {
    "owk_mega_step": [_PTRS, _INTS, _INTS, _P, _P, _P, _P, _F, _F, _F, _P],
    "owk_mega_step_maps": [_PTRS, _INTS, _P],
    "owk_mega_beam": [_PTRS, _INTS, _INTS, _P, _P, _P, _P, _P, _F, _F, _F, _P],
    "owk_mega_beam_maps": [_PTRS, _INTS, _P],
    "owk_mega_batch": [_PTRS, _INTS, _INTS, _P, _P, _P, _P, _F, _F, _F, _P],
    "owk_mega_batch_maps": [_PTRS, _INTS, _P],
}


@functools.cache
def _kernel_lib(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu built and loaded: mega_step (K2), mega_beam (K7) or
    mega_batch (K8)."""
    lib = _build.load(name)
    for entry, argtypes in _ARGTYPES.items():
        if entry.startswith(_ENTRIES[name]):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    ws = getattr(lib, _ENTRIES[name] + "_workspace")
    ws.argtypes = [_INTS]
    ws.restype = ctypes.c_longlong
    return lib


_WORKSPACES: dict = {}


def _workspace(name: str, dims, device) -> torch.Tensor:
    """Scratch for one step (the residual, query, attention and GELU rows),
    kept per kernel, device and shape."""
    key = (name, str(device), tuple(dims))
    ws = _WORKSPACES.get(key)
    if ws is None:
        fn = getattr(_kernel_lib(name), _ENTRIES[name] + "_workspace")
        n = fn((ctypes.c_int * len(dims))(*dims))
        ws = _WORKSPACES[key] = torch.zeros(n, dtype=torch.uint8, device=device)
    return ws


def _check_tensor(what: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{what} must be a contiguous {dtype} "
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


def _step_args(kernel: str, cfg, mp: MegaParams, R: int, kv_k: torch.Tensor,
               kv_v: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor, Tc: int, dev):
    """Check a step's arguments other than x0, kv_head and K7's origin
    table, on the card: self-cache (L, Tc, S) for K2, the row-flat
    (L, Tc * R, S) for K7 and K8; the cross-KV (L, Ta, S), or K8's
    per-stream (L, R, Ta, S). Returns the kernel's pointer list (x0, head
    and the logits as None, the workspace last) and dims (L, S, H, Tc, Ta,
    Vp, the seven kinds, R)."""
    what = _WHAT[kernel]
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    S, H, L, V = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer, cfg.n_vocab
    if S % 128 or S // H != 64 or S > 2048:
        raise ValueError(f"{what}: S={S} with {H} heads; the kernel "
                         "takes S % 128 == 0, 64-wide heads and S <= 2048")
    per_stream = kernel == "mega_batch"
    Ta, Vp = xk.shape[-2], mp.vp
    if Vp % 128 or Vp < V:
        raise ValueError(f"{what}: vocab plane width {Vp}")
    cache_rows = Tc if kernel == "mega_step" else Tc * R
    for name, t in (("kv_k", kv_k), ("kv_v", kv_v)):
        _check_tensor(f"{what}: {name}", t, torch.bfloat16, (L, cache_rows, S), dev)
    for name, t in (("xk", xk), ("xv", xv)):
        _check_tensor(f"{what}: {name}", t, torch.bfloat16,
                      (L, R, Ta, S) if per_stream else (L, Ta, S), dev)
    _check_tensor(f"{what}: lnw", mp.lnw, torch.bfloat16, (3 * L + 1, S), dev)
    _check_tensor(f"{what}: lnb", mp.lnb, torch.bfloat16, (3 * L + 1, S), dev)
    ptrs = [None, None, mp.lnw.data_ptr(), mp.lnb.data_ptr()]
    kn = {"qkv_w": (S, 3 * S), "o_w": (S, S), "cq_w": (S, S), "co_w": (S, S),
          "mlp0_w": (S, 4 * S), "mlp1_w": (4 * S, S), "teT": (S, Vp)}
    for name, bname in zip(WEIGHTS, _BIASES):
        b = getattr(mp, bname)
        _check_tensor(f"{what}: {bname}", b, torch.bfloat16, (L, kn[name][1]), dev)
        ptrs.append(b.data_ptr())
    kinds = []
    for name in WEIGHTS:
        w = getattr(mp, name)
        if _kind(w) == "int4" and S % 256:
            raise ValueError(f"{what}: int4 planes need S % 256 == 0, S={S}")
        ptrs += _field_args(f"{what}: {name}", w, *kn[name],
                            None if name == "teT" else L, dev)
        kinds.append(_KINDS[_kind(w)])
    dims = [L, S, H, Tc, Ta, Vp, *kinds, R]
    ws = _workspace(kernel, dims, dev)
    ptrs += [kv_k.data_ptr(), kv_v.data_ptr(), xk.data_ptr(), xv.data_ptr(), None,
             ws.data_ptr()]
    return ptrs, dims


def _kq(cfg) -> float:
    """bf16(dh^-0.25) as the f32 the kernels multiply Q and K by."""
    dh = cfg.n_text_state // cfg.n_text_head
    return float(torch.tensor(float(dh) ** -0.25, dtype=torch.bfloat16))


def _kv_head(kv_head, dev) -> torch.Tensor:
    """kv_head as an int64 scalar on the card (read there by the kernel)."""
    if (isinstance(kv_head, torch.Tensor) and kv_head.dtype == torch.int64
            and kv_head.device == dev and kv_head.numel() == 1):
        return kv_head
    return torch.as_tensor(kv_head, device=dev).to(torch.int64).reshape(())


# K2, K7 and K8 keep each prepared decoder's 14 tensor maps (two a weight field,
# 128 bytes each), keyed on the planes' addresses, the dims they are read
# with and the device (a map is a function of those alone, whichever library
# encodes it), and each step's checked argument pack, keyed on the kernel,
# the decoder and config (by identity; the fields of a prepared MegaParams
# are not replaced), the row count, the device and the caches' and
# cross-KV's shapes: a call then checks the four step tensors' type and
# layout, writes their addresses into the pack and does work only for x0,
# kv_head and the logits. The lockstep loop lays out new caches every round:
# the same pack serves them all.
_step_maps: dict[tuple, ctypes.Array] = {}
_step_packs: dict[tuple, "_StepPack"] = {}
_STEP_CACHE_MAX = 256   # entries kept before a cache starts over
_STEP_TENSORS = 24      # the pointer list's kv_k, kv_v, xk, xv


@dataclasses.dataclass
class _StepPack:
    mp: "weakref.ref"
    cfg: object
    ptrs: ctypes.Array
    dims: ctypes.Array
    plan: ctypes.Array
    maps: ctypes.Array
    ws: torch.Tensor
    kq: float
    cross_scale: float


def _plan(kernel: str, cfg, mp: MegaParams, R: int, Tc: int, Ta: int):
    kinds = [_kind(getattr(mp, n)) for n in WEIGHTS]
    if kernel == "mega_batch":
        return mega_batch_plan(cfg, kinds, Tc, Ta=Ta, streams=R, Vp=mp.vp)
    if kernel == "mega_beam":
        return mega_beam_plan(cfg, kinds, Tc, Ta=Ta, beams=R, Vp=mp.vp)
    return mega_step_plan(cfg, kinds, Tc, Ta=Ta, rows=R, Vp=mp.vp)


def _step_pack(kernel: str, cfg, mp: MegaParams, R: int, kv_k, kv_v, xk, xv,
               dev) -> _StepPack:
    # a hit is the same kernel, decoder and config (held by identity), row
    # count, device and shapes; the tensors' type and layout are checked at
    # every call, and their addresses written into the pack
    ts = (kv_k, kv_v, xk, xv)
    what = _WHAT[kernel]
    for name, t in zip(("kv_k", "kv_v", "xk", "xv"), ts):
        if (t.dtype != torch.bfloat16 or t.device != dev or not t.is_contiguous()
                or t.data_ptr() % 16):
            _check_tensor(f"{what}: {name}", t, torch.bfloat16, t.shape, dev)
    key = (kernel, id(mp), id(cfg), R, dev.index, *(tuple(t.shape) for t in ts))
    pack = _step_packs.get(key)
    if pack is None or pack.mp() is not mp or pack.cfg is not cfg:
        Tc = kv_k.shape[1] // (1 if kernel == "mega_step" else R)
        ptrs, dims = _step_args(kernel, cfg, mp, R, kv_k, kv_v, xk, xv, Tc, dev)
        plan = _plan(kernel, cfg, mp, R, Tc, xk.shape[-2])
        c_ptrs = (_P * len(ptrs))(*ptrs)
        c_dims = (_I * len(dims))(*dims)
        mkey = (tuple(ptrs[10:24]), tuple(dims[:3]), dims[5], tuple(dims[6:13]), dev)
        maps = _step_maps.get(mkey)
        if maps is None:
            maps = ctypes.create_string_buffer(14 * 128)
            rc = getattr(_kernel_lib(kernel), _ENTRIES[kernel] + "_maps")(
                c_ptrs, c_dims, ctypes.addressof(maps))
            if rc != 0:
                raise RuntimeError(f"{what}: tensor map encoding failed (cudaError {rc})")
            if len(_step_maps) >= _STEP_CACHE_MAX:
                _step_maps.clear()
            _step_maps[mkey] = maps
        if len(_step_packs) >= _STEP_CACHE_MAX:
            _step_packs.clear()
        pack = _step_packs[key] = _StepPack(
            weakref.ref(mp), cfg, c_ptrs, c_dims, (_I * len(plan.ints))(*plan.ints), maps,
            _workspace(kernel, dims, dev), _kq(cfg), _cross_scale(cfg))
    for i, t in enumerate(ts):
        pack.ptrs[_STEP_TENSORS + i] = t.data_ptr()
    return pack


def _launch_step(kernel: str, cfg, mp: MegaParams, x0: torch.Tensor, kv_k: torch.Tensor,
                 kv_v: torch.Tensor, kv_head, xk: torch.Tensor, xv: torch.Tensor,
                 origin: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K2 (csrc/mega_step.cu), K7 (csrc/mega_beam.cu, given its
    (R, Tc) int64 origin table) or K8 (csrc/mega_batch.cu) on the current
    stream from the cached argument pack; returns the (R, V) f32 logits,
    raises if a launch fails."""
    what = _WHAT[kernel]
    dev = x0.device
    R, S = x0.shape
    pack = _step_pack(kernel, cfg, mp, R, kv_k, kv_v, xk, xv, dev)
    if S != cfg.n_text_state:
        raise ValueError(f"{what}: x0 {tuple(x0.shape)}; rows of {cfg.n_text_state}")
    x0b = x0.to(torch.bfloat16).contiguous()
    if x0b.data_ptr() % 16:
        x0b = x0b.clone()
    head = _kv_head(kv_head, dev)
    logits = torch.empty(R, mp.vp, dtype=torch.float32, device=dev)
    lineage = ()
    if kernel == "mega_beam":
        if (origin.dtype != torch.int64 or origin.device != dev
                or tuple(origin.shape) != (R, pack.dims[3]) or not origin.is_contiguous()):
            _check_tensor(f"{what}: origin", origin, torch.int64, (R, pack.dims[3]), dev)
        lineage = (origin.data_ptr(),)
    rc = getattr(_kernel_lib(kernel), _ENTRIES[kernel])(
        pack.ptrs, pack.dims, pack.plan, ctypes.addressof(pack.maps), x0b.data_ptr(),
        head.data_ptr(), *lineage, logits.data_ptr(), float(cfg.eps), pack.kq,
        pack.cross_scale, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError {rc})")
    return logits[:, :cfg.n_vocab]


def mega_decode_step(cfg, mp: MegaParams, x0: torch.Tensor,
                     kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                     xk: torch.Tensor, xv: torch.Tensor):
    """Kernel K2: one decode step for R <= 8 consecutive tokens of one
    stream (R = 1: the greedy step; R > 1: the speculative verify pass).

    x0 (R, S) bf16 token + position rows for positions kv_head ..
    kv_head + R - 1; kv_k/kv_v (L, Tc, S) bf16 self-cache, written in place
    at those rows (a row at or past Tc is not written; the kernel checks
    on the card, where kv_head lives); kv_head a 0-d integer tensor on
    x0's device (the kernel reads it there, so a step never waits on the
    host) or an int; xk/xv (L, Ta, S) bf16 cross-KV, xk pre-scaled by
    dh^-0.25. Row r attends the cache rows up to kv_head + r: the rows
    before it and its own, not those after. Returns (logits (R, V) f32,
    kv_k, kv_v); each row equals a one-row step at its position.

    CPU tensors take `mega_decode_step_plain`; CUDA tensors launch
    csrc/mega_step.cu on the current stream or raise. `launches` counts
    steps run on the card, `launches_by_rows` the same by R."""
    if x0.dim() != 2 or not 1 <= x0.shape[0] <= 8:
        raise ValueError(f"mega_decode_step: x0 {tuple(x0.shape)}; 1 to 8 rows")
    if x0.device.type == "cpu":
        return mega_decode_step_plain(cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv)
    logits = _launch_step("mega_step", cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv)
    R, counts = x0.shape[0], mega_decode_step.launches_by_rows
    mega_decode_step.launches += 1
    counts[R] = counts.get(R, 0) + 1
    return logits, kv_k, kv_v


mega_decode_step.launches = 0
mega_decode_step.launches_by_rows = {}


def mega_decode_step_beam(cfg, mp: MegaParams, x0: torch.Tensor,
                          kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                          xk: torch.Tensor, xv: torch.Tensor,
                          origin: torch.Tensor | None = None):
    """Kernel K7: one beam-search decode step for B <= 8 beams, the beams
    riding one weight stream and sharing the cross-KV.

    x0 (B, S) bf16 per-beam token + position rows for position kv_head;
    kv_k/kv_v (L, Tc * B, S) bf16 row-flat time-major self-cache (row
    t * B + b is slot b at time t), beam b's new K/V row written in place
    at row kv_head * B + b; kv_head a 0-d integer tensor on x0's device or
    an int; xk/xv (L, Ta, S) bf16 shared cross-KV, xk pre-scaled by
    dh^-0.25; origin (B, Tc) int64 lineage table, required for B > 1:
    beam b attends row t * B + origin[b, t] at each time t <= kv_head (the
    JAX package passes it as `beam_attn_bias(origin, kv_head, Tc)`).
    Returns (logits (B, V) f32, kv_k, kv_v). One row delegates to K2
    (`mega_decode_step`), as the JAX package does; origin is then unused.

    CPU tensors take `mega_decode_step_beam_plain`; CUDA tensors launch
    csrc/mega_beam.cu on the current stream (planned by `mega_beam_plan`:
    at most 1024 cache rows a beam and 2048 audio positions, ValueError past
    them) or raise. `launches` counts steps of B > 1 run on the card."""
    B = x0.shape[0]
    if x0.dim() != 2 or not 1 <= B <= 8:
        raise ValueError(f"mega_decode_step_beam: x0 {tuple(x0.shape)}; 1 to 8 rows")
    if B == 1:
        return mega_decode_step(cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv)
    if origin is None:
        raise ValueError("mega_decode_step_beam: beam mode requires the origin table")
    if kv_k.shape[1] % B:
        raise ValueError(f"mega_decode_step_beam: cache rows {kv_k.shape[1]} are not "
                         f"a multiple of {B} beams")
    if x0.device.type == "cpu":
        return mega_decode_step_beam_plain(cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv,
                                           origin)
    logits = _launch_step("mega_beam", cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv, origin)
    mega_decode_step_beam.launches += 1
    return logits, kv_k, kv_v


mega_decode_step_beam.launches = 0


def mega_decode_step_batch(cfg, mp: MegaParams, x0: torch.Tensor,
                           kv_k: torch.Tensor, kv_v: torch.Tensor, kv_head,
                           xk: torch.Tensor, xv: torch.Tensor):
    """Kernel K8: one greedy decode step for B <= 8 independent streams
    (batched serving), the streams riding one weight stream, each with its
    own cross-KV.

    x0 (B, S) bf16 per-stream token + position rows for position kv_head
    (the streams advance in lockstep); kv_k/kv_v (L, Tc * B, S) bf16
    row-flat time-major self-cache (row t * B + b is stream b at time t),
    stream b's new K/V row written in place at row kv_head * B + b;
    kv_head a 0-d integer tensor on x0's device or an int; xk/xv
    (L, B, Ta, S) bf16 per-stream cross-KV, xk pre-scaled by dh^-0.25
    (natural layout, not padded: the TPU kernel's padding to 256-row
    chunks adds exact zeros). Returns (logits (B, V) f32, kv_k, kv_v). One
    stream delegates to K2 (`mega_decode_step`), as the JAX package does.

    CPU tensors take `mega_decode_step_batch_plain`; CUDA tensors launch
    csrc/mega_batch.cu on the current stream (planned by `mega_batch_plan`:
    at most 1024 cache rows a stream and 2048 audio positions, ValueError
    past them) or raise. `launches` counts steps of B > 1 run on the card."""
    B = x0.shape[0]
    if x0.dim() != 2 or not 1 <= B <= 8:
        raise ValueError(f"mega_decode_step_batch: x0 {tuple(x0.shape)}; 1 to 8 rows")
    if xk.dim() != 4 or xk.shape[1] != B:
        raise ValueError(f"mega_decode_step_batch: cross-KV {tuple(xk.shape)} is not "
                         f"(L, {B}, Ta, S)")
    if B == 1:
        return mega_decode_step(cfg, mp, x0, kv_k, kv_v, kv_head, xk[:, 0], xv[:, 0])
    if kv_k.shape[1] % B:
        raise ValueError(f"mega_decode_step_batch: cache rows {kv_k.shape[1]} are not "
                         f"a multiple of {B} streams")
    if x0.device.type == "cpu":
        return mega_decode_step_batch_plain(cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv)
    logits = _launch_step("mega_batch", cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv)
    mega_decode_step_batch.launches += 1
    return logits, kv_k, kv_v


mega_decode_step_batch.launches = 0
