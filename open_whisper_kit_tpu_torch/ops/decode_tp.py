"""Tensor-parallel decode step: K2's weight stream column-sharded over tp.

Port of open_whisper_kit_tpu/ops/decode_tp.py. The decode-step kernel K2
(ops/decode_megakernel.py) streams every weight byte of the decoder once a
token; on a mesh it runs whole on every rank. This step instead shards
every matmul weight by COLUMNS over a tp process group, so each rank
streams 1/tp of the int8 bytes a token, through kernel K3
(quant_matmul.qmm, its rows route on the card, `qmm_plain_fixed` on the
CPU), with the stages' outputs all-gathered (parallel/mesh.all_gather_last).

Column-parallel everywhere (not Megatron's column + row pairs with a sum):
an output element of a column shard is a whole-K dot, the same arithmetic
the one-device step does for that column, so tp ranks give logits and
caches bit-equal to tp = 1. Each shard's K3 launch keeps the splits of K
that `qmm_rows_plan` takes for the WHOLE width (a narrower plane would get
more splits, another f32 sum order), and the attention runs head by head,
each head the same products at every tp.

Sharding map (rank d of tp, Hd = H/tp heads, Sd = S/tp; every shard zero-
padded to a multiple of 128 columns, the planes' tile):
  qkv   (S, 3S) -> columns permuted to [q_d | k_d | v_d] blocks, d-th
  o     (S, S)  -> output columns [d*Sd, (d+1)*Sd)
  cq, co        -> head columns / output columns, as o
  mlp0  (S, 4S) -> hidden columns, 1/tp
  mlp1  (4S, S) -> output columns, 1/tp (K = 4S stays whole)
  teT   (S, Vp) -> vocab columns, 1/tp (Vp padded to a multiple of 128 tp)
  self-KV (L, Tc, S), cross-KV (L, Ta, S), natural layout -> S axis, 1/tp
  (head-contiguous: the natural layout is [h0 dh | h1 dh | ...]).

No user path calls it (none in the JAX package either): it is the step a
multi-card deployment would take when the weight stream bounds a token.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import all_gather_last
from .decode_megakernel import _to_planes
from .quant_matmul import _BN, _padded, qmm, qmm_rows_plan

_FIELDS = ("qkv", "o", "cq", "co", "mlp0", "mlp1")


def _permute_qkv_cols(w: torch.Tensor, S: int, tp: int) -> torch.Tensor:
    """(..., 3S) fused-qkv columns -> per-rank blocks [q_d | k_d | v_d]."""
    Sd = S // tp
    idx = np.concatenate([np.concatenate([np.arange(p * S + d * Sd, p * S + (d + 1) * Sd)
                                          for p in range(3)])
                          for d in range(tp)])
    return w.index_select(-1, torch.as_tensor(idx, device=w.device))


def _pad_shards(w: torch.Tensor, tp: int) -> torch.Tensor:
    """(..., N) -> (..., tp * Np_d): each of the tp column blocks zero-padded
    to Np_d, a multiple of 128."""
    Nd = w.shape[-1] // tp
    pad = _padded(Nd) - Nd
    if pad == 0:
        return w.contiguous()
    return torch.cat([F.pad(b, (0, pad)) for b in w.split(Nd, dim=-1)], dim=-1).contiguous()


def prepare_mega_tp(cfg, dec, tp: int) -> dict:
    """Prepared decoder params (after model.prepare_decoder) -> stacked int8
    planes laid out for `tp`-way column sharding (the whole planes: see
    `shard_mega_tp` for a rank's). K2's quantizer (q8_0-level numerics;
    checkpoint QuantLinear planes pass through losslessly)."""
    b = dec["blocks"]
    if "qkv_w" not in b:
        raise ValueError("run prepare_decoder first (fused qkv required)")
    S = cfg.n_text_state
    if cfg.n_text_head % tp:
        raise ValueError(f"tp={tp} must divide n_text_head={cfg.n_text_head}")
    bf = torch.bfloat16
    out = {"tp": tp}
    for f in _FIELDS:
        p = _to_planes(b[f + "_w"])
        qs, sc = p.qs, p.sc
        bias = b[f + "_b"].to(bf)
        if f == "qkv":
            qs, sc, bias = (_permute_qkv_cols(t, S, tp) for t in (qs, sc, bias))
        out[f + "_qs"], out[f + "_sc"] = _pad_shards(qs, tp), _pad_shards(sc, tp)
        out[f + "_b"] = _pad_shards(bias, tp)

    te = dec["te"]
    V = te.shape[0]
    Vp = -(-V // (_BN * tp)) * (_BN * tp)    # tp-divisible padded vocab
    teT = _to_planes(F.pad(te.t().float(), (0, Vp - V)))
    out.update(n_vocab=V, vp=Vp, teT_qs=teT.qs, teT_sc=teT.sc)
    out["lnw"] = torch.stack([b["attn_ln_w"], b["cross_ln_w"], b["mlp_ln_w"]], dim=1).to(bf)
    out["lnb"] = torch.stack([b["attn_ln_b"], b["cross_ln_b"], b["mlp_ln_b"]], dim=1).to(bf)
    out["ln_w"], out["ln_b"] = dec["ln_w"].to(bf), dec["ln_b"].to(bf)
    return out


def tp_param_specs(mp: dict) -> dict:
    """Spec per entry of a prepare_mega_tp dict (parallel/mesh.py tuples):
    column axes on tp, the biases of column-sharded weights with them."""
    col = (None, None, "tp")       # (L, K, N) planes: shard N
    bias = (None, "tp")            # (L, N)
    specs = {f + s: col for f in _FIELDS for s in ("_qs", "_sc")}
    specs.update({f + "_b": bias for f in _FIELDS})
    specs.update(lnw=(None, None, None), lnb=(None, None, None), ln_w=(None,), ln_b=(None,),
                 teT_qs=(None, "tp"), teT_sc=(None, "tp"))
    return specs


def shard_mega_tp(mp: dict, rank: int) -> dict:
    """Rank `rank`'s shard of a prepare_mega_tp dict (the whole dict is its
    own shard at tp = 1): each entry's tp axis cut in mp["tp"] blocks."""
    tp = int(mp["tp"])
    out = {k: v for k, v in mp.items() if not isinstance(v, torch.Tensor)}
    for name, spec in tp_param_specs(mp).items():
        t = mp[name]
        if "tp" in spec and tp > 1:
            d = spec.index("tp")
            w = t.shape[d] // tp
            t = t.narrow(d, rank * w, w).contiguous()
        out[name] = t
    return out


def _ln(x32: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _attn_local(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, n_head: int,
                scale: float, mask: torch.Tensor | None) -> torch.Tensor:
    """Attention of this rank's heads over its columns of a natural-layout
    cache: q (R, Sd) f32, kc/vc (T, Sd), mask (R, T) additive f32 or None.
    f32 scores, softmax and P.V, head by head: each head's products are the
    same calls at any tp, so a head's output does not depend on how many
    heads share the rank."""
    R, T = q.shape[0], kc.shape[0]
    dh = q.shape[-1] // n_head
    qh = q.float().reshape(R, n_head, dh).transpose(0, 1).contiguous()
    kh = kc.float().reshape(T, n_head, dh).transpose(0, 1).contiguous()
    vh = vc.float().reshape(T, n_head, dh).transpose(0, 1).contiguous()
    out = []
    for h in range(n_head):
        s = (qh[h] @ kh[h].t()) * scale
        if mask is not None:
            s = s + mask
        out.append(torch.softmax(s, dim=-1) @ vh[h])
    return torch.stack(out, dim=1).reshape(R, n_head * dh)


def mega_decode_step_tp(cfg, mp: dict, x0: torch.Tensor, kv_k: torch.Tensor,
                        kv_v: torch.Tensor, kv_head, xk: torch.Tensor, xv: torch.Tensor,
                        group=None):
    """The TP decode step: the function of decode_megakernel.mega_decode_step
    (R consecutive tokens, natural-layout KV, logits at every row) with the
    weight stream column-sharded over the process group `group` (None: one
    rank, tp = 1).

    mp: this rank's shard_mega_tp dict (mp["tp"] the group's size). x0
    (R, S) bf16 embedding rows, the same on every rank; kv_k/kv_v
    (L, Tc, Sd) this rank's columns of the natural self-KV, written in
    place at rows kv_head..kv_head+R-1; xk/xv (L, Ta, Sd) its columns of
    the cross-KV (xk pre-scaled d**-0.25). Returns (logits (R, V) f32, the
    same on every rank, kv_k, kv_v)."""
    tp, V = int(mp["tp"]), int(mp["n_vocab"])
    n_ranks = 1 if group is None else torch.distributed.get_world_size(group)
    if n_ranks != tp:
        raise ValueError(f"planes sharded {tp} ways, the group has {n_ranks} ranks")
    S, H, L = cfg.n_text_state, cfg.n_text_head, cfg.n_text_layer
    dh, Sd, Hd = S // H, S // tp, H // tp
    R, Tc = x0.shape[0], kv_k.shape[1]
    eps = float(cfg.eps)
    kqscale = float(dh) ** -0.25
    head = int(kv_head)
    if head + R > Tc:
        raise ValueError(f"rows {head}..{head + R - 1} past the cache's {Tc}")
    dev = x0.device

    def gather(y):
        return y if group is None else all_gather_last(y, group)

    def mm(h, f, il, n_whole):
        """h (R, K) @ this rank's block of field f -> (R, n_whole / tp) f32,
        the K3 launch at the whole width's splits."""
        qs, sc = mp[f + "_qs"], mp[f + "_sc"]
        if il is not None:
            qs, sc = qs[il], sc[il]
        splits = qmm_rows_plan(R, qs.shape[0], _padded(n_whole)).splits
        return qmm(h.to(torch.bfloat16), qs, sc, splits=splits)[:, :n_whole // tp]

    def bias(f, il, n):
        return mp[f + "_b"][il][:n].float()

    positions = head + torch.arange(R, device=dev)
    mask = torch.where(torch.arange(Tc, device=dev)[None, :] <= positions[:, None],
                       0.0, float("-inf"))
    x = x0.float()
    for il in range(L):
        h = _ln(x, mp["lnw"][il, 0], mp["lnb"][il, 0], eps)
        qkv = mm(h, "qkv", il, 3 * S) + bias("qkv", il, 3 * Sd)
        q = qkv[:, :Sd] * kqscale
        kv_k[il, head:head + R] = (qkv[:, Sd:2 * Sd] * kqscale).to(kv_k.dtype)
        kv_v[il, head:head + R] = qkv[:, 2 * Sd:].to(kv_v.dtype)
        a = _attn_local(q, kv_k[il], kv_v[il], Hd, 1.0, mask)
        o = mm(gather(a.to(torch.bfloat16)), "o", il, S) + bias("o", il, Sd)
        x = x + gather(o)

        h = _ln(x, mp["lnw"][il, 1], mp["lnb"][il, 1], eps)
        cq = mm(h, "cq", il, S) + bias("cq", il, Sd)
        ca = _attn_local(cq, xk[il], xv[il], Hd, kqscale, None)
        co = mm(gather(ca.to(torch.bfloat16)), "co", il, S) + bias("co", il, Sd)
        x = x + gather(co)

        h = _ln(x, mp["lnw"][il, 2], mp["lnb"][il, 2], eps)
        hid = F.gelu(mm(h, "mlp0", il, 4 * S) + bias("mlp0", il, 4 * Sd), approximate="tanh")
        m1 = mm(gather(hid.to(torch.bfloat16)), "mlp1", il, S) + bias("mlp1", il, Sd)
        x = x + gather(m1)

    x = _ln(x, mp["ln_w"], mp["ln_b"], eps)
    # the vocab blocks are whole tiles: the gathered logits are (R, Vp)
    splits = qmm_rows_plan(R, S, _padded(V)).splits
    logits = gather(qmm(x.to(torch.bfloat16), mp["teT_qs"], mp["teT_sc"], splits=splits))
    return logits[:, :V], kv_k, kv_v
