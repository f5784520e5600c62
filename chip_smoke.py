#!/usr/bin/env python3
"""Drive the PyTorch port (open_whisper_kit_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each gated; any failure exits non-zero before the result lines:
  1. torch / CUDA versions and the card's name and power limit;
  2. build kernels K1 (csrc/mha_packed.cu), K2 (mega_step.cu), K3
     (qmm.cu), K4 (qmm4.cu), K5 (ffn_int8.cu) and K7 (mega_beam.cu) with
     nvcc, one process per source, all at once, timed;
  3. K1 against its plain torch version on the card: bf16 at the
     large-v3-turbo encoder shape (B=1, T=1536, S=1280, n_valid=1500,
     gate max|err| <= 1e-2 * max|ref|) and the narrow f32 shape (S=128,
     gate 1e-4); kernel, plain and SDPA times (CUDA events, median of 20);
     K3, K4 and K5 against their plain versions at the shapes large-v3-turbo
     gives them (gate 1e-3 * max|ref|), with kernel, plain and library times
     (torch.matmul on the dequantized bf16 weight), each launch with a cold
     L2 cache, and the bound; K2 (the whole decoder step) at large-v3-turbo
     width (4 layers, 448 cache rows, 1500 audio positions, vocabulary
     51866) in its four modes (dense, int8 logits, int8, int4): 8
     consecutive steps from a cache with 100 rows of history, each from the
     same inputs as its plain version (logits and the new cache rows
     within 2e-2 of max|ref|, K2_TOL), the step
     time against the plain step and the port's decode_impl step on the
     same weights (the yardstick; no single library call computes a step),
     each with a cold L2 cache, and the bound; K7 (the beam step) at the same
     width for B = 5 beams in the same four modes: 8 steps at heads 126-129
     and 254-257 (across the self-attention's 128-row time-block edges)
     with lineage reorders, from a cache whose slot 0 holds 100 prompt rows
     and whose later rows hold random K/V with a random lineage, each from
     the same inputs as its plain version (logits within K2_TOL of
     max|ref|, the same argmax per beam except on rows whose two best plain
     logits lie within 1e-2 of max|ref|, K7_ARGMAX_GAP, the new cache rows
     of layer 0 within one bf16 step), the step time at head 258 against
     the plain step, the decode_impl step over 5 beams and five K2 steps
     on the same weights (the yardsticks), and the bound;
  4. Transcriber(preset="large-v3-turbo", bf16, cuda, seed 0) answers 30 s
     and 65 s of seeded synthetic audio; K1's launch count must be exactly
     32 (encoder layers) per encoder pass;
  5. the narrow f32 config through whisper_full on cuda and on cpu:
     encoder outputs within 1e-4, token ids equal;
  6. a full-width large-v3-turbo q8_0 checkpoint (the port's writer, seed-0
     random tensors) through Transcriber(model_path=...) on cuda: 30 s and
     65 s requests (temperature_inc = 0), which run K2 by themselves (its
     int8 mode) for every token step; K3 must launch exactly 200 per
     encoder pass (32 layers x 6 linears + 4 layers x cross K/V) and 16 per
     decode_impl call (prompt ingest: 4 layers x qkv/o/cq/co), K5 4 per
     decode_impl call, K2 once per token step; then one 30 s request with
     megakernel=False, whose token steps run decode_impl (K3 and K5); then
     the main path of beam search: a 30 s request with beam_size=5, every
     beam token step one K7 launch (auto) and K2 never; then K7's witness
     on the main path: a 65 s beam-5 request with K7 and its plain version
     in lockstep on the same caches in every step (logits within K2_TOL,
     heads past 128), and the same request with the plain version alone,
     the two transcripts compared;
  7. runtime W8 logits (decoder_int8=True; K3 once per decoder call) and W4
     logits (quantize_decoder_int8(logits_bits=4); K4 once per decoder call)
     on the seed-0 turbo preset, one 30 s greedy request each, after the
     same request on the dense logits projection and, on the same weights,
     with megakernel=True (K2 dense) and megakernel="int4" (K2 int4); and
     beam_size=5 on the same weights with megakernel=False (decode_impl over
     5 beams) and megakernel="int4" (K7 int4);
  8. narrow q4_0 and q5_0 checkpoints (S = 128: the decoder MLP runs K5)
     through whisper_full on cuda and on cpu, 35 s over two windows: token
     ids equal, at least 100 of them;
  9. a narrow bf16 q8_0 checkpoint with megakernel="int8" (K2 on the card,
     its plain version on the CPU), 35 s: token ids equal, at least 100;
 10. beam search (beam_size=3, 40 s) on the card against the CPU: the
     narrow f32 config (decode_impl, the device beam loop's sort, dedupe and
     gathers on the card) with token ids equal, at least 100; and the
     narrow bf16 q8_0 checkpoint with megakernel="int8" (K7 on the card, its
     plain version on the CPU) on three 40 s requests, token ids equal.
Every phase prints ms per sampled token beside its RTF. The last three lines are the kernels JSON, the nvidia-smi name/power line
and {"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --profile

also traces one 30 s greedy request on the q8_0 checkpoint, one beam-5
request on it (K7) and one greedy request on the dense preset with
torch.profiler (device busy share, top kernels; tables
in chiprun_out/). It is the source of PERF.md's "Where the time goes".
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TURBO_LAYERS = 32
NARROW = (51864, 1500, 128, 2, 2, 448, 128, 2, 2, 80)
NARROW_Q = (51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80)   # 3 decoder layers
TURBO = (51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128)
KERNELS = ("mha_packed", "mega_step", "qmm", "qmm4", "ffn_int8", "mega_beam")
SRC = "open_whisper_kit_tpu_torch/csrc/"
# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over HBM bandwidth and its FLOPs over bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of fn() in ms over `reps` launches. `flush`, a
    tensor larger than the L2 cache, is overwritten before each timed
    launch (outside the timed span), so fn reads its inputs from HBM as a
    caller streaming many weights does."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def audio(seconds: float, seed: int):
    import numpy as np
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


def greedy_params(FullParams):
    p = FullParams(print_progress=False)
    p.temperature_inc = 0
    return p


def phase_k1(torch, A, dtype, S: int, tol_rel: bool, tol: float, seed: int):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(1, 1536, S, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    n_head, scale, n_valid = S // 64, 0.125, 1500
    ref = A.mha_plain(q, k, v, n_head, scale, n_valid)
    out = A.mha_packed(q, k, v, scale, n_valid)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    limit = tol * ref_max if tol_rel else tol
    print(f"[3] K1 {dtype} (1,1536,{S}) n_valid={n_valid}: max|err| {err:.3e} "
          f"max|ref| {ref_max:.3e} limit {limit:.3e}", flush=True)
    check(bool(torch.isfinite(out).all()) and err <= limit,
          f"K1 {dtype} S={S} disagrees with its plain version")
    kern = cuda_ms(torch, lambda: A.mha_packed(q, k, v, scale, n_valid))
    plain = cuda_ms(torch, lambda: A.mha_plain(q, k, v, n_head, scale, n_valid))
    # the yardstick: SDPA on the head-major layout it takes, same mask
    qh, kh, vh = (t.view(1, 1536, n_head, 64).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    mask = (torch.arange(1536, device="cuda") < n_valid)[None, None, None, :]
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale))
    # QK^T and PV over the live keys; q/k/v read once, out written once
    b_ms, b_by = bound(nbytes(q, k, v, out), 4 * 1536 * n_valid * S)
    print(f"[3]   kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us, SDPA "
          f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}) "
          "(median of 20)", flush=True)
    return {"max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib}


# (kernel, what large-v3-turbo runs it on, M, K, N)
QUANT_SHAPES = [
    ("qmm", "encoder mlp0", 1536, 1280, 5120),
    ("qmm", "encoder q/k/v/o", 1536, 1280, 1280),
    ("qmm", "encoder mlp1", 1536, 5120, 1280),
    ("qmm", "cross-KV k/v", 1500, 1280, 1280),
    ("qmm", "decoder qkv, 1 row", 1, 1280, 3840),
    ("qmm", "decoder qkv, 5 rows", 5, 1280, 3840),
    ("qmm", "decoder o/cq/co, 1 row", 1, 1280, 1280),
    ("qmm", "W8 logits, 1 row", 1, 1280, 51866),
    ("qmm4", "W4 logits, 1 row", 1, 1280, 51866),
    ("ffn_int8", "decoder MLP, 1 row", 1, 1280, 5120),
    ("ffn_int8", "decoder MLP, 5 rows", 5, 1280, 5120),
]


def phase_quant_kernels(torch, Q):
    """Each shape: kernel against plain (gate 1e-3 * max|ref|), times of
    the kernel, the plain version and the library yardstick with the L2
    cache flushed before each launch (on the decode path every weight
    plane arrives cold), and the bound. The bound counts the logical N
    columns only: the planes' padding to a multiple of 128 is zeros that
    the function does not need. Returns {kernel: [per-shape dicts]}."""
    g = torch.Generator(device="cuda").manual_seed(0)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def weight(K, N):
        return torch.randn(K, N, generator=g, device="cuda") * K ** -0.5

    out = {name: [] for name in ("qmm", "qmm4", "ffn_int8")}
    for name, label, M, K, N in QUANT_SHAPES:
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        if name == "ffn_int8":
            w0 = Q.quantize_linear(weight(K, N), pad=False)
            w1 = Q.quantize_linear(weight(N, K))
            b0 = (torch.randn(N, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
            args = (x, w0.qs, w0.scales, b0, w1.qs, w1.scales)
            kern, plain = Q.ffn_int8, Q.ffn_int8_plain
            lib_fn = None   # no single library call computes the fused pair
            flops = 2 * M * K * N + 2 * M * N * K
            moved = (nbytes(x, w0.qs, w0.scales, b0, w1.qs[:, :K], w1.scales[:, :K])
                     + M * K * 4)
        else:
            w = (Q.quantize_linear4 if name == "qmm4" else Q.quantize_linear)(weight(K, N))
            args = (x, w.qs, w.scales)
            kern, plain = (Q.qmm4, Q.qmm4_plain) if name == "qmm4" else (Q.qmm, Q.qmm_plain)
            wd = Q.dequantize_dense(w, torch.bfloat16).contiguous()
            lib_fn = lambda x=x, wd=wd: torch.matmul(x, wd)   # noqa: E731
            flops = 2 * M * K * N
            moved = nbytes(x, w.qs[:, :N], w.scales[:, :N]) + M * N * 4
        ref = plain(*args)
        got = kern(*args)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        check(bool(torch.isfinite(got).all()) and err <= 1e-3 * ref_max,
              f"{name} ({label}) disagrees with its plain version: {err:.3e} "
              f"> 1e-3 * {ref_max:.3e}")
        k_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush)
        p_ms = cuda_ms(torch, lambda: plain(*args), flush=l2_flush)
        l_ms = cuda_ms(torch, lib_fn, flush=l2_flush) if lib_fn is not None else None
        b_ms, b_by = bound(moved, flops)
        out[name].append({"shape": f"{label}: M={M} K={K} N={N}", "max_abs_err": err,
                          "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                          "bound_ms": b_ms, "bound_by": b_by})
        lib_txt = f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none"
        print(f"[3] {name} {label} (M={M}, K={K}, N={N}): max|err| {err:.3e} "
              f"(max|ref| {ref_max:.3e}); kernel {k_ms * 1e3:.1f} us, plain "
              f"{p_ms * 1e3:.1f} us, library {lib_txt}, bound {b_ms * 1e3:.1f} us "
              f"({b_by})", flush=True)
        del args, ref, got
    del l2_flush
    torch.cuda.empty_cache()
    return out


K2_MODES = ("none", "logits", "all", "int4")
K2_HISTORY, K2_STEPS = 100, 8
# K2 against its plain version: the two sum in different f32 orders, so a
# bf16 rounding of the residual stream flips now and then, and each later
# layer carries the flips on. Layer 0's new cache rows agree within one
# bf16 step (<= 1e-3 of their max); layers 1-3 and the logits, at this
# width and depth, within 0.6-1.1 % of max|ref| (H100 80GB HBM3, 700 W).
# Stated tolerance: 2e-2 of max|ref|, the JAX package's own for this
# kernel (tests/test_decode_megakernel.py).
K2_TOL = 2e-2


def turbo_decoder(torch, TM, Q, cfg, mode):
    """Seeded random large-v3-turbo decoder weights on the card, prepared
    (fused qkv), and the decoder decode_impl runs for the same mode: dense;
    W8 logits plane; every matmul int8 (K3/K5); every matmul and the
    logits int4 (K4)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    L, S, V = cfg.n_text_layer, cfg.n_text_state, cfg.n_vocab

    def w(*shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    blocks = {n: w(L, S, scale=0.02) for n in (
        "attn_ln_b", "cross_ln_b", "mlp_ln_b", "q_b", "v_b", "o_b", "cq_b", "co_b", "mlp1_b")}
    blocks.update({n: torch.ones(L, S, dtype=torch.bfloat16, device="cuda")
                   for n in ("attn_ln_w", "cross_ln_w", "mlp_ln_w")})
    blocks.update({n: w(L, S, S) for n in ("q_w", "k_w", "v_w", "o_w", "cq_w", "co_w")})
    blocks.update(mlp0_w=w(L, S, 4 * S), mlp0_b=w(L, 4 * S, scale=0.02),
                  mlp1_w=w(L, 4 * S, S))
    dec = TM.prepare_decoder({
        "te": w(V, S, scale=0.02), "pe": w(cfg.n_text_ctx, S, scale=0.02),
        "blocks": blocks, "ln_w": torch.ones(S, dtype=torch.bfloat16, device="cuda"),
        "ln_b": w(S, scale=0.02)})
    if mode == "logits":
        return dec, TM.quantize_decoder_int8(dec)
    if mode == "all":
        return dec, TM.quantize_decoder_int8(dec, scope="all")
    if mode == "int4":
        b4 = dict(dec["blocks"])
        for n in ("qkv_w", "o_w", "cq_w", "co_w", "mlp0_w", "mlp1_w"):
            b4[n] = Q.stack([Q.quantize_linear4(dec["blocks"][n][il]) for il in range(L)])
        return dec, {**dec, "blocks": b4, "te_logits": Q.quantize_linear4(dec["te"].t())}
    return dec, dec


def k2_bytes_ops(MK, mp, cfg, n_keys: int, Ta: int, rows: int = 1) -> tuple[int, int]:
    """Bytes a step over `rows` rows must move (every plane on its logical
    columns with its scales, biases and layernorm rows, the cross-KV, the
    self-KV rows each row attends, x0 and the logits, each once) and its
    operations (2 per weight per row, and QK^T and P.V over the self and
    cross keys per row)."""
    L, S, V = cfg.n_text_layer, cfg.n_text_state, cfg.n_vocab
    moved, weights = 0, 0
    for name in MK.WEIGHTS:
        w = getattr(mp, name)
        cols = V if name == "teT" else None
        for t in ((w.qs, w.sc) if hasattr(w, "qs") else (w,)):
            t = t[..., :cols] if cols else t
            moved += t.numel() * t.element_size()
        K, N = ({"qkv_w": (S, 3 * S), "mlp0_w": (S, 4 * S), "mlp1_w": (4 * S, S),
                 "teT": (S, V)}.get(name, (S, S)))
        weights += K * N * (1 if name == "teT" else L)
    moved += sum(getattr(mp, n).numel() * 2 for n in (
        "qkv_b", "o_b", "cq_b", "co_b", "mlp0_b", "mlp1_b", "lnw", "lnb"))
    moved += L * 2 * (Ta + rows * n_keys) * S * 2 + rows * (S * 2 + V * 4)
    ops = rows * (2 * weights + L * 4 * (n_keys + Ta) * S)
    return moved, ops


def phase_k2(torch, TM, MK, Q):
    """K2 at large-v3-turbo width in each mode: K2_STEPS consecutive steps
    from a cache holding K2_HISTORY rows, each kernel step against the
    plain step on the same inputs (logits and the new cache rows within
    K2_TOL of max|ref|); times of the kernel step, the plain
    step and the decode_impl step (the yardstick) with a cold L2 cache;
    the bound. Returns {mode: row}."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Tc, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx, cfg.n_audio_ctx
    g = torch.Generator(device="cuda").manual_seed(1)
    xk, xv = ((torch.randn(L, 1, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, 1, Tc, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    hist[:, :, :, K2_HISTORY:] = 0
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        kk, kv, pk, pv = (hist[i % 2].clone() for i in range(4))
        toks = torch.randint(0, cfg.n_vocab, (K2_STEPS,), generator=g, device="cuda")
        err = ref_max = cache_err = 0.0
        layer_err = [0.0] * L
        for i in range(K2_STEPS):
            # the same inputs each step: the kernel's cache is the plain one's
            kk.copy_(pk)
            kv.copy_(pv)
            head = torch.tensor(K2_HISTORY + i, device="cuda")
            x0 = (dec["te"][toks[i]] + dec["pe"][head])[None].to(torch.bfloat16)
            ref, _, _ = MK.mega_decode_step_plain(cfg, mp, x0, pk[:, 0], pv[:, 0], head,
                                                  xk[:, 0], xv[:, 0])
            got, _, _ = MK.mega_decode_step(cfg, mp, x0, kk[:, 0], kv[:, 0], head,
                                            xk[:, 0], xv[:, 0])
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
                  f"K2 {mode}: non-finite or misshapen logits")
            e, m = (got - ref).abs().max().item(), ref.abs().max().item()
            check(e <= K2_TOL * m, f"K2 {mode} step {i}: logits differ from the plain "
                  f"version: {e:.3e} > {K2_TOL} * {m:.3e}")
            err, ref_max = max(err, e), max(ref_max, m)
            row = K2_HISTORY + i
            for a, b in ((kk, pk), (kv, pv)):
                ra, rb = a[:, 0, row].float(), b[:, 0, row].float()
                per_layer = ((ra - rb).abs().amax(dim=1) / rb.abs().max()).tolist()
                layer_err = [max(x, y) for x, y in zip(layer_err, per_layer)]
                cache_err = max(cache_err, max(per_layer))
                check(torch.equal(a[:, :, :row], b[:, :, :row]) and not a[:, :, row + 1:].any(),
                      f"K2 {mode}: cache rows other than the written one changed")
        check(cache_err <= K2_TOL, f"K2 {mode}: new cache rows differ from the plain "
              f"version ({cache_err:.3e} of their max)")
        head = torch.tensor(K2_HISTORY + K2_STEPS, device="cuda")
        x0 = (dec["te"][toks[0]] + dec["pe"][head])[None].to(torch.bfloat16)
        tok = toks[:1, None]
        k_ms = cuda_ms(torch, lambda: MK.mega_decode_step(
            cfg, mp, x0, kk[:, 0], kv[:, 0], head, xk[:, 0], xv[:, 0]), flush=l2_flush)
        p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_plain(
            cfg, mp, x0, pk[:, 0], pv[:, 0], head, xk[:, 0], xv[:, 0]), flush=l2_flush)
        y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, pk, pv, head, xk, xv),
                       flush=l2_flush)
        moved, ops = k2_bytes_ops(MK, mp, cfg, K2_HISTORY + K2_STEPS + 1, Ta)
        b_ms, b_by = bound(moved, ops)
        out[mode] = {"mode": mode, "max_abs_err": err, "max_ref": ref_max,
                     "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err, "ms": k_ms, "plain_ms": p_ms,
                     "decode_impl_ms": y_ms, "library_ms": None, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": moved}
        print(f"[3] K2 {mode}: {K2_STEPS} steps, logits max|err| {err:.3e} (max|ref| "
              f"{ref_max:.3e}), cache rows {cache_err:.3e} of max (by layer "
              f"{', '.join(f'{x:.1e}' for x in layer_err)}); step {k_ms * 1e3:.1f} "
              f"us, plain {p_ms * 1e3:.1f} us, decode_impl step {y_ms * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)", flush=True)
        del dec, ydec, mp, kk, kv, pk, pv
        torch.cuda.empty_cache()
    del l2_flush, hist, xk, xv
    torch.cuda.empty_cache()
    return out


K7_BEAMS = 5
# K7's steps in phase 3: (head, the sources each beam continues or None),
# on both sides of the self-attention's 128-row time-block edges, after a
# prompt of K2_HISTORY rows in slot 0 and random rows with a random lineage
# up to the last head
K7_STEPS = [(126, None), (127, [1, 0, 1, 4, 3]), (128, [2, 2, 0, 1, 4]), (129, None),
            (254, [3, 3, 1, 0, 2]), (255, None), (256, [4, 0, 0, 2, 1]), (257, None)]
# a kernel's pick may differ from the plain version's best only where their
# plain logits lie within this share of max|ref| (a near tie: the two sum
# in other f32 orders); the logits themselves are held to K2_TOL
K7_ARGMAX_GAP = 1e-2
# audio seeds of the narrow q8_0 beam comparison (phase 10): 40 s requests
# whose CPU transcript stays the same when the input is scaled by 1 +- 2^-20,
# 2^-16 or 2^-13. They emit the same 10 tokens: on this random-weight model
# no request that emits 100 or more keeps its beam transcript under
# 1 + 2^-20 (near-tied candidate scores), so the 100-token check of the
# beam loop runs on f32
Q8_BEAM_SEEDS = (3, 4, 7)


def phase_k7(torch, TM, MK, Q):
    """K7 at large-v3-turbo width, B = K7_BEAMS, in each mode: the steps of
    K7_STEPS from a cache whose slot 0 holds K2_HISTORY prompt rows and
    whose later rows hold random K/V with a random lineage, each kernel
    step against the plain step on the same inputs (logits within K2_TOL
    of max|ref|; the same argmax per beam, or a token whose plain logit
    lies within K7_ARGMAX_GAP * max|ref| of the best; the new cache rows of
    layer 0 within one bf16 step, every layer within K2_TOL; every other
    row untouched); times of the kernel step, the plain step, the
    decode_impl step over B beams and B K2 steps (the yardsticks: no single
    library call computes a beam step) with a cold L2 cache, at the head
    after the last step; the bound. Returns {mode: row}."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Tc, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx, cfg.n_audio_ctx
    B, T0 = K7_BEAMS, K2_HISTORY
    T1 = K7_STEPS[-1][0] + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    # the time-major beam cache: a prompt of T0 rows ingested in slot 0, then
    # every slot's rows up to T1
    hist = torch.zeros(2, L, Tc, B, S, dtype=torch.bfloat16, device="cuda")
    hist[:, :, :T0, 0] = (torch.randn(2, L, T0, S, generator=g, device="cuda") * 0.5
                          ).to(torch.bfloat16)
    hist[:, :, T0:T1] = (torch.randn(2, L, T1 - T0, B, S, generator=g, device="cuda") * 0.5
                         ).to(torch.bfloat16)
    hist = hist.reshape(2, L, Tc * B, S)
    origin0 = torch.where(torch.arange(Tc, device="cuda")[None] < T0, 0,
                          torch.arange(B, device="cuda")[:, None])
    origin0[:, T0:T1] = torch.randint(0, B, (B, T1 - T0), generator=g, device="cuda")
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        kk, kv, pk, pv = (hist[i % 2].clone() for i in range(4))
        origin = origin0.clone()
        toks = torch.randint(0, cfg.n_vocab, (len(K7_STEPS), B), generator=g, device="cuda")
        err = ref_max = cache_err = flip_gap = 0.0
        n_flip = 0
        layer_err = [0.0] * L
        for i, (head, src) in enumerate(K7_STEPS):
            if src is not None:
                origin = origin[torch.tensor(src, device="cuda")]
            origin[:, head] = torch.arange(B, device="cuda")
            kk.copy_(pk)
            kv.copy_(pv)
            x0 = (dec["te"][toks[i]] + dec["pe"][head]).to(torch.bfloat16)
            ht = torch.tensor(head, device="cuda")
            ref, _, _ = MK.mega_decode_step_beam_plain(cfg, mp, x0, pk, pv, ht, xk, xv, origin)
            got, _, _ = MK.mega_decode_step_beam(cfg, mp, x0, kk, kv, ht, xk, xv,
                                                 origin=origin)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and got.shape == ref.shape == (B, cfg.n_vocab),
                  f"K7 {mode}: non-finite or misshapen logits")
            e, m = (got - ref).abs().max().item(), ref.abs().max().item()
            check(e <= K2_TOL * m, f"K7 {mode} step {i} (head {head}): logits differ from "
                  f"the plain version: {e:.3e} > {K2_TOL} * {m:.3e}")
            # the two sum in other f32 orders, so a random-weight row whose two
            # best logits are nearly tied may pick the other of them
            pick, best = got.argmax(1), ref.argmax(1)
            gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
            check(bool((gap <= K7_ARGMAX_GAP * m).all()),
                  f"K7 {mode} step {i} (head {head}): argmax {pick.tolist()} against "
                  f"{best.tolist()}, plain-logit gaps {gap.tolist()} > {K7_ARGMAX_GAP} * {m:.3e}")
            n_flip += int((pick != best).sum())
            flip_gap = max(flip_gap, gap.max().item() / m)
            err, ref_max = max(err, e), max(ref_max, m)
            rows = slice(head * B, (head + 1) * B)
            for a, b in ((kk, pk), (kv, pv)):
                ra, rb = a[:, rows].float(), b[:, rows].float()
                per_layer = ((ra - rb).abs().amax(dim=(1, 2)) / rb.abs().max()).tolist()
                layer_err = [max(x, y) for x, y in zip(layer_err, per_layer)]
                cache_err = max(cache_err, max(per_layer))
                check(torch.equal(a[:, :head * B], b[:, :head * B])
                      and torch.equal(a[:, (head + 1) * B:], b[:, (head + 1) * B:]),
                      f"K7 {mode}: cache rows other than the written ones changed")
        # one bf16 step of the largest value: 2^-7 of it
        check(layer_err[0] <= 2 ** -7 and cache_err <= K2_TOL,
              f"K7 {mode}: new cache rows differ from the plain version (by layer "
              f"{layer_err} of their max)")
        head = T1
        ht = torch.tensor(head, device="cuda")
        origin[:, head] = torch.arange(B, device="cuda")
        x0 = (dec["te"][toks[0]] + dec["pe"][head]).to(torch.bfloat16)
        k_ms = cuda_ms(torch, lambda: MK.mega_decode_step_beam(
            cfg, mp, x0, kk, kv, ht, xk, xv, origin=origin), flush=l2_flush)
        p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_beam_plain(
            cfg, mp, x0, pk, pv, ht, xk, xv, origin), flush=l2_flush)
        # decode_impl over B beams on natural (L, B, Tc, S) caches, the batch-1
        # cross-KV serving every beam, and B single-row K2 steps
        nk, nv = (t.reshape(L, Tc, B, S).transpose(1, 2).contiguous() for t in (pk, pv))
        tok = toks[0][:, None]
        y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, nk, nv, ht, xk[:, None],
                                                     xv[:, None]), flush=l2_flush)
        k2c = [(nk[:, b].contiguous(), nv[:, b].contiguous()) for b in range(B)]

        def k2_steps():
            for b in range(B):
                MK.mega_decode_step(cfg, mp, x0[b:b + 1], k2c[b][0], k2c[b][1], ht, xk, xv)
        k2_ms = cuda_ms(torch, k2_steps, flush=l2_flush)
        # each beam reads one row per time step: its lineage's slot
        moved, ops = k2_bytes_ops(MK, mp, cfg, head + 1, Ta, rows=B)
        moved += B * (head + 1) * 8
        b_ms, b_by = bound(moved, ops)
        out[mode] = {"mode": mode, "beams": B, "heads": [h for h, _ in K7_STEPS],
                     "timed_head": head, "max_abs_err": err, "max_ref": ref_max,
                     "argmax_near_tie_flips": n_flip, "argmax_flip_gap_rel": flip_gap,
                     "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err,
                     "ms": k_ms, "plain_ms": p_ms, "decode_impl_ms": y_ms,
                     "k2_x5_ms": k2_ms, "library_ms": None, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": moved}
        print(f"[3] K7 {mode}, B={B}: {len(K7_STEPS)} steps at heads "
              f"{', '.join(str(h) for h, _ in K7_STEPS)}, logits max|err| {err:.3e} (max|ref| "
              f"{ref_max:.3e}), argmax differs on {n_flip} of {len(K7_STEPS) * B} rows "
              f"(near-ties, plain gaps up to {flip_gap:.2e} of max|ref|), "
              f"cache rows {cache_err:.3e} of max (by layer "
              f"{', '.join(f'{x:.1e}' for x in layer_err)}); at head {head}: step "
              f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, decode_impl B={B} step "
              f"{y_ms * 1e3:.1f} us, {B} K2 steps {k2_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)", flush=True)
        del dec, ydec, mp, kk, kv, pk, pv, nk, nv, k2c
        torch.cuda.empty_cache()
    del l2_flush, hist, xk, xv
    torch.cuda.empty_cache()
    return out


class BeamWitness:
    """Swaps the beam loop's view of K7 while installed. "lockstep": every
    step runs K7 and, on copies of the same caches, its plain version; the
    loop goes on with K7's result, and each step's logits error, argmax
    flips and the plain logits' closest gap among each beam's B + 1 best
    are kept. "plain": every step runs the plain version on the card.
    Both keep each step's head, input rows and lineage, so two runs show
    the first step whose inputs differ."""

    def __init__(self, torch, DB, mode):
        self.torch, self.DB, self.mode, self.mk = torch, DB, mode, DB.MK
        self.steps = []      # (head, x0, origin) on the host
        self.stats = []      # lockstep: (head, err, max|ref|, flips, flip gap, top gap)

    def __enter__(self):
        mk, w = self.mk, self

        def step(cfg, mp, x0, kv_k, kv_v, kv_head, xk, xv, origin=None):
            w.steps.append((int(kv_head), x0.cpu(), origin.cpu()))
            if w.mode == "plain":
                return mk.mega_decode_step_beam_plain(cfg, mp, x0, kv_k, kv_v, kv_head,
                                                      xk, xv, origin)
            ref, _, _ = mk.mega_decode_step_beam_plain(cfg, mp, x0, kv_k.clone(),
                                                       kv_v.clone(), kv_head, xk, xv, origin)
            got, kv_k, kv_v = mk.mega_decode_step_beam(cfg, mp, x0, kv_k, kv_v, kv_head,
                                                       xk, xv, origin=origin)
            pick = got.argmax(1)
            gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
            top = ref.topk(x0.shape[0] + 1, dim=1).values
            v = w.torch.stack([(got - ref).abs().max(), ref.abs().max(),
                             (pick != ref.argmax(1)).sum().float(), gap.max(),
                             (top[:, :-1] - top[:, 1:]).min()]).tolist()
            w.stats.append((int(kv_head), *v))
            return got, kv_k, kv_v

        class View:
            def __getattr__(self, name):
                return getattr(mk, name)
            mega_decode_step_beam = staticmethod(step)
        self.DB.MK = View()
        return self

    def __exit__(self, *exc):
        self.DB.MK = self.mk


class CallCounter:
    """Counts calls of the model's encoder pass and decoder forward, and the
    token loops' calls of the K2 and K7 steps, while it is installed (each
    is looked up on its module at call time; the loops' views of the kernel
    module are swapped for one that counts, so the wrappers' own counters
    are untouched)."""

    def __init__(self, TM, DL, DB):
        self.TM, self.DL, self.DB = TM, DL, DB
        self.enc = self.dec = self.mega = self.beam = 0
        self._orig = (TM.encode_with_cross_kv, TM.decode_impl, DL.MK)

    def __enter__(self):
        enc, dec, mk = self._orig
        counter = self

        def encode(*a, **k):
            self.enc += 1
            return enc(*a, **k)

        def decode(*a, **k):
            self.dec += 1
            return dec(*a, **k)

        class CountingMK:
            def __getattr__(self, name):
                return getattr(mk, name)

            @staticmethod
            def mega_decode_step(*a, **k):
                counter.mega += 1
                return mk.mega_decode_step(*a, **k)

            @staticmethod
            def mega_decode_step_beam(*a, **k):
                counter.beam += 1
                return mk.mega_decode_step_beam(*a, **k)
        self.TM.encode_with_cross_kv, self.TM.decode_impl = encode, decode
        self.DL.MK = self.DB.MK = CountingMK()
        return self

    def __exit__(self, *exc):
        self.TM.encode_with_cross_kv, self.TM.decode_impl, self.DL.MK = self._orig
        self.DB.MK = self._orig[2]


def witness_k7(torch, tr, FullParams, DB) -> None:
    """K7 against its plain version along the main path, on the card: one
    65 s beam request in lockstep (BeamWitness), every step within K2_TOL
    of max|ref| with argmax flips only within K7_ARGMAX_GAP, its heads
    past a 128-row time-block edge; then the same request with the plain
    version in every step, the same encoder and cross-KV. Prints whether
    the two transcripts agree and, where they part, the first step whose
    inputs differ and the lockstep numbers of the step before it."""
    secs, seed = 65.0, 65
    runs = {}
    for mode in ("lockstep", "plain"):
        with BeamWitness(torch, DB, mode) as w:
            res = tr.transcribe(audio(secs, seed),
                                request_params(FullParams, beam_size=K7_BEAMS))
        torch.cuda.synchronize()
        runs[mode] = (w, [t.id for s in res.segments for t in s.tokens])
    wk, ids_k = runs["lockstep"]
    wp, ids_p = runs["plain"]
    worst = max(wk.stats, key=lambda r: r[1] / r[2])
    past = [r for r in wk.stats if r[0] >= 128]
    flips = [r for r in wk.stats if r[3] > 0]
    print(f"[6] K7 witness, {secs:.0f} s beam {K7_BEAMS}: {len(wk.stats)} lockstep steps, heads "
          f"up to {max(r[0] for r in wk.stats)} ({len(past)} steps at 128 or more); logits "
          f"max|err| up to {worst[1] / worst[2]:.2e} of max|ref| (head {worst[0]}), past 128 "
          f"up to {max((r[1] / r[2] for r in past), default=0.0):.2e}; argmax flips on "
          f"{int(sum(r[3] for r in flips))} rows, plain gaps up to "
          f"{max((r[4] / r[2] for r in flips), default=0.0):.2e} of max|ref|", flush=True)
    for head, e, m, n_flip, gap, _ in wk.stats:
        check(e <= K2_TOL * m, f"K7 witness, head {head}: logits differ from the plain "
              f"version: {e:.3e} > {K2_TOL} * {m:.3e}")
        check(n_flip == 0 or gap <= K7_ARGMAX_GAP * m,
              f"K7 witness, head {head}: argmax off the plain best by {gap:.3e}")
    check(past, "K7 witness: the request never attended past 128 rows")
    same = next((i for i, (a, b) in enumerate(zip(ids_k, ids_p)) if a != b),
                min(len(ids_k), len(ids_p)))
    line = (f"[6] K7 witness: tokens with K7 {len(ids_k)}, with the plain step {len(ids_p)}, "
            f"equal {ids_k == ids_p}, equal prefix {same}")
    if ids_k != ids_p:
        d = next((i for i, (a, b) in enumerate(zip(wk.steps, wp.steps))
                  if a[0] != b[0] or not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))),
                 min(len(wk.steps), len(wp.steps)))
        head, e, m, _, _, top_gap = wk.stats[max(d - 1, 0)]
        line += (f"; the steps' inputs first differ at step {d} of {len(wk.steps)}; "
                 f"at the step before it (head {head}) the plain logits' closest pair among "
                 f"a beam's {K7_BEAMS + 1} best lies {top_gap:.3e} apart, the kernel's "
                 f"largest error {e:.3e} (max|ref| {m:.3e})")
    print(line, flush=True)


def profile_request(torch, tr, FullParams, secs, seed, tag, beam_size=0) -> None:
    """One request (greedy, or beam search with `beam_size`) under
    torch.profiler: device busy share (the sum of kernel self times over the
    wall time) and the kernels that take it; the full table goes to
    chiprun_out/profile-<tag>.txt."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = tr.transcribe(audio(secs, seed), request_params(FullParams, beam_size=beam_size))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
    # device rows (kernels, copies) have no host time of their own; an aten
    # op's row repeats the time of the kernels it launched
    kern = sorted((e for e in rows if e.self_cpu_time_total == 0 and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kern) / 1e3
    n_tok = res.timings.n_sample
    print(f"[profile {tag}] {secs:.0f} s {f'beam {beam_size}' if beam_size else 'greedy'}, traced: wall {wall * 1e3:.0f} ms, "
          f"device busy {busy:.0f} ms ({100 * busy / (wall * 1e3):.1f} %), sampled "
          f"tokens {n_tok}, device launches {sum(e.count for e in kern)}; top: "
          + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms x{e.count}"
                      for e in kern[:6]), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    sort = "self_device_time_total" if hasattr(kern[0], "self_device_time_total") \
        else "self_cuda_time_total"
    (out / f"profile-{tag}.txt").write_text(rows.table(sort_by=sort, row_limit=40))


def reset_counts(A, Q, MK) -> None:
    A.mha_packed.launches = MK.mega_decode_step.launches = 0
    MK.mega_decode_step_beam.launches = 0
    Q.qmm.launches = Q.qmm4.launches = Q.ffn_int8.launches = 0


def request_params(FullParams, greedy=True, megakernel=None, beam_size=0):
    """FullParams of a request: temperature_inc = 0 when `greedy` (the
    device loops alone), beam search when `beam_size`."""
    p = greedy_params(FullParams) if greedy else FullParams(print_progress=False)
    p.megakernel = megakernel
    if beam_size:
        from open_whisper_kit_tpu_torch.decode.params import BeamSearchParams, SamplingStrategy
        p = dataclasses.replace(p, strategy=SamplingStrategy.BEAM_SEARCH,
                                beam_search=BeamSearchParams(beam_size=beam_size))
    return p


def serve(torch, tr, FullParams, secs, seed, tag, greedy=True, megakernel=None,
          beam_size=0):
    p = request_params(FullParams, greedy, megakernel, beam_size)
    t0 = time.perf_counter()
    res = tr.transcribe(audio(secs, seed), p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tm = res.timings
    n_tok = sum(len(s.tokens) for s in res.segments)
    print(f"[{tag}] {secs:.0f} s audio, {f'beam {beam_size}' if beam_size else 'greedy'}, "
          f"megakernel={megakernel!r} (mode "
          f"{tr.ctx.mega_mode(p)}): encoder passes {tm.n_encode}, sampled tokens "
          f"{tm.n_sample}, emitted tokens {n_tok}, segments {len(res.segments)}, wall "
          f"{wall:.3f} s, RTF {wall / secs:.4f}, {wall * 1e3 / max(tm.n_sample, 1):.2f} ms "
          "per sampled token", flush=True)
    # random weights may close a window's last segment at seek + seek_delta
    # before its opening timestamp (whisper.cpp's rule), so t0 <= t1 is not
    # asked; ids, probabilities, text and non-negative times are
    n_vocab = tr.ctx.cfg.n_vocab
    bad = [(s.t0, s.t1, s.text, [(t.id, t.p) for t in s.tokens][:4])
           for s in res.segments
           if not (s.t0 >= 0 and s.t1 >= 0 and s.text and s.tokens and all(
               0 <= t.id < n_vocab and 0.0 <= t.p <= 1.0 for t in s.tokens))]
    check(n_tok > 0 and not bad, f"malformed segment: {bad[:2]}")
    return res


def main(profiling: bool = False) -> int:
    if not (REPO / "open_whisper_kit_tpu_torch").is_dir():
        print("chip_smoke: the open_whisper_kit_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from open_whisper_kit_tpu_torch import Transcriber
    from open_whisper_kit_tpu_torch.audio import mel as mel_mod
    from open_whisper_kit_tpu_torch.decode import device_beam as DB
    from open_whisper_kit_tpu_torch.decode import device_loop as DL
    from open_whisper_kit_tpu_torch.decode import full as TF
    from open_whisper_kit_tpu_torch.decode import tokenizer as tok_mod
    from open_whisper_kit_tpu_torch.decode.params import FullParams
    from open_whisper_kit_tpu_torch.io import ggml_writer as W
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import _build
    from open_whisper_kit_tpu_torch.ops import attention as A
    from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q

    phase_t = {}
    t_start = time.perf_counter()

    def done(tag):
        phase_t[tag] = time.perf_counter() - t_start - sum(phase_t.values())
        print(f"[{tag}] phase took {phase_t[tag]:.1f} s", flush=True)

    # ---- 1. versions and card ----
    smi = nvidia_smi_line()
    print(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} | {smi}", flush=True)
    done("1")

    # ---- 2. build the kernels, one nvcc per source, all at once ----
    t0 = time.perf_counter()
    _build.build_all(list(KERNELS))
    A._kernel_lib()
    MK._kernel_lib("mega_step")
    MK._kernel_lib("mega_beam")
    for name in ("qmm", "qmm4", "ffn_int8"):
        Q._kernel_lib(name)
    print(f"[2] {', '.join(KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    done("2")

    # ---- 3. every kernel against its plain version ----
    k1 = phase_k1(torch, A, torch.bfloat16, 1280, True, 1e-2, 0)
    phase_k1(torch, A, torch.float32, 128, False, 1e-4, 1)
    quant = phase_quant_kernels(torch, Q)
    k2 = phase_k2(torch, TM, MK, Q)
    k7 = phase_k7(torch, TM, MK, Q)
    done("3")

    # ---- 4. turbo bf16 requests through the public entry point ----
    t0 = time.perf_counter()
    tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    print(f"[4] large-v3-turbo weights (seed 0) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reset_counts(A, Q, MK)
    n_enc = 0
    for secs, seed in ((30.0, 30), (65.0, 65)):
        res = serve(torch, tr, FullParams, secs, seed, "4", greedy=False)
        n_enc += res.timings.n_encode
    launches = {"mha_packed": A.mha_packed.launches}
    print(f"[4] K1 launches {launches['mha_packed']} for {n_enc} encoder passes",
          flush=True)
    check(n_enc > 0 and launches["mha_packed"] == TURBO_LAYERS * n_enc,
          f"K1 launches {launches['mha_packed']} != {TURBO_LAYERS} x {n_enc}")
    ctx = tr.ctx
    mel = mel_mod.log_mel_spectrogram(audio(30.0, 30), ctx.filters, "cuda")
    enc_out, xk, xv = ctx.encode_window(mel.data, 0, 0)
    check(tuple(enc_out.shape) == (1, 1500, 1280) and bool(torch.isfinite(enc_out).all())
          and tuple(xk.shape) == (4, 1, 1500, 1280), "turbo encoder output malformed")
    enc_ms = cuda_ms(torch, lambda: ctx.encode_window(mel.data, 0, 0), reps=5, warmup=1)
    print(f"[4] turbo encoder + cross-KV per window: {enc_ms:.2f} ms (median of 5)",
          flush=True)
    del tr, ctx, enc_out, xk, xv
    torch.cuda.empty_cache()
    done("4")

    # ---- 5. narrow f32 config: cuda against cpu ----
    cfg = TM.WhisperConfig(*NARROW)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = [b"<%d>" % i for i in range(min(cfg.n_vocab, 50257))]
    results = {}
    for dev in ("cuda", "cpu"):
        vocab = tok_mod.build_vocab(tokens, cfg.n_vocab)
        c = TF.WhisperContext(cfg, params, vocab, TF._synthetic_mel_filters(80),
                              n_loaded=1, dtype=torch.float32, device=dev)
        samples = audio(65.0, 5)
        m = mel_mod.log_mel_spectrogram(samples, c.filters, dev)
        eo = c.encode_window(m.data, 0, 0)[0].cpu()
        r = TF.whisper_full(c, greedy_params(FullParams), samples)
        results[dev] = (eo, [[t.id for t in s.tokens] for s in r.segments])
    enc_err = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    same = results["cuda"][1] == results["cpu"][1]
    print(f"[5] narrow f32: encoder max|cuda-cpu| {enc_err:.3e}, segments "
          f"{len(results['cuda'][1])}, token ids equal {same}", flush=True)
    check(enc_err <= 1e-4, "narrow f32 encoder: cuda and cpu differ")
    check(same and len(results["cuda"][1]) > 0, "narrow f32 tokens: cuda and cpu differ")
    done("5")

    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke-ckpt-", dir=build_dir))
    try:
        # ---- 6. full-width q8_0 checkpoint through Transcriber(model_path) ----
        t0 = time.perf_counter()
        hp = W.WhisperHParams(*TURBO, ftype=1, qntvr=0)
        path = tmp / "ggml-large-v3-turbo-q8_0.bin"
        tensors = W.random_reference_tensors(hp, seed=0)
        W.write_checkpoint(path, hp, TF._synthetic_mel_filters(128), tokens, tensors,
                           wtype=W.TYPE_FOR_NAME["q8_0"])
        del tensors
        print(f"[6] q8_0 large-v3-turbo checkpoint written in "
              f"{time.perf_counter() - t0:.1f} s ({path.stat().st_size / 1e6:.0f} MB)",
              flush=True)
        t0 = time.perf_counter()
        tr = Transcriber(model_path=path, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        blocks = tr.ctx.params["decoder"]["blocks"]
        check(tr.model_type == "large-v3-turbo"
              and isinstance(tr.ctx.params["encoder"]["blocks"]["mlp0_w"], Q.QuantLinear)
              and isinstance(blocks["qkv_w"], Q.QuantLinear)
              and blocks["mlp0_w"].qs.shape[-1] == blocks["mlp0_w"].n_out,
              "q8_0 checkpoint did not load as unpadded int8 planes")
        print(f"[6] loaded on cuda in {time.perf_counter() - t0:.1f} s", flush=True)
        check(tr.ctx.mega_mode(greedy_params(FullParams)) == "all",
              "q8_0 checkpoint: K2 is not switched on by itself")
        launches["qmm"] = launches["ffn_int8"] = 0
        # auto (K2 int8 for every token step), then megakernel=False, whose
        # token steps run decode_impl (K3 and K5 on the decoder path)
        for megakernel, runs in ((None, ((30.0, 30), (65.0, 65))), (False, ((30.0, 30),))):
            reset_counts(A, Q, MK)
            with CallCounter(TM, DL, DB) as calls:
                n_sample = sum(serve(torch, tr, FullParams, secs, seed, "6",
                                     megakernel=megakernel).timings.n_sample
                               for secs, seed in runs)
            torch.cuda.synchronize()
            want_k3 = calls.enc * (TURBO_LAYERS * 6 + 4 * 2) + calls.dec * 4 * 4
            want_k5 = calls.dec * 4
            n_k2 = MK.mega_decode_step.launches
            print(f"[6] megakernel={megakernel!r}: encoder passes {calls.enc}, decode_impl "
                  f"calls {calls.dec}, K2 steps {calls.mega}, sampled tokens {n_sample}: "
                  f"K2 launches {n_k2}, K3 launches {Q.qmm.launches} (predicted {want_k3}), "
                  f"K5 launches {Q.ffn_int8.launches} (predicted {want_k5}), K1 launches "
                  f"{A.mha_packed.launches} (predicted {TURBO_LAYERS * calls.enc})",
                  flush=True)
            check(calls.enc > 0 and Q.qmm.launches == want_k3
                  and Q.ffn_int8.launches == want_k5
                  and A.mha_packed.launches == TURBO_LAYERS * calls.enc
                  and Q.qmm4.launches == 0, "q8_0 request: launch counts off prediction")
            if megakernel is None:
                # every token step is one K2 launch; a window's loop steps once
                # per sampled token but its last, and at most POLL - 1 masked
                # steps past its end
                check(n_k2 == calls.mega and n_sample - calls.dec <= n_k2
                      <= n_sample + 16 * calls.dec,
                      f"q8_0 auto: K2 launches {n_k2} do not match the token steps")
                launches["mega_decode_step"] = n_k2
            else:
                check(n_k2 == 0 and calls.mega == 0, "megakernel=False still ran K2")
            launches["qmm"] += Q.qmm.launches
            launches["ffn_int8"] += Q.ffn_int8.launches
        # the main path of beam search: every beam token step is one K7
        # launch (int8, by itself), K2 never; the host reads the loop's done
        # flag every POLL steps and one control pair per window, no token
        reset_counts(A, Q, MK)
        reads0 = tr.ctx.reads.n
        with CallCounter(TM, DL, DB) as calls:
            n_sample = serve(torch, tr, FullParams, 30.0, 30, "6",
                             beam_size=K7_BEAMS).timings.n_sample
        torch.cuda.synchronize()
        reads = tr.ctx.reads.n - reads0
        want_k3 = calls.enc * (TURBO_LAYERS * 6 + 4 * 2) + calls.dec * 4 * 4
        n_k7 = MK.mega_decode_step_beam.launches
        print(f"[6] beam {K7_BEAMS}: encoder passes {calls.enc}, decode_impl calls "
              f"{calls.dec}, K7 steps {calls.beam}, sampled tokens {n_sample}: K7 launches "
              f"{n_k7}, K2 launches {MK.mega_decode_step.launches}, K3 launches "
              f"{Q.qmm.launches} (predicted {want_k3}), K5 launches {Q.ffn_int8.launches} "
              f"(predicted {calls.dec * 4}), K1 launches {A.mha_packed.launches}, host "
              f"reads {reads}", flush=True)
        check(calls.enc > 0 and Q.qmm.launches == want_k3
              and Q.ffn_int8.launches == calls.dec * 4 and Q.qmm4.launches == 0
              and A.mha_packed.launches == TURBO_LAYERS * calls.enc
              and MK.mega_decode_step.launches == 0 and calls.mega == 0,
              "q8_0 beam request: launch counts off prediction")
        check(n_k7 == calls.beam and n_sample - calls.dec <= n_k7 <= n_sample + 16 * calls.dec,
              f"q8_0 beam: K7 launches {n_k7} do not match the beam token steps")
        check(reads <= n_sample / 16 + 2 * calls.dec + 1,
              f"q8_0 beam: {reads} host reads for {n_sample} token steps")
        launches["mega_decode_step_beam"] = n_k7
        witness_k7(torch, tr, FullParams, DB)
        mel = mel_mod.log_mel_spectrogram(audio(30.0, 30), tr.ctx.filters, "cuda")
        q_ms = cuda_ms(torch, lambda: tr.ctx.encode_window(mel.data, 0, 0), reps=5,
                       warmup=1)
        print(f"[6] q8_0 encoder + cross-KV per window: {q_ms:.2f} ms (median of 5)",
              flush=True)
        if profiling:
            profile_request(torch, tr, FullParams, 30.0, 30, "q8_0")
            profile_request(torch, tr, FullParams, 30.0, 30, "q8_0-beam5", beam_size=K7_BEAMS)
        del tr, blocks
        torch.cuda.empty_cache()
        done("6")

        # ---- 7. runtime W8 and W4 logits on the turbo preset ----
        tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16,
                         decoder_int8=True, seed=0)
        dec = tr.ctx.params["decoder"]
        check(isinstance(dec["te_logits"], Q.QuantLinear), "decoder_int8 made no W8 plane")
        x_ln = torch.randn(1, 1, 1280, generator=torch.Generator(device="cuda").manual_seed(3),
                           device="cuda").to(torch.bfloat16)
        dense = TM._dot_f32(x_ln, dec["te"].t())
        # the same request on the dense logits projection first: the yardstick
        # for the W8/W4 requests' RTF, in the same call on the same card
        tr.ctx.params["decoder"] = {k: v for k, v in dec.items() if k != "te_logits"}
        serve(torch, tr, FullParams, 30.0, 30, "7 dense logits")
        if profiling:
            profile_request(torch, tr, FullParams, 30.0, 30, "dense")
        # the same weights through K2: dense planes, then runtime int4 planes
        for megakernel in (True, "int4"):
            reset_counts(A, Q, MK)
            serve(torch, tr, FullParams, 30.0, 30, "7 K2", megakernel=megakernel)
            check(MK.mega_decode_step.launches > 0 and Q.qmm.launches == 0
                  and Q.qmm4.launches == 0, f"megakernel={megakernel!r} did not run K2 alone")
        # beam search on the same weights: decode_impl over the beams, then K7 int4
        for megakernel in (False, "int4"):
            reset_counts(A, Q, MK)
            serve(torch, tr, FullParams, 30.0, 30, "7", megakernel=megakernel,
                  beam_size=K7_BEAMS)
            n_k7 = MK.mega_decode_step_beam.launches
            check((n_k7 > 0) == (megakernel == "int4") and MK.mega_decode_step.launches == 0
                  and Q.qmm.launches == 0 and Q.qmm4.launches == 0,
                  f"beam, megakernel={megakernel!r}: K7 launches {n_k7}, K2 "
                  f"{MK.mega_decode_step.launches}")
        tr.ctx.params["decoder"] = dec
        for bits in (8, 4):
            if bits == 4:
                dec = dict(dec)
                dec.pop("te_logits")
                dec = TM.quantize_decoder_int8(dec, logits_bits=4)
                tr.ctx.params["decoder"] = dec
                check(isinstance(dec["te_logits"], Q.QuantLinear4), "no W4 plane")
            lg = Q.qmatmul(x_ln, dec["te_logits"])
            rel = ((lg - dense).abs().max() / dense.abs().max()).item()
            print(f"[7] W{bits} logits plane against the dense bf16 projection: "
                  f"max|diff| / max|dense| {rel:.4f}", flush=True)
            check(tuple(lg.shape) == (1, 1, 51866) and rel <= (0.05 if bits == 8 else 0.25),
                  f"W{bits} logits far from the dense projection")
            reset_counts(A, Q, MK)
            with CallCounter(TM, DL, DB) as calls:
                serve(torch, tr, FullParams, 30.0, 30, "7")
            torch.cuda.synchronize()
            kern = Q.qmm if bits == 8 else Q.qmm4
            other = Q.qmm4 if bits == 8 else Q.qmm
            print(f"[7] W{bits}: decoder calls {calls.dec}, {kern.__name__} launches "
                  f"{kern.launches}", flush=True)
            check(calls.dec > 0 and kern.launches == calls.dec and other.launches == 0
                  and Q.ffn_int8.launches == 0, f"W{bits} logits: launch counts off")
            if bits == 4:
                launches["qmm4"] = kern.launches
        del tr, dec
        torch.cuda.empty_cache()
        done("7")

        # ---- 8. narrow q4_0 / q5_0 checkpoints: cuda against cpu ----
        hp = W.WhisperHParams(*NARROW_Q, ftype=1, qntvr=0)
        tensors = W.random_reference_tensors(hp, seed=0)
        # 35 s (two windows); audio seeds whose transcript on the CPU stays
        # the same when the input is scaled by 1 +- 2^-20, 2^-16 or 2^-13,
        # so a last-place difference in a sum does not flip a near-tied
        # random-weight token
        for qtype, seed in (("q4_0", 6), ("q5_0", 6)):
            path = tmp / f"narrow-{qtype}.bin"
            W.write_checkpoint(path, hp, TF._synthetic_mel_filters(80), tokens, tensors,
                               wtype=W.TYPE_FOR_NAME[qtype])
            ids, n_enc = {}, {}
            for dev in ("cuda", "cpu"):
                c = TF.WhisperContext.from_file(path, dtype=torch.float32, device=dev)
                reset_counts(A, Q, MK)
                r = TF.whisper_full(c, greedy_params(FullParams), audio(35.0, seed))
                ids[dev] = [[t.id for t in s.tokens] for s in r.segments]
                n_enc[dev] = r.timings.n_encode
                if dev == "cuda":
                    check(Q.qmm.launches > 0 and Q.ffn_int8.launches > 0,
                          f"narrow {qtype} on cuda did not run K3 and K5")
            flat = {dev: [t for s in v for t in s] for dev, v in ids.items()}
            same = ids["cuda"] == ids["cpu"]
            n_tok = len(flat["cuda"])
            first = next((i for i, (a, b) in enumerate(zip(flat["cuda"], flat["cpu"]))
                          if a != b), None)
            print(f"[8] narrow {qtype}: encoder passes {n_enc['cuda']}, segments "
                  f"{len(ids['cuda'])}, tokens {n_tok}, token ids cuda == cpu {same}"
                  + ("" if same else f" (first differing token {first})"), flush=True)
            check(same and n_tok >= 100 and n_enc["cuda"] == n_enc["cpu"] == 2,
                  f"narrow {qtype}: cuda and cpu differ, or too few tokens to tell")
        done("8")

        # ---- 9. narrow bf16 q8_0 checkpoint, megakernel="int8": cuda against cpu ----
        path = tmp / "narrow-q8_0.bin"
        W.write_checkpoint(path, hp, TF._synthetic_mel_filters(80), tokens, tensors,
                           wtype=W.TYPE_FOR_NAME["q8_0"])
        p9 = greedy_params(FullParams)
        p9.megakernel = "int8"
        ids = {}
        for dev in ("cuda", "cpu"):
            c = TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device=dev)
            check(c.mega_mode(p9) == "all", "narrow q8_0: K2 not selected")
            reset_counts(A, Q, MK)
            # audio seed 7: its CPU transcript stays the same when the input
            # is scaled by 1 +- 2^-20, 2^-16 or 2^-13
            r = TF.whisper_full(c, p9, audio(35.0, 7))
            ids[dev] = [[t.id for t in s.tokens] for s in r.segments]
            if dev == "cuda":
                check(MK.mega_decode_step.launches > 0, "narrow q8_0 on cuda did not run K2")
        n_tok = sum(map(len, ids["cuda"]))
        print(f"[9] narrow bf16 q8_0, megakernel='int8': segments {len(ids['cuda'])}, "
              f"tokens {n_tok}, token ids cuda == cpu {ids['cuda'] == ids['cpu']}", flush=True)
        check(ids["cuda"] == ids["cpu"] and n_tok >= 100,
              "narrow bf16 q8_0 with K2: cuda and cpu differ, or too few tokens to tell")
        done("9")

        # ---- 10. beam search, beam_size=3: cuda against cpu ----
        pb = request_params(FullParams, beam_size=3)
        cfg3 = TM.WhisperConfig(*NARROW_Q)
        params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
        ids = {}
        for dev in ("cuda", "cpu"):
            c = TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                                  TF._synthetic_mel_filters(80), n_loaded=1,
                                  dtype=torch.float32, device=dev)
            # audio seed 1: the CPU transcript stays the same when the input is
            # scaled by 1 +- 2^-20, 2^-16 or 2^-13
            r = TF.whisper_full(c, pb, audio(40.0, 1))
            ids[dev] = [[t.id for t in s.tokens] for s in r.segments]
        n_tok = sum(map(len, ids["cuda"]))
        print(f"[10] narrow f32, beam 3: segments {len(ids['cuda'])}, tokens {n_tok}, "
              f"token ids cuda == cpu {ids['cuda'] == ids['cpu']}", flush=True)
        check(ids["cuda"] == ids["cpu"] and n_tok >= 100,
              "narrow f32 beam: cuda and cpu differ, or too few tokens to tell")
        pq = dataclasses.replace(pb, megakernel="int8")
        ctxs = {dev: TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device=dev)
                for dev in ("cuda", "cpu")}
        check(all(c.mega_mode(pq) == "all" for c in ctxs.values()),
              "narrow q8_0: K7 not selected")
        n_equal = 0
        for seed in Q8_BEAM_SEEDS:
            ids = {}
            for dev, c in ctxs.items():
                reset_counts(A, Q, MK)
                r = TF.whisper_full(c, pq, audio(40.0, seed))
                ids[dev] = [t.id for s in r.segments for t in s.tokens]
                if dev == "cuda":
                    check(MK.mega_decode_step_beam.launches > 0
                          and MK.mega_decode_step.launches == 0,
                          "narrow q8_0 beam on cuda did not run K7 alone")
            same = next((i for i, (a, b) in enumerate(zip(ids["cuda"], ids["cpu"])) if a != b),
                        min(len(ids["cuda"]), len(ids["cpu"])))
            print(f"[10] narrow bf16 q8_0, beam 3, megakernel='int8', audio seed {seed}: "
                  f"tokens cuda {len(ids['cuda'])} cpu {len(ids['cpu'])}, equal "
                  f"{ids['cuda'] == ids['cpu']}, equal prefix {same}", flush=True)
            check(ids["cuda"] == ids["cpu"] and ids["cpu"],
                  f"narrow q8_0 beam, audio seed {seed}: cuda (K7) and cpu differ")
            n_equal += len(ids["cpu"])
        print(f"[10] narrow bf16 q8_0 beam: {n_equal} equal tokens over "
              f"{len(Q8_BEAM_SEEDS)} requests", flush=True)
        done("10")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    head = {"qmm": 0, "qmm4": 0, "ffn_int8": 0}   # the row each headline takes
    replaces = {"mha_packed": "open_whisper_kit_tpu/ops/attention.py:70",
                "mega_decode_step": "open_whisper_kit_tpu/ops/decode_megakernel.py:1128",
                "mega_decode_step_beam": "open_whisper_kit_tpu/ops/decode_megakernel.py:1309",
                "qmm": "open_whisper_kit_tpu/ops/quant_matmul.py:129",
                "qmm4": "open_whisper_kit_tpu/ops/quant_matmul.py:280",
                "ffn_int8": "open_whisper_kit_tpu/ops/quant_matmul.py:385"}
    rows = [{"name": "mha_packed", **k1},
            {"name": "mega_decode_step", **k2["all"], "modes": list(k2.values())},
            {"name": "mega_decode_step_beam", **k7["all"], "modes": list(k7.values())}]
    for name, i in head.items():
        rows.append({"name": name, **{k: v for k, v in quant[name][i].items()
                                      if k != "shape"},
                     "shape": quant[name][i]["shape"], "shapes": quant[name]})
    stems = {"mega_decode_step": "mega_step", "mega_decode_step_beam": "mega_beam"}
    for r in rows:
        stem = stems.get(r["name"], r["name"])
        r.update(route="cuda", source=SRC + stem + ".cu",
                 replaces=replaces[r["name"]], launches=launches[r["name"]])
        check(r["launches"] > 0, f"{r['name']} never launched on its path")
    print(f"[end] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(profiling="--profile" in sys.argv[1:]))
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
