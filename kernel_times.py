#!/usr/bin/env python3
"""Time K2, K7, K8, K1's f32 body, K3's rows and tiles routes, T1, K4, K5,
K6, T2 and K9 of the PyTorch port on one GPU, for one or more source trees
in turn.

    python3 kernel_times.py ROOT [ROOT ...] [--only k9,k4]

Each ROOT is a directory holding `open_whisper_kit_tpu_torch/`: this
checkout, or another commit unpacked with `git archive` into a git-ignored
directory such as `build/`; each runs in a process of its own, in the order
given (A B B A interleaves two trees on one card). A root prints one JSON
line per case, every time the median of 20 launches in µs (CUDA events):
- K3 (`ops.quant_matmul.qmm`) at its decode-row shapes, 1 x 1280 -> 1280
  and -> 3840, 5 x 1280 -> 3840, 1 x 1280 -> 51866 (the W8 logits), 8 x
  1280 -> 1280 and -> 3840 (lockstep batches of 8 streams) and 16 x 1280
  -> 1280, beside `torch.matmul` on the dequantized bf16 weight, each with
  the L2 cache flushed before the launch, "queued" (behind a spin on the
  card: the device time) and not (the span then also holds the wrapper's
  host time); and the host's time to issue one call (`host_us`: 200 calls
  back to back on the host clock, no flush);
- T1 (`ops.gemm.mm_bf16`) at the tensor-core probe's two products beside
  cuBLAS bf16 (`torch.mm` with f32 out), queued, cold L2; where the tree's
  T1 plans its tile (`mm_bf16_plan`), with that tile;
- where the tree has the split rows route (`qmm_rows_plan`), the rows
  route at its one- and five-row shapes for a range of splits;
- K2 (`ops.decode_megakernel.mega_decode_step`, the whole large-v3-turbo
  decoder step, seed-0 random weights as chip_smoke.py's phase 3 makes
  them) in its four modes at R = 1 (head 108 of a 448-row cache) and R = 5
  and 8 (the verify rows, head 258 of a 459-row cache), each with the L2
  cache flushed: queued behind a spin (the device time), the call (with its
  host time) and `host_us` (one call's host time on an idle card, median of
  50), beside the bound (chip_smoke.k2_bytes_ops) and its share;
- K8 (`ops.decode_megakernel.mega_decode_step_batch`, the same step for B
  independent streams, each with its own cross-KV) in the four modes at
  B = 2, 5 and 8, head 258 of a 448-row cache a stream, timed as K2, beside
  its bound (every plane, each stream's cross-KV and self-KV rows);
- K7 (`ops.decode_megakernel.mega_decode_step_beam`, the same step for B
  beams over one shared cross-KV, with a lineage) in the four modes at
  B = 2, 5 and 8, head 258 of a 448-row cache a beam with a random origin
  table, timed as K2, beside its bound (every plane and the cross-KV once,
  each beam's lineage rows and origin entries);
- K1's f32 body (`ops.attention.mha_packed` on f32 tensors) at (1, 1536,
  128), the narrow f32 models' encoder, and (1, 1536, 1280), large-v3-
  turbo's width, 1500 live keys, warm L2 as the encoder finds its q/k/v:
  queued and not, beside SDPA on the head-major layout with the same mask,
  the plain version and the bound (the f32 operations at the f32 peak);
- K3's tiles route (`ops.quant_matmul.qmm` above 16 rows) at the encoder's
  linears, the cross-KV and a window's 227-row prompt ingest and a 64-row
  bucket (qkv, o), cold
  L2, queued and not, the plain version (below 1000 rows), `torch.matmul`
  on the dequantized weight queued, the bound and its share, and the
  output's digest (to hold two trees' bits against each other);
- K5 (`ops.quant_matmul.ffn_int8`, the int8 decoder MLP 1280 -> 5120 ->
  1280 with W1 padded as the port pads it) at 1, 5, 24, 40, 64 and 227
  rows, cold L2, queued and not, `host_us`, the plain version, the bound
  (the bytes) and its share, the route (rows body or tiles) where the tree
  has one, the tiles plan where it has one (`ffn_int8_tiles_plan`), the
  output's digest and whether two calls give the same bits;
- K6 (`ops.encoder_int8.w8a8_mm`) at the encoder's four linears (qkv, o,
  mlp0, mlp1) for 1 and 8 windows (M = 1536, 12288), bf16 x, cold L2,
  queued: the call (quantize and GEMM together), the GEMM alone (T2's
  entry on the same quantized rows), the quantize launch alone where the
  tree has one (`owk_quantize_rows`), `host_us`, the plain version, the
  library yardsticks (`torch._int_mm` with the same quantize and scale
  ops; dense bf16 `torch.matmul`; the plain version at one window only),
  the bound (int8 operations at 1979
  TOP/s, or the bytes) and its share, and the GEMM's tile where the tree
  plans one (`gemm.w8a8_plan`); the quantize launch's own bound (its
  bytes);
- T2 (`ops.gemm.mm_s8`) at the probe's two products beside `_int_mm` +
  scale ops, queued, cold L2, with the bound and its share;
- K4 (`ops.quant_matmul.qmm4`, the W4 logits 1280 -> 51866) at 1, 5, 8,
  17 and 64 rows, cold L2: queued, the call, `host_us`, `torch.matmul` on
  the dequantized bf16 weight queued, the bound (the bytes) and its share,
  the route (rows body or tiles) where the tree has one, the tiles plan
  where it has one (`tiles_plan`), the digest and two calls' bit-equality;
- K9b and K9a (`ops.experiments.cross_attention_q8`, `_nat`) at
  chip_smoke.py's phase-18 cases (K9_CASES: turbo bf16 at one row, five
  rows over one shared plane, eight streams, K9a's eight streams on
  1504-row slabs; narrow f32), cold L2: queued, the call, `host_us`, the
  launches a call, SDPA over the float cross-KV queued, the bound and its
  share, and the tree's key chunks where it plans them (`cross_q8_plan`).
`--only` names the groups to time (rows, mm, k3, k5, k6, k1, k2, k7, k8,
k4, k9; default all). The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROWS_SHAPES = [(1, 1280, 1280), (1, 1280, 3840), (5, 1280, 3840), (1, 1280, 51866),
               (8, 1280, 1280), (8, 1280, 3840), (16, 1280, 1280)]
SPLITS = {1280: (4, 6, 8), 3840: (2, 3, 4, 6, 8), 51866: (1, 2)}
MM_SHAPES = [(1536, 1280, 5120), (1536, 5120, 1280)]
K2_CASES = [(1, 448, 108), (5, 459, 258), (8, 459, 258)]   # (R, cache rows, head)
K8_STREAMS = (2, 5, 8)
K8_HEAD = 258          # of a 448-row cache a stream (n_text_ctx)
K7_BEAMS = (2, 5, 8)   # at K8_HEAD of a 448-row cache a beam
K1_F32_SHAPES = [(1, 1536, 128), (1, 1536, 1280)]   # (B, T, S), 1500 live keys
K5_ROWS = (1, 5, 24, 40, 64, 227)
K4_ROWS = (1, 5, 8, 17, 64)
# K3's tiles route: the encoder's linears, the cross-KV, and a window's
# prompt ingest (227 rows) and a 64-row bucket (host-stepped ingest, the DTW
# re-decode) at qkv and o
K3_TILES_SHAPES = [(1536, 1280, 5120), (1536, 1280, 1280), (1536, 5120, 1280),
                   (1500, 1280, 1280), (227, 1280, 3840), (227, 1280, 1280),
                   (64, 1280, 3840), (64, 1280, 1280)]
GROUPS = ("rows", "mm", "k3", "k5", "k5split", "k6", "k1", "k2", "k7", "k8", "k4", "k9")
K6_SHAPES = [(rows, label, k, n) for rows in (1536, 12288)
             for label, k, n in (("qkv", 1280, 3840), ("o", 1280, 1280), ("mlp0", 1280, 5120),
                                 ("mlp1", 5120, 1280))]


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def setup(root: Path):
    sys.path.insert(0, str(root))   # the tree's package; cuda_ms from its chip_smoke.py
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as CS
    return torch, CS


def plane(torch, Q, M, K, N, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = Q.quantize_linear(torch.randn(K, N, generator=g, device="cuda") * K ** -0.5)
    x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
    return w, x, Q.dequantize_dense(w, torch.bfloat16).contiguous()


def host_us(torch, fn, n: int = 200) -> float:
    """µs of host time per call of fn, issued n times back to back."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def call_host_us(torch, fn, reps: int = 50) -> float:
    """Median µs of host time one call of fn() takes, on an idle card."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def bits(torch, fn) -> dict:
    """The digest of fn()'s output (its bits, to hold two trees' against
    each other) and whether a second call gives the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return {"digest": hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()[:16],
            "bit_equal": bool(torch.equal(a, b))}


def k3_tiles_times(torch, CS, root: Path) -> None:
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for M, K, N in K3_TILES_SHAPES:
        w, x, wd = plane(torch, Q, M, K, N, M + K + N)
        run = lambda: Q.qmm(x, w.qs, w.scales)   # noqa: E731
        ref = Q.qmm_plain(x, w.qs, w.scales)
        err = ((run() - ref).abs().max() / ref.abs().max()).item()
        b_ms, b_by = CS.bound(CS.nbytes(x, w.qs[:, :N], w.scales[:, :N]) + M * N * 4,
                              2 * M * K * N)
        k_ms = CS.cuda_ms(torch, run, flush=flush, queued=True)
        emit(root=str(root), kernel="qmm tiles route", M=M, K=K, N=N, rel_err=err,
             **bits(torch, run), us=1e3 * k_ms,
             us_unqueued=1e3 * CS.cuda_ms(torch, run, flush=flush),
             plain_us=1e3 * CS.cuda_ms(torch, lambda: Q.qmm_plain(x, w.qs, w.scales),
                                       flush=flush, queued=True) if M < 1000 else None,
             matmul_us=1e3 * CS.cuda_ms(torch, lambda: torch.matmul(x, wd), flush=flush,
                                        queued=True),
             bound_us=1e3 * b_ms, bound_by=b_by, bound_share=b_ms / k_ms)


# K5's tiles route by hand: (splits of the first half, of the second) at
# 40 and 227 rows, through the C entry (K5_SPLITS_M x K5_SPLITS)
K5_SPLITS_M = (40, 227)
K5_SPLITS = [(1, 1), (1, 5), (1, 8), (2, 5), (2, 8), (3, 5), (3, 8), (4, 5), (2, 2)]


def k5_split_times(torch, CS, root: Path) -> None:
    """K5's tiles route at each (splits_up, splits_down) of K5_SPLITS, and
    each half alone as an unsplit K3 launch on the same shapes (f32 out):
    what the splits and the ordered combine buy. Trees with the tiles plan
    only."""
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    if not hasattr(Q, "tiles_clusters"):
        return
    g = torch.Generator(device="cuda").manual_seed(9)
    S, FF = 1280, 5120
    w0 = Q.quantize_linear(torch.randn(S, FF, generator=g, device="cuda") * S ** -0.5, pad=False)
    w1 = Q.quantize_linear(torch.randn(FF, S, generator=g, device="cuda") * FF ** -0.5)
    b0 = (torch.randn(FF, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    lib = Q._kernel_lib("ffn_int8")
    stream = torch.cuda.current_stream().cuda_stream
    for M in K5_SPLITS_M:
        x = torch.randn(M, S, generator=g, device="cuda").to(torch.bfloat16)
        ref = Q.ffn_int8_plain(x, w0.qs, w0.scales, b0, w1.qs, w1.scales)
        h = torch.empty(M, FF, dtype=torch.bfloat16, device="cuda")
        out = torch.empty(M, S, device="cuda")
        for su, sd in K5_SPLITS:
            def run(su=su, sd=sd):
                rc = lib.owk_ffn_int8(x.data_ptr(), w0.qs.data_ptr(), w0.scales.data_ptr(),
                                      b0.data_ptr(), 1, w1.qs.data_ptr(), w1.scales.data_ptr(),
                                      h.data_ptr(), out.data_ptr(), M, S, FF, S, su, sd, 8,
                                      stream)
                if rc:
                    raise RuntimeError(f"owk_ffn_int8: cudaError {rc}")
            run()
            torch.cuda.synchronize()
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            emit(root=str(root), kernel="ffn_int8 tiles by hand", M=M, splits_up=su,
                 splits_down=sd, rel_err=err,
                 us=1e3 * CS.cuda_ms(torch, run, flush=flush, queued=True),
                 us_warm=1e3 * CS.cuda_ms(torch, run, queued=True))
        hb = h.clone()
        w4 = Q.quantize_linear4(torch.randn(FF, S, generator=g, device="cuda") * FF ** -0.5)
        out4 = torch.empty(M, S, device="cuda")
        for splits in (1, 2, 5, 8):
            def run4(splits=splits):
                rc = Q._kernel_lib("qmm4").owk_qmm4(hb.data_ptr(), w4.qs.data_ptr(),
                                                    w4.scales.data_ptr(), out4.data_ptr(), M,
                                                    FF, S, splits, 1, stream)
                if rc:
                    raise RuntimeError(f"owk_qmm4: cudaError {rc}")
            emit(root=str(root), kernel="qmm4 tiles by hand", M=M, K=FF, N=S, splits=splits,
                 us=1e3 * CS.cuda_ms(torch, run4, flush=flush, queued=True),
                 us_warm=1e3 * CS.cuda_ms(torch, run4, queued=True))
        for half, (a, w) in (("first half alone (K3, f32 out)", (x, w0)),
                             ("second half alone (K3)", (hb, w1))):
            emit(root=str(root), kernel="ffn_int8 tiles by hand", M=M, what=half,
                 us=1e3 * CS.cuda_ms(torch, lambda a=a, w=w: Q.qmm(a, w.qs, w.scales),
                                     flush=flush, queued=True),
                 us_warm=1e3 * CS.cuda_ms(torch, lambda a=a, w=w: Q.qmm(a, w.qs, w.scales),
                                          queued=True))


def k2_times(torch, CS, root: Path) -> None:
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    cfg = TM.WhisperConfig(*CS.TURBO)
    L, S, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_audio_ctx
    g = torch.Generator(device="cuda").manual_seed(3)
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, 459, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for mode in CS.K2_MODES:
        dec, ydec = CS.turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        for R, Tc, head in K2_CASES:
            kk, kv = (hist[i, :, :Tc].clone() for i in range(2))
            kk[:, head:] = kv[:, head:] = 0
            toks = torch.randint(0, cfg.n_vocab, (R,), generator=g, device="cuda")
            x0 = (dec["te"][toks] + dec["pe"][head:head + R]).to(torch.bfloat16)
            ht = torch.tensor(head, device="cuda")

            def step():
                return MK.mega_decode_step(cfg, mp, x0, kk, kv, ht, xk, xv)
            moved, ops = CS.k2_bytes_ops(MK, mp, cfg, head + R, Ta, rows=R, self_shared=True)
            b_ms = CS.bound(moved, ops)[0]
            q_ms = CS.cuda_ms(torch, step, flush=flush, queued=True)
            emit(root=str(root), kernel="mega_decode_step", mode=mode, R=R,
                 cache_rows=Tc, head=head, us=1e3 * q_ms,
                 us_call=1e3 * CS.cuda_ms(torch, step, flush=flush),
                 host_us=call_host_us(torch, step), bound_us=1e3 * b_ms,
                 bound_share=b_ms / q_ms)
        del dec, ydec, mp
        torch.cuda.empty_cache()


def k8_times(torch, CS, root: Path) -> None:
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    cfg = TM.WhisperConfig(*CS.TURBO)
    L, S, Ta, Tc = cfg.n_text_layer, cfg.n_text_state, cfg.n_audio_ctx, cfg.n_text_ctx
    B_max, head = max(K8_STREAMS), K8_HEAD
    g = torch.Generator(device="cuda").manual_seed(5)
    xk, xv = ((torch.randn(L, B_max, Ta, S, generator=g, device="cuda") * 0.5)
              .to(torch.bfloat16) for _ in range(2))
    hist = (torch.randn(2, L, Tc * B_max, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for mode in CS.K2_MODES:
        dec, ydec = CS.turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        for B in K8_STREAMS:
            kk, kv = (hist[i, :, :Tc * B].clone() for i in range(2))
            kk[:, head * B:] = kv[:, head * B:] = 0
            sk, sv = xk[:, :B].contiguous(), xv[:, :B].contiguous()
            toks = torch.randint(0, cfg.n_vocab, (B,), generator=g, device="cuda")
            x0 = (dec["te"][toks] + dec["pe"][head]).to(torch.bfloat16)
            ht = torch.tensor(head, device="cuda")

            def step():
                return MK.mega_decode_step_batch(cfg, mp, x0, kk, kv, ht, sk, sv)
            moved, ops = CS.k2_bytes_ops(MK, mp, cfg, head + 1, Ta, rows=B, cross_streams=B)
            b_ms = CS.bound(moved, ops)[0]
            q_ms = CS.cuda_ms(torch, step, flush=flush, queued=True)
            emit(root=str(root), kernel="mega_decode_step_batch", mode=mode, B=B,
                 cache_rows=Tc, head=head, us=1e3 * q_ms,
                 us_call=1e3 * CS.cuda_ms(torch, step, flush=flush),
                 host_us=call_host_us(torch, step), bound_us=1e3 * b_ms,
                 bound_share=b_ms / q_ms)
        del dec, ydec, mp
        torch.cuda.empty_cache()


def k7_times(torch, CS, root: Path) -> None:
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    cfg = TM.WhisperConfig(*CS.TURBO)
    L, S, Ta, Tc = cfg.n_text_layer, cfg.n_text_state, cfg.n_audio_ctx, cfg.n_text_ctx
    B_max, head = max(K7_BEAMS), K8_HEAD
    g = torch.Generator(device="cuda").manual_seed(6)
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, Tc * B_max, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for mode in CS.K2_MODES:
        dec, ydec = CS.turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        for B in K7_BEAMS:
            kk, kv = (hist[i, :, :Tc * B].clone() for i in range(2))
            kk[:, head * B:] = kv[:, head * B:] = 0
            origin = torch.randint(0, B, (B, Tc), generator=g, device="cuda")
            origin[:, head] = torch.arange(B, device="cuda")
            toks = torch.randint(0, cfg.n_vocab, (B,), generator=g, device="cuda")
            x0 = (dec["te"][toks] + dec["pe"][head]).to(torch.bfloat16)
            ht = torch.tensor(head, device="cuda")

            def step():
                return MK.mega_decode_step_beam(cfg, mp, x0, kk, kv, ht, xk, xv, origin=origin)
            moved, ops = CS.k2_bytes_ops(MK, mp, cfg, head + 1, Ta, rows=B)
            moved += B * (head + 1) * 8
            b_ms = CS.bound(moved, ops)[0]
            q_ms = CS.cuda_ms(torch, step, flush=flush, queued=True)
            emit(root=str(root), kernel="mega_decode_step_beam", mode=mode, B=B,
                 cache_rows=Tc, head=head, us=1e3 * q_ms,
                 us_call=1e3 * CS.cuda_ms(torch, step, flush=flush),
                 host_us=call_host_us(torch, step), bound_us=1e3 * b_ms,
                 bound_share=b_ms / q_ms)
        del dec, ydec, mp
        torch.cuda.empty_cache()


def k1_f32_times(torch, CS, root: Path) -> None:
    import torch.nn.functional as F
    from open_whisper_kit_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(1)
    n_valid, scale = 1500, 0.125
    for B, T, S in K1_F32_SHAPES:
        q, k, v = (torch.randn(B, T, S, generator=g, device="cuda") for _ in range(3))
        H = S // 64
        ref = A.mha_plain(q, k, v, H, scale, n_valid)
        err = (A.mha_packed(q, k, v, scale, n_valid) - ref).abs().max().item()
        qh, kh, vh = (t.view(B, T, H, 64).transpose(1, 2).contiguous() for t in (q, k, v))
        mask = (torch.arange(T, device="cuda") < n_valid)[None, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=scale)

        def us(fn, queued=True):
            return 1e3 * CS.cuda_ms(torch, fn, queued=queued)
        b_ms, b_by = CS.bound(4 * q.numel() * 4, 4 * B * T * n_valid * S, CS.F32_PEAK)
        k_us = us(lambda: A.mha_packed(q, k, v, scale, n_valid))
        emit(root=str(root), kernel="mha_packed f32", B=B, T=T, S=S, n_valid=n_valid,
             max_abs_err=err, us=k_us,
             us_unqueued=us(lambda: A.mha_packed(q, k, v, scale, n_valid), False),
             sdpa_us=us(sdpa), plain_us=us(lambda: A.mha_plain(q, k, v, H, scale, n_valid)),
             bound_us=1e3 * b_ms, bound_by=b_by, bound_share=1e3 * b_ms / k_us)


def k5_times(torch, CS, root: Path) -> None:
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    g = torch.Generator(device="cuda").manual_seed(9)
    S, FF = 1280, 5120
    w0 = Q.quantize_linear(torch.randn(S, FF, generator=g, device="cuda") * S ** -0.5, pad=False)
    w1 = Q.quantize_linear(torch.randn(FF, S, generator=g, device="cuda") * FF ** -0.5)
    b0 = (torch.randn(FF, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for M in K5_ROWS:
        x = torch.randn(M, S, generator=g, device="cuda").to(torch.bfloat16)
        args = (x, w0.qs, w0.scales, b0, w1.qs, w1.scales)
        ref = Q.ffn_int8_plain(*args)
        err = ((Q.ffn_int8(*args) - ref).abs().max() / ref.abs().max()).item()
        moved = CS.nbytes(x, w0.qs, w0.scales, b0, w1.qs[:, :S], w1.scales[:, :S]) + M * S * 4
        b_ms, b_by = CS.bound(moved, 4 * M * S * FF)
        k_ms = CS.cuda_ms(torch, lambda: Q.ffn_int8(*args), flush=flush, queued=True)
        plan = (dataclasses.asdict(Q.ffn_int8_tiles_plan(M, S, FF, w1.qs.shape[1],
                                                         clusters=Q.tiles_clusters(0)))
                if hasattr(Q, "tiles_clusters") and M > 16 else None)
        emit(root=str(root), kernel="ffn_int8", M=M, K=S, FF=FF, rel_err=err,
             route=Q.ffn_int8_route(M) if hasattr(Q, "ffn_int8_route") else "tiles",
             plan=plan, **bits(torch, lambda: Q.ffn_int8(*args)),
             us=1e3 * k_ms,
             us_unqueued=1e3 * CS.cuda_ms(torch, lambda: Q.ffn_int8(*args), flush=flush),
             host_us=call_host_us(torch, lambda: Q.ffn_int8(*args)),
             plain_us=1e3 * CS.cuda_ms(torch, lambda: Q.ffn_int8_plain(*args), flush=flush,
                                       queued=True),
             bound_us=1e3 * b_ms, bound_by=b_by, bound_share=b_ms / k_ms)


def k6_t2_times(torch, CS, root: Path) -> None:
    from open_whisper_kit_tpu_torch.ops import encoder_int8 as E8
    from open_whisper_kit_tpu_torch.ops import gemm as G
    from open_whisper_kit_tpu_torch.tools import bench_int8_mxu as P
    g = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    lib = E8._kernel_lib()
    has_quant = hasattr(lib, "owk_quantize_rows")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def us(fn, queued=True):
        return 1e3 * CS.cuda_ms(torch, fn, flush=flush, queued=queued)

    for M, label, K, N in K6_SHAPES:
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
        wq, ws = E8.quantize_w_cols(w)
        wq_t = wq.t().contiguous()
        got = E8.w8a8_mm(x, wq_t, ws)
        ref = E8.w8a8_mm_plain(x, wq_t, ws)
        n_diff = int((got.float() != ref.float()).sum())
        xq, xs = E8.quantize_act_rows(x)
        wd = w.to(torch.bfloat16)

        def int_mm():
            q, s_ = E8.quantize_act_rows(x)
            return ((torch._int_mm(q, wq_t.t()).float() * s_) * ws).to(torch.bfloat16)
        row = {}
        if has_quant:
            q_out = torch.empty(M, K, dtype=torch.int8, device="cuda")
            s_out = torch.empty(M, dtype=torch.float32, device="cuda")

            def quant():
                rc = lib.owk_quantize_rows(x.data_ptr(), 0, q_out.data_ptr(), s_out.data_ptr(),
                                           M, K, E8._INV127, stream)
                if rc:
                    raise RuntimeError(f"owk_quantize_rows: cudaError {rc}")
            quant()
            torch.cuda.synchronize()
            ok = torch.equal(q_out, xq) and torch.equal(s_out, xs[:, 0])
            qb_ms, _ = CS.bound(M * K * 2 + M * K + M * 4, 0)
            q_us = us(quant)
            row.update(quantize_us=q_us, quantize_bit_equal=ok, quantize_bound_us=1e3 * qb_ms,
                       quantize_bound_share=1e3 * qb_ms / q_us)
        b_ms, b_by = CS.bound(CS.nbytes(x, wq, ws, got), 2 * M * K * N, "int8")
        k_us = us(lambda: E8.w8a8_mm(x, wq_t, ws))
        gemm_us = us(lambda: G.mm_s8(xq, xs, wq_t, ws))
        gb_ms, _ = CS.bound(CS.nbytes(xq, xs, wq, ws, got), 2 * M * K * N, "int8")
        tile = (list(G.w8a8_plan(M, N, sms).tile) if hasattr(G, "w8a8_plan") else [128, 128])
        emit(root=str(root), kernel="w8a8_mm", shape=f"{label}, {M // 1536} window(s)", M=M,
             K=K, N=N, tile=tile, values_differing=n_diff, us=k_us,
             us_unqueued=us(lambda: E8.w8a8_mm(x, wq_t, ws), False),
             host_us=call_host_us(torch, lambda: E8.w8a8_mm(x, wq_t, ws)),
             gemm_us=gemm_us, gemm_bound_share=1e3 * gb_ms / gemm_us, **row,
             # the plain version's f64 product: timed at one window only
             plain_us=us(lambda: E8.w8a8_mm_plain(x, wq_t, ws)) if M == 1536 else None,
             int_mm_us=us(int_mm),
             dense_bf16_us=us(lambda: torch.matmul(x, wd)), bound_us=1e3 * b_ms,
             bound_by=b_by, bound_share=1e3 * b_ms / k_us,
             int8_tops=2 * M * K * N / k_us / 1e6)
        del x, w, wq, wq_t, got, ref, xq, xs, wd, row
        torch.cuda.empty_cache()

    x0, w1, w2 = P.operands(P.M, P.K, P.F_, "cuda")
    h = torch.nn.functional.gelu(G.mm_bf16_plain(x0, w1).float(),
                                 approximate="tanh").to(torch.bfloat16)
    for (label, M, K, N), a, b in zip((("x @ W1", P.M, P.K, P.F_), ("h @ W2", P.M, P.F_, P.K)),
                                      (x0, h), (w1, w2)):
        aq, a_s = P.quant_rows(a)
        bq, b_s = P.quant_cols(b)
        bq_t = bq.t().contiguous()
        got = G.mm_s8(aq, a_s, bq_t, b_s)
        n_diff = int((got.float() != G.mm_s8_plain(aq, a_s, bq_t, b_s).float()).sum())

        def int_mm():
            return ((torch._int_mm(aq, bq_t.t()).float() * a_s) * b_s).to(torch.bfloat16)
        b_ms, b_by = CS.bound(CS.nbytes(aq, a_s, bq_t, b_s, got), 2 * M * K * N, "int8")
        k_us = us(lambda: G.mm_s8(aq, a_s, bq_t, b_s))
        tile = (list(G.w8a8_plan(M, N, sms).tile) if hasattr(G, "w8a8_plan") else [128, 128])
        emit(root=str(root), kernel="mm_s8", shape=label, M=M, K=K, N=N, tile=tile,
             values_differing=n_diff, us=k_us,
             host_us=call_host_us(torch, lambda: G.mm_s8(aq, a_s, bq_t, b_s)),
             int_mm_us=us(int_mm), bound_us=1e3 * b_ms, bound_by=b_by,
             bound_share=1e3 * b_ms / k_us, int8_tops=2 * M * K * N / k_us / 1e6)
    del flush
    torch.cuda.empty_cache()


def k4_times(torch, CS, root: Path) -> None:
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    g = torch.Generator(device="cuda").manual_seed(11)
    K, N = 1280, 51866
    w = Q.quantize_linear4(torch.randn(K, N, generator=g, device="cuda") * K ** -0.5)
    wd = Q.dequantize_dense(w, torch.bfloat16).contiguous()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for M in K4_ROWS:
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        ref = Q.qmm4_plain(x, w.qs, w.scales)
        err = ((Q.qmm4(x, w.qs, w.scales) - ref).abs().max() / ref.abs().max()).item()
        run = lambda: Q.qmm4(x, w.qs, w.scales)   # noqa: E731
        b_ms, b_by = CS.bound(CS.nbytes(x, w.qs[:, :N], w.scales[:, :N]) + M * N * 4,
                              2 * M * K * N)
        k_ms = CS.cuda_ms(torch, run, flush=flush, queued=True)
        route = Q.qmm_route(M) if hasattr(Q, "qmm4_rows_plan") else "tiles"
        plan = (dataclasses.asdict(Q.tiles_plan(M, K, w.qs.shape[1], bits=4,
                                                clusters=Q.tiles_clusters(0)))
                if hasattr(Q, "tiles_clusters") and M > 16 else None)
        emit(root=str(root), kernel="qmm4", M=M, K=K, N=N, rel_err=err, route=route,
             plan=plan, **bits(torch, run),
             us=1e3 * k_ms, us_call=1e3 * CS.cuda_ms(torch, run, flush=flush),
             host_us=call_host_us(torch, run),
             matmul_us=1e3 * CS.cuda_ms(torch, lambda: torch.matmul(x, wd), flush=flush,
                                        queued=True),
             bound_us=1e3 * b_ms, bound_by=b_by, bound_share=b_ms / k_ms)


def k9_times(torch, CS, root: Path) -> None:
    import torch.nn.functional as F
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import experiments as XQ
    g = torch.Generator(device="cuda").manual_seed(19)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    Ta = CS.K9_TA
    for kernel, dt, H, B, Bk in CS.K9_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        S, nat, scale = H * 64, kernel == "K9a", 64 ** -0.25
        xk, xv = ((torch.randn(1, Bk, Ta, S, generator=g, device="cuda") * 0.5).to(dtype)
                  for _ in range(2))
        quant = TM.quantize_cross_kv_nat if nat else TM.quantize_cross_kv
        qk, qv = quant(xk, H), quant(xv, H)
        planes = (qk.qs[0], qk.scale[0], qv.qs[0], qv.scale[0])
        extra = (qk.ta_valid,) if nat else ()
        fn = XQ.cross_attention_q8_nat if nat else XQ.cross_attention_q8
        plain = XQ.cross_attention_q8_nat_plain if nat else XQ.cross_attention_q8_plain
        q = torch.randn(B, 1, S, generator=g, device="cuda").to(dtype)
        run = lambda: fn(q, *planes, H, scale, *extra)   # noqa: E731
        ref = plain(q, *planes, H, scale, *extra).float()
        before = fn.launches
        err = ((run().float() - ref).abs().max() / ref.abs().max()).item()
        per_call = fn.launches - before
        kh, vh = (x[0].view(Bk, Ta, H, 64).transpose(1, 2).contiguous() for x in (xk, xv))
        qh = q.view(Bk, B // Bk, H, 64).transpose(1, 2).contiguous()
        live = Bk * H * Ta * (64 + 4)
        b_ms, b_by = CS.bound(2 * live + 2 * CS.nbytes(q), 4 * B * H * Ta * 64,
                              "bf16" if dt == "bf16" else CS.F32_FLOP_PER_S)
        k_ms = CS.cuda_ms(torch, run, flush=flush, queued=True)
        plan = (XQ.cross_q8_plan(B, H, extra[0] if nat else Ta, Bk < B)
                if hasattr(XQ, "cross_q8_plan") else None)
        emit(root=str(root), kernel=kernel, dtype=dt, H=H, B=B, planes=Bk, rel_err=err,
             us=1e3 * k_ms, us_call=1e3 * CS.cuda_ms(torch, run, flush=flush),
             host_us=call_host_us(torch, run), launches_per_call=per_call,
             sdpa_us=1e3 * CS.cuda_ms(
                 torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
                 flush=flush, queued=True),
             bound_us=1e3 * b_ms, bound_by=b_by, bound_share=b_ms / k_ms,
             chunks=plan.chunks if plan else None, chunk=plan.chunk if plan else None,
             rows=plan.rows if plan else None)
        del xk, xv, qk, qv, planes, kh, vh


def child(root: Path, only: tuple[str, ...]) -> None:
    torch, CS = setup(root)
    from open_whisper_kit_tpu_torch.ops import gemm as G
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def us(fn, queued=True):
        return 1e3 * CS.cuda_ms(torch, fn, flush=flush, queued=queued)

    for M, K, N in ROWS_SHAPES if "rows" in only else ():
        w, x, wd = plane(torch, Q, M, K, N, M + N)
        ref = Q.qmm_plain(x, w.qs, w.scales)
        err = ((Q.qmm(x, w.qs, w.scales) - ref).abs().max() / ref.abs().max()).item()
        emit(root=str(root), kernel="qmm rows route", M=M, K=K, N=N, rel_err=err,
             us=us(lambda: Q.qmm(x, w.qs, w.scales)),
             us_unqueued=us(lambda: Q.qmm(x, w.qs, w.scales), False),
             host_us=host_us(torch, lambda: Q.qmm(x, w.qs, w.scales)),
             matmul_us=us(lambda: torch.matmul(x, wd)),
             matmul_us_unqueued=us(lambda: torch.matmul(x, wd), False),
             matmul_host_us=host_us(torch, lambda: torch.matmul(x, wd)))
        if not hasattr(Q, "qmm_rows_plan"):
            continue
        Np = w.qs.shape[1]
        maps = Q._rows_tensor_maps(w.qs, w.scales, K, Np)
        lib = Q._kernel_lib("qmm_rows")
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty(M, Np, device="cuda")
        for splits in SPLITS.get(N, ()) if M <= 5 else ():
            def run(splits=splits):
                rc = lib.owk_qmm_rows(x.data_ptr(), maps, out.data_ptr(), M, K, Np, splits,
                                      stream)
                if rc:
                    raise RuntimeError(f"owk_qmm_rows: cudaError {rc}")
            run()
            torch.cuda.synchronize()
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            emit(root=str(root), kernel="qmm rows route", M=M, K=K, N=N, splits=splits,
                 blocks=splits * Np // 128, rel_err=err, us=us(run))

    g = torch.Generator(device="cuda").manual_seed(0)
    for M, K, N in MM_SHAPES if "mm" in only else ():
        a = (torch.randn(M, K, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
        b = (torch.randn(K, N, generator=g, device="cuda") * K ** -0.5).to(torch.bfloat16)
        ok = G.mm_bf16_within(G.mm_bf16(a, b), G.mm_bf16_plain(a, b), a, b)["ok"]
        tile = (list(G.mm_bf16_plan(M, N, torch.cuda.get_device_properties(0)
                                    .multi_processor_count).tile)
                if hasattr(G, "mm_bf16_plan") else None)
        emit(root=str(root), kernel="mm_bf16", M=M, K=K, N=N, tile=tile, ok=ok,
             us=us(lambda: G.mm_bf16(a, b)),
             cublas_us=us(lambda: torch.mm(a, b, out_dtype=torch.float32)))
    del flush
    torch.cuda.empty_cache()
    for group, times in (("k3", k3_tiles_times), ("k5", k5_times),
                         ("k5split", k5_split_times), ("k6", k6_t2_times),
                         ("k1", k1_f32_times), ("k2", k2_times), ("k7", k7_times), ("k8", k8_times),
                         ("k4", k4_times), ("k9", k9_times)):
        if group in only:
            times(torch, CS, root)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups to time (default: all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = tuple(args.only.split(","))
    if not set(only) <= set(GROUPS):
        ap.error(f"--only takes {', '.join(GROUPS)}")
    if args.child:
        child(args.roots[0].resolve(), only)
        return 0
    print(smi(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--child", str(root), "--only", args.only],
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
