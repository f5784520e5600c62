#!/usr/bin/env python3
"""Drive the PyTorch port (open_whisper_kit_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each gated; any failure exits non-zero before the result lines:
  1. torch / CUDA versions and the card's name and power limit;
  2. build kernels K1 (csrc/mha_packed.cu), K2 (mega_step.cu, 1-8 rows), K3
     (qmm.cu, and qmm_rows.cu for M <= 16), K4 (qmm4.cu), K5 (ffn_int8.cu),
     K6 and T2 (w8a8.cu), K7
     (mega_beam.cu), K8 (mega_batch.cu), K9a/K9b (cross_q8.cu) and T1
     (mm_bf16.cu) with nvcc, one process per source, all at once, timed;
  3. K1 against its plain torch version on the card: bf16 at the
     large-v3-turbo encoder shape (B=1, T=1536, S=1280, n_valid=1500,
     gate max|err| <= 1e-2 * max|ref|) and f32 at the narrow models' shape
     (S=128) and at large-v3-turbo's width (S=1280), gate 2e-5; kernel,
     plain and SDPA times (CUDA events, median of 20), the bound, the bound
     of the bf16 kernel's two-pass work (QK^T twice) and the TFLOP/s it
     reaches, and of the f32 body's 3xTF32 products;
     K3, K4 and K5 against their plain versions at the shapes large-v3-turbo
     gives them (gate 1e-3 * max|ref|), with kernel, plain and library times
     (torch.matmul on the dequantized bf16 weight), each launch with a cold
     L2 cache, the bound and the kernel's share of it; at K3's rows-route
     shapes (1 x 1280 -> 1280 and -> 3840, 5 x 1280 -> 3840, W8 logits) and
     K4's (the W4 logits at 1, 5 and 8 rows, on the rows body) also the
     kernel's and torch.matmul's device times queued behind a spin, with
     the bound's share of the queued time (K4 also the call and host_us),
     and two launches bit-equal (the splits' ordered combine); K5 at 1, 5, 8 and 16 rows (the rows body)
     likewise queued, two launches bit-equal; K2 (the whole decoder
     step) at large-v3-turbo
     width (4 layers, 448 cache rows, 1500 audio positions, vocabulary
     51866) in its four modes (dense, int8 logits, int8, int4): 8
     consecutive steps from a cache with 100 rows of history, each from the
     same inputs as its plain version (logits and the new cache rows
     within 2e-2 of max|ref|, K2_TOL), two launches from the same inputs
     bit-equal, the step's device time queued behind a spin (its "ms"), the
     call with its host time and the host's time to issue one step
     (host_us), beside the plain step and the port's decode_impl step on
     the same weights (the yardstick; no single library call computes a
     step), each with a cold L2 cache, the bound and its share of the
     device time (with --profile also each of the 33 launches' traced
     device time); K7 (the beam step) at the same
     width for B = 5 beams in the same four modes: 8 steps at heads 126-129
     and 254-257 (across the self-attention's 128-row time-block edges)
     with lineage reorders, from a cache whose slot 0 holds 100 prompt rows
     and whose later rows hold random K/V with a random lineage, each from
     the same inputs as its plain version (logits within K2_TOL of
     max|ref|, the same argmax per beam except on rows whose two best plain
     logits lie within 1e-2 of max|ref|, K7_ARGMAX_GAP, the new cache rows
     of layer 0 within one bf16 step), and the same steps at B = 2 and 8;
     at head 258 two launches bit-equal, x0, the head and the origin table
     written behind a spin giving the same bits, B identical beams with
     one lineage B bit-equal rows, the step queued (device time, its "ms"
     in the kernels line), the call and host_us, and at B = 5 the plain
     step, the decode_impl step over 5 beams and five K2 steps on the same
     weights (the yardsticks), and the bound and its share; K2's speculative
     verify rows (R = 5 and 8, the verify passes of gamma = 4 and 7) at the
     same width in the four modes on a cache of n_text_ctx + 11 rows: one
     R-row step bit-equal to R one-row K2 steps at heads 126, 448 - R and
     Tc - 8 on the same cache, and at the first two also on a 448-row cache
     (the greedy loop's), logits and cache rows; within K2_TOL of the plain
     R-row step; at head 258 the step queued, the call and host_us against
     R one-row K2 steps, the plain step and the decode_impl step at T = R,
     and the bound;
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
     decode_impl call (prompt ingest: 4 layers x qkv/o/cq/co), by route: the
     encoder's and the decoder calls over more than 16 rows on the tiles,
     the others on the rows (check_k3_routes), K5 4 per
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
     on the seed-0 turbo preset, one 30 s greedy request each (K4 by route,
     then K4 on that plane at one row: queued, the call and host_us), after
     the same request on the dense logits projection and, on the same weights,
     with megakernel=True (K2 dense) and megakernel="int4" (K2 int4); and
     beam_size=5 on the same weights with megakernel=False (decode_impl over
     5 beams) and megakernel="int4" (K7 int4);
  8. narrow q4_0 and q5_0 checkpoints (S = 128: the decoder MLP runs K5)
     through whisper_full on cuda and on cpu, 35 s over two windows: token
     ids equal, at least 100 of them;
  9. a narrow bf16 q8_0 checkpoint with megakernel="int8" (K2 on the card,
     its plain version on the CPU), 35 s: token ids equal, at least 100;
     then K2 alone from one encoder output (EncoderReplay: the card's
     token loop starts from the CPU's encoder output and cross-KV), audio
     seeds 3, 4 and 7: per stream the equal tokens and, where it parts
     before 100, the step and the CPU's top-two gap there (a parting that
     is not a near tie, within K7_ARGMAX_GAP of max|logit|, fails);
 10. beam search (beam_size=3, 40 s) on the card against the CPU: the
     narrow f32 config (decode_impl, the device beam loop's sort, dedupe and
     gathers on the card) with token ids equal, at least 100; and the
     narrow bf16 q8_0 checkpoint with megakernel="int8" (K7 on the card, its
     plain version on the CPU) on three 40 s requests, token ids equal;
     then K7 alone from one encoder output, 90 s requests on audio seeds 3,
     4 and 7, as phase 9's (the parting step: the first whose three best
     ids differ on a beam's row, the gap the least between the CPU's four
     best there);
 11. K6 (the W8A8 matmul) against its plain version, bit for bit, at the
     four encoder linears of large-v3-turbo for one window (M = 1536) and
     a round of eight (M = 12288) and a narrow padding shape; kernel,
     plain, torch._int_mm with the same quantize and scale ops (library)
     and dense bf16 torch.matmul times, cold L2, and the int8 bound;
 12. K1 at B = 8 windows (a batched round's encoder attention);
 13. K8 (the batched-stream step) at large-v3-turbo width, B = 8 streams
     with distinct cross-KV, in the four modes: 8 steps at heads 126-129
     and 254-257 against its plain version (K2_TOL, K7's argmax rule); at
     head 258 two launches bit-equal, x0 and the head written behind a
     spin giving the same bits, eight identical streams eight bit-equal
     rows; the step queued (device time, its "ms" in the kernels line), the call
     and host_us against the plain step, the decode_impl step over 8
     streams and eight K2 steps, and the bound (each stream's cross-KV)
     and its share;
 14. batched serving at full width on the seed-0 turbo preset: the W8A8
     encoder against the dense one (cosine > 0.98, relative error < 0.1)
     and both timed on a round of 8 windows; transcribe_batch of 8 x 30 s
     with the W8A8 encoder and K8 int8 (the main path of the kernels line's
     K6 and K8 launches), with megakernel=False, and with the dense
     encoder; full_parallel of 240 s over 8 chunks; a 30 s whisper_full
     request with the W8A8 encoder; transcribe_batch on the q8_0 checkpoint
     with the W8A8 encoder and K8. Each prints audio seconds per second, ms
     per lockstep step and encoder ms per round, and holds the launch
     counts exact (K6 128 and K1 32 per encoder pass, K8 once per lockstep
     step, K7 never, K2 only in chunks the quality gates send to
     whisper_full);
 15. narrow batched serving on the card against the CPU: f32
     transcribe_batched (token ids equal, at least 100) and the bf16 q8_0
     checkpoint's transcribe_batch with megakernel="int8" (K8 on the card,
     its plain version on the CPU), token ids equal on audio seed 4 (148
     tokens), the first differing token of seed 5 printed (the two
     swapped places with K8 on K2's GEMVs, Q8_BATCH_SEEDS); then, for seeds 4
     and 5, the first-step logits of the card's prompt ingest from the
     CPU's encoder output, copied over, against the CPU's, beside the whole
     card path's (ingest_split); then K8 alone: the same batch with the
     lockstep loop on the card from the CPU's encoder output and cross-KV,
     per stream the equal tokens and where it parts, as phase 9's;
 16. speculative greedy decoding at full width: the q8_0 checkpoint
     (Transcriber(model_path=..., draft_model_path=...)) serves 30 s and
     65 s greedily with K2, then with a q4_0 draft of its own seed-0 tensors
     (gamma 4) and a q8_0 draft of seed-1 tensors (gamma 7), K2 int8 for the
     draft steps and the verify passes (temperature_inc = 0): each
     transcript equal to K2 greedy's token for token, launch counts exact
     (per round gamma + 1 one-row K2 steps and one K2 call at gamma + 1
     rows, verify passes between the live rounds and POLL - 1 more a
     window, prompt ingest through decode_impl, K1/K3/K5 per encoder pass
     and decode_impl call); acceptance, rounds and ms per sampled token
     beside greedy's; the verify launches go to the kernels line as
     mega_decode_step_verify;
 17. narrow speculative decoding on the card against the CPU: bf16 q8_0
     with a q4_0 draft, megakernel="int8", gamma 4, 35 s: token ids equal
     (148), and on the card equal to K2 greedy;
 18. K9b (cross_attention_q8) and K9a (cross_attention_q8_nat) against
     their plain versions at large-v3-turbo width (20 heads, 1500 audio
     positions, bf16, gate 1e-2 of max|ref|): K9b for one row, five rows
     over one shared plane and eight streams, K9a for eight streams on
     1504-row slabs with ta_valid = 1500; and a narrow f32 shape (gate 1e-5);
     kernel (one launch over clusters of key chunks: queued, the call and
     host_us), plain and SDPA over the float cross-KV that int8 replaces
     (CUDA events, cold L2, median of 20), the byte bound and its share;
 19. int8 cross-KV on the q8_0 checkpoint (cross_kv_int8=True,
     temperature_inc = 0): greedy 30 s and 65 s (the K-window loop), 30 s
     with device_windows=1, beam 5 on 30 s, each beside the same request
     with float cross-KV and megakernel=False (ms per sampled token);
     launch counts exact: K9b 4 per one-row decode_impl call, K2 and K7
     never, K3/K5/K1 as phase 6's megakernel=False request;
 20. (inside phase 14) transcribe_batch of 8 x 30 s with the W8A8 encoder
     and cross_kv_int8 (megakernel="int8" asked): K8 never, K9b 4 per
     one-row decode_impl call (every lockstep step), K6 128 per encoder
     pass; audio s per s and ms per lockstep step beside megakernel=False
     with float cross-KV;
 21. K9a on its path: 8 decode_impl steps at B = 8 on the q8_0 decoder
     over QuantKVNat planes against the same steps over QuantKV planes of
     the same cross-KV: logits within 5e-3 of max|ref|, 4 K9a launches per
     step;
 22. narrow f32 (3 decoder layers) with cross_kv_int8 on the card against
     the CPU: greedy 35 s, beam 3 on 40 s, transcribe_batched of 60 s in 2
     chunks: token ids equal, at least 100 each, K9b launched on the card.
 23. T1 (mm_bf16, the bf16 GEMM) and T2 (mm_s8, K6's s8 GEMM alone) of the
     tensor-core probe against their plain versions at its two products,
     (1536,1280)@(1280,5120) and (1536,5120)@(5120,1280), on the probe's
     operands: T1 within one bf16 ulp per element (plus the f32 sum-order
     bound where products cancel), T2 bit for bit; kernel, plain and
     library times (cuBLAS bf16 through torch.mm with f32 out; _int_mm with
     the scale ops), cold L2, the bound and T1's and cuBLAS's shares of the
     bf16 peak; T2 also bit for bit at the 8-window mlp0 and mlp1 products
     on seeded operands; then the port's probe
     (open_whisper_kit_tpu_torch.tools.bench_int8_mxu.main) at full shape,
     the path of T1 and T2, with exact launch counts (two per chained
     iteration per chain call).
Phases 11-13, 18 and 23 run right after phase 3, with the other kernel
checks; 19 and 21 right after 6, on its checkpoint.
Every phase prints ms per sampled token beside its RTF. The last three lines are the kernels JSON, the nvidia-smi name/power line
and {"ok": true, "device": {...}}. Imports nothing of JAX.

    python3 chip_smoke.py --profile

also traces one q8_0 encoder + cross-KV pass of a 30 s window (the
encoder's kernel split), one 30 s greedy request on the q8_0 checkpoint, one beam-5
request on it (K7), one greedy request on the dense preset, one
transcribe_batch of 8 x 30 s (W8A8 encoder, K8 int8) and one call of each
of the tensor-core probe's four chains with torch.profiler
(device busy share, top kernels; tables in chiprun_out/), and in phase 3
five K2 steps per mode at one row and int8 at five and eight
(chiprun_out/k2-stages-*.json: each launch's device time and how many
start before the one in front ends). It is the source of PERF.md's
"Where the time goes".
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
KERNELS = ("mha_packed", "mega_step", "qmm", "qmm_rows", "qmm4", "ffn_int8", "mega_beam",
           "w8a8", "mega_batch", "cross_q8", "mm_bf16")
SRC = "open_whisper_kit_tpu_torch/csrc/"
# H100 SXM published HBM bandwidth (NVIDIA data sheet): the bound of a
# kernel is the larger of its bytes over it and its operations over the
# tensor-core rate of their type (bound())
HBM_BYTES_PER_S = 3.35e12
F32_PEAK = 67e12   # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
TF32_PEAK = 495e12   # H100 SXM dense TF32 on the tensor cores (NVIDIA data sheet)


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


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None,
            queued: bool = False) -> float:
    """Median device time of fn() in ms over `reps` launches. `flush`, a
    tensor larger than the L2 cache, is overwritten before each timed
    launch (outside the timed span), so fn reads its inputs from HBM as a
    caller streaming many weights does. The span starts when the card
    reaches it: a call whose host side (the wrapper's checks, allocations
    and launches) outlasts its kernels is timed with that host time in it.
    `queued` puts a 1 ms spin on the card before the span, so the host
    has issued fn's launches before the span starts: the span then holds
    the kernels and the gaps between them only."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if queued:
            torch.cuda._sleep(2_000_000)     # about 1 ms at the H100's clock
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(torch, fn, reps: int = 50) -> float:
    """Median µs of host time one call of fn() takes to return (its checks
    and launches), each call made on an idle card (a synchronize between
    calls, outside the timed span)."""
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


# K2's 33 launches of one large-v3-turbo step, in chain order
K2_STAGES = [f"L{il} {s}" for il in range(4) for s in (
    "qkv", "self-attend", "o", "cq", "cross-attend", "co", "mlp0", "mlp1")] + ["logits"]


def k2_stage_trace(torch, tag: str, fn, steps: int = 5) -> dict:
    """`steps` calls of fn() (one K2 step each), queued behind a spin, under
    torch.profiler: from the trace's kernel rows (chrome trace, written to
    chiprun_out/k2-stages-<tag>.json), each launch of the last step in chain
    order with its device µs, the chain's span from the first start to the
    last end, and how many launches start before the one in front of them
    has ended (the dependent launches' overlap)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / f"k2-stages-{tag}.json"
    prof.export_chrome_trace(str(path))
    kern = sorted((e for e in json.loads(path.read_text()).get("traceEvents", [])
                   if e.get("cat") == "kernel" and ("gemv" in e.get("name", "")
                                                    or "attend" in e.get("name", ""))),
                  key=lambda e: e["ts"])
    n = len(K2_STAGES)
    last = kern[-n:] if len(kern) >= n else []
    if not last:
        return {"stages": [], "span_us": None, "overlapping": None}
    stages = [{"stage": name, "us": e["dur"]} for name, e in zip(K2_STAGES, last)]
    overlap = sum(b["ts"] < a["ts"] + a["dur"] for a, b in zip(last, last[1:]))
    span = last[-1]["ts"] + last[-1]["dur"] - last[0]["ts"]
    return {"stages": stages, "span_us": span, "overlapping": overlap}


def bound(nbytes: float, flops: float, rate: str | float = "bf16") -> tuple[float, str]:
    """(least ms the card could take, what bounds it); `rate` the peak of
    the operations' type: "bf16" or "int8", the H100's dense tensor-core
    peaks as the tensor-core probe states them, or a number."""
    from open_whisper_kit_tpu_torch.tools import bench_int8_mxu as P
    rate = {"bf16": P.BF16_PEAK, "int8": P.INT8_PEAK}.get(rate, rate)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
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


def phase_k1(torch, A, dtype, S: int, tol_rel: bool, tol: float, seed: int, B: int = 1,
             tag: str = "3"):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, 1536, S, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    n_head, scale, n_valid = S // 64, 0.125, 1500
    ref = A.mha_plain(q, k, v, n_head, scale, n_valid)
    out = A.mha_packed(q, k, v, scale, n_valid)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    limit = tol * ref_max if tol_rel else tol
    print(f"[{tag}] K1 {dtype} ({B},1536,{S}) n_valid={n_valid}: max|err| {err:.3e} "
          f"max|ref| {ref_max:.3e} limit {limit:.3e}", flush=True)
    check(bool(torch.isfinite(out).all()) and err <= limit,
          f"K1 {dtype} S={S} disagrees with its plain version")
    kern = cuda_ms(torch, lambda: A.mha_packed(q, k, v, scale, n_valid))
    plain = cuda_ms(torch, lambda: A.mha_plain(q, k, v, n_head, scale, n_valid))
    # the yardstick: SDPA on the head-major layout it takes, same mask
    qh, kh, vh = (t.view(B, 1536, n_head, 64).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    mask = (torch.arange(1536, device="cuda") < n_valid)[None, None, None, :]
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale))
    # QK^T and PV over the live keys; q/k/v read once, out written once; f32
    # operations at the H100's f32 (non-tensor) peak, bf16 at its tensor peak
    flops = 4 * B * 1536 * n_valid * S
    b_ms, b_by = bound(nbytes(q, k, v, out), flops,
                       F32_PEAK if dtype == torch.float32 else "bf16")
    if dtype == torch.float32:
        # the f32 body's own work: the same products in 3xTF32, three TF32
        # products each, at the tensor cores' TF32 peak
        tf32_ms, _ = bound(nbytes(q, k, v, out), 3 * flops, TF32_PEAK)
        print(f"[{tag}]   kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us, SDPA "
              f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), {100 * b_ms / kern:.1f} "
              f"% of it; 3xTF32 bound {tf32_ms * 1e3:.1f} us (median of 20)", flush=True)
        return {"shape": f"({B},1536,{S}) f32, {n_valid} keys", "max_abs_err": err,
                "ms": kern, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib, "bound_share": b_ms / kern, "tf32x3_bound_ms": tf32_ms}
    # the bf16 kernel's own work: QK^T twice (the TPU kernel's rounding point
    # needs the row sums before P is rounded), then PV
    two_ms, _ = bound(nbytes(q, k, v, out), 1.5 * flops)
    tflops = 1.5 * flops / (kern * 1e-3) / 1e12
    print(f"[{tag}]   kernel {kern * 1e3:.1f} us, plain {plain * 1e3:.1f} us, SDPA "
          f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), two-pass bound "
          f"{two_ms * 1e3:.1f} us, {tflops:.0f} TFLOP/s of two-pass work (median of 20)",
          flush=True)
    return {"max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib, "two_pass_bound_ms": two_ms,
            "tflops": tflops}


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
    ("qmm4", "W4 logits, 5 rows", 5, 1280, 51866),
    ("qmm4", "W4 logits, 8 rows", 8, 1280, 51866),
    ("ffn_int8", "decoder MLP, 1 row", 1, 1280, 5120),
    ("ffn_int8", "decoder MLP, 5 rows", 5, 1280, 5120),
    ("ffn_int8", "decoder MLP, 8 rows", 8, 1280, 5120),
    ("ffn_int8", "decoder MLP, 16 rows", 16, 1280, 5120),
]


def phase_quant_kernels(torch, Q):
    """Each shape: kernel against plain (gate 1e-3 * max|ref|), times of
    the kernel, the plain version and the library yardstick with the L2
    cache flushed before each launch (on the decode path every weight
    plane arrives cold), and the bound. The bound counts the logical N
    columns only: the planes' padding to a multiple of 128 is zeros that
    the function does not need. K3's rows-route shapes (M <= 16, kernel
    "qmm_rows") are also timed queued behind a spin (cuda_ms's `queued`:
    the device time without the wrapper's host time) for the kernel and the
    library call, and two launches must give the same bits; so are K5's
    (on the rows body at these rows since PR 15: two launches, the second a
    dependent launch). Returns {kernel: [per-shape dicts]}; a rows-route
    dict's "ms" and "library_ms" are the queued times, "ms_unqueued" and
    "library_ms_unqueued" the others."""
    g = torch.Generator(device="cuda").manual_seed(0)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def weight(K, N):
        return torch.randn(K, N, generator=g, device="cuda") * K ** -0.5

    out = {name: [] for name in ("qmm", "qmm_rows", "qmm4", "ffn_int8")}
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
        row = {"shape": f"{label}: M={M} K={K} N={N}", "max_abs_err": err,
               "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms}
        lib_txt = f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none"
        print(f"[3] {name} {label} (M={M}, K={K}, N={N}): max|err| {err:.3e} "
              f"(max|ref| {ref_max:.3e}); kernel {k_ms * 1e3:.1f} us, plain "
              f"{p_ms * 1e3:.1f} us, library {lib_txt}, bound {b_ms * 1e3:.1f} us "
              f"({b_by}), {100 * b_ms / k_ms:.1f} % of the bound", flush=True)
        if name == "qmm" and Q.qmm_route(M) == "rows":
            name = "qmm_rows"
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"qmm rows route ({label}): two launches differ")
            kq_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush, queued=True)
            lq_ms = cuda_ms(torch, lib_fn, flush=l2_flush, queued=True)
            plan = Q.qmm_rows_plan(M, K, args[1].shape[1])
            row.update(ms=kq_ms, library_ms=lq_ms, ms_unqueued=k_ms, library_ms_unqueued=l_ms,
                       bound_share=b_ms / kq_ms, splits=plan.splits, blocks=plan.blocks)
            print(f"[3]   qmm rows route, queued (device time): kernel {kq_ms * 1e3:.1f} us, "
                  f"torch.matmul {lq_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us, "
                  f"{100 * b_ms / kq_ms:.1f} % of the bound; kernel / matmul "
                  f"{kq_ms / lq_ms:.2f}; {plan.splits} splits, {plan.blocks} blocks; two "
                  "launches bit-equal", flush=True)
            del again
        elif name == "qmm4" and Q.qmm_route(M) == "rows":
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"qmm4 rows body ({label}): two launches differ")
            kq_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush, queued=True)
            lq_ms = cuda_ms(torch, lib_fn, flush=l2_flush, queued=True)
            h_us = host_us(torch, lambda: kern(*args))
            plan = Q.qmm4_rows_plan(M, K, args[1].shape[1])
            row.update(ms=kq_ms, call_ms=k_ms, host_us=h_us, library_ms=lq_ms,
                       library_ms_unqueued=l_ms, bound_share=b_ms / kq_ms,
                       body="rows: qmm_rows.cuh with the int4 stage", splits=plan.splits,
                       blocks=plan.blocks)
            print(f"[3]   qmm4 on the rows body, queued (device time): kernel {kq_ms * 1e3:.1f} "
                  f"us, the call {k_ms * 1e3:.1f} us, host {h_us:.1f} us, torch.matmul "
                  f"{lq_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us, {100 * b_ms / kq_ms:.1f} % of "
                  f"the bound; {plan.splits} split(s), {plan.blocks} blocks; two launches "
                  "bit-equal", flush=True)
            del again
        elif name == "ffn_int8" and Q.ffn_int8_route(M) == "rows":
            again = kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"ffn_int8 ({label}): two launches differ")
            kq_ms = cuda_ms(torch, lambda: kern(*args), flush=l2_flush, queued=True)
            plan = Q.ffn_int8_rows_plan(M, K, N, args[4].shape[1])
            row.update(ms=kq_ms, ms_unqueued=k_ms, bound_share=b_ms / kq_ms,
                       body="rows: qmm_rows.cuh twice, the second a dependent launch",
                       splits=[plan.up.splits, plan.down.splits],
                       blocks=[plan.up.blocks, plan.down.blocks])
            print(f"[3]   ffn_int8 on the rows body, queued (device time): kernel "
                  f"{kq_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us, "
                  f"{100 * b_ms / kq_ms:.1f} % of the bound; splits {plan.up.splits} / "
                  f"{plan.down.splits}, blocks {plan.up.blocks} / {plan.down.blocks}; two "
                  "launches bit-equal", flush=True)
            del again
        out[name].append(row)
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


def k2_bytes_ops(MK, mp, cfg, n_keys: int, Ta: int, rows: int = 1,
                 cross_streams: int = 1, self_shared: bool = False) -> tuple[int, int]:
    """Bytes a step over `rows` rows must move (every plane on its logical
    columns with its scales, biases and layernorm rows, the cross-KV (one,
    or one per stream: `cross_streams`), the self-KV rows each row attends
    (`self_shared`: the rows are consecutive tokens of one stream, whose
    n_keys rows are read once for all), x0 and the logits, each once) and
    its operations (2 per weight per row, and QK^T and P.V over the self
    and cross keys per row)."""
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
    self_rows = n_keys if self_shared else rows * n_keys
    moved += L * 2 * (cross_streams * Ta + self_rows) * S * 2 + rows * (S * 2 + V * 4)
    ops = rows * (2 * weights + L * 4 * (n_keys + Ta) * S)
    return moved, ops


def phase_k2(torch, TM, MK, Q, profiling: bool = False):
    """K2 at large-v3-turbo width in each mode: K2_STEPS consecutive steps
    from a cache holding K2_HISTORY rows, each kernel step against the
    plain step on the same inputs (logits and the new cache rows within
    K2_TOL of max|ref|), and two launches from the same inputs bit-equal;
    times with a cold L2 cache of the kernel step queued behind a spin (its
    device time, "ms"), of the call with its host time ("call_ms"), of the
    plain step and the decode_impl step (the yardstick); the host's time to
    issue one step ("host_us"); the bound. With `profiling`, each launch's
    device time in a traced step (k2_stage_trace). Returns {mode: row}.
    K2's "ms" in the kernels line is this queued device time; the kernels
    lines of older trees held the call, host time included, under that key
    (now "call_ms")."""
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
        # two launches from the same inputs: the same bits (no float atomics;
        # the splits and the key chunks combine in a fixed order)
        twice = []
        for _ in range(2):
            kk.copy_(pk)
            kv.copy_(pv)
            twice.append((MK.mega_decode_step(cfg, mp, x0, kk[:, 0], kv[:, 0], head,
                                              xk[:, 0], xv[:, 0])[0], kk.clone(), kv.clone()))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(*twice)),
              f"K2 {mode}: two launches from the same inputs differ")
        del twice
        tok = toks[:1, None]

        def step():
            return MK.mega_decode_step(cfg, mp, x0, kk[:, 0], kv[:, 0], head, xk[:, 0],
                                       xv[:, 0])
        kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
        k_ms = cuda_ms(torch, step, flush=l2_flush)
        h_us = host_us(torch, step)
        stages = k2_stage_trace(torch, f"{mode}-1", step) if profiling else None
        p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_plain(
            cfg, mp, x0, pk[:, 0], pv[:, 0], head, xk[:, 0], xv[:, 0]), flush=l2_flush)
        y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, pk, pv, head, xk, xv),
                       flush=l2_flush)
        moved, ops = k2_bytes_ops(MK, mp, cfg, K2_HISTORY + K2_STEPS + 1, Ta)
        b_ms, b_by = bound(moved, ops)
        out[mode] = {"mode": mode, "max_abs_err": err, "max_ref": ref_max,
                     "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err,
                     "two_launches_bit_equal": True, "ms": kq_ms, "call_ms": k_ms,
                     "host_us": h_us, "plain_ms": p_ms, "decode_impl_ms": y_ms,
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                     "bound_share": b_ms / kq_ms, "bytes": moved}
        if stages is not None:
            out[mode]["stage_trace"] = stages
        print(f"[3] K2 {mode}: {K2_STEPS} steps, logits max|err| {err:.3e} (max|ref| "
              f"{ref_max:.3e}), cache rows {cache_err:.3e} of max (by layer "
              f"{', '.join(f'{x:.1e}' for x in layer_err)}), two launches bit-equal; step "
              f"queued (device time) {kq_ms * 1e3:.1f} us, {100 * b_ms / kq_ms:.1f} % of the "
              f"bound; the call {k_ms * 1e3:.1f} us, host {h_us:.1f} us; plain "
              f"{p_ms * 1e3:.1f} us, decode_impl step {y_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)", flush=True)
        if stages is not None and stages["stages"]:
            print(f"[3]   K2 {mode} traced stages (device us): " + ", ".join(
                f"{r['stage']} {r['us']:.1f}" for r in stages["stages"])
                + f"; chain span {stages['span_us']:.1f} us, {stages['overlapping']} of "
                f"{len(stages['stages']) - 1} launches start before the one in front ends",
                flush=True)
        del dec, ydec, mp, kk, kv, pk, pv
        torch.cuda.empty_cache()
    del l2_flush, hist, xk, xv
    torch.cuda.empty_cache()
    return out


K7_BEAMS = 5
K7_MORE_BEAMS = (2, 8)   # phase 3 also checks and times K7 at these B
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


def k7_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv, origin) -> None:
    """K7's fixed-order checks on the card at one head (kk, kv restored
    after): two launches from the same inputs bit-equal; x0, the head and
    the origin table written behind a 2 ms spin (other values in their
    tensors until it ends) giving those bits, so no launch of the chain
    reads the step's data, the lineage included, before its wait; B
    identical beams (beam 0's token and one lineage, beam 0's) giving B
    bit-equal logits and cache rows."""
    B = x0.shape[0]
    ht = torch.tensor(head, device="cuda")
    k0, v0 = kk.clone(), kv.clone()
    runs = []
    for spun in (False, False, True):
        kk.copy_(k0)
        kv.copy_(v0)
        x, h, o = x0, ht, origin
        if spun:
            x, h = torch.full_like(x0, float("nan")), torch.tensor(3, device="cuda")
            o = (origin + 1) % B
            torch.cuda.synchronize()
            torch.cuda._sleep(4_000_000)
            x.copy_(x0)
            h.copy_(ht)
            o.copy_(origin)
        runs.append((MK.mega_decode_step_beam(cfg, mp, x, kk, kv, h, xk, xv, origin=o)[0],
                     kk.clone(), kv.clone()))
        torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])),
          f"K7 {mode}, B={B}: two launches from the same inputs differ")
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[2])),
          f"K7 {mode}, B={B}: x0, head and origin written behind a spin change the result")
    del runs
    one = origin[:1].expand(B, -1).contiguous()
    one[:, head] = torch.arange(B, device="cuda")
    kk.copy_(k0)
    kv.copy_(v0)
    got = MK.mega_decode_step_beam(cfg, mp, x0[:1].expand(B, -1).contiguous(), kk, kv, ht, xk,
                                   xv, origin=one)[0]
    torch.cuda.synchronize()
    rows = [t[:, head * B:(head + 1) * B] for t in (kk, kv)]
    check(all(torch.equal(got[b], got[0]) for b in range(1, B))
          and all(torch.equal(r[:, b], r[:, 0]) for r in rows for b in range(1, B)),
          f"K7 {mode}, B={B}: {B} identical beams with one lineage give rows that differ")
    kk.copy_(k0)
    kv.copy_(v0)
    del got, one


def phase_k7(torch, TM, MK, Q):
    """K7 at large-v3-turbo width, B = K7_BEAMS (and K7_MORE_BEAMS), in each
    mode: the steps of K7_STEPS from a cache whose slot 0 holds K2_HISTORY
    prompt rows and whose later rows hold random K/V with a random lineage,
    each kernel step against the plain step on the same inputs (logits
    within K2_TOL of max|ref|; the same argmax per beam, or a token whose
    plain logit lies within K7_ARGMAX_GAP * max|ref| of the best; the new
    cache rows of layer 0 within one bf16 step, every layer within K2_TOL;
    every other row untouched); at the head after the last step two
    launches bit-equal, the step's data written behind a spin giving the
    same bits and B identical beams B bit-equal rows (k7_bit_checks); times
    with a cold L2 cache of the kernel step queued behind a spin (its
    device time, "ms"), of the call with its host time ("call_ms"), the
    host's time to issue one step ("host_us"), and at B = K7_BEAMS of the
    plain step, the decode_impl step over B beams and B K2 steps (the
    yardsticks: no single library call computes a beam step); the bound
    and its share of the device time. Returns {(mode, B): row}. K7's "ms"
    in the kernels line is this queued device time; the kernels lines of
    trees whose K7 ran on mega_rows.cuh held the call, host time included,
    under that key (now "call_ms")."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Tc, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx, cfg.n_audio_ctx
    T0, T1 = K2_HISTORY, K7_STEPS[-1][0] + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        for B in (K7_BEAMS, *K7_MORE_BEAMS):
            # the time-major beam cache: a prompt of T0 rows ingested in slot 0,
            # then every slot's rows up to T1
            hist = torch.zeros(2, L, Tc, B, S, dtype=torch.bfloat16, device="cuda")
            hist[:, :, :T0, 0] = (torch.randn(2, L, T0, S, generator=g, device="cuda") * 0.5
                                  ).to(torch.bfloat16)
            hist[:, :, T0:T1] = (torch.randn(2, L, T1 - T0, B, S, generator=g, device="cuda")
                                 * 0.5).to(torch.bfloat16)
            hist = hist.reshape(2, L, Tc * B, S)
            origin = torch.where(torch.arange(Tc, device="cuda")[None] < T0, 0,
                                 torch.arange(B, device="cuda")[:, None])
            origin[:, T0:T1] = torch.randint(0, B, (B, T1 - T0), generator=g, device="cuda")
            kk, kv, pk, pv = (hist[i % 2].clone() for i in range(4))
            del hist
            toks = torch.randint(0, cfg.n_vocab, (len(K7_STEPS), B), generator=g, device="cuda")
            err = ref_max = cache_err = flip_gap = 0.0
            n_flip = 0
            layer_err = [0.0] * L
            for i, (head, src) in enumerate(K7_STEPS):
                if src is not None:   # K7_BEAMS' sources; other B continue the same ones
                    origin = origin[torch.tensor([(src[b % K7_BEAMS] + b // K7_BEAMS) % B
                                                  for b in range(B)], device="cuda")]
                origin[:, head] = torch.arange(B, device="cuda")
                kk.copy_(pk)
                kv.copy_(pv)
                x0 = (dec["te"][toks[i]] + dec["pe"][head]).to(torch.bfloat16)
                ht = torch.tensor(head, device="cuda")
                ref, _, _ = MK.mega_decode_step_beam_plain(cfg, mp, x0, pk, pv, ht, xk, xv,
                                                           origin)
                got, _, _ = MK.mega_decode_step_beam(cfg, mp, x0, kk, kv, ht, xk, xv,
                                                     origin=origin)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all())
                      and got.shape == ref.shape == (B, cfg.n_vocab),
                      f"K7 {mode}, B={B}: non-finite or misshapen logits")
                e, m = (got - ref).abs().max().item(), ref.abs().max().item()
                check(e <= K2_TOL * m, f"K7 {mode}, B={B}, step {i} (head {head}): logits "
                      f"differ from the plain version: {e:.3e} > {K2_TOL} * {m:.3e}")
                # the two sum in other f32 orders, so a random-weight row whose two
                # best logits are nearly tied may pick the other of them
                pick, best = got.argmax(1), ref.argmax(1)
                gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
                check(bool((gap <= K7_ARGMAX_GAP * m).all()),
                      f"K7 {mode}, B={B}, step {i} (head {head}): argmax {pick.tolist()} "
                      f"against {best.tolist()}, plain-logit gaps {gap.tolist()} > "
                      f"{K7_ARGMAX_GAP} * {m:.3e}")
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
                          f"K7 {mode}, B={B}: cache rows other than the written ones changed")
            # one bf16 step of the largest value: 2^-7 of it
            check(layer_err[0] <= 2 ** -7 and cache_err <= K2_TOL,
                  f"K7 {mode}, B={B}: new cache rows differ from the plain version (by "
                  f"layer {layer_err} of their max)")
            head = T1
            ht = torch.tensor(head, device="cuda")
            origin[:, head] = torch.arange(B, device="cuda")
            x0 = (dec["te"][toks[0]] + dec["pe"][head]).to(torch.bfloat16)
            k7_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv, origin)

            def step():
                return MK.mega_decode_step_beam(cfg, mp, x0, kk, kv, ht, xk, xv, origin=origin)
            kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
            k_ms = cuda_ms(torch, step, flush=l2_flush)
            h_us = host_us(torch, step)
            # each beam reads one row per time step, its lineage's slot, and
            # its origin entries
            moved, ops = k2_bytes_ops(MK, mp, cfg, head + 1, Ta, rows=B)
            moved += B * (head + 1) * 8
            b_ms, b_by = bound(moved, ops)
            row = {"mode": mode, "beams": B, "heads": [h for h, _ in K7_STEPS],
                   "timed_head": head, "max_abs_err": err, "max_ref": ref_max,
                   "argmax_near_tie_flips": n_flip, "argmax_flip_gap_rel": flip_gap,
                   "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err,
                   "two_launches_bit_equal": True, "spun_inputs_bit_equal": True,
                   "identical_beams_bit_equal": True,
                   "ms": kq_ms, "call_ms": k_ms, "host_us": h_us, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / kq_ms,
                   "bytes": moved}
            yard = ""
            if B == K7_BEAMS:
                p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_beam_plain(
                    cfg, mp, x0, pk, pv, ht, xk, xv, origin), reps=5, warmup=1, flush=l2_flush)
                # decode_impl over B beams on natural (L, B, Tc, S) caches, the
                # batch-1 cross-KV serving every beam, and B single-row K2 steps
                nk, nv = (t.reshape(L, Tc, B, S).transpose(1, 2).contiguous()
                          for t in (pk, pv))
                tok = toks[0][:, None]
                y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, nk, nv, ht,
                                                             xk[:, None], xv[:, None]),
                               flush=l2_flush)
                k2c = [(nk[:, b].contiguous(), nv[:, b].contiguous()) for b in range(B)]

                def k2_steps():
                    for b in range(B):
                        MK.mega_decode_step(cfg, mp, x0[b:b + 1], k2c[b][0], k2c[b][1], ht,
                                            xk, xv)
                k2_ms = cuda_ms(torch, k2_steps, flush=l2_flush)
                row.update(plain_ms=p_ms, decode_impl_ms=y_ms, k2_x5_ms=k2_ms)
                yard = (f"; plain {p_ms * 1e3:.1f} us, decode_impl B={B} step "
                        f"{y_ms * 1e3:.1f} us, {B} K2 steps {k2_ms * 1e3:.1f} us")
                del nk, nv, k2c
            out[(mode, B)] = row
            print(f"[3] K7 {mode}, B={B}: {len(K7_STEPS)} steps at heads "
                  f"{', '.join(str(h) for h, _ in K7_STEPS)}, logits max|err| {err:.3e} "
                  f"(max|ref| {ref_max:.3e}), argmax differs on {n_flip} of "
                  f"{len(K7_STEPS) * B} rows (near-ties, plain gaps up to {flip_gap:.2e} of "
                  f"max|ref|), cache rows {cache_err:.3e} of max (by layer "
                  f"{', '.join(f'{x:.1e}' for x in layer_err)}); two launches, spun inputs "
                  f"and {B} identical beams bit-equal; at head {head}: step queued (device "
                  f"time) {kq_ms * 1e3:.1f} us, {100 * b_ms / kq_ms:.1f} % of the bound; the "
                  f"call {k_ms * 1e3:.1f} us, host {h_us:.1f} us{yard}; bound "
                  f"{b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)", flush=True)
            del kk, kv, pk, pv, origin
            torch.cuda.empty_cache()
        del dec, ydec, mp
        torch.cuda.empty_cache()
    del l2_flush, xk, xv
    torch.cuda.empty_cache()
    return out


# K2's verify rows in phase 3: R = 5 and 8, the verify passes of gamma = 4
# and 7, on a cache of n_text_ctx + K2V_PAD rows (the speculative loop's
# n_text_ctx + gamma + 4 at gamma = 7)
K2V_ROWS = (5, 8)
K2V_PAD = 7 + 4
K2V_TIMED_HEAD = 258


def phase_k2_verify(torch, TM, MK, Q, profiling: bool = False):
    """K2's speculative verify rows at large-v3-turbo width in each mode, R
    in K2V_ROWS: from a cache of Tc = n_text_ctx + K2V_PAD rows (the
    speculative loop's) holding `head` rows of random history, one R-row
    step against R one-row K2 steps at head, head + 1, ... on the same
    cache (logits and every cache row bit for bit), against R one-row steps
    on an n_text_ctx-row cache (the greedy loop's; logits and rows bit for
    bit) where the rows fit there, and against the plain R-row step (logits
    and the new cache rows within K2_TOL of max|ref|), at heads 126,
    n_text_ctx - R and Tc - 8; times at head K2V_TIMED_HEAD of the R-row step, the plain
    step, R one-row K2 steps and the decode_impl step at T = R (the
    yardsticks; no single library call computes a step) with a cold L2
    cache; the bound. Returns {(mode, R): row}."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_audio_ctx
    Tc = cfg.n_text_ctx + K2V_PAD
    g = torch.Generator(device="cuda").manual_seed(3)
    xk, xv = ((torch.randn(L, 1, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, 1, Tc, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    pos_max = torch.tensor(cfg.n_text_ctx - 1, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)

        def rows_at(head, R):
            # token + position rows; positions past the table clamp, as JAX's gather
            toks = torch.randint(0, cfg.n_vocab, (R,), generator=g, device="cuda")
            pos = torch.minimum(head + torch.arange(R, device="cuda"), pos_max)
            return (dec["te"][toks] + dec["pe"].index_select(0, pos)).to(torch.bfloat16)

        def caches(head):
            c = hist.clone()
            c[:, :, :, head:] = 0
            return c[0], c[1]
        n_ctx = cfg.n_text_ctx

        def one_row_steps(x0, head, k, v):
            return torch.cat([MK.mega_decode_step(
                cfg, mp, x0[r:r + 1], k[:, 0], v[:, 0], torch.tensor(head + r, device="cuda"),
                xk[:, 0], xv[:, 0])[0] for r in range(x0.shape[0])])
        for R in K2V_ROWS:
            err = ref_max = cache_err = 0.0
            heads = (126, n_ctx - R, Tc - 8)
            for head in heads:
                ht = torch.tensor(head, device="cuda")
                x0 = rows_at(head, R)
                (vk, vv), (sk, sv), (pk, pv) = caches(head), caches(head), caches(head)
                got, _, _ = MK.mega_decode_step(cfg, mp, x0, vk[:, 0], vv[:, 0], ht,
                                                xk[:, 0], xv[:, 0])
                seq = one_row_steps(x0, head, sk, sv)
                ref, _, _ = MK.mega_decode_step_plain(cfg, mp, x0, pk[:, 0], pv[:, 0], ht,
                                                      xk[:, 0], xv[:, 0])
                if head + R <= n_ctx:   # the greedy loop's cache
                    gk, gv = (c[:, :, :n_ctx].contiguous() for c in caches(head))
                    greedy = one_row_steps(x0, head, gk, gv)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()) and got.shape == ref.shape
                      == (R, cfg.n_vocab), f"K2 verify {mode} R={R}: non-finite or "
                      "misshapen logits")
                check(torch.equal(got, seq) and torch.equal(vk, sk) and torch.equal(vv, sv),
                      f"K2 verify {mode} R={R} head {head}: not bit-equal to {R} one-row "
                      f"K2 steps (logits max|diff| {(got - seq).abs().max().item():.3e})")
                if head + R <= n_ctx:
                    check(torch.equal(got, greedy) and torch.equal(vk[:, :, :n_ctx], gk)
                          and torch.equal(vv[:, :, :n_ctx], gv),
                          f"K2 verify {mode} R={R} head {head}: not bit-equal to {R} "
                          f"one-row K2 steps on a {n_ctx}-row cache (logits max|diff| "
                          f"{(got - greedy).abs().max().item():.3e})")
                e, m = (got - ref).abs().max().item(), ref.abs().max().item()
                check(e <= K2_TOL * m, f"K2 verify {mode} R={R} head {head}: logits differ "
                      f"from the plain version: {e:.3e} > {K2_TOL} * {m:.3e}")
                err, ref_max = max(err, e), max(ref_max, m)
                rows = slice(head, min(head + R, Tc))
                for a, b in ((vk, pk), (vv, pv)):
                    ra, rb = a[:, 0, rows].float(), b[:, 0, rows].float()
                    cache_err = max(cache_err, ((ra - rb).abs().max() / rb.abs().max()).item())
                    check(torch.equal(a[:, :, :head], b[:, :, :head]),
                          f"K2 verify {mode}: history rows changed")
            check(cache_err <= K2_TOL, f"K2 verify {mode} R={R}: new cache rows differ "
                  f"from the plain version ({cache_err:.3e} of their max)")
            head = K2V_TIMED_HEAD
            ht = torch.tensor(head, device="cuda")
            x0 = rows_at(head, R)
            (vk, vv), (pk, pv) = caches(head), caches(head)
            tok = torch.randint(0, cfg.n_vocab, (1, R), generator=g, device="cuda")
            def step():
                return MK.mega_decode_step(cfg, mp, x0, vk[:, 0], vv[:, 0], ht, xk[:, 0],
                                           xv[:, 0])
            kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
            k_ms = cuda_ms(torch, step, flush=l2_flush)
            h_us = host_us(torch, step)
            stages = (k2_stage_trace(torch, f"{mode}-{R}", step)
                      if profiling and mode == "all" else None)

            s_ms = cuda_ms(torch, lambda: one_row_steps(x0, head, vk, vv), flush=l2_flush)
            p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_plain(
                cfg, mp, x0, pk[:, 0], pv[:, 0], ht, xk[:, 0], xv[:, 0]), flush=l2_flush)
            y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, pk, pv, ht, xk, xv),
                           flush=l2_flush)
            moved, ops = k2_bytes_ops(MK, mp, cfg, head + R, Ta, rows=R, self_shared=True)
            b_ms, b_by = bound(moved, ops)
            out[(mode, R)] = {
                "mode": mode, "rows": R, "heads": list(heads), "cache_rows": Tc,
                "timed_head": head, "bit_equal_to_one_row_steps": True,
                "max_abs_err": err, "max_ref": ref_max, "cache_rel_err": cache_err,
                "ms": kq_ms, "call_ms": k_ms, "host_us": h_us, "plain_ms": p_ms,
                "one_row_steps_ms": s_ms, "decode_impl_ms": y_ms, "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / kq_ms,
                "bytes": moved}
            if stages is not None:
                out[(mode, R)]["stage_trace"] = stages
            print(f"[3] K2 verify {mode}, R={R}: bit-equal to {R} one-row K2 steps at heads "
                  f"{', '.join(map(str, heads))} (cache {Tc} rows; and on a {n_ctx}-row "
                  f"cache at heads {heads[0]} and {heads[1]}); logits max|err| against the plain "
                  f"version {err:.3e} (max|ref| {ref_max:.3e}), cache rows {cache_err:.3e} "
                  f"of max; at head {head}: step queued (device time) {kq_ms * 1e3:.1f} us, "
                  f"{100 * b_ms / kq_ms:.1f} % of the bound; the call {k_ms * 1e3:.1f} us, host "
                  f"{h_us:.1f} us; {R} one-row steps "
                  f"{s_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, decode_impl T={R} "
                  f"{y_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}, "
                  f"{moved / 1e6:.1f} MB)", flush=True)
        del dec, ydec, mp
        torch.cuda.empty_cache()
    del l2_flush, hist, xk, xv
    torch.cuda.empty_cache()
    return out


# (what large-v3-turbo runs K6 on, M, K, N): the four encoder linears of one
# 30 s window (M = 1536) and of a batched round of eight (M = 12288), and
# the narrow padding shape
K6_SHAPES = [(f"{label}, {rows}", m, k, n)
             for rows, m in (("1 window", 1536), ("8 windows", 12288))
             for label, k, n in (("qkv", 1280, 3840), ("o", 1280, 1280),
                                 ("mlp0", 1280, 5120), ("mlp1", 5120, 1280))] + [
    ("narrow padding", 13, 32, 72)]
K6_HEADLINE = "mlp0, 8 windows"


def phase_k6(torch, E8):
    """K6 against its plain version at K6_SHAPES, bit for bit (the bf16
    input of the turbo encoder; the wide-K mlp1 input as the encoder gives
    it, rounded to bf16); times with the L2 cache flushed before each launch
    of the kernel, the plain version, torch._int_mm with the same quantize
    and scale ops around it (the library yardstick: the same function), and
    the dense bf16 torch.matmul the W8A8 layer replaces, each queued behind
    a spin (device time; since PR 15, unqueued before); the bound (int8
    operations at 1979 TOP/s, or the bytes). Returns the per-shape rows."""
    g = torch.Generator(device="cuda").manual_seed(11)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for label, M, K, N in K6_SHAPES:
        x = torch.randn(M, K, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
        wq, ws = E8.quantize_w_cols(w)
        wq_t = wq.t().contiguous()
        ref = E8.w8a8_mm_plain(x, wq_t, ws)
        got = E8.w8a8_mm(x, wq_t, ws)
        torch.cuda.synchronize()
        n_diff = int((got.float() != ref.float()).sum())
        err = (got.float() - ref.float()).abs().max().item()
        check(got.shape == ref.shape == (M, N) and n_diff == 0,
              f"K6 {label} (M={M}, K={K}, N={N}): {n_diff} of {got.numel()} values "
              f"differ from the plain version (max|err| {err:.3e})")
        k_ms = cuda_ms(torch, lambda: E8.w8a8_mm(x, wq_t, ws), flush=l2_flush, queued=True)
        p_ms = cuda_ms(torch, lambda: E8.w8a8_mm_plain(x, wq_t, ws), flush=l2_flush,
                       queued=True)

        def int_mm():
            xq, xs = E8.quantize_act_rows(x)
            return ((torch._int_mm(xq, wq_t.t()).float() * xs) * ws).to(torch.bfloat16)
        l_ms = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            check(torch.equal(int_mm(), ref), f"K6 {label}: the _int_mm yardstick differs")
            l_ms = cuda_ms(torch, int_mm, flush=l2_flush, queued=True)
        wd = w.to(torch.bfloat16)
        d_ms = cuda_ms(torch, lambda: torch.matmul(x, wd), flush=l2_flush, queued=True)
        b_ms, b_by = bound(nbytes(x, wq, ws, got), 2 * M * K * N, "int8")
        rows.append({"shape": f"{label}: M={M} K={K} N={N}", "max_abs_err": err,
                     "values_differing": n_diff, "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "dense_bf16_ms": d_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
        lib_txt = f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none"
        print(f"[11] K6 {label} (M={M}, K={K}, N={N}): bit-equal to plain; kernel "
              f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, _int_mm + quantize/scale "
              f"{lib_txt}, dense bf16 matmul {d_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us "
              f"({b_by}), {100 * b_ms / k_ms:.1f} % of the bound (queued, device time)",
              flush=True)
        del x, w, wq, wq_t, ws, ref, got
    del l2_flush
    torch.cuda.empty_cache()
    return rows


K8_STREAMS = 8
K8_HEADS = (126, 127, 128, 129, 254, 255, 256, 257)


def k8_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv) -> None:
    """K8's fixed-order checks on the card at one head (kk, kv restored
    after): two launches from the same inputs
    bit-equal; x0 and the head written behind a 2 ms spin (other values in
    their tensors until it ends) giving those bits, so no launch of the
    chain reads them before its wait; B identical streams (stream 0's
    token, history and cross-KV) giving B bit-equal logits and cache rows."""
    B = x0.shape[0]
    ht = torch.tensor(head, device="cuda")
    k0, v0 = kk.clone(), kv.clone()
    runs = []
    for spun in (False, False, True):
        kk.copy_(k0)
        kv.copy_(v0)
        x, h = x0, ht
        if spun:
            x, h = torch.full_like(x0, float("nan")), torch.tensor(3, device="cuda")
            torch.cuda.synchronize()
            torch.cuda._sleep(4_000_000)
            x.copy_(x0)
            h.copy_(ht)
        runs.append((MK.mega_decode_step_batch(cfg, mp, x, kk, kv, h, xk, xv)[0],
                     kk.clone(), kv.clone()))
        torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])),
          f"K8 {mode}: two launches from the same inputs differ")
    check(all(torch.equal(a, b) for a, b in zip(runs[0], runs[2])),
          f"K8 {mode}: x0 and head written behind a spin change the result")
    del runs
    L, S = k0.shape[0], k0.shape[2]
    same = [t.reshape(L, -1, B, S)[:, :, :1].expand(-1, -1, B, -1).reshape(L, -1, S)
            .contiguous() for t in (k0, v0)]
    sk, sv = (t[:, :1].expand(-1, B, -1, -1).contiguous() for t in (xk, xv))
    got = MK.mega_decode_step_batch(cfg, mp, x0[:1].expand(B, -1).contiguous(), *same, ht,
                                    sk, sv)[0]
    torch.cuda.synchronize()
    rows = [t[:, head * B:(head + 1) * B] for t in same]
    check(all(torch.equal(got[b], got[0]) for b in range(1, B))
          and all(torch.equal(r[:, b], r[:, 0]) for r in rows for b in range(1, B)),
          f"K8 {mode}: {B} identical streams give rows that differ")
    kk.copy_(k0)
    kv.copy_(v0)
    del same, sk, sv, got


def phase_k8(torch, TM, MK, Q):
    """K8 at large-v3-turbo width, B = K8_STREAMS streams with distinct
    cross-KV, in each mode: steps at K8_HEADS from a cache with random
    history below the head (every stream its own slot), each kernel step
    against the plain step on the same inputs (logits within K2_TOL of
    max|ref|, K7's argmax rule, the new cache rows of layer 0 within one
    bf16 step and every layer within K2_TOL, every other row untouched);
    at head 258 two launches from the same inputs bit-equal, x0 and the
    head written behind a 2 ms spin giving the same bits, and eight
    identical streams giving eight bit-equal rows; times with a cold L2
    cache of the kernel step queued behind a spin (its device time, "ms"),
    of the call with its host time ("call_ms"), of the plain step, the
    decode_impl step over the 8 streams and eight K2 steps (the
    yardsticks: no single library call computes the step); the host's
    time to issue one step ("host_us"); the bound, which counts each
    stream's cross-KV, and its share of the device time. Returns {mode:
    row}. K8's "ms" in the kernels line is this queued device time; the
    kernels lines of trees whose K8 ran on mega_rows.cuh held the call,
    host time included, under that key (now "call_ms")."""
    cfg = TM.WhisperConfig(*TURBO)
    L, S, Tc, Ta = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx, cfg.n_audio_ctx
    B = K8_STREAMS
    g = torch.Generator(device="cuda").manual_seed(4)
    xk, xv = ((torch.randn(L, B, Ta, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, Tc * B, S, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for mode in K2_MODES:
        dec, ydec = turbo_decoder(torch, TM, Q, cfg, mode)
        mp = MK.prepare_mega(cfg, ydec if mode in ("logits", "all") else dec, quant=mode)
        toks = torch.randint(0, cfg.n_vocab, (len(K8_HEADS), B), generator=g, device="cuda")
        err = ref_max = cache_err = flip_gap = 0.0
        n_flip = 0
        layer_err = [0.0] * L
        for i, head in enumerate(K8_HEADS):
            kk, kv, pk, pv = (hist[c % 2].clone() for c in range(4))
            for c in (kk, kv, pk, pv):
                c[:, head * B:] = 0
            x0 = (dec["te"][toks[i]] + dec["pe"][head]).to(torch.bfloat16)
            ht = torch.tensor(head, device="cuda")
            ref, _, _ = MK.mega_decode_step_batch_plain(cfg, mp, x0, pk, pv, ht, xk, xv)
            got, _, _ = MK.mega_decode_step_batch(cfg, mp, x0, kk, kv, ht, xk, xv)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()) and got.shape == ref.shape == (B, cfg.n_vocab),
                  f"K8 {mode}: non-finite or misshapen logits")
            e, m = (got - ref).abs().max().item(), ref.abs().max().item()
            check(e <= K2_TOL * m, f"K8 {mode} (head {head}): logits differ from the plain "
                  f"version: {e:.3e} > {K2_TOL} * {m:.3e}")
            pick, best = got.argmax(1), ref.argmax(1)
            gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
            check(bool((gap <= K7_ARGMAX_GAP * m).all()),
                  f"K8 {mode} (head {head}): argmax {pick.tolist()} against {best.tolist()}, "
                  f"plain-logit gaps {gap.tolist()} > {K7_ARGMAX_GAP} * {m:.3e}")
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
                      and not a[:, (head + 1) * B:].any(),
                      f"K8 {mode}: cache rows other than the written ones changed")
        check(layer_err[0] <= 2 ** -7 and cache_err <= K2_TOL,
              f"K8 {mode}: new cache rows differ from the plain version (by layer "
              f"{layer_err} of their max)")
        head = K8_HEADS[-1] + 1
        ht = torch.tensor(head, device="cuda")
        kk[:, head * B:] = 0
        x0 = (dec["te"][toks[0]] + dec["pe"][head]).to(torch.bfloat16)
        k8_bit_checks(torch, MK, cfg, mp, mode, x0, kk, kv, head, xk, xv)

        def step():
            return MK.mega_decode_step_batch(cfg, mp, x0, kk, kv, ht, xk, xv)
        kq_ms = cuda_ms(torch, step, flush=l2_flush, queued=True)
        k_ms = cuda_ms(torch, step, flush=l2_flush)
        h_us = host_us(torch, step)
        p_ms = cuda_ms(torch, lambda: MK.mega_decode_step_batch_plain(
            cfg, mp, x0, pk, pv, ht, xk, xv), reps=5, warmup=1, flush=l2_flush)
        nk, nv = (t.reshape(L, Tc, B, S).transpose(1, 2).contiguous() for t in (kk, kv))
        tok = toks[0][:, None]
        y_ms = cuda_ms(torch, lambda: TM.decode_impl(cfg, ydec, tok, nk, nv, ht, xk, xv),
                       flush=l2_flush)
        per = [(nk[:, b].contiguous(), nv[:, b].contiguous(), xk[:, b].contiguous(),
                xv[:, b].contiguous()) for b in range(B)]

        def k2_steps():
            for b, (ck, cv, sk, sv) in enumerate(per):
                MK.mega_decode_step(cfg, mp, x0[b:b + 1], ck, cv, ht, sk, sv)
        k2_ms = cuda_ms(torch, k2_steps, flush=l2_flush)
        moved, ops = k2_bytes_ops(MK, mp, cfg, head + 1, Ta, rows=B, cross_streams=B)
        b_ms, b_by = bound(moved, ops)
        out[mode] = {"mode": mode, "streams": B, "heads": list(K8_HEADS), "timed_head": head,
                     "max_abs_err": err, "max_ref": ref_max,
                     "argmax_near_tie_flips": n_flip, "argmax_flip_gap_rel": flip_gap,
                     "cache_rel_err": cache_err, "cache_rel_err_by_layer": layer_err,
                     "two_launches_bit_equal": True, "spun_inputs_bit_equal": True,
                     "identical_streams_bit_equal": True,
                     "ms": kq_ms, "call_ms": k_ms, "host_us": h_us, "plain_ms": p_ms,
                     "decode_impl_ms": y_ms, "k2_x8_ms": k2_ms, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / kq_ms,
                     "bytes": moved}
        print(f"[13] K8 {mode}, B={B}: {len(K8_HEADS)} steps at heads "
              f"{', '.join(map(str, K8_HEADS))}, logits max|err| {err:.3e} (max|ref| "
              f"{ref_max:.3e}), argmax differs on {n_flip} of {len(K8_HEADS) * B} rows "
              f"(near-ties, plain gaps up to {flip_gap:.2e} of max|ref|), cache rows "
              f"{cache_err:.3e} of max (by layer {', '.join(f'{x:.1e}' for x in layer_err)}); "
              f"two launches, spun inputs and {B} identical streams bit-equal; at head {head}: "
              f"step queued (device time) {kq_ms * 1e3:.1f} us, {100 * b_ms / kq_ms:.1f} % of "
              f"the bound; the call {k_ms * 1e3:.1f} us, host {h_us:.1f} us; plain "
              f"{p_ms * 1e3:.1f} us, decode_impl B={B} step {y_ms * 1e3:.1f} us, {B} K2 steps "
              f"{k2_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}, {moved / 1e6:.1f} MB)",
              flush=True)
        del dec, ydec, mp, kk, kv, pk, pv, nk, nv, per
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
    """Counts calls of the model's encoder pass and decoder forward (`dec1`:
    those over one token row; `dec_rows`: each call's batch x tokens, the
    rows its linears take), and the
    token loops' calls of the K2, K7 and K8 steps, while it is installed (each
    is looked up on its module at call time; the loops' views of the kernel
    module are swapped for one that counts, so the wrappers' own counters
    are untouched)."""

    def __init__(self, TM, DL, DB, TB=None):
        self.TM, self.DL, self.DB, self.TB = TM, DL, DB, TB
        self.enc = self.dec = self.dec1 = self.mega = self.beam = self.batch = 0
        self.dec_rows = []
        self._orig = (TM.encode_with_cross_kv, TM.decode_impl, DL.MK)

    def __enter__(self):
        enc, dec, mk = self._orig
        counter = self

        def encode(*a, **k):
            self.enc += 1
            return enc(*a, **k)

        def decode(*a, **k):
            tokens = a[2] if len(a) > 2 else k["tokens"]
            self.dec += 1
            self.dec1 += tokens.shape[1] == 1
            self.dec_rows.append(tokens.shape[0] * tokens.shape[1])
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

            @staticmethod
            def mega_decode_step_batch(*a, **k):
                counter.batch += 1
                return mk.mega_decode_step_batch(*a, **k)
        self.TM.encode_with_cross_kv, self.TM.decode_impl = encode, decode
        self.DL.MK = self.DB.MK = CountingMK()
        if self.TB is not None:
            self.TB.MK = self.DL.MK
        return self

    def __exit__(self, *exc):
        self.TM.encode_with_cross_kv, self.TM.decode_impl, self.DL.MK = self._orig
        self.DB.MK = self._orig[2]
        if self.TB is not None:
            self.TB.MK = self._orig[2]


class RoundClock:
    """While installed, keeps each lockstep round's wall time (host clock;
    a round ends in its one result read, which waits for the device) and
    its BatchResult."""

    def __init__(self, TB):
        self.TB, self.rounds = TB, []

    def __enter__(self):
        make, clock = self.TB._make_batch_step, self

        def making(sa, reads):
            run = make(sa, reads)

            def timed(*a, **k):
                t0 = time.perf_counter()
                res = run(*a, **k)
                clock.rounds.append((time.perf_counter() - t0, res))
                return res
            return timed
        self._make = make
        self.TB._make_batch_step = making
        return self

    def __exit__(self, *exc):
        self.TB._make_batch_step = self._make


def serve_batch(torch, tr, FullParams, mods, tag, what, megakernel, enc_ms, int8_encoder,
                cross_kv_int8=False):
    """One batched request: `what` "batch" (transcribe_batch of 8 x 30 s)
    or "parallel" (full_parallel of 240 s over 8 chunks), greedy with
    temperature_inc = 0. Checks the launch counts: K6 128 and K1 32 per
    encoder pass (K6 0 with the dense encoder), K8 once per lockstep step
    the loop issues (0 with megakernel=False or `cross_kv_int8`), K9b
    n_text_layer per one-row decode_impl call with `cross_kv_int8` (else
    0), K7 never, K2 only in chunks whose quality gates sent them to
    whisper_full. Prints audio seconds per second, encoder ms per round
    (`enc_ms`, timed apart) and ms per lockstep step (the rounds' wall less
    their encoder passes, over the steps in which a stream was running).
    Returns (launches, results, (audio s per s, ms per lockstep step))."""
    A, Q, MK, E8, XQ, TB = mods.A, mods.Q, mods.MK, mods.E8, mods.XQ, mods.TB
    p = greedy_params(FullParams)
    p.megakernel = megakernel
    p.cross_kv_int8 = cross_kv_int8
    reset_counts(A, Q, MK, E8, XQ)
    files = [audio(30.0, 500 + b) for b in range(8)]
    with CallCounter(mods.TM, mods.DL, mods.DB, TB) as calls, RoundClock(TB) as clock:
        t0 = time.perf_counter()
        if what == "batch":
            results = tr.transcribe_batch(files, p)
        else:
            results = [tr.full_parallel(p, mods.np.concatenate(files), 8)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rounds = len(clock.rounds)
    steps = sum(int(r.n_tokens[0]) for _, r in clock.rounds)
    fell_back = sum(int(r.failed.sum()) for _, r in clock.rounds)
    loop_ms = sum(w for w, _ in clock.rounds) * 1e3 - rounds * enc_ms
    n_tok = sum(len(s.tokens) for r in results for s in r.segments)
    got = {"w8a8_mm": E8.w8a8_mm.launches, "mha_packed": A.mha_packed.launches,
           "mega_decode_step_batch": MK.mega_decode_step_batch.launches,
           "mega_decode_step": MK.mega_decode_step.launches,
           "mega_decode_step_beam": MK.mega_decode_step_beam.launches,
           "cross_attention_q8": XQ.cross_attention_q8.launches}
    print(f"[{tag}] {what} 240 s audio, {'W8A8' if int8_encoder else 'dense'} encoder, "
          f"megakernel={megakernel!r}, cross_kv_int8={cross_kv_int8}: wall {wall:.3f} s, "
          f"{240.0 / wall:.1f} audio s per s; "
          f"rounds {rounds}, lockstep steps {steps} ({loop_ms / max(steps, 1):.2f} ms per "
          f"step), encoder {enc_ms:.1f} ms per round; chunks sent to whisper_full "
          f"{fell_back}; encoder passes {calls.enc}, K8 steps {calls.batch}, K2 steps "
          f"{calls.mega}, one-row decode_impl calls {calls.dec1}; launches {got}; emitted "
          f"tokens {n_tok}", flush=True)
    check(rounds > 0 and n_tok > 0, f"{tag}: no lockstep round or no tokens")
    n_layer = tr.ctx.cfg.n_audio_layer
    check(got["w8a8_mm"] == (4 * n_layer * calls.enc if int8_encoder else 0)
          and got["mha_packed"] == n_layer * calls.enc,
          f"{tag}: K6/K1 launches {got} for {calls.enc} encoder passes")
    on = megakernel in (True, "int8", "int4") and not cross_kv_int8
    n_layer_dec = tr.ctx.cfg.n_text_layer
    check(got["cross_attention_q8"] == (n_layer_dec * calls.dec1 if cross_kv_int8 else 0)
          and (calls.dec1 >= steps - rounds or not cross_kv_int8),
          f"{tag}: K9b launches {got['cross_attention_q8']} for {calls.dec1} one-row "
          f"decode_impl calls over {steps} lockstep steps")
    check(got["mega_decode_step_batch"] == calls.batch
          and ((steps - rounds <= calls.batch <= steps + 15 * rounds) if on
               else calls.batch == 0),
          f"{tag}: K8 launches {got['mega_decode_step_batch']}, {calls.batch} calls for "
          f"{steps} lockstep steps over {rounds} rounds")
    check(got["mega_decode_step_beam"] == 0 and got["mega_decode_step"] == calls.mega
          and (fell_back > 0 or calls.mega == 0),
          f"{tag}: K2/K7 launched outside the whisper_full fallback: {got}")
    return got, results, (240.0 / wall, loop_ms / max(steps, 1))


def phase_batched(torch, Transcriber, FullParams, mods, q8_path, profiling=False,
                  done=None) -> dict:
    """Batched serving at full large-v3-turbo width (seed-0 preset): the
    W8A8 encoder against the dense one (per-position cosine > 0.98 and
    relative error < 0.1, the JAX package's envelope), both timed on a
    round of 8 windows; transcribe_batch of 8 x 30 s with the W8A8 encoder
    and K8 int8 (the main path: its launch counts go to the kernels line),
    with megakernel=False (staged decode_impl), with the dense encoder;
    full_parallel of 240 s over 8 chunks; one 30 s whisper_full request
    with the W8A8 encoder; and transcribe_batch on the q8_0 checkpoint with
    the W8A8 encoder and K8. Phase 20 sits among them: transcribe_batch of
    8 x 30 s with the W8A8 encoder and cross_kv_int8 (megakernel="int8"
    asked: K8 stays off, K9b runs every lockstep step), beside the same
    request with float cross-KV and megakernel=False. `done(tag)` prints a
    phase's time. Returns the main path's launches."""
    TM, E8, TB = mods.TM, mods.E8, mods.TB
    tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16, seed=0)
    ctx, cfg = tr.ctx, tr.ctx.cfg
    dense_enc = ctx.params["encoder"]
    enc8 = E8.prepare_encoder_int8(cfg, dense_enc)
    mel = mods.mel_mod.log_mel_spectrogram(
        mods.np.concatenate([audio(30.0, 500 + b) for b in range(8)]), ctx.filters, "cuda")
    windows = torch.stack([mel.data[b * 3000:(b + 1) * 3000] for b in range(8)])
    dec = ctx.params["decoder"]
    a = TM.encode(cfg, enc8, windows[:1]).float()
    d = TM.encode(cfg, dense_enc, windows[:1]).float()
    rel = ((a - d).norm() / d.norm()).item()
    cos = (a * d).sum(-1) / (a.norm(dim=-1) * d.norm(dim=-1))
    enc_ms = {name: cuda_ms(torch, lambda e=e: TM.encode_with_cross_kv(cfg, e, dec, windows),
                            reps=3, warmup=1) for name, e in (("w8a8", enc8), ("dense", dense_enc))}
    print(f"[14] W8A8 against the dense turbo encoder, one 30 s window: relative error "
          f"{rel:.4f}, smallest per-position cosine {cos.min().item():.5f}; encoder + cross-KV "
          f"of a round of 8 windows: W8A8 {enc_ms['w8a8']:.1f} ms, dense {enc_ms['dense']:.1f} "
          f"ms (median of 3)", flush=True)
    check(tuple(a.shape) == (1, cfg.n_audio_ctx, cfg.n_audio_state)
          and bool(torch.isfinite(a).all())
          and cos.min().item() > 0.98 and rel < 0.1,
          "the W8A8 turbo encoder is outside the envelope of the dense one")
    ctx.params["encoder"] = enc8
    launches, _, _ = serve_batch(torch, tr, FullParams, mods, "14", "batch", "int8",
                                 enc_ms["w8a8"], True)
    if profiling:
        pb = greedy_params(FullParams)
        pb.megakernel = "int8"
        profile_call(torch, "batch8-w8a8-k8", "transcribe_batch 8 x 30 s, W8A8, K8 int8",
                     lambda: tr.transcribe_batch([audio(30.0, 500 + b) for b in range(8)], pb))
    _, _, flt = serve_batch(torch, tr, FullParams, mods, "14", "batch", False, enc_ms["w8a8"],
                            True)
    if done is not None:
        done("14")
    # ---- 20. the same batch with int8 cross-KV: K9b every lockstep step ----
    _, _, q8 = serve_batch(torch, tr, FullParams, mods, "20", "batch", "int8", enc_ms["w8a8"],
                           True, cross_kv_int8=True)
    print(f"[20] 8 x 30 s, W8A8 encoder: int8 cross-KV (K9b) {q8[0]:.1f} audio s per s, "
          f"{q8[1]:.2f} ms per lockstep step; float cross-KV, megakernel=False {flt[0]:.1f} "
          f"audio s per s, {flt[1]:.2f} ms per lockstep step", flush=True)
    if done is not None:
        done("20")
    serve_batch(torch, tr, FullParams, mods, "14", "parallel", "int8", enc_ms["w8a8"], True)
    reset_counts(mods.A, mods.Q, mods.MK, E8)
    res = serve(torch, tr, FullParams, 30.0, 30, "14 single-stream W8A8")
    check(E8.w8a8_mm.launches == 4 * cfg.n_audio_layer * res.timings.n_encode,
          "single-stream W8A8 request: K6 launches off")
    ctx.params["encoder"] = dense_enc
    serve_batch(torch, tr, FullParams, mods, "14", "batch", "int8", enc_ms["dense"], False)
    del tr, ctx, dense_enc, enc8, dec, windows, mel
    torch.cuda.empty_cache()
    tq = Transcriber(model_path=q8_path, dtype=torch.bfloat16, encoder_int8=True)
    check("qkv_q" in tq.ctx.params["encoder"]["blocks"], "q8_0 + encoder_int8: no W8A8 planes")
    serve_batch(torch, tq, FullParams, mods, "14 q8_0", "batch", "int8", enc_ms["w8a8"], True)
    del tq
    torch.cuda.empty_cache()
    return launches


# audio seeds of the narrow q8_0 batch comparison (phase 15): 40 s files
# whose CPU transcript in a batch of eight with megakernel="int8" stays the
# same when the input is scaled by 1 +- 2^-20, 2^-16 or 2^-13 (148 tokens
# each; of seeds 0-7 only 4 and 5 pass all six scalings, the others part
# at token 0, 116 or 138 under at least one). Both transcripts pass near
# ties under the 1.6-2.1e-2 card-against-CPU logit difference the encoder
# leaves before any K8 step (ROADMAP section 3): seed 4 parted on the card
# at its first token in earlier trees, and with K8 on K2's GEMVs seed 5
# parts at its 135th token, where the CPU's two best lie 3.7e-3 apart. The
# seed that holds is held equal, the other decoded (first, as before) with
# its first difference printed
Q8_BATCH_SEEDS = (4,)
Q8_BATCH_SHOWN = (5,)


def phase_narrow_batched(torch, TF, TM, tok_mod, FullParams, mods, q8_path, tokens) -> None:
    """Batched serving on the card against the CPU at narrow width: the f32
    config (3 decoder layers; the decode_impl branch) through
    transcribe_batched of 60 s in 2 chunks (audio seed 0: its CPU
    transcript, 296 tokens, stays the same when the input is scaled by
    1 +- 2^-20, 2^-16 or 2^-13), token ids equal and at least 100 of them; the narrow bf16 q8_0 checkpoint with megakernel="int8"
    (K8 on the card, its plain version on the CPU) through transcribe_batch
    of the Q8_BATCH_SHOWN and Q8_BATCH_SEEDS files (40 s each), token ids
    equal on the latter, the first differing token printed for the others,
    with each stream's first step (the token each side picks from the
    prompt ingest's logits, the CPU's gap between its two best and the
    largest difference of the raw logits: a near tie when the gap is the
    smaller) and, where the transcripts part, the same at the first
    lockstep step whose best token differs."""
    MK, TB = mods.MK, mods.TB
    p = greedy_params(FullParams)
    cfg3 = TM.WhisperConfig(*NARROW_Q)
    params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
    ids = {}
    for dev in ("cuda", "cpu"):
        c = TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                              TF._synthetic_mel_filters(80), n_loaded=1,
                              dtype=torch.float32, device=dev)
        r = TB.transcribe_batched(c, p, audio(60.0, 0), n_chunks=2)
        ids[dev] = [t.id for s in r.segments for t in s.tokens]
    print(f"[15] narrow f32, transcribe_batched 60 s in 2 chunks: tokens cuda "
          f"{len(ids['cuda'])} cpu {len(ids['cpu'])}, token ids equal "
          f"{ids['cuda'] == ids['cpu']}", flush=True)
    check(ids["cuda"] == ids["cpu"] and len(ids["cpu"]) >= 100,
          "narrow f32 batch: cuda and cpu differ, or too few tokens to tell")
    pq = dataclasses.replace(p, megakernel="int8")
    seeds = Q8_BATCH_SHOWN + Q8_BATCH_SEEDS
    held = slice(len(Q8_BATCH_SHOWN), None)
    files = [audio(40.0, s) for s in seeds]
    ids, first_step, top2 = {}, {}, {}
    real_rules = TB.LR.apply_rules
    for dev in ("cuda", "cpu"):
        c = TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
        MK.mega_decode_step_batch.launches = 0
        steps = []

        best = []     # every step's two best filtered logits, and the largest raw one

        def rules(rc, logits, *a, steps=steps, best=best, **k):
            out = real_rules(rc, logits, *a, **k)
            if not steps:       # the round's first step: the prompt ingest's logits
                steps.append((logits.float().cpu(), out[0].float().cpu()))
            best.append((torch.topk(out[0].float(), 2), logits.float()))
            return out
        TB.LR.apply_rules = rules
        try:
            res = TB.transcribe_chunks_with_timings(c, pq, files)[0]
        finally:
            TB.LR.apply_rules = real_rules
        first_step[dev] = steps[0]
        top2[dev] = [(t.values.cpu(), t.indices.cpu(), raw.cpu()) for t, raw in best]
        ids[dev] = [[t.id for s in segs for t in s.tokens] for segs in res]
        if dev == "cuda":
            check(MK.mega_decode_step_batch.launches > 0, "narrow q8_0 batch: K8 not launched")
    (raw_g, filt_g), (raw_c, filt_c) = first_step["cuda"], first_step["cpu"]
    for b, (seed, a, c_ids) in enumerate(zip(seeds, ids["cuda"], ids["cpu"])):
        first = next((i for i, (x, y) in enumerate(zip(a, c_ids)) if x != y),
                     min(len(a), len(c_ids)))
        top = torch.topk(filt_c[b], 2)
        print(f"[15] narrow bf16 q8_0, transcribe_batch of {len(files)} x 40 s, megakernel="
              f"'int8', audio seed {seed}: tokens cuda {len(a)} cpu {len(c_ids)}, equal "
              f"{a == c_ids}, equal prefix {first}; first step (the prompt ingest's logits, "
              f"before K8): token cuda {int(filt_g[b].argmax())} cpu {int(top.indices[0])}, "
              f"cpu top-2 gap {(top.values[0] - top.values[1]).item():.3e}, max|logits cuda - "
              f"cpu| {(raw_g[b] - raw_c[b]).abs().max().item():.3e}", flush=True)
        if a != c_ids:
            step = next((i for i, (g, c) in enumerate(zip(top2["cuda"], top2["cpu"]))
                         if int(g[1][b, 0]) != int(c[1][b, 0])), None)
            if step is not None:
                (gv, gi, graw), (cv, ci, craw) = top2["cuda"][step], top2["cpu"][step]
                print(f"[15]   audio seed {seed}: the first lockstep step whose best token "
                      f"differs is {step}: cpu {ci[b].tolist()} {(cv[b, 0] - cv[b, 1]).item():.3e}"
                      f" apart, cuda {gi[b].tolist()} {(gv[b, 0] - gv[b, 1]).item():.3e} apart; "
                      f"max|logits cuda - cpu| {(graw[b] - craw[b]).abs().max().item():.3e}",
                      flush=True)
    n_tok = sum(map(len, ids["cpu"][held]))
    check(ids["cuda"][held] == ids["cpu"][held]
          and n_tok >= 100, "narrow q8_0 batch with K8: cuda and cpu differ")
    ingest_split(torch, TF, TM, TB, mods, q8_path, pq, Q8_BATCH_SHOWN + Q8_BATCH_SEEDS)
    # K8 alone: the card's lockstep loop from the CPU's encoder output
    ctxs = {dev: TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
            for dev in ("cuda", "cpu")}
    MK.mega_decode_step_batch.launches = 0
    one_encoder_output(
        torch, TM, TB.LR, "15", f"narrow bf16 q8_0 transcribe_batch of {len(files)} x 40 s "
        f"(audio seeds {', '.join(map(str, seeds))}), megakernel='int8'",
        lambda c: [[t.id for s in segs for t in s.tokens]
                   for segs in TB.transcribe_chunks_with_timings(c, pq, files)[0]],
        ctxs, per_row=True)
    check(MK.mega_decode_step_batch.launches > 0, "narrow q8_0 batch from one encoder output: "
          "K8 not launched")


def ingest_split(torch, TF, TM, TB, mods, q8_path, p, seeds) -> None:
    """Where the card's first-step logits part from the CPU's on the narrow
    bf16 q8_0 checkpoint: for each audio seed, the prompt ingest (the
    lockstep prompt, cross-KV and decode_impl) on the card from the CPU's
    encoder output, copied over, against the same ingest on the CPU, beside
    the whole card path (mel, encoder, ingest) against the CPU. The first
    difference is the ingest's share of the gap, the rest the mel's and the
    encoder's. A seed whose transcripts agree is the yardstick."""
    ctxs = {dev: TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
            for dev in ("cpu", "cuda")}
    cpu, card = ctxs["cpu"], ctxs["cuda"]
    prompt = torch.tensor([TB._init_prompt(cpu, p)])
    frames = 2 * cpu.cfg.n_audio_ctx

    def encode(ctx, samples):
        mel = mods.mel_mod.log_mel_spectrogram(samples, ctx.filters, device=ctx.device)
        return TM.encode(ctx.cfg, ctx.params["encoder"], mel.data[None, :frames])

    def ingest(ctx, enc_out):
        dec = ctx.params["decoder"]
        xk, xv = TM.cross_kv(ctx.cfg, dec, enc_out)
        kv_k, kv_v = TM.init_kv_cache(ctx.cfg, 1, dtype=ctx.dtype, device=ctx.device)
        logits, _, _ = TM.decode_impl(ctx.cfg, dec, prompt.to(ctx.device), kv_k, kv_v, 0,
                                      xk, xv, logits_pos=prompt.shape[1] - 1)
        return logits[0, 0].float().cpu()

    for seed in seeds:
        samples = audio(40.0, seed)
        enc_cpu, enc_card = encode(cpu, samples), encode(card, samples).cpu()
        ref = ingest(cpu, enc_cpu)
        from_cpu_enc = ingest(card, enc_cpu.to("cuda"))
        whole = ingest(card, enc_card.to("cuda"))
        top = torch.topk(ref, 2).values
        gap = lambda a: (a - ref).abs().max().item()  # noqa: E731
        print(f"[15] audio seed {seed}, first-step logits, max|ref| {ref.abs().max().item():.3e} "
              f"(a bf16 step there {ref.abs().max().item() * 2.0 ** -8:.3e}), raw top-2 gap "
              f"{(top[0] - top[1]).item():.3e}: card against cpu, the whole path "
              f"{gap(whole):.3e} (encoder output max|diff| / max|ref| "
              f"{((enc_card.float() - enc_cpu.float()).abs().max() / enc_cpu.float().abs().max()).item():.3e}); "
              f"the ingest alone, from the cpu's encoder output {gap(from_cpu_enc):.3e}",
              flush=True)
        check(bool(torch.isfinite(whole).all() and torch.isfinite(from_cpu_enc).all()),
              f"ingest split, audio seed {seed}: non-finite logits")


# the card against the CPU from one encoder output (phases 9, 10 and 15):
# the audio seeds and request lengths of the bf16 q8_0 step-kernel checks,
# and the equal tokens each stream is asked for
ONE_ENC_SEEDS = (3, 4, 7)
ONE_ENC_GREEDY_SECS = 35.0
ONE_ENC_BEAM_SECS = 90.0
ONE_ENC_TOKENS = 100


class EncoderReplay:
    """The CPU's encoder outputs on the card. `record()` keeps every
    TM.encode_with_cross_kv result (enc_out, xk, xv) of the CPU run made
    while it is installed; `replay(device)` returns them in the same order,
    copied to the card, in place of the card's own encoder pass (the
    request's mel window shapes must match), so the card's token loop starts
    from the CPU's encoder output and cross-KV: its tokens then test the
    step kernels alone. Every decode path (whisper_full's windows, the
    K-window loop, the lockstep rounds) calls the encoder through that
    module attribute."""

    def __init__(self, TM):
        self.TM, self.real, self.outs, self.served = TM, TM.encode_with_cross_kv, [], 0

    def record(self):
        def enc(cfg, e, d, mel):
            out = self.real(cfg, e, d, mel)
            self.outs.append((tuple(mel.shape), out))
            return out
        return self._installed(enc)

    def replay(self, device):
        def enc(cfg, e, d, mel):
            check(self.served < len(self.outs), "encoder replay: the card asked for more "
                  "encoder passes than the CPU made")
            shape, out = self.outs[self.served]
            check(tuple(mel.shape) == shape, f"encoder replay: window {tuple(mel.shape)} where "
                  f"the CPU encoded {shape}")
            self.served += 1
            return tuple(t.to(device) for t in out)
        return self._installed(enc)

    def _installed(self, fn):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.TM.encode_with_cross_kv = fn
            try:
                yield self
            finally:
                self.TM.encode_with_cross_kv = self.real
        return ctx()


class StepLogits:
    """Every call of the logit rules while installed: the raw logits and the
    filtered logits' `k` best values and ids of each row, kept on the
    device until `rows()`."""

    def __init__(self, torch, LR, k=2):
        self.torch, self.LR, self.k, self.real, self.steps = torch, LR, k, LR.apply_rules, []

    def __enter__(self):
        def rules(rc, logits, *a, **kw):
            out = self.real(rc, logits, *a, **kw)
            top = self.torch.topk(out[0].float(), self.k)
            self.steps.append((top.values, top.indices, logits.float()))
            return out
        self.LR.apply_rules = rules
        return self

    def __exit__(self, *exc):
        self.LR.apply_rules = self.real

    def rows(self):
        return [tuple(t.cpu() for t in step) for step in self.steps]


def first_parting(card, cpu, k=1, row=None):
    """The first step whose best `k` ids differ on any row (or on `row`)
    between two StepLogits records, masked candidates (-inf, whose order
    topk leaves open) left out: (step, row, the CPU's smallest gap between
    adjacent finite candidates among its best k + 1, max|logit| of the
    CPU's row, max|logits card - cpu| of the row), or None."""
    for step, ((gv, gi, graw), (cv, ci, craw)) in enumerate(zip(card, cpu)):
        if gi.shape != ci.shape:
            return step, None, None, None, None
        gi = gi[:, :k].masked_fill(~gv[:, :k].isfinite(), -1)
        ci = ci[:, :k].masked_fill(~cv[:, :k].isfinite(), -1)
        differ = (gi != ci).any(1)
        if row is not None:
            differ = differ[row:row + 1] if row < differ.numel() else differ[:0]
        differ = differ.nonzero() + (row or 0)
        if differ.numel():
            r = int(differ[0])
            gaps = cv[r, :k] - cv[r, 1:k + 1]
            gap = gaps[gaps.isfinite()].min().item() if gaps.isfinite().any() else 0.0
            return (step, r, gap, craw[r].abs().max().item(),
                    (graw[r] - craw[r]).abs().max().item())
    return None


def one_encoder_output(torch, TM, LR, tag, what, run, ctxs, k=1, per_row=False):
    """`run(ctx)` (a list of token-id lists, one a stream) on the CPU context,
    recording its encoder outputs and logits, then on the card context from
    those outputs. Per stream prints the equal tokens (the common prefix) and,
    where the streams part before ONE_ENC_TOKENS, the first step whose best
    `k` ids differ (on the stream's own row of the logits with `per_row`, a
    lockstep batch; else on any row: one stream's beams) and the CPU's gap
    there. Fails where a stream parts before
    ONE_ENC_TOKENS at a step whose CPU gap is wider than K7_ARGMAX_GAP of
    max|logit| (not a near tie), or where the parting step is not found in
    greedy decoding (k = 1). Returns [(equal tokens, total, parting)]."""
    replay = EncoderReplay(TM)
    with replay.record(), StepLogits(torch, LR, k + 1) as cpu_steps:
        cpu = run(ctxs["cpu"])
    with replay.replay(ctxs["cuda"].device), StepLogits(torch, LR, k + 1) as card_steps:
        card = run(ctxs["cuda"])
    check(replay.served == len(replay.outs) > 0,
          f"{what}: the card used {replay.served} of {len(replay.outs)} encoder outputs")
    card_rows, cpu_rows = card_steps.rows(), cpu_steps.rows()
    out = []
    for i, (a, c) in enumerate(zip(card, cpu)):
        part = first_parting(card_rows, cpu_rows, k, i if per_row else None)
        equal = next((j for j, (x, y) in enumerate(zip(a, c)) if x != y), min(len(a), len(c)))
        same = a == c
        line = (f"[{tag}] {what}, from the CPU's encoder output, stream {i}: tokens cuda "
                f"{len(a)} cpu {len(c)}, equal {same}, equal tokens {equal}")
        if not same and part is not None:
            step, row, gap, big, diff = part
            line += (f"; the first step whose best {k} differ: {step} (row {row}), the CPU's gap "
                     f"there {gap:.3e} of max|logit| {big:.3e} ({gap / big:.2e}), max|logits "
                     f"cuda - cpu| {diff:.3e}" if row is not None else
                     f"; the steps part at {step} (different rows)")
        print(line, flush=True)
        if not same and equal < ONE_ENC_TOKENS:
            if k == 1:
                check(part is not None and part[1] is not None
                      and part[2] <= K7_ARGMAX_GAP * part[3],
                      f"{what}, stream {i}: parts from the CPU at token {equal}, not at a "
                      "near tie of the CPU's logits")
            elif part is not None and part[1] is not None:
                check(part[2] <= K7_ARGMAX_GAP * part[3],
                      f"{what}, stream {i}: parts from the CPU at token {equal}, not at a "
                      "near tie of the CPU's candidates")
        out.append((equal, len(c), part))
    return out


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


# the drafts of phase 16: (tag, checkpoint file, gamma); (a) the target's
# own seed-0 tensors as q4_0, the closest draft there is without real
# weights; (b) seed-1 tensors as q8_0, whose proposals the target rejects,
# with the most verify rows K2 takes (gamma + 1 = 8)
SPEC_DRAFTS = (("a", "draft-q4_0-seed0.bin", 4), ("b", "draft-q8_0-seed1.bin", 7))


def phase_speculative(torch, Transcriber, TF, FullParams, mods, tmp) -> int:
    """Speculative greedy decoding at full large-v3-turbo width: the q8_0
    target (K2 int8 by itself) serves 30 s and 65 s greedily, then with
    each of SPEC_DRAFTS attached (Transcriber(model_path=...,
    draft_model_path=...), then set_draft), temperature_inc = 0. Each
    transcript must equal the target's K2-greedy one token for token; the
    launch counts are exact: every round gamma + 1 one-row K2 draft steps
    and one K2 verify pass at gamma + 1 rows, as many verify passes as live
    rounds plus at most POLL - 1 masked ones a window, every window's
    prompt ingest (both models) one decode_impl call, no decode_impl call
    in a round. Prints acceptance, rounds and ms per sampled token beside
    greedy's. Returns the verify passes' launches."""
    A, Q, MK, TM, DL, DB = mods.A, mods.Q, mods.MK, mods.TM, mods.DL, mods.DB
    from open_whisper_kit_tpu_torch.decode import device_speculative as DS
    target = tmp / "ggml-large-v3-turbo-q8_0.bin"
    requests = ((30.0, 30), (65.0, 65))

    def run(tr, p, secs, seed):
        reset_counts(A, Q, MK)
        with CallCounter(TM, DL, DB) as calls:
            t0 = time.perf_counter()
            res = tr.transcribe(audio(secs, seed), p)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ids = [t.id for s in res.segments for t in s.tokens]
        return res, ids, wall, calls, dict(MK.mega_decode_step.launches_by_rows)

    tr = Transcriber(model_path=target, draft_model_path=tmp / SPEC_DRAFTS[0][1],
                     dtype=torch.bfloat16)
    greedy = {}
    p = greedy_params(FullParams)
    for secs, seed in requests:
        res, ids, wall, _, _ = run(tr, p, secs, seed)
        greedy[secs] = ids, wall / max(res.timings.n_sample, 1) * 1e3
        check(len(ids) > 0, f"q8_0 greedy {secs:.0f} s: no tokens")
        print(f"[16] q8_0 greedy, {secs:.0f} s, K2 auto: sampled tokens "
              f"{res.timings.n_sample}, emitted {len(ids)}, wall {wall:.3f} s, "
              f"{greedy[secs][1]:.2f} ms per sampled token", flush=True)
    n_verify = 0
    for tag, name, gamma in SPEC_DRAFTS:
        if tag != SPEC_DRAFTS[0][0]:
            tr.ctx.set_draft(TF.WhisperContext.from_file(tmp / name, dtype=torch.bfloat16,
                                                         device="cuda"))
        ps = dataclasses.replace(p, speculative=gamma)
        check(tr.ctx.mega_mode(ps) == "all" and tr.ctx.draft.mega_mode(ps, draft=True)
              == "all", f"draft ({tag}): K2 not selected for the draft steps and the verify")
        for secs, seed in requests:
            res, ids, wall, calls, rows = run(tr, ps, secs, seed)
            tm = res.timings
            n_win = tm.n_encode // 2
            rounds = tm.n_decode - n_win
            verify, one = rows.get(gamma + 1, 0), rows.get(1, 0)
            same = ids == greedy[secs][0]
            first = next((i for i, (a, b) in enumerate(zip(ids, greedy[secs][0])) if a != b),
                         None)
            ms_tok = wall / max(tm.n_sample, 1) * 1e3
            print(f"[16] draft ({tag}) {name}, gamma {gamma}, {secs:.0f} s: windows {n_win}, "
                  f"sampled tokens {tm.n_sample}, emitted {len(ids)}, rounds {rounds} "
                  f"({tm.n_sample / max(rounds, 1):.2f} tokens a round), accepted "
                  f"{tm.n_spec_accepted} of {rounds * gamma} proposals "
                  f"({tm.n_spec_accepted / max(rounds * gamma, 1):.1%}); K2 launches: "
                  f"{one} one-row, {verify} at {gamma + 1} rows, all {rows}; decode_impl "
                  f"calls {calls.dec}, encoder passes {calls.enc}; wall {wall:.3f} s, "
                  f"{ms_tok:.2f} ms per sampled token (greedy {greedy[secs][1]:.2f}); "
                  f"transcript equals K2 greedy {same}"
                  + ("" if same else f" (first differing token {first})"), flush=True)
            check(same and len(ids) > 0, f"draft ({tag}) {secs:.0f} s: the speculative "
                  "transcript differs from K2 greedy")
            check(set(rows) <= {1, gamma + 1} and one == (gamma + 1) * verify
                  and rounds <= verify <= rounds + (DS.POLL - 1) * n_win,
                  f"draft ({tag}) {secs:.0f} s: K2 launches {rows} for {rounds} rounds "
                  f"over {n_win} windows")
            check(calls.enc == 2 * n_win and calls.dec == 2 * n_win
                  and A.mha_packed.launches == TURBO_LAYERS * calls.enc
                  and Q.qmm.launches == calls.enc * (TURBO_LAYERS * 6 + 4 * 2)
                  + calls.dec * 4 * 4 and Q.ffn_int8.launches == calls.dec * 4,
                  f"draft ({tag}) {secs:.0f} s: encoder / decode_impl launches off "
                  f"prediction (encoder {calls.enc}, decode_impl {calls.dec}, K1 "
                  f"{A.mha_packed.launches}, K3 {Q.qmm.launches}, K5 {Q.ffn_int8.launches})")
            n_verify += verify
    del tr
    torch.cuda.empty_cache()
    return n_verify


# audio seed of the narrow speculative comparison (phase 17): its CPU
# transcript with megakernel="int8" stays the same when the input is scaled
# by 1 +- 2^-20, 2^-16 or 2^-13 (of seeds 0-7, only 4 and 7 hold all six)
SPEC_NARROW_SEED = 4


def phase_narrow_speculative(torch, TF, FullParams, mods, q8_path, hp, tokens) -> None:
    """Narrow bf16 q8_0 target with a q4_0 draft of the same tensors,
    megakernel="int8", gamma = 4, 35 s: draft steps K2 at one row and verify
    passes K2 at five rows on the card, their plain versions on the CPU;
    token ids equal, at least 100, and on the card equal to K2 greedy."""
    W, MK = mods.W, mods.MK
    draft_path = q8_path.with_name("narrow-q4_0-draft.bin")
    W.write_checkpoint(draft_path, hp, TF._synthetic_mel_filters(80), tokens,
                       W.random_reference_tensors(hp, seed=0), wtype=W.TYPE_FOR_NAME["q4_0"])
    p = greedy_params(FullParams)
    p.megakernel = "int8"
    ps = dataclasses.replace(p, speculative=4)
    samples = audio(35.0, SPEC_NARROW_SEED)
    ids = {}
    for dev in ("cuda", "cpu"):
        c = TF.WhisperContext.from_file(q8_path, dtype=torch.bfloat16, device=dev)
        c.set_draft(TF.WhisperContext.from_file(draft_path, dtype=torch.bfloat16, device=dev))
        MK.mega_decode_step.launches_by_rows.clear()
        r = TF.whisper_full(c, ps, samples)
        ids[dev] = [t.id for s in r.segments for t in s.tokens]
        if dev == "cuda":
            rows = dict(MK.mega_decode_step.launches_by_rows)
            check(rows.get(5, 0) > 0 and rows.get(1, 0) == 5 * rows[5],
                  f"narrow speculative on cuda: K2 launches {rows}")
            c.draft = None
            g = TF.whisper_full(c, p, samples)
            greedy = [t.id for s in g.segments for t in s.tokens]
    same = ids["cuda"] == ids["cpu"]
    print(f"[17] narrow bf16 q8_0 + q4_0 draft, gamma 4, megakernel='int8', audio seed "
          f"{SPEC_NARROW_SEED}: tokens {len(ids['cuda'])}, token ids cuda == cpu {same}, "
          f"cuda == K2 greedy {ids['cuda'] == greedy}, K2 launches on cuda {rows}", flush=True)
    check(same and len(ids["cuda"]) >= 100 and ids["cuda"] == greedy,
          "narrow speculative: cuda and cpu differ, too few tokens, or not K2 greedy's")


# K9 cases of phase 18: (kernel, dtype, heads, query rows B, plane batch Bk)
# at 1500 audio positions; the turbo shapes of the main path (greedy: one
# row; beam 5: five rows over one shared plane, batch stride 0; lockstep:
# eight streams, each its own planes; K9a's route: eight streams on
# 1504-row slabs, ta_valid = 1500) and a narrow f32 shape (S = 128)
K9_CASES = [("K9b", "bf16", 20, 1, 1), ("K9b", "bf16", 20, 5, 1), ("K9b", "bf16", 20, 8, 8),
            ("K9a", "bf16", 20, 8, 8), ("K9b", "f32", 2, 1, 1), ("K9a", "f32", 2, 8, 8)]
K9_TA = 1500
# gates against the plain version, relative to max|ref|: bf16 a tenth of a
# percent past the kernels' own bf16 rounding of p * vs (JAX's K9b test
# allows 2e-2 absolute on O(1) outputs); f32 the f32 summation order
K9_TOL = {"bf16": 1e-2, "f32": 1e-5}
F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores (NVIDIA data sheet)


def phase_k9(torch, TM, XQ) -> dict:
    """K9b (cross_attention_q8) and K9a (cross_attention_q8_nat) against
    their plain versions at K9_CASES on the same inputs (planes from
    TM.quantize_cross_kv / quantize_cross_kv_nat of a random cross-KV), gated
    at K9_TOL; times with the L2 cache flushed before each launch of the
    kernel, the plain version and SDPA over the float K/V of the same shape
    (the float cross-KV that int8 replaces: no single PyTorch call attends
    over int8 planes with per-row scales, so library_ms stays null); the
    bound (the live keys' planes and scales, q and out, at 3.35 TB/s).
    Returns {"K9b": rows, "K9a": rows}."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(19)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows = {"K9b": [], "K9a": []}
    for kernel, dt, H, B, Bk in K9_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        S, nat, scale = H * 64, kernel == "K9a", 64 ** -0.25
        xk, xv = ((torch.randn(1, Bk, K9_TA, S, generator=g, device="cuda") * 0.5).to(dtype)
                  for _ in range(2))
        quant = TM.quantize_cross_kv_nat if nat else TM.quantize_cross_kv
        qk, qv = quant(xk, H), quant(xv, H)
        planes = (qk.qs[0], qk.scale[0], qv.qs[0], qv.scale[0])
        extra = (qk.ta_valid,) if nat else ()
        fn = XQ.cross_attention_q8_nat if nat else XQ.cross_attention_q8
        plain = XQ.cross_attention_q8_nat_plain if nat else XQ.cross_attention_q8_plain
        q = torch.randn(B, 1, S, generator=g, device="cuda").to(dtype)
        ref = plain(q, *planes, H, scale, *extra)
        got = fn(q, *planes, H, scale, *extra)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        shape = (f"B={B} over {'one shared plane' if Bk < B else f'{Bk} planes'}, H={H}, "
                 f"Ta={K9_TA}{', Tap=%d' % planes[0].shape[1] if nat else ''}, {dt}")
        print(f"[18] {kernel} {shape}: max|err| {err:.3e} max|ref| {ref_max:.3e} limit "
              f"{K9_TOL[dt] * ref_max:.3e}", flush=True)
        check(got.shape == q.shape and bool(torch.isfinite(got).all())
              and err <= K9_TOL[dt] * ref_max,
              f"{kernel} {shape} disagrees with its plain version")
        # device time (launches queued behind a spin), and the call as an
        # eager caller issues it (host side included)
        k_ms = cuda_ms(torch, lambda: fn(q, *planes, H, scale, *extra), flush=l2_flush,
                       queued=True)
        c_ms = cuda_ms(torch, lambda: fn(q, *planes, H, scale, *extra), flush=l2_flush)
        h_us = host_us(torch, lambda: fn(q, *planes, H, scale, *extra))
        p_ms = cuda_ms(torch, lambda: plain(q, *planes, H, scale, *extra), flush=l2_flush,
                       queued=True)
        plan = XQ.cross_q8_plan(B, H, planes[0].shape[-2] if not nat else qk.ta_valid, Bk < B)
        # the float path's attention over the same cross-KV: rows sharing a
        # plane fold into queries, as decode_impl folds them
        kh, vh = (x[0].view(Bk, K9_TA, H, 64).transpose(1, 2).contiguous() for x in (xk, xv))
        qh = q.view(Bk, B // Bk, H, 64).transpose(1, 2).contiguous()
        s_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
                       flush=l2_flush, queued=True)
        live = (Bk * H * K9_TA * 64, Bk * H * K9_TA * 4)     # plane and scale bytes a side
        b_ms, b_by = bound(2 * sum(live) + 2 * nbytes(q), 4 * B * H * K9_TA * 64,
                           "bf16" if dt == "bf16" else F32_FLOP_PER_S)
        rows[kernel].append({"shape": shape, "max_abs_err": err, "ms": k_ms, "call_ms": c_ms,
                             "host_us": h_us, "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": None, "float_kv_sdpa_ms": s_ms,
                             "chunks": plan.chunks, "chunk": plan.chunk, "rows": plan.rows,
                             "blocks": plan.blocks})
        print(f"[18]   kernel {k_ms * 1e3:.1f} us queued (the call with its host side "
              f"{c_ms * 1e3:.1f} us, host {h_us:.1f} us), plain {p_ms * 1e3:.1f} us, SDPA over "
              f"the float cross-KV that int8 replaces {s_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), {100 * b_ms / k_ms:.1f} % of the bound (median of "
              f"20, cold L2; device times queued behind a spin); one launch: {plan.chunks} "
              f"chunks of {plan.chunk} keys a cluster, {plan.rows} row(s) a block, "
              f"{plan.blocks} blocks", flush=True)
        del xk, xv, qk, qv, planes, q, ref, got, kh, vh, qh
    del l2_flush
    torch.cuda.empty_cache()
    return rows


# the requests of phase 19 on the q8_0 checkpoint: (label, seconds, audio
# seed, FullParams fields, beams)
INT8_KV_REQUESTS = (("greedy", 30.0, 30, {}, 0), ("greedy", 65.0, 65, {}, 0),
                    ("greedy, device_windows=1", 30.0, 30, {"device_windows": 1}, 0),
                    ("beam 5", 30.0, 30, {}, K7_BEAMS))


def phase_cross_int8(torch, tr, FullParams, mods) -> int:
    """int8 cross-KV at full width on the q8_0 turbo checkpoint:
    INT8_KV_REQUESTS with cross_kv_int8=True and megakernel left to the
    policy (temperature_inc = 0), each beside the same request with float
    cross-KV and megakernel=False, which takes the same decode_impl route
    with float cross-attention. Launch counts exact: K9b n_text_layer per
    one-row decode_impl call (none for the float request), K2 and K7 never,
    K3 and K5 as phase 6's megakernel=False request, K1 per encoder pass.
    Prints ms per sampled token of both. Returns the int8 requests' K9b
    launches."""
    A, Q, MK, XQ, TM, DL, DB = mods.A, mods.Q, mods.MK, mods.XQ, mods.TM, mods.DL, mods.DB
    n_layer = tr.ctx.cfg.n_text_layer
    k9b = 0
    for label, secs, seed, kw, beams in INT8_KV_REQUESTS:
        out = {}
        for int8 in (True, False):
            p = request_params(FullParams, megakernel=None if int8 else False,
                               beam_size=beams)
            p = dataclasses.replace(p, cross_kv_int8=int8, **kw)
            check(tr.ctx.mega_mode(p) is None, f"{label}: a step kernel selected")
            reset_counts(A, Q, MK, XQ=XQ)
            with CallCounter(TM, DL, DB) as calls:
                t0 = time.perf_counter()
                res = tr.transcribe(audio(secs, seed), p)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            n_sample = res.timings.n_sample
            n_tok = sum(len(s.tokens) for s in res.segments)
            n9 = XQ.cross_attention_q8.launches
            want_k3 = calls.enc * (TURBO_LAYERS * 6 + 4 * 2) + calls.dec * 4 * 4
            out[int8] = wall * 1e3 / max(n_sample, 1)
            print(f"[19] q8_0 {label}, {secs:.0f} s, cross_kv_int8={int8}: encoder passes "
                  f"{calls.enc}, decode_impl calls {calls.dec} ({calls.dec1} one-row), sampled "
                  f"tokens {n_sample}, emitted {n_tok}; launches K9b {n9}, K3 "
                  f"{Q.qmm.launches} (predicted {want_k3}), K5 {Q.ffn_int8.launches}, K1 "
                  f"{A.mha_packed.launches}, K2 {MK.mega_decode_step.launches}, K7 "
                  f"{MK.mega_decode_step_beam.launches}; wall {wall:.3f} s, {out[int8]:.2f} "
                  "ms per sampled token", flush=True)
            check(n_tok > 0 and calls.dec1 > 0, f"{label}: no tokens or no one-row step")
            check(n9 == (n_layer * calls.dec1 if int8 else 0)
                  and XQ.cross_attention_q8_nat.launches == 0,
                  f"{label}, cross_kv_int8={int8}: K9b launches {n9} for {calls.dec1} "
                  "one-row decode_impl calls")
            check(MK.mega_decode_step.launches == MK.mega_decode_step_beam.launches == 0
                  and calls.mega == calls.beam == 0 and Q.qmm.launches == want_k3
                  and Q.ffn_int8.launches == 4 * calls.dec and Q.qmm4.launches == 0
                  and A.mha_packed.launches == TURBO_LAYERS * calls.enc,
                  f"{label}, cross_kv_int8={int8}: launch counts off prediction")
            if int8:
                k9b += n9
        print(f"[19] q8_0 {label}, {secs:.0f} s: {out[True]:.2f} ms per sampled token with "
              f"int8 cross-KV (K9b), {out[False]:.2f} with float cross-KV (megakernel=False)",
              flush=True)
    return k9b


K9A_STEPS = 8
K9A_TOL = 5e-3      # JAX's tests/test_whisper_model.py QuantKVNat tolerance


def phase_k9a_path(torch, tr, mods) -> int:
    """K9a on its path: K9A_STEPS full-width decode_impl steps at B = 8
    streams on the q8_0 checkpoint's decoder, once over QuantKVNat planes
    (K9a) and once over QuantKV planes (K9b) of the same cross-KV, from the
    same inputs (each step's token the QuantKV run's argmax): logits within
    K9A_TOL of max|ref|, n_text_layer K9a launches per step. Returns K9a's
    launches."""
    TM, XQ = mods.TM, mods.XQ
    cfg, dec = tr.ctx.cfg, tr.ctx.params["decoder"]
    B, H, L = K8_STREAMS, cfg.n_text_head, cfg.n_text_layer
    g = torch.Generator(device="cuda").manual_seed(21)
    enc = torch.randn(B, cfg.n_audio_ctx, cfg.n_audio_state, generator=g,
                      device="cuda").to(torch.bfloat16)
    xk, xv = TM.cross_kv(cfg, dec, enc)
    planes = {"QuantKVNat": (TM.quantize_cross_kv_nat(xk, H), TM.quantize_cross_kv_nat(xv, H)),
              "QuantKV": (TM.quantize_cross_kv(xk, H), TM.quantize_cross_kv(xv, H))}
    caches = {k: TM.init_kv_cache(cfg, B, dtype=torch.bfloat16, device="cuda") for k in planes}
    tok = torch.randint(0, cfg.n_vocab, (B, 1), generator=g, device="cuda")
    errs, n9a = [], 0
    for step in range(K9A_STEPS):
        logits = {}
        for kind in ("QuantKVNat", "QuantKV"):
            XQ.cross_attention_q8_nat.launches = XQ.cross_attention_q8.launches = 0
            kv_k, kv_v = caches[kind]
            out, kv_k, kv_v = TM.decode_impl(cfg, dec, tok, kv_k, kv_v, step, *planes[kind])
            caches[kind] = kv_k, kv_v
            torch.cuda.synchronize()
            logits[kind] = out[:, 0].float()
            launched = (XQ.cross_attention_q8_nat.launches, XQ.cross_attention_q8.launches)
            check(launched == ((L, 0) if kind == "QuantKVNat" else (0, L)),
                  f"K9a path step {step}, {kind}: launches (K9a, K9b) {launched}")
            n9a += launched[0]
        ref = logits["QuantKV"]
        errs.append(((logits["QuantKVNat"] - ref).abs().max() / ref.abs().max()).item())
        check(bool(torch.isfinite(logits["QuantKVNat"]).all()) and errs[-1] <= K9A_TOL,
              f"K9a path step {step}: logits {errs[-1]:.3e} of max|ref| off the QuantKV run")
        tok = ref.argmax(1)[:, None]
    print(f"[21] {K9A_STEPS} decode_impl steps at B = {B}, q8_0 turbo decoder: QuantKVNat "
          f"(K9a, {planes['QuantKVNat'][0].qs.shape[2]}-row slabs, ta_valid "
          f"{planes['QuantKVNat'][0].ta_valid}) against QuantKV (K9b): logits max|diff| / "
          f"max|ref| per step {[f'{e:.2e}' for e in errs]} (limit {K9A_TOL}); K9a launches "
          f"{n9a}", flush=True)
    del planes, caches, enc, xk, xv
    torch.cuda.empty_cache()
    return n9a


# audio seeds of phase 22 (narrow f32, cross_kv_int8, cuda against cpu):
# (greedy 35 s, beam 3 40 s, transcribe_batched 60 s in 2 chunks); each CPU
# transcript stays the same when the input is scaled by 1 +- 2^-20, 2^-16
# or 2^-13
INT8_KV_NARROW_SEEDS = (0, 1, 0)


def phase_narrow_cross_int8(torch, TF, TM, tok_mod, FullParams, mods, tokens) -> None:
    """int8 cross-KV on the card against the CPU at narrow width (the f32
    timestamp config): greedy whisper_full of 35 s, beam 3 of 40 s and
    transcribe_batched of 60 s in 2 chunks, cross_kv_int8=True: token ids
    equal, at least 100 each; on the card K9b launches, on the CPU none."""
    XQ, TB = mods.XQ, mods.TB
    cfg3 = TM.WhisperConfig(*NARROW_Q)
    params3 = TM.init_params(cfg3, seed=0, dtype=torch.float32, device="cpu")
    p = dataclasses.replace(greedy_params(FullParams), cross_kv_int8=True)
    pb = dataclasses.replace(request_params(FullParams, beam_size=3), cross_kv_int8=True)
    sg, sb, st = INT8_KV_NARROW_SEEDS
    runs = (("greedy 35 s", lambda c: TF.whisper_full(c, p, audio(35.0, sg))),
            ("beam 3, 40 s", lambda c: TF.whisper_full(c, pb, audio(40.0, sb))),
            ("transcribe_batched 60 s in 2 chunks",
             lambda c: TB.transcribe_batched(c, p, audio(60.0, st), n_chunks=2)))
    ctxs = {dev: TF.WhisperContext(cfg3, params3, tok_mod.build_vocab(tokens, cfg3.n_vocab),
                                   TF._synthetic_mel_filters(80), n_loaded=1,
                                   dtype=torch.float32, device=dev) for dev in ("cuda", "cpu")}
    for label, run in runs:
        ids, n9 = {}, {}
        for dev, c in ctxs.items():
            XQ.cross_attention_q8.launches = 0
            r = run(c)
            ids[dev] = [t.id for s in r.segments for t in s.tokens]
            n9[dev] = XQ.cross_attention_q8.launches
        first = next((i for i, (a, b) in enumerate(zip(ids["cuda"], ids["cpu"])) if a != b),
                     min(len(ids["cuda"]), len(ids["cpu"])))
        print(f"[22] narrow f32, cross_kv_int8, {label}: tokens cuda {len(ids['cuda'])} cpu "
              f"{len(ids['cpu'])}, equal {ids['cuda'] == ids['cpu']}, equal prefix {first}; "
              f"K9b launches cuda {n9['cuda']} cpu {n9['cpu']}", flush=True)
        check(ids["cuda"] == ids["cpu"] and len(ids["cpu"]) >= 100 and n9["cuda"] > 0
              and n9["cpu"] == 0, f"narrow int8 cross-KV {label}: cuda and cpu differ, too "
              "few tokens, or K9b not launched on the card")


# the tensor-core probe's two products (tools/bench_int8_mxu.py): x @ W1 and
# h @ W2 of large-v3-turbo's encoder MLP, M = 1536 rows (one window, padded)
MXU_SHAPES = (("x @ W1", 1536, 1280, 5120), ("h @ W2", 1536, 5120, 1280))
# T2 also at the encoder's 8-window MLP products (the 128 x 256 tile)
MXU_S8_WIDE = (("mlp0, 8 windows", 12288, 1280, 5120), ("mlp1, 8 windows", 12288, 5120, 1280))


def phase_mxu(torch, G, P, profiling: bool = False) -> dict:
    """T1 (mm_bf16) and T2 (mm_s8) against their plain versions at the
    probe's two products, on the probe's own operands (X0 and W1; the gelu
    of their product, rounded to bf16, and W2; T2 on their quant_rows /
    quant_cols planes): T1 within one bf16 ulp of every element, plus what
    two f32 sums of the same K products can differ by in another order,
    with at most 1 % of the values differing and 0.1 % by more than one
    ulp (G.mm_bf16_within); T2 bit for bit. Times with the L2 cache flushed before each
    launch, queued behind a spin (device time): the kernel, the plain
    version, the library call (T1: cuBLAS bf16 through torch.mm with f32
    out; T2: torch._int_mm with the same scale ops, first checked equal to
    the plain version) and the bound. Then the port's probe, main(), at
    full shape: every chain call of T1 and T2 launches its kernel exactly
    twice per iteration (two warm calls and the timed repeats), and each
    chain's row is finite. With `profiling`, one call of each of the four
    chains under torch.profiler (profile_call). Returns {"mm_bf16": rows,
    "mm_s8": rows, "launches": {...}, "probe": rows}."""
    import torch.nn.functional as F
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    x0, w1, w2 = P.operands(P.M, P.K, P.F_, "cuda")
    h = F.gelu(G.mm_bf16_plain(x0, w1).float(), approximate="tanh").to(torch.bfloat16)
    rows = {"mm_bf16": [], "mm_s8": []}
    for (label, M, K, N), a, b in zip(MXU_SHAPES, (x0, h), (w1, w2)):
        check(tuple(a.shape) == (M, K) and tuple(b.shape) == (K, N), f"{label}: operands")
        shape = f"{label}: ({M},{K})@({K},{N})"
        # ---- T1 ----
        ref = G.mm_bf16_plain(a, b)
        got = G.mm_bf16(a, b)
        torch.cuda.synchronize()
        r = G.mm_bf16_within(got, ref, a, b)
        err = r["max_abs_err"]
        print(f"[23] T1 {shape}: max|err| {err:.3e} (max|ref| "
              f"{ref.float().abs().max().item():.3e}); {r['differing']} of {r['n']} values "
              f"differ (limit {G.MM_BF16_MAX_DIFFERING:.0%}), {r['past_ulp']} by more than "
              f"one bf16 ulp (limit {G.MM_BF16_MAX_PAST_ULP:.1%}), {r['past_bound']} past "
              f"the ulp plus the f32 order bound (limit 0)", flush=True)
        check(got.shape == ref.shape and r["ok"],
              f"T1 {shape}: beyond its gate against the plain version: {r}")
        k_ms = cuda_ms(torch, lambda: G.mm_bf16(a, b), flush=l2_flush, queued=True)
        p_ms = cuda_ms(torch, lambda: G.mm_bf16_plain(a, b), flush=l2_flush, queued=True)
        l_ms = cuda_ms(torch, lambda: torch.mm(a, b, out_dtype=torch.float32),
                       flush=l2_flush, queued=True)
        b_ms, b_by = bound(nbytes(a, b, got), 2 * M * K * N)
        share = 2 * M * K * N / (k_ms * 1e-3) / P.BF16_PEAK
        plan = G.mm_bf16_plan(M, N, torch.cuda.get_device_properties(0).multi_processor_count)
        rows["mm_bf16"].append({"shape": shape, "max_abs_err": err, "values_differing":
                                r["differing"], "values_past_one_ulp": r["past_ulp"], "ms": k_ms,
                                "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "bf16_peak_share": share,
                                "library_bf16_peak_share": share * k_ms / l_ms})
        print(f"[23]   T1 kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, cuBLAS bf16 "
              f"(torch.mm, f32 out) {l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}); "
              f"{2 * M * K * N / k_ms / 1e9:.1f} TFLOP/s, {100 * share:.1f} % of the bf16 peak "
              f"(cuBLAS {100 * share * k_ms / l_ms:.1f} %), kernel / cuBLAS {k_ms / l_ms:.2f}; "
              f"{plan}", flush=True)
        del ref, got
        # ---- T2 ----
        aq, a_s = P.quant_rows(a)
        bq, b_s = P.quant_cols(b)
        bq_t = bq.t().contiguous()
        ref = G.mm_s8_plain(aq, a_s, bq_t, b_s)
        got = G.mm_s8(aq, a_s, bq_t, b_s)
        torch.cuda.synchronize()
        n_diff = int((got.float() != ref.float()).sum())
        err = (got.float() - ref.float()).abs().max().item()
        print(f"[23] T2 {shape}: {n_diff} of {got.numel()} values differ from the plain "
              f"version (max|err| {err:.3e})", flush=True)
        check(got.shape == ref.shape and n_diff == 0,
              f"T2 {shape}: {n_diff} values differ from the plain version")

        def int_mm():
            return ((torch._int_mm(aq, bq_t.t()).float() * a_s) * b_s).to(torch.bfloat16)
        check(torch.equal(int_mm(), ref), f"T2 {shape}: the _int_mm yardstick differs")
        k_ms = cuda_ms(torch, lambda: G.mm_s8(aq, a_s, bq_t, b_s), flush=l2_flush,
                       queued=True)
        p_ms = cuda_ms(torch, lambda: G.mm_s8_plain(aq, a_s, bq_t, b_s), flush=l2_flush,
                       queued=True)
        l_ms = cuda_ms(torch, int_mm, flush=l2_flush, queued=True)
        b_ms, b_by = bound(nbytes(aq, a_s, bq_t, b_s, got), 2 * M * K * N, "int8")
        rows["mm_s8"].append({"shape": shape, "max_abs_err": err, "values_differing": n_diff,
                              "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                              "bound_ms": b_ms, "bound_by": b_by})
        print(f"[23]   T2 kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, _int_mm + "
              f"scale ops {l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}); "
              f"{2 * M * K * N / k_ms / 1e9:.1f} TOP/s (median of 20, cold L2, device time)",
              flush=True)
        del aq, a_s, bq, bq_t, ref, got
    del x0, w1, w2, h
    # T2 at the 8-window encoder products, seeded operands, bit for bit
    g = torch.Generator(device="cuda").manual_seed(23)
    for label, M, K, N in MXU_S8_WIDE:
        shape = f"{label}: ({M},{K})@({K},{N})"
        aq, a_s = P.quant_rows(torch.randn(M, K, generator=g, device="cuda")
                               .to(torch.bfloat16))
        bq, b_s = P.quant_cols(torch.randn(K, N, generator=g, device="cuda") * K ** -0.5)
        bq_t = bq.t().contiguous()
        ref = G.mm_s8_plain(aq, a_s, bq_t, b_s)
        got = G.mm_s8(aq, a_s, bq_t, b_s)
        torch.cuda.synchronize()
        n_diff = int((got.float() != ref.float()).sum())
        check(got.shape == ref.shape and n_diff == 0,
              f"T2 {shape}: {n_diff} values differ from the plain version")
        k_ms = cuda_ms(torch, lambda: G.mm_s8(aq, a_s, bq_t, b_s), flush=l2_flush,
                       queued=True)
        b_ms, b_by = bound(nbytes(aq, a_s, bq_t, b_s, got), 2 * M * K * N, "int8")
        rows["mm_s8"].append({"shape": shape, "max_abs_err": 0.0, "values_differing": 0,
                              "ms": k_ms, "plain_ms": None, "library_ms": None,
                              "bound_ms": b_ms, "bound_by": b_by})
        print(f"[23] T2 {shape}: bit-equal to the plain version; kernel {k_ms * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.1f} us ({b_by}), {100 * b_ms / k_ms:.1f} % of the bound",
              flush=True)
        del aq, a_s, bq, bq_t, ref, got
    del l2_flush
    torch.cuda.empty_cache()

    # ---- the probe, the main path of T1 and T2 ----
    G.mm_bf16.launches = G.mm_s8.launches = 0
    probe = P.main([])
    torch.cuda.synchronize()
    launches = {"mm_bf16": G.mm_bf16.launches, "mm_s8": G.mm_s8.launches}
    want = 2 * P.NITER * (2 + P.REPEATS)
    print(f"[23] probe main(): {len(probe)} rows; launches T1 {launches['mm_bf16']}, T2 "
          f"{launches['mm_s8']} (predicted {want} each: 2 x {P.NITER} iterations x "
          f"{2 + P.REPEATS} chain calls)", flush=True)
    check(launches["mm_bf16"] == launches["mm_s8"] == want,
          "probe: T1/T2 launch counts off prediction")
    check(len(probe) == 4
          and all(r["us_per_iter"] > 0 and 0 < r["peak_share"] < 1 for r in probe),
          "probe: malformed rows")
    if profiling:
        x0, w1, w2 = P.operands(P.M, P.K, P.F_, "cuda")
        (w1q, w1s), (w2q, w2s) = P.quant_cols(w1), P.quant_cols(w2)
        w1q_cm, w2q_cm = (w.t().contiguous().t() for w in (w1q, w2q))
        for tag, step, ws in (
                ("bf16", P.step_bf16, (w1, w2)),
                ("w8a8", P.step_xla_s8, (w1q_cm, w1s, w2q_cm, w2s)),
                ("T1", P.make_step_pallas_bf16(w1, w2), ()),
                ("T2", P.make_step_pallas_s8(w1q, w1s, w2q, w2s), ())):
            loop = P.chain(step)
            loop(x0, *ws)
            profile_call(torch, f"probe-{tag}", f"probe chain {tag}, {P.NITER} iterations",
                         lambda: (loop(x0, *ws), [])[1])
    return {**rows, "launches": launches, "probe": probe}


def profile_request(torch, tr, FullParams, secs, seed, tag, beam_size=0) -> None:
    """One request (greedy, or beam search with `beam_size`) under
    torch.profiler (profile_call)."""
    profile_call(torch, tag, f"{secs:.0f} s {f'beam {beam_size}' if beam_size else 'greedy'}",
                 lambda: [tr.transcribe(audio(secs, seed),
                                        request_params(FullParams, beam_size=beam_size))])


def profile_call(torch, tag, label, run) -> None:
    """`run()` (a list of TranscribeResults, or none) under torch.profiler: device
    busy share (the sum of kernel self times over the wall time) and the
    kernels that take it; the full table goes to
    chiprun_out/profile-<tag>.txt."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = run()
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
    n_tok = sum(r.timings.n_sample for r in results)
    print(f"[profile {tag}] {label}, traced: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} %), "
          + (f"sampled tokens {n_tok}, " if results else "")
          + f"device launches {sum(e.count for e in kern)}; top: "
          + "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms x{e.count}"
                      for e in kern[:6]), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    sort = "self_device_time_total" if hasattr(kern[0], "self_device_time_total") \
        else "self_cuda_time_total"
    (out / f"profile-{tag}.txt").write_text(rows.table(sort_by=sort, row_limit=40))


def reset_counts(A, Q, MK, E8=None, XQ=None) -> None:
    A.mha_packed.launches = MK.mega_decode_step.launches = 0
    MK.mega_decode_step.launches_by_rows.clear()
    MK.mega_decode_step_beam.launches = MK.mega_decode_step_batch.launches = 0
    Q.qmm.launches = Q.qmm4.launches = Q.ffn_int8.launches = 0
    Q.qmm.launches_by_route.update(rows=0, tiles=0)
    Q.qmm4.launches_by_route.update(rows=0, tiles=0)
    if E8 is not None:
        E8.w8a8_mm.launches = 0
    if XQ is not None:
        XQ.cross_attention_q8.launches = XQ.cross_attention_q8_nat.launches = 0


def check_k3_routes(Q, calls, what) -> None:
    """K3's launches by route in a q8_0 request: every encoder pass (32
    layers x 6 linears + 4 cross K/V, M = 1500 or 1536) and every decoder
    call over more than QMM_ROWS_MAX rows (4 layers x qkv/o/cq/co) on the
    tiles; the decoder's calls over fewer rows on the rows route."""
    big = sum(m > Q.QMM_ROWS_MAX for m in calls.dec_rows)
    want = {"rows": 16 * (calls.dec - big), "tiles": (TURBO_LAYERS * 6 + 4 * 2) * calls.enc
            + 16 * big}
    got = dict(Q.qmm.launches_by_route)
    print(f"[6] {what}: K3 launches by route {got} (predicted {want})", flush=True)
    check(got == want, f"{what}: K3 route counts {got} != {want}")


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
    from open_whisper_kit_tpu_torch.ops import encoder_int8 as E8
    from open_whisper_kit_tpu_torch.ops import experiments as XQ
    from open_whisper_kit_tpu_torch.ops import gemm as G
    from open_whisper_kit_tpu_torch.ops import quant_matmul as Q
    from open_whisper_kit_tpu_torch.tools import bench_int8_mxu as P
    from open_whisper_kit_tpu_torch.decode import batch as TB
    import types
    import numpy as np
    mods = types.SimpleNamespace(A=A, Q=Q, MK=MK, E8=E8, XQ=XQ, TB=TB, TM=TM, DL=DL, DB=DB,
                                 mel_mod=mel_mod, np=np, W=W)

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
    MK._kernel_lib("mega_batch")
    E8._kernel_lib()
    XQ._kernel_lib()
    G._lib_bf16()
    G._lib_s8()
    for name in ("qmm", "qmm_rows", "qmm4", "ffn_int8"):
        Q._kernel_lib(name)
    print(f"[2] {', '.join(KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    done("2")

    # ---- 3. every kernel against its plain version ----
    k1 = phase_k1(torch, A, torch.bfloat16, 1280, True, 1e-2, 0)
    k1["f32_shapes"] = [phase_k1(torch, A, torch.float32, S, False, 2e-5, 1)
                        for S in (128, 1280)]
    quant = phase_quant_kernels(torch, Q)
    k2 = phase_k2(torch, TM, MK, Q, profiling)
    k2v = phase_k2_verify(torch, TM, MK, Q, profiling)
    k7 = phase_k7(torch, TM, MK, Q)
    done("3")

    # ---- 11-13. the kernels of batched serving against their plain versions ----
    k6 = phase_k6(torch, E8)
    done("11")
    phase_k1(torch, A, torch.bfloat16, 1280, True, 1e-2, 2, B=K8_STREAMS, tag="12")
    done("12")
    k8 = phase_k8(torch, TM, MK, Q)
    done("13")
    # ---- 18. K9b and K9a (int8 cross-KV) against their plain versions ----
    k9 = phase_k9(torch, TM, XQ)
    done("18")
    # ---- 23. T1 and T2 against their plain versions; the probe, their path ----
    mxu = phase_mxu(torch, G, P, profiling)
    done("23")

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
        print(f"[6] q8_0 large-v3-turbo checkpoint written in "
              f"{time.perf_counter() - t0:.1f} s ({path.stat().st_size / 1e6:.0f} MB)",
              flush=True)
        # phase 16's drafts: the same tensors as q4_0, and seed-1 tensors as q8_0
        t0 = time.perf_counter()
        W.write_checkpoint(tmp / SPEC_DRAFTS[0][1], hp, TF._synthetic_mel_filters(128),
                           tokens, tensors, wtype=W.TYPE_FOR_NAME["q4_0"])
        del tensors
        W.write_checkpoint(tmp / SPEC_DRAFTS[1][1], hp, TF._synthetic_mel_filters(128),
                           tokens, W.random_reference_tensors(hp, seed=1),
                           wtype=W.TYPE_FOR_NAME["q8_0"])
        print(f"[6] the two draft checkpoints written in {time.perf_counter() - t0:.1f} s",
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
        launches["qmm"] = launches["qmm_rows"] = launches["ffn_int8"] = 0
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
            check_k3_routes(Q, calls, f"q8_0 megakernel={megakernel!r}")
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
            launches["qmm"] += Q.qmm.launches_by_route["tiles"]
            launches["qmm_rows"] += Q.qmm.launches_by_route["rows"]
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
        check_k3_routes(Q, calls, f"q8_0 beam {K7_BEAMS}")
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
            profile_call(torch, "q8_0-encoder", "q8_0 encoder + cross-KV, one 30 s window",
                         lambda: (tr.ctx.encode_window(mel.data, 0, 0), [])[1])
            profile_request(torch, tr, FullParams, 30.0, 30, "q8_0")
            profile_request(torch, tr, FullParams, 30.0, 30, "q8_0-beam5", beam_size=K7_BEAMS)
        done("6")

        # ---- 19. int8 cross-KV requests on the q8_0 checkpoint (K9b) ----
        launches["cross_attention_q8"] = phase_cross_int8(torch, tr, FullParams, mods)
        done("19")
        # ---- 21. K9a on its path: decode_impl over QuantKVNat planes ----
        launches["cross_attention_q8_nat"] = phase_k9a_path(torch, tr, mods)
        del tr, blocks
        torch.cuda.empty_cache()
        done("21")

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
                by_route = dict(Q.qmm4.launches_by_route)
                # K4 on this plane as the request runs it: one row, queued
                # (device time), the call and the host's time to issue it
                te4 = dec["te_logits"]
                x1 = x_ln.reshape(1, -1)
                ref4 = Q.qmm4_plain(x1, te4.qs, te4.scales)
                err4 = ((Q.qmm4(x1, te4.qs, te4.scales) - ref4).abs().max()
                        / ref4.abs().max()).item()
                flush7 = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
                run4 = lambda: Q.qmm4(x1, te4.qs, te4.scales)   # noqa: E731
                q4_ms = cuda_ms(torch, run4, flush=flush7, queued=True)
                c4_ms = cuda_ms(torch, run4, flush=flush7)
                h4_us = host_us(torch, run4)
                print(f"[7] W4: K4 launches by route {by_route} (the rows body at every "
                      f"decoder call of at most {Q.QMM_ROWS_MAX} rows); K4 on this plane, one "
                      f"row: {q4_ms * 1e3:.1f} us queued (device time), the call "
                      f"{c4_ms * 1e3:.1f} us, host {h4_us:.1f} us (cold L2, median of 20); "
                      f"max|err| / max|ref| {err4:.2e} against its plain version", flush=True)
                check(by_route["rows"] > 0 and err4 <= 1e-3,
                      "W4 logits: K4's rows body not launched, or off its plain version")
                del flush7
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
        # K2 alone: the card's token loop from the CPU's encoder output
        ctxs = {dev: TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device=dev)
                for dev in ("cuda", "cpu")}
        for seed in ONE_ENC_SEEDS:
            reset_counts(A, Q, MK)
            one_encoder_output(
                torch, TM, mods.TB.LR, "9", f"narrow bf16 q8_0 greedy, megakernel='int8', "
                f"{ONE_ENC_GREEDY_SECS:.0f} s, audio seed {seed}",
                lambda c, seed=seed: [[t.id for s in TF.whisper_full(
                    c, p9, audio(ONE_ENC_GREEDY_SECS, seed)).segments for t in s.tokens]], ctxs)
            check(MK.mega_decode_step.launches > 0, "narrow q8_0 from one encoder output: no K2")
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
        # K7 alone: the card's beam loop from the CPU's encoder output, on
        # requests long enough for ONE_ENC_TOKENS
        for seed in ONE_ENC_SEEDS:
            reset_counts(A, Q, MK)
            one_encoder_output(
                torch, TM, mods.TB.LR, "10", f"narrow bf16 q8_0 beam 3, megakernel='int8', "
                f"{ONE_ENC_BEAM_SECS:.0f} s, audio seed {seed}",
                lambda c, seed=seed: [[t.id for s in TF.whisper_full(
                    c, pq, audio(ONE_ENC_BEAM_SECS, seed)).segments for t in s.tokens]], ctxs,
                k=pq.beam_search.beam_size)
            check(MK.mega_decode_step_beam.launches > 0,
                  "narrow q8_0 beam from one encoder output: no K7")
        done("10")

        # ---- 14 and 20. batched serving at full width: the W8A8 encoder and
        # K8; with int8 cross-KV (K9b) ----
        got = phase_batched(torch, Transcriber, FullParams, mods,
                            tmp / "ggml-large-v3-turbo-q8_0.bin", profiling, done)
        launches.update({k: got[k] for k in ("w8a8_mm", "mega_decode_step_batch")})
        done("14, the rest")

        # ---- 15. narrow batched serving: cuda against cpu ----
        phase_narrow_batched(torch, TF, TM, tok_mod, FullParams, mods, path, tokens)
        done("15")

        # ---- 16. speculative greedy decoding at full width ----
        launches["mega_decode_step_verify"] = phase_speculative(
            torch, Transcriber, TF, FullParams, mods, tmp)
        done("16")

        # ---- 17. narrow speculative decoding: cuda against cpu ----
        phase_narrow_speculative(torch, TF, FullParams, mods, path, hp, tokens)
        done("17")

        # ---- 22. narrow int8 cross-KV: cuda against cpu ----
        phase_narrow_cross_int8(torch, TF, TM, tok_mod, FullParams, mods, tokens)
        done("22")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches.update(mxu["launches"])
    head = {"qmm": 0, "qmm_rows": 0, "qmm4": 0, "ffn_int8": 0}   # the row each headline takes
    replaces = {"mha_packed": "open_whisper_kit_tpu/ops/attention.py:70",
                "mega_decode_step": "open_whisper_kit_tpu/ops/decode_megakernel.py:1128",
                "mega_decode_step_verify": "open_whisper_kit_tpu/ops/decode_megakernel.py:1128",
                "mega_decode_step_beam": "open_whisper_kit_tpu/ops/decode_megakernel.py:1309",
                "mega_decode_step_batch": "open_whisper_kit_tpu/ops/decode_megakernel.py:1471",
                "w8a8_mm": "open_whisper_kit_tpu/ops/encoder_int8.py:129",
                "qmm": "open_whisper_kit_tpu/ops/quant_matmul.py:129",
                "qmm_rows": "open_whisper_kit_tpu/ops/quant_matmul.py:129",
                "qmm4": "open_whisper_kit_tpu/ops/quant_matmul.py:280",
                "ffn_int8": "open_whisper_kit_tpu/ops/quant_matmul.py:385",
                "cross_attention_q8": "open_whisper_kit_tpu/ops/experiments.py:155",
                "cross_attention_q8_nat": "open_whisper_kit_tpu/ops/experiments.py:73",
                "mm_bf16": "tools/bench_int8_mxu.py:115",
                "mm_s8": "tools/bench_int8_mxu.py:125"}
    rows = [{"name": "mha_packed", **k1},
            {"name": "mega_decode_step", **k2["all"], "modes": list(k2.values())},
            {"name": "mega_decode_step_verify", **k2v[("all", 5)],
             "modes": list(k2v.values())},
            {"name": "mega_decode_step_beam", **k7[("all", K7_BEAMS)],
             "modes": list(k7.values())},
            {"name": "mega_decode_step_batch", **k8["all"], "modes": list(k8.values())},
            {"name": "w8a8_mm", **next(r for r in k6 if r["shape"].startswith(K6_HEADLINE)),
             "shapes": k6},
            {"name": "cross_attention_q8", **k9["K9b"][0], "shapes": k9["K9b"]},
            {"name": "cross_attention_q8_nat", **k9["K9a"][0], "shapes": k9["K9a"]},
            {"name": "mm_bf16", **mxu["mm_bf16"][0], "shapes": mxu["mm_bf16"]},
            {"name": "mm_s8", **mxu["mm_s8"][0], "shapes": mxu["mm_s8"]}]
    for name, i in head.items():
        rows.append({"name": name, **{k: v for k, v in quant[name][i].items()
                                      if k != "shape"},
                     "shape": quant[name][i]["shape"], "shapes": quant[name]})
    stems = {"mega_decode_step": "mega_step", "mega_decode_step_verify": "mega_step",
             "mega_decode_step_beam": "mega_beam",
             "mega_decode_step_batch": "mega_batch", "w8a8_mm": "w8a8",
             "cross_attention_q8": "cross_q8", "cross_attention_q8_nat": "cross_q8",
             "mm_s8": "w8a8"}
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
