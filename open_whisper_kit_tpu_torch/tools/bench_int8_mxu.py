"""Probe: does the H100 run s8 x s8 -> s32 at about twice its bf16 rate, and
from which layer (the library's GEMMs, or the port's own kernels)?

Counterpart of the JAX package's tools/bench_int8_mxu.py, on the
encoder's own dominant compute: the MLP pair x @ W1 -> gelu -> @ W2 at
large-v3-turbo's shapes ((1536, 1280) @ (1280, 5120) @ (5120, 1280) = 40.3
GOP an iteration), chained x_{i+1} = f(x_i) NITER times with the output
renormalised, so every product is computed and written. Four chains:

* `step_bf16`: the library's bf16 GEMM (cuBLAS through
  `torch.mm(..., out_dtype=torch.float32)`), tanh gelu between;
* `step_xla_s8`: the library's int8 GEMM (`torch._int_mm`) with the row
  quantize and the scale ops around it, the real W8A8 serving costs;
* `make_step_pallas_bf16`: kernel T1 (ops/gemm.py::mm_bf16);
* `make_step_pallas_s8`: kernel T2 (ops/gemm.py::mm_s8), the rows
  quantized between the products.

    python -m open_whisper_kit_tpu_torch.tools.bench_int8_mxu
    python -m open_whisper_kit_tpu_torch.tools.bench_int8_mxu --device cpu --shape 256,256,512

Every row gives µs per iteration (the median of REPEATS timed chain
calls after two warm calls, and their range), the rate in TOP/s and, on the
card, the share of an H100 SXM's dense bf16 (989 TFLOP/s) or int8 (1979
TOP/s) peak. The card's name and power limit come first. The chain is a
Python loop whose host side can outlast its kernels, so each timed call
starts behind a spin on the card twice as long as the second warm call's
host time: the CUDA events then span the kernels, not the host's launching
them, as the JAX probe's one jitted scan does. The JAX probe sweeps TPU VMEM blocks;
here T1 and T2 run once each, at the tile their plans pick for each product
(`ops.gemm.mm_bf16_plan`, `ops.gemm.w8a8_plan`), which their rows name on
the card.
On the CPU (`--device cpu`) every product takes its plain version and the
times are the CPU's; no share of a peak is given.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.encoder_int8 import quantize_w_cols
from ..ops.gemm import mm_bf16, mm_bf16_plan, mm_s8, w8a8_plan

M, K, F_ = 1536, 1280, 5120
NITER = 32
REPEATS = 5                               # timed chain calls per row
BF16_PEAK, INT8_PEAK = 989e12, 1979e12   # H100 SXM, dense (NVIDIA data sheet)
_INV127 = float(np.float32(1.0 / 127.0))
_SPIN_HZ = 2.0e9                          # cycles a second of torch.cuda._sleep, about


def gop(m: int, k: int, f: int) -> float:
    """Operations of one iteration, both products, in units of 1e9."""
    return 2 * m * k * f * 2 / 1e9


def operands(m: int, k: int, f: int, device) -> tuple[torch.Tensor, ...]:
    """X0 (m, k), W1 (k, f), W2 (f, k) in bf16: the probe's draws from
    default_rng(0), in its order and scale."""
    rng = np.random.default_rng(0)
    draws = (rng.standard_normal((m, k)) * 0.5, rng.standard_normal((k, f)) * k ** -0.5,
             rng.standard_normal((f, k)) * f ** -0.5)
    return tuple(torch.from_numpy(d).to(torch.bfloat16).to(device) for d in draws)


def quant_rows(x: torch.Tensor):
    """(M, K) float -> int8 rows + f32 per-row scale (symmetric), as the
    probe's jitted chain computes it: s = amax * f32(1/127) (XLA folds the
    division by the constant 127 into that product), q = round(x / s) by
    IEEE division, clipped to +-127; an all-zero row gives zeros."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True) * _INV127
    q = torch.clamp(torch.round(x32 / torch.where(s == 0, 1.0, s)), -127, 127)
    return q.to(torch.int8), s


def quant_cols(w: torch.Tensor):
    """(K, N) float -> int8 columns + f32 (1, N) scales: s = amax / 127 by
    IEEE division (the probe quantizes its weights eagerly)."""
    return quantize_w_cols(w)


def timeit(fn, *args, niter: int = NITER) -> list[float]:
    """Seconds per iteration of REPEATS timed calls of fn(*args) after two
    warm calls: the first builds kernels and initialises libraries, the
    second gives the host's time to issue one call. On the card each timed
    call runs behind a spin twice that long and is timed with CUDA events;
    on the CPU with the host clock."""
    device = args[0].device
    for _ in range(2):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(*args)
        host = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    for _ in range(REPEATS):
        if device.type == "cuda":
            torch.cuda._sleep(int(2 * host * _SPIN_HZ))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3 / niter)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) / niter)
    return times


def chain(step, niter: int = NITER):
    """x -> step(x, *ws) niter times, each output renormalised to unit
    mean square and rounded to bf16."""
    def loop(x, *ws):
        for _ in range(niter):
            # f32 before the scale: torch keeps bf16 * (0-d f32) in bf16,
            # where jnp promotes to f32
            y = step(x, *ws).float()
            x = (y * torch.rsqrt(torch.mean(torch.square(y)) + 1e-6)).to(torch.bfloat16)
        return x
    return loop


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 @ bf16 -> f32: cuBLAS on the card (the library yardstick),
    an f32 product on the CPU, where torch has no mm with out_dtype."""
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _int_mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> the exact sums in f32: torch._int_mm on
    the card, a float64 product on the CPU."""
    if a.is_cuda:
        return torch._int_mm(a, b).float()
    return (a.double() @ b.double()).float()


# ---- the library's bf16 GEMM ----
def step_bf16(x, w1, w2):
    h = F.gelu(_mm_f32(x, w1), approximate="tanh").to(torch.bfloat16)
    return _mm_f32(h, w2)


# ---- the library's W8A8 ----
def step_xla_s8(x, w1q, w1s, w2q, w2s):
    xq, xs = quant_rows(x)
    h = F.gelu(_int_mm_f32(xq, w1q) * xs * w1s, approximate="tanh")
    hq, hs = quant_rows(h)
    return _int_mm_f32(hq, w2q) * hs * w2s


# ---- the port's kernels ----
def make_step_pallas_bf16(w1: torch.Tensor, w2: torch.Tensor):
    """The chained step over T1, each product at its plan's tile."""
    def step(x):
        h = F.gelu(mm_bf16(x, w1).float(), approximate="tanh").to(torch.bfloat16)
        return mm_bf16(h, w2)
    return step


def _tiles(plan, m: int, k: int, f: int, device: torch.device) -> str:
    """The tiles `plan` picks for x @ W1 and h @ W2 on the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return " / ".join(f"{bm}x{bn}" for bm, bn in (plan(m, n, sms).tile for n in (f, k)))


def t1_name(m: int, k: int, f: int, device: torch.device) -> str:
    """T1's row: on the card with the tiles its plan picks for x @ W1 and
    h @ W2."""
    if device.type != "cuda":
        return "T1 bf16"
    return "T1 bf16 " + _tiles(mm_bf16_plan, m, k, f, device)


def t2_name(m: int, k: int, f: int, device: torch.device) -> str:
    """T2's row, named as T1's."""
    if device.type != "cuda":
        return "T2 W8A8 (incl act quant)"
    return f"T2 W8A8 {_tiles(w8a8_plan, m, k, f, device)} (incl act quant)"


def make_step_pallas_s8(w1q, w1s, w2q, w2s):
    """The chained step over T2, each product at its plan's tile. The int8
    weights come in JAX's (K, N) layout and are transposed here, once,
    into the (N, K) planes T2 takes."""
    w1t, w2t = w1q.t().contiguous(), w2q.t().contiguous()

    def step(x):
        xq, xs = quant_rows(x)
        h = F.gelu(mm_s8(xq, xs, w1t, w1s).float(), approximate="tanh")
        hq, hs = quant_rows(h)
        return mm_s8(hq, hs, w2t, w2s)
    return step


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def report(name: str, times: list[float], n_gop: float, peak: float | None) -> dict:
    med = statistics.median(times)
    row = {"name": name, "us_per_iter": med * 1e6, "us_min": min(times) * 1e6,
           "us_max": max(times) * 1e6, "top_s": n_gop / med / 1e3,
           "peak_share": None if peak is None else n_gop * 1e9 / med / peak}
    share = "" if peak is None else f"  {row['peak_share']:6.1%} of peak"
    print(f"{name:36s} {row['us_per_iter']:9.1f} us [{row['us_min']:.1f}-"
          f"{row['us_max']:.1f}]  {row['top_s']:7.1f} TOP/s{share}", flush=True)
    return row


def _shape(text: str) -> tuple[int, int, int]:
    m, k, f = (int(v) for v in text.split(","))
    return m, k, f


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the four chains, print one row each, return the rows."""
    ap = argparse.ArgumentParser(prog="python -m open_whisper_kit_tpu_torch.tools.bench_int8_mxu",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shape", type=_shape, default=(M, K, F_), metavar="M,K,F")
    ap.add_argument("--niter", type=int, default=NITER, help="chained iterations per call")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_int8_mxu: no CUDA device (pass --device cpu for the "
                           "plain versions on the CPU)")
    m, k, f = args.shape
    n_gop = gop(m, k, f)
    on_card = device.type == "cuda"
    if on_card:
        print(nvidia_smi_line(), flush=True)
        where = f"{torch.cuda.get_device_name(device)}, torch {torch.__version__}"
    else:
        where = "cpu (plain versions; no device metric)"
    print(f"MLP pair ({m},{k})x({k},{f})x({f},{k}), {args.niter} chained iters, "
          f"{n_gop:.1f} GOP/iter, {where}", flush=True)

    x0, w1, w2 = operands(m, k, f, device)
    w1q, w1s = quant_cols(w1)
    w2q, w2s = quant_cols(w2)
    # column-major (K, N) views: the layout of _int_mm's second operand on
    # the card, made once outside the timed chains
    w1q_cm, w2q_cm = (w.t().contiguous().t() for w in (w1q, w2q))
    bf16_peak, int8_peak = (BF16_PEAK, INT8_PEAK) if on_card else (None, None)

    def run(step, *ws):
        return timeit(chain(step, args.niter), x0, *ws, niter=args.niter)

    rows = [report("torch bf16 (torch.mm, f32 out)", run(step_bf16, w1, w2), n_gop,
                   bf16_peak),
            report("torch W8A8 (_int_mm, incl act quant)",
                   run(step_xla_s8, w1q_cm, w1s, w2q_cm, w2s),
                   n_gop, int8_peak)]
    rows.append(report(t1_name(m, k, f, device), run(make_step_pallas_bf16(w1, w2)), n_gop,
                       bf16_peak))
    rows.append(report(t2_name(m, k, f, device), run(make_step_pallas_s8(w1q, w1s, w2q, w2s)),
                       n_gop, int8_peak))
    return rows


if __name__ == "__main__":
    main()
