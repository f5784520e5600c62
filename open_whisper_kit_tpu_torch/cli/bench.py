"""whisper-bench: encoder / decoder / batch / prompt + memcpy + mul_mat
(port of open_whisper_kit_tpu/cli/bench.py).

Mirror of examples/bench/bench.cpp (-w 0 model bench, -w 1 memcpy,
-w 2 mul_mat) producing the Enc./Dec./Bch5/PP columns of
scripts/bench-all-gg.txt. The passes run through the port's own model
functions (model.encode, model.decode_impl), so a checkpoint's kernels run
on the card: K1 in every encoder layer, and K3/K5 for a quantized one.
Each timed region is a plain loop of N iterations with data dependencies,
warmed up once, ending in a synchronize. Every line carries the device: on
the card its name and power limit as nvidia-smi reports them. Runs on the
card (cuda:0; without CUDA it raises) unless `-ng/--no-gpu` asks for the
CPU.

    python -m open_whisper_kit_tpu_torch.cli.bench -m model.bin
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_line(torch, dev) -> str:
    """The device a number was taken on: the card's name and power limit
    (nvidia-smi), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return f"{dev} {out or torch.cuda.get_device_name(dev) + ', power limit unknown'}"


def _bench_model(model_path: str | None, preset: str | None, dev):
    import torch

    from ..decode.full import WhisperContext
    from ..models.whisper import model as M

    if model_path:
        ctx = WhisperContext.from_file(model_path, dtype=torch.bfloat16, device=dev)
        name = ctx.model_type
    else:
        ctx = WhisperContext.from_preset(preset or "tiny", dtype=torch.bfloat16,
                                         device=dev)
        name = preset or "tiny"
    cfg, enc, dec = ctx.cfg, ctx.params["encoder"], ctx.params["decoder"]

    mel = torch.zeros((1, 2 * cfg.n_audio_ctx, cfg.n_mels), dtype=torch.float32,
                      device=dev)

    N_ENC = 4

    def enc_loop(mel0):
        x = mel0
        for _ in range(N_ENC):
            out = M.encode(cfg, enc, x)
            x = mel0 + out.float().mean() * 1e-6
        return x.sum()

    with torch.inference_mode():
        enc_loop(mel)
        _sync(torch, dev)
        t0 = time.perf_counter()
        enc_loop(mel)
        _sync(torch, dev)
        enc_ms = (time.perf_counter() - t0) / N_ENC * 1e3

        enc_out = M.encode(cfg, enc, mel)
        xk, xv = M.cross_kv(cfg, dec, enc_out)

        def dec_bench(batch, length=128):
            xkb = xk.repeat_interleave(batch, dim=1) if batch > 1 else xk
            xvb = xv.repeat_interleave(batch, dim=1) if batch > 1 else xv

            def loop():
                kv_k, kv_v = M.init_kv_cache(cfg, batch, dtype=ctx.dtype, device=dev)
                tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
                for head in range(length):
                    logits, kv_k, kv_v = M.decode_impl(cfg, dec, tok, kv_k, kv_v,
                                                       head, xkb, xvb)
                    tok = logits[:, -1].argmax(dim=-1)[:, None]
                return tok.sum()

            loop()
            _sync(torch, dev)
            t0 = time.perf_counter()
            loop()
            _sync(torch, dev)
            return (time.perf_counter() - t0) / length * 1e3

        dec_ms = dec_bench(1)
        bch5_ms = dec_bench(5)

        def pp():
            kv_k, kv_v = M.init_kv_cache(cfg, 1, dtype=ctx.dtype, device=dev)
            toks = torch.zeros((1, 256), dtype=torch.long, device=dev)
            logits, _, _ = M.decode_impl(cfg, dec, toks, kv_k, kv_v, 0, xk, xv)
            return logits[:, -1].sum()

        pp()
        _sync(torch, dev)
        t0 = time.perf_counter()
        pp()
        _sync(torch, dev)
        pp_ms = (time.perf_counter() - t0) / 256 * 1e3

    print(f"| {device_line(torch, dev)} | {name:>16} | {enc_ms:8.2f} | {dec_ms:8.2f} "
          f"| {bch5_ms:8.2f} | {pp_ms:8.4f} |")
    print("|  (columns: Enc. ms, Dec. ms/tok, Bch5 ms/tok, PP ms/tok)")


def _bench_memcpy(dev):
    import torch

    n = 1 << 28  # 1 GB of f32
    x = torch.ones(n // 4, dtype=torch.float32, device=dev)

    def copy_loop(c):
        for _ in range(8):
            c = c * 1.0000001
        return c[:1].sum()

    copy_loop(x)
    _sync(torch, dev)
    t0 = time.perf_counter()
    copy_loop(x)
    _sync(torch, dev)
    dt = (time.perf_counter() - t0) / 8
    gbps = 2 * (n / 1e9) / dt  # read + write
    print(f"memcpy (on-device, 1 GB r+w): {gbps:7.2f} GB/s | {device_line(torch, dev)}")


def _bench_mul_mat(dev):
    import torch

    line = device_line(torch, dev)
    for size in (512, 1024, 2048, 4096):
        for dtype, label in ((torch.float32, "F32"), (torch.bfloat16, "BF16")):
            a = torch.ones((size, size), dtype=dtype, device=dev)
            b = torch.ones((size, size), dtype=dtype, device=dev)

            def mm_loop(c):
                for _ in range(8):
                    c = torch.matmul(c, b)
                return c[:1, :1].float().sum()

            mm_loop(a)
            _sync(torch, dev)
            t0 = time.perf_counter()
            mm_loop(a)
            _sync(torch, dev)
            dt = (time.perf_counter() - t0) / 8
            gflops = 2 * size ** 3 / dt / 1e9
            print(f"  {size:4d} x {size:4d}: {label}: {gflops:9.1f} GFLOPS | {line}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-bench")
    ap.add_argument("-m", "--model", default=None)
    ap.add_argument("--preset", default=None,
                    help="model preset with random weights (tiny..large-v3-turbo)")
    ap.add_argument("-w", "--what", type=int, default=0,
                    help="0=model, 1=memcpy, 2=mul_mat")
    ap.add_argument("-t", "--threads", type=int, default=4)  # compat no-op
    ap.add_argument("-fa", "--flash-attn", action="store_true")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)

    from ..decode.full import _resolve_device
    dev = _resolve_device("cpu" if args.no_gpu else "cuda")
    if args.what == 1:
        _bench_memcpy(dev)
    elif args.what == 2:
        _bench_mul_mat(dev)
    else:
        _bench_model(args.model, args.preset, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
