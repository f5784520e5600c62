#!/usr/bin/env python3
"""Time greedy large-v3-turbo requests of the PyTorch port on one GPU, for
one or more source trees in turn.

    python3 greedy_rtf.py ROOT [ROOT ...] [--reps 3]

Each ROOT is a directory holding `open_whisper_kit_tpu_torch/`: this
checkout, or another commit unpacked with `git archive` into a git-ignored
directory such as `build/`. Each root runs in a process of its own, in the
order given, so naming roots as A B B A interleaves two trees on one card.
A process builds the dense bf16 large-v3-turbo preset from seed 0 on cuda,
serves one warm-up request, then `--reps` timed requests of 30 s of
seeded noise with `temperature_inc = 0` (the greedy device loop alone).
Each timed request prints one JSON line: the root, wall seconds (host clock,
ending in `torch.cuda.synchronize()`), RTF, sampled tokens, encoder passes
and wall ms per sampled token. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SECONDS, AUDIO_SEED = 30.0, 30


def child(root: Path, reps: int) -> None:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from open_whisper_kit_tpu_torch import Transcriber
    from open_whisper_kit_tpu_torch.decode.params import FullParams

    if not torch.cuda.is_available():
        sys.exit("greedy_rtf: no CUDA device")
    samples = (np.random.default_rng(AUDIO_SEED).standard_normal(int(16000 * SECONDS))
               .astype(np.float32) * 0.1)
    tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16, device="cuda",
                     seed=0)
    for rep in range(reps + 1):
        p = FullParams(print_progress=False)
        p.temperature_inc = 0
        t0 = time.perf_counter()
        res = tr.transcribe(samples, p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rep == 0:
            continue   # warm-up: first launches, allocator growth
        n = res.timings.n_sample
        print(json.dumps({"root": str(root), "rep": rep, "wall_s": wall,
                          "rtf": wall / SECONDS, "sampled_tokens": n,
                          "encoder_passes": res.timings.n_encode,
                          "ms_per_token": 1e3 * wall / max(n, 1)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.roots[0].resolve(), args.reps)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--child", "--reps", str(args.reps),
                        str(root)], check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
