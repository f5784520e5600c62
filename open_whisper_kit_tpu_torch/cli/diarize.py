"""diarize-cli: SortFormer model + wav -> RTTM, on one torch device.

Port of open_whisper_kit_tpu/cli/diarize.py, a mirror of
Sources/diarize-cli/main.swift:1-85 (model.gguf + audio -> .rttm, optional
threshold/median-filter/preset flags). `--device` (default cuda) picks the
device; the JAX package's compile-cache setup has no counterpart here.

    python -m open_whisper_kit_tpu_torch.cli.diarize -m model.gguf -f a.wav
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(prog="diarize-cli")
    p.add_argument("-m", "--model", required=True, help="sortformer GGUF")
    p.add_argument("-f", "--file", required=True, help="input wav")
    p.add_argument("-o", "--output", default="", help="output .rttm path")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--median-window", type=int, default=11)
    p.add_argument("--preset", default="offline",
                   choices=["offline", "low_latency", "2s", "3s", "5s"])
    p.add_argument("--print-probs", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..align import rttm as R
    from ..api import Diarizer

    d = Diarizer(model_path=args.model, device=args.device)
    probs, segments = d.diarize(
        args.file, stream_config=args.preset,
        threshold=args.threshold, median_win=args.median_window,
        file_id=Path(args.file).stem)

    text = R.to_rttm(segments)
    out = args.output or str(Path(args.file).with_suffix(".rttm"))
    Path(out).write_text(text)
    print(f"wrote {len(segments)} segments to {out}")
    if args.print_probs:
        for t in range(probs.shape[0]):
            print(f"{t * 0.08:8.2f}s  " +
                  "  ".join(f"{p:.3f}" for p in probs[t]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
