"""vad-speech-segments: standalone Silero VAD segment dump (port of
open_whisper_kit_tpu/cli/vad_segments.py).

Mirror of examples/vad-speech-segments/speech.cpp: model + wav ->
printed speech segments. Runs on the card unless `-ng/--no-gpu` asks for
the CPU.

    python -m open_whisper_kit_tpu_torch.cli.vad_segments -vm silero.bin -f a.wav
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vad-speech-segments")
    ap.add_argument("-vm", "--vad-model", required=True)
    ap.add_argument("-f", "--file", required=True)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--min-speech-duration-ms", type=int, default=250)
    ap.add_argument("--min-silence-duration-ms", type=int, default=100)
    ap.add_argument("--max-speech-duration-s", type=float, default=float("inf"))
    ap.add_argument("--speech-pad-ms", type=int, default=30)
    ap.add_argument("--samples-overlap", type=float, default=0.1)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)

    from ..audio.wav import load_wav
    from ..decode.full import _resolve_device
    from ..decode.params import VadParams
    from ..models.silero.vad import SileroVAD
    from ..vad.segments import segments_from_probs

    vad = SileroVAD.from_file(args.vad_model,
                              device=_resolve_device("cpu" if args.no_gpu else "cuda"))
    audio = load_wav(args.file)
    probs = vad.detect_speech(audio)
    params = VadParams(
        threshold=args.threshold,
        min_speech_duration_ms=args.min_speech_duration_ms,
        min_silence_duration_ms=args.min_silence_duration_ms,
        max_speech_duration_s=args.max_speech_duration_s,
        speech_pad_ms=args.speech_pad_ms,
        samples_overlap=args.samples_overlap)
    segments = segments_from_probs(probs, params)

    print(f"Detected {len(segments)} speech segments:")
    for i, seg in enumerate(segments):
        print(f"Speech segment {i}: start = {seg.start / 100.0:.2f}, "
              f"end = {seg.end / 100.0:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
