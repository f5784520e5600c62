"""Voice-command example (examples/command analog; PyTorch port of
examples/voice_command.py).

Listens for short utterances (vad_simple gated), transcribes them, and
matches against an allowed-command list (optionally grammar-constrained).
Audio comes from a WAV replay or raw s16le stdin — same sources as the
stream CLI. Runs on the card unless `-ng` asks for the CPU (`-dev N`:
cuda:N).

    python -m open_whisper_kit_tpu_torch.examples.voice_command \
        -m ggml-base.en.bin --commands "turn on the light,turn off the light" \
        --input-wav cmd.wav
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from . import add_device_args, device_of


def best_command(text: str, commands: list[str]) -> tuple[str, float]:
    """Nearest command by word-overlap similarity (examples/command's
    simple matching mode)."""
    t = set(text.lower().split())
    best, score = "", 0.0
    for c in commands:
        cw = set(c.lower().split())
        s = len(t & cw) / max(1, len(cw))
        if s > score:
            best, score = c, s
    return best, score


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--commands", default="", help="comma-separated commands")
    ap.add_argument("--grammar", default=None, help="GBNF grammar file")
    ap.add_argument("--input-wav", default="")
    ap.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    add_device_args(ap)
    args = ap.parse_args(argv)

    import torch

    from ..audio.wav import load_wav
    from ..decode.full import WhisperContext, whisper_full
    from ..decode.params import FullParams
    from ..decode.stream import StreamingTranscriber, StreamParams

    ctx = WhisperContext.from_file(args.model, dtype=torch.bfloat16,
                                   device=device_of(args))
    commands = [c.strip() for c in args.commands.split(",") if c.strip()]

    sp = StreamParams(step_ms=0, length_ms=5000, vad_thold=args.vad_thold)
    st = StreamingTranscriber(ctx, sp)

    # grammar-constrained decode for the command utterances
    if args.grammar:
        grammar_text = Path(args.grammar).read_text()
    elif commands:
        alts = " | ".join(f'"{c}"' for c in commands)
        grammar_text = f"root ::= \" \"? ({alts})"
    else:
        grammar_text = None

    def handle(events):
        for ev in events:
            text = ev.text.strip()
            if not text:
                continue
            if commands:
                cmd, score = best_command(text, commands)
                print(f"heard: {text!r} -> command: {cmd!r} ({score:.0%})")
            else:
                print(f"heard: {text!r}")

    if grammar_text:
        # one-shot grammar-constrained mode on the whole input
        audio = load_wav(args.input_wav) if args.input_wav else None
        if audio is None:
            print("grammar mode needs --input-wav", file=sys.stderr)
            return 1
        p = FullParams(print_progress=False, grammar_rules=grammar_text,
                       single_segment=True, max_tokens=16)
        p.greedy.best_of = 1
        res = whisper_full(ctx, p, audio)
        handle([type("E", (), {"text": s.text})() for s in res.segments])
        return 0

    if args.input_wav:
        audio = load_wav(args.input_wav)
        for i in range(0, len(audio), 8000):
            handle(st.feed(audio[i:i + 8000]))
        handle(st.feed(np.zeros(32000, np.float32)))  # flush with silence
    else:
        while True:
            raw = sys.stdin.buffer.read(16000)
            if not raw:
                break
            pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
            handle(st.feed(pcm))
    return 0


if __name__ == "__main__":
    sys.exit(main())
