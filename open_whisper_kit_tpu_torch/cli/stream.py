"""whisper-stream-compatible CLI of the PyTorch port (port of
open_whisper_kit_tpu/cli/stream.py).

Reference: examples/stream/stream.cpp. Runs on the card (cuda:0; without
CUDA it raises) unless `-ng/--no-gpu` asks for the CPU. Audio sources, in
priority order:
`--device <alsa-dev>` live microphone capture (native/owk_audio ALSA loop,
the SDL audio_async analog), `--input-wav` replayed at real-time pace, or
raw s16le PCM on stdin (e.g. piped from `arecord`/`sox`/`ffmpeg`).
Capture degrades to stdin with a warning on hosts without ALSA.

    python -m open_whisper_kit_tpu_torch.cli.stream -m model.bin --input-wav a.wav
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(prog="whisper-stream")
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--step", type=int, default=3000, dest="step_ms")
    p.add_argument("--length", type=int, default=10000, dest="length_ms")
    p.add_argument("--keep", type=int, default=200, dest="keep_ms")
    p.add_argument("-c", "--capture", type=int, default=-1)  # compat no-op
    p.add_argument("-mt", "--max-tokens", type=int, default=32)
    p.add_argument("-ac", "--audio-ctx", type=int, default=0)
    p.add_argument("-bs", "--beam-size", type=int, default=-1)
    p.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    p.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    p.add_argument("-tr", "--translate", action="store_true")
    p.add_argument("-nf", "--no-fallback", action="store_true")
    p.add_argument("-ps", "--print-special", action="store_true")
    p.add_argument("-kc", "--keep-context", action="store_true")
    p.add_argument("-l", "--language", default="en")
    p.add_argument("-m", "--model", default="models/ggml-base.en.bin")
    p.add_argument("-f", "--file", default="", help="output transcript file")
    p.add_argument("-tdrz", "--tinydiarize", action="store_true")
    p.add_argument("-sa", "--save-audio", action="store_true")
    p.add_argument("-ng", "--no-gpu", action="store_true",
                   help="run on the CPU")
    p.add_argument("-fa", "--flash-attn", action="store_true")
    p.add_argument("--input-wav", default="",
                   help="WAV to replay in simulated real time")
    p.add_argument("--realtime", action="store_true",
                   help="pace --input-wav playback at 1x")
    p.add_argument("--device", default="",
                   help="ALSA capture device (e.g. 'default'): live mic "
                        "input via native/owk_audio; falls back to stdin "
                        "with a warning if capture is unavailable")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..decode.full import WhisperContext
    from ..decode.stream import StreamingTranscriber, StreamParams

    ctx = WhisperContext.from_file(args.model, dtype=torch.bfloat16,
                                   device="cpu" if args.no_gpu else "cuda")
    sp = StreamParams(
        step_ms=args.step_ms, length_ms=args.length_ms, keep_ms=args.keep_ms,
        max_tokens=args.max_tokens, audio_ctx=args.audio_ctx,
        beam_size=args.beam_size, vad_thold=args.vad_thold,
        freq_thold=args.freq_thold, translate=args.translate,
        no_fallback=args.no_fallback, print_special=args.print_special,
        no_context=not args.keep_context, tinydiarize=args.tinydiarize,
        language=args.language)
    st = StreamingTranscriber(ctx, sp)

    fout = open(args.file, "w") if args.file else None

    def emit(events):
        for ev in events:
            line = ev.text if not ev.final else ev.text + "\n"
            print(("\r" + ev.text) if not ev.final else "\n" + ev.text,
                  end="", flush=True)
            if fout and ev.final:
                fout.write(ev.text + "\n")
                fout.flush()

    print("[Start speaking]", flush=True)
    capture = None
    if args.device:
        from ..audio.native import CaptureUnavailable, LiveCapture
        try:
            capture = LiveCapture(device=args.device,
                                  buffer_ms=2 * args.length_ms + 2000)
        except CaptureUnavailable as ex:
            print(f"[capture unavailable: {ex}; reading stdin]",
                  file=sys.stderr, flush=True)
    if capture is not None:
        # mic loop (examples/stream/stream.cpp:18-44): poll every step_ms,
        # feed exactly the unseen tail so the step/length/keep engine sees
        # a gapless stream
        seen = 0
        try:
            while capture.running:
                time.sleep(args.step_ms / 1000.0)
                pcm, seen = capture.get_new(seen)
                if len(pcm):
                    emit(st.feed(pcm))
        except KeyboardInterrupt:
            pass
        finally:
            capture.stop()
    elif args.input_wav:
        from ..audio.wav import load_wav
        audio = load_wav(args.input_wav)
        chunk = 16000 * max(args.step_ms, 500) // 1000
        for i in range(0, len(audio), chunk):
            if args.realtime:
                time.sleep(chunk / 16000.0)
            emit(st.feed(audio[i:i + chunk]))
    else:
        # raw s16le pcm on stdin
        while True:
            raw = sys.stdin.buffer.read(16000 * 2)  # 1 s blocks
            if not raw:
                break
            pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
            emit(st.feed(pcm))

    if fout:
        fout.close()
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
