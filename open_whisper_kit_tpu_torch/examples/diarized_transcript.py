"""Speaker-attributed transcription: ASR + diarization + alignment
(PyTorch port of examples/diarized_transcript.py).

The Swift SDK's headline flow (OpenWhisperKit.transcribe + SortFormerContext
+ DiarizationAligner, Sources/OpenWhisperKit/) as a script:

    python -m open_whisper_kit_tpu_torch.examples.diarized_transcript \
        -m ggml-large-v3-turbo.bin -dm sortformer.gguf meeting.wav

Prints an utterance-grouped "[speaker_N]: text" transcript and writes a
sidecar RTTM. Runs on the card unless `-ng` asks for the CPU (`-dev N`:
cuda:N).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import add_device_args, device_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("audio")
    ap.add_argument("-m", "--model", required=True, help="whisper ggml-bin")
    ap.add_argument("-dm", "--diarize-model", required=True,
                    help="sortformer GGUF")
    ap.add_argument("--preset", default="3s",
                    choices=["low_latency", "2s", "3s", "5s"])
    ap.add_argument("--language", default="en")
    ap.add_argument("--rttm-out", default=None)
    add_device_args(ap)
    args = ap.parse_args(argv)

    import torch

    from .. import api
    from ..align.rttm import to_rttm
    from ..decode.params import FullParams

    # 1) transcribe with word timestamps
    device = device_of(args)
    tr = api.Transcriber(model_path=args.model, dtype=torch.bfloat16, device=device)
    params = FullParams(language=args.language, token_timestamps=True)
    result = tr.transcribe(args.audio, params)
    words = api.words_from_result(result, tr.ctx.vocab)

    # 2) diarize (device-resident AOSC when on an accelerator)
    dz = api.Diarizer(model_path=args.diarize_model, device=device)
    _probs, segments = dz.diarize(args.audio, stream_config=args.preset)

    # 3) align words to speakers, group into utterances
    diarized = api.align(words, segments)
    for utt in diarized.segments:
        print(f"[{utt.speaker}] {utt.start:7.2f}-{utt.end:7.2f}: {utt.text}")

    rttm_path = args.rttm_out or (str(Path(args.audio).with_suffix(".rttm")))
    Path(rttm_path).write_text(to_rttm(segments))
    print(f"\nwrote {rttm_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
