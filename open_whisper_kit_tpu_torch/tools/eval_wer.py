"""WER evaluation harness (port of the JAX package's tools/eval_wer.py).

Transcribe a local corpus with the port's Transcriber and score it against
the reference transcripts, after OpenAI's English normalization
(english_normalizer.py). As in whisper-cli, the run is on card 0 unless
`-dev N` picks another or `-ng` asks for the CPU; without CUDA and without
`-ng` it raises.

    python -m open_whisper_kit_tpu_torch.tools.eval_wer --model ggml.bin --corpus DIR [--limit N]

Corpus layouts:
  * librispeech: DIR/**/*.flac|wav + *.trans.txt ("utt-id TEXT" lines)
  * plain:       DIR/*.wav + DIR/*.txt (same stem)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .english_normalizer import normalize_english as normalize_text


def wer(ref: str, hyp: str) -> tuple[float, int]:
    """Word error rate by edit distance; returns (wer, n_ref_words)."""
    r = ref.split()
    h = hyp.split()
    if not r:
        return (0.0 if not h else 1.0), 0
    d = list(range(len(h) + 1))
    for i in range(1, len(r) + 1):
        prev = d[0]
        d[0] = i
        for j in range(1, len(h) + 1):
            cur = d[j]
            d[j] = min(d[j] + 1, d[j - 1] + 1,
                       prev + (0 if r[i - 1] == h[j - 1] else 1))
            prev = cur
    return d[len(h)] / len(r), len(r)


def collect_corpus(corpus: Path) -> list[tuple[Path, str]]:
    pairs: list[tuple[Path, str]] = []
    trans: dict[str, str] = {}
    for tf in corpus.rglob("*.trans.txt"):
        for line in tf.read_text().splitlines():
            utt, _, text = line.partition(" ")
            trans[utt] = text
    for ext in ("*.wav", "*.flac"):
        for af in sorted(corpus.rglob(ext)):
            if af.stem in trans:
                pairs.append((af, trans[af.stem]))
            else:
                txt = af.with_suffix(".txt")
                if txt.exists():
                    pairs.append((af, txt.read_text().strip()))
    return pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--beam-size", type=int, default=-1)
    ap.add_argument("--language", default="en")
    ap.add_argument("--no-fallback", action="store_true",
                    help="greedy t=0, single decoder, no temperature "
                         "fallback (matches the offline dry-run oracle)")
    ap.add_argument("-ng", "--no-gpu", action="store_true", help="run on the CPU")
    ap.add_argument("-dev", "--device", type=int, default=0,
                    help="the card to run on (cuda:N)")
    args = ap.parse_args(argv)

    from .. import api
    from ..cli.main import device_from_args
    from ..decode.params import FullParams, SamplingStrategy

    pairs = collect_corpus(Path(args.corpus))
    if args.limit:
        pairs = pairs[:args.limit]
    if not pairs:
        print("no (audio, transcript) pairs found", file=sys.stderr)
        return 1

    tr = api.Transcriber(model_path=args.model, device=device_from_args(args))
    p = FullParams(print_progress=False, language=args.language)
    if args.beam_size > 1:
        p.strategy = SamplingStrategy.BEAM_SEARCH
        p.beam_search.beam_size = args.beam_size
    if args.no_fallback:
        p.greedy.best_of = 1
        p.temperature_inc = 0.0

    total_err = 0.0
    total_words = 0
    for af, ref_text in pairs:
        res = tr.transcribe(af, p)
        hyp = normalize_text(res.text)
        ref = normalize_text(ref_text)
        w, n = wer(ref, hyp)
        total_err += w * n
        total_words += n
        print(f"{af.name}: wer={w:.3f}")

    print(f"\nTOTAL WER: {total_err / max(1, total_words):.4f} "
          f"over {total_words} words, {len(pairs)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
