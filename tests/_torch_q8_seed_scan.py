"""Seed scan for the card-against-CPU checks of chip_smoke.py's phases 9
and 10 (not collected by pytest; CPU only, no jax).

The narrow bf16 q8_0 checkpoint the smoke writes (its NARROW_Q shapes,
seed-0 tensors), megakernel="int8", on the CPU (K2's and K7's plain
versions):

* greedy: 35 s requests per audio seed: tokens, the CPU's top-two logit
  gap per step over max|logit| (least over the first 100 steps, and at
  the ingest's step 0), and whether the transcript stays the same when
  the input is scaled by 1 +- 2^-20, 2^-16 and 2^-13;
* beam: beam-3 requests: tokens and, for 100 or more, the same scaling
  rule per scaling;
* beamgap: beam-3 requests: the first step at which the closest adjacent
  pair among a row's best four logits falls below 1e-3, 3e-3 and 1e-2 of
  the row's max|logit|.

    python tests/_torch_q8_seed_scan.py greedy FIRST LAST [--secs 35]
    python tests/_torch_q8_seed_scan.py beam FIRST LAST --secs 90
    python tests/_torch_q8_seed_scan.py beamgap FIRST LAST --secs 90

One JSON line per seed on stdout.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from open_whisper_kit_tpu_torch.decode import full as TF  # noqa: E402
from open_whisper_kit_tpu_torch.decode import logit_rules as LR  # noqa: E402
from open_whisper_kit_tpu_torch.decode.params import FullParams  # noqa: E402
from open_whisper_kit_tpu_torch.io import ggml_writer as W  # noqa: E402

SCALINGS = (1 + 2 ** -20, 1 - 2 ** -20, 1 + 2 ** -16, 1 - 2 ** -16, 1 + 2 ** -13, 1 - 2 ** -13)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("greedy", "beam", "beamgap"))
    ap.add_argument("first", type=int)
    ap.add_argument("last", type=int)
    ap.add_argument("--secs", type=float, default=35.0)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "narrow-q8_0.bin"
        hp = W.WhisperHParams(*CS.NARROW_Q, ftype=1, qntvr=0)
        tokens = [b"<%d>" % i for i in range(min(hp.n_vocab, 50257))]
        W.write_checkpoint(path, hp, TF._synthetic_mel_filters(80), tokens,
                           W.random_reference_tensors(hp, seed=0), wtype=W.TYPE_FOR_NAME["q8_0"])
        ctx = TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device="cpu")
    if args.mode == "greedy":
        p = CS.greedy_params(FullParams)
    else:
        p = CS.request_params(FullParams, beam_size=3)
    p.megakernel = "int8"

    def run(seed, scale=1.0):
        with CS.StepLogits(torch, LR, 4) as st:
            r = TF.whisper_full(ctx, p, CS.audio(args.secs, seed) * scale)
        return [t.id for s in r.segments for t in s.tokens], st.rows()

    for seed in range(args.first, args.last + 1):
        ids, rows = run(seed)
        out = {"seed": seed, "secs": args.secs, "tokens": len(ids), "steps": len(rows)}
        if args.mode == "greedy":
            gaps = []
            for v, _, raw in rows:
                g, m = v[:, 0] - v[:, 1], raw.abs().amax(-1)
                ok = g.isfinite()
                gaps.append(float((g[ok] / m[ok]).min()) if ok.any() else 1.0)
            out.update(least_gap=min(gaps[:100]), gap_step0=gaps[0],
                       stable=all(run(seed, s)[0] == ids for s in SCALINGS))
        elif args.mode == "beam":
            if len(ids) >= 100:
                out["stable"] = [run(seed, s)[0] == ids for s in SCALINGS]
        else:
            closest = []
            for v, _, raw in rows:
                g = v[:, :3] - v[:, 1:4]
                rel = (g / raw.abs().amax(-1, keepdim=True))[g.isfinite()]
                closest.append(float(rel.min()) if rel.numel() else 1.0)
            out["first_below"] = {thr: next((i for i, c in enumerate(closest) if c < thr), None)
                                  for thr in (1e-3, 3e-3, 1e-2)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
