"""Compare two RTTM files and compute the Diarization Error Rate (port of
the JAX package's tools/compare_rttm.py, over the port's align/rttm.py).

The role of streaming-sortformer/scripts/compare_rttm.py, scored per 10 ms
frame with the best one-to-one speaker mapping (searched exhaustively over
the smaller speaker set: the diarizer has at most 4 speakers, so this is
exact where the reference script matches speakers by label).

    python -m open_whisper_kit_tpu_torch.tools.compare_rttm ref.rttm hyp.rttm [--collar 0.25]

Prints missed / false-alarm / confusion / DER. Exit code 0 (informational).
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

import numpy as np

from ..align.rttm import parse_rttm

FRAME_RATE = 100  # 10 ms frames


def load_frames(path: str, n_frames: int, collar_frames: int = 0):
    """RTTM -> (speakers, activity (n_spk, n_frames) bool, boundary
    (n_frames,) bool: the collars around the file's segment edges)."""
    segs = parse_rttm(Path(path).read_text())
    speakers = sorted({s.speaker for s in segs})
    act = np.zeros((len(speakers), n_frames), bool)
    boundary = np.zeros(n_frames, bool)
    for s in segs:
        a = int(round(s.start * FRAME_RATE))
        b = int(round((s.start + s.duration) * FRAME_RATE))
        act[speakers.index(s.speaker), a:b] = True
        if collar_frames:
            for edge in (a, b):
                boundary[max(0, edge - collar_frames):edge + collar_frames] = True
    return speakers, act, boundary


def der(ref_path: str, hyp_path: str, collar: float = 0.0) -> dict:
    ends = []
    for p in (ref_path, hyp_path):
        for s in parse_rttm(Path(p).read_text()):
            ends.append(s.start + s.duration)
    n = int(round(max(ends, default=0.0) * FRAME_RATE)) + 1
    cf = int(round(collar * FRAME_RATE))
    rs, ra, boundary = load_frames(ref_path, n, cf)
    hs, ha, _ = load_frames(hyp_path, n)
    scored = ~boundary
    ra, ha = ra[:, scored], ha[:, scored]

    # the one-to-one mapping with the most matched speech
    overlap = (ra[:, None, :] & ha[None, :, :]).sum(axis=2)  # (R, H)
    R, H = overlap.shape
    best = -1
    if R and H:
        small, big = (range(R), range(H)) if R <= H else (range(H), range(R))
        for perm in itertools.permutations(big, len(tuple(small))):
            tot = sum(overlap[i, j] if R <= H else overlap[j, i]
                      for i, j in zip(small, perm))
            best = max(best, tot)
    matched = max(best, 0)

    n_ref = ra.sum(axis=0)    # reference speakers active per frame
    n_hyp = ha.sum(axis=0)
    total_ref = int(n_ref.sum())
    missed = int(np.maximum(n_ref - n_hyp, 0).sum())
    false_alarm = int(np.maximum(n_hyp - n_ref, 0).sum())
    confusion = max(int(np.minimum(n_ref, n_hyp).sum()) - matched, 0)
    d = ((missed + false_alarm + confusion) / total_ref
         if total_ref else 0.0)
    return {"missed": missed, "false_alarm": false_alarm,
            "confusion": confusion, "total_ref": total_ref, "der": d,
            "ref_speakers": rs, "hyp_speakers": hs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ref")
    ap.add_argument("hyp")
    ap.add_argument("--collar", type=float, default=0.0,
                    help="seconds excluded around each ref boundary")
    args = ap.parse_args(argv)
    r = der(args.ref, args.hyp, args.collar)
    t = max(1, r["total_ref"])
    print(f"ref speakers : {r['ref_speakers']}")
    print(f"hyp speakers : {r['hyp_speakers']}")
    print(f"missed       : {r['missed']:8d}  ({100*r['missed']/t:.2f}%)")
    print(f"false alarm  : {r['false_alarm']:8d}  ({100*r['false_alarm']/t:.2f}%)")
    print(f"confusion    : {r['confusion']:8d}  ({100*r['confusion']/t:.2f}%)")
    print(f"DER          : {100*r['der']:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
