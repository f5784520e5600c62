# Source: open_whisper_kit_tpu/align/rttm.py, copied as it stands (pure Python and numpy, no JAX).
"""RTTM output + parsing.

Writer ports sortformer_to_rttm (streaming-sortformer/src/sortformer.cpp:
2593-2674): threshold -> per-speaker binary median filter (majority vote,
zero-padded) -> contiguous segments -> `SPEAKER <file> 1 <start> <dur> ...`.
Parser mirrors Sources/OpenWhisperKit/RTTMParser.swift.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

FRAME_DUR = 0.08  # 80 ms per diarization frame
N_SPK = 4


@dataclasses.dataclass
class RttmSegment:
    file: str
    start: float
    duration: float
    speaker: str

    @property
    def end(self) -> float:
        return self.start + self.duration


def median_filter_binary(col: np.ndarray, win: int) -> np.ndarray:
    """Majority vote over a zero-padded window (sortformer.cpp:2572-2592)."""
    if win <= 1:
        return col.copy()
    n = len(col)
    half = win // 2
    c = np.concatenate([[0], np.cumsum(col)])
    out = np.zeros(n, col.dtype)
    for i in range(n):
        lo = max(0, i - half)
        hi = min(n, i - half + win)
        ones = c[hi] - c[lo]
        out[i] = 1 if ones * 2 > win else 0
    return out


def probs_to_segments(probs: np.ndarray, threshold: float = 0.5,
                      median_win: int = 11,
                      file_id: str = "unknown") -> list[RttmSegment]:
    """(n_frames, n_spk) sigmoid probs -> RTTM segments."""
    n_frames, n_spk = probs.shape
    binary = (probs > threshold).astype(np.uint8)
    if median_win > 1:
        for s in range(n_spk):
            binary[:, s] = median_filter_binary(binary[:, s], median_win)

    segments: list[RttmSegment] = []
    for s in range(n_spk):
        seg_start = -1
        for t in range(n_frames + 1):
            active = t < n_frames and binary[t, s]
            if active and seg_start < 0:
                seg_start = t
            elif not active and seg_start >= 0:
                segments.append(RttmSegment(
                    file_id, seg_start * FRAME_DUR,
                    (t - seg_start) * FRAME_DUR, f"speaker_{s}"))
                seg_start = -1
    return segments


def to_rttm(segments: list[RttmSegment]) -> str:
    lines = []
    for seg in segments:
        lines.append(
            f"SPEAKER {seg.file} 1 {seg.start:.2f} {seg.duration:.2f} "
            f"<NA> <NA> {seg.speaker} <NA> <NA>")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_rttm(text: str) -> list[RttmSegment]:
    """Parse RTTM lines (RTTMParser.swift semantics: skip malformed)."""
    out: list[RttmSegment] = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 8 or parts[0] != "SPEAKER":
            continue
        try:
            out.append(RttmSegment(parts[1], float(parts[3]),
                                   float(parts[4]), parts[7]))
        except ValueError:
            continue
    return out


def load_rttm(path: str | Path) -> list[RttmSegment]:
    return parse_rttm(Path(path).read_text())


def write_rttm(path: str | Path, segments: list[RttmSegment]):
    Path(path).write_text(to_rttm(segments))
