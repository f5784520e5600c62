# Source: open_whisper_kit_tpu/vad/segments.py, copied as it stands (pure Python and numpy, no JAX).
"""VAD probability -> speech segments, audio splicing, and time remapping.

Ports of:
* whisper_vad_segments_from_probs (src/whisper.cpp:5210-5445) — hysteresis
  thresholding (neg_threshold = threshold-0.15, floor 0.01), min speech
  250 ms, min silence 100 ms, forced max-speech splits at >=98 ms silences,
  200 ms gap merge, inter-segment padding,
* whisper_vad (src/whisper.cpp:6643-6825) — speech-segment splice with
  0.1 s silence gaps + overlap, and the vad_mapping_table,
* map_processed_to_original_time (src/whisper.cpp:7947-7986) — binary-search
  linear interpolation back to original timestamps.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from ..decode.params import VadParams

SAMPLE_RATE = 16000
N_WINDOW = 512


@dataclasses.dataclass
class VadSegment:
    start: float   # centiseconds
    end: float


def _samples_to_cs(samples: int) -> int:
    return int(samples / SAMPLE_RATE * 100.0 + 0.5)


def _cs_to_samples(cs: float) -> int:
    return int(cs / 100.0 * SAMPLE_RATE + 0.5)


def segments_from_probs(probs: np.ndarray, params: VadParams) -> list[VadSegment]:
    threshold = params.threshold
    n_probs = len(probs)
    min_silence_samples = SAMPLE_RATE * params.min_silence_duration_ms // 1000
    audio_length_samples = n_probs * N_WINDOW
    min_speech_samples = SAMPLE_RATE * params.min_speech_duration_ms // 1000
    speech_pad_samples = SAMPLE_RATE * params.speech_pad_ms // 1000

    if params.max_speech_duration_s > 100000.0:
        max_speech_samples = 2**30
    else:
        max_speech_samples = int(SAMPLE_RATE * params.max_speech_duration_s
                                 - N_WINDOW - 2 * speech_pad_samples)
        if max_speech_samples < 0:
            max_speech_samples = 2**30

    min_silence_at_max_speech = SAMPLE_RATE * 98 // 1000
    neg_threshold = max(threshold - 0.15, 0.01)

    speeches: list[list[int]] = []
    is_speech = False
    temp_end = 0
    prev_end = 0
    next_start = 0
    cur_start = 0
    has_cur = False

    for i in range(n_probs):
        prob = float(probs[i])
        cur_sample = N_WINDOW * i

        if prob >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = cur_sample

        if prob >= threshold and not is_speech:
            is_speech = True
            cur_start = cur_sample
            has_cur = True
            continue

        if is_speech and (cur_sample - cur_start) > max_speech_samples:
            if prev_end:
                speeches.append([cur_start, prev_end])
                has_cur = True
                if next_start < prev_end:
                    is_speech = False
                    has_cur = False
                else:
                    cur_start = next_start
                prev_end = next_start = temp_end = 0
            else:
                speeches.append([cur_start, cur_sample])
                prev_end = next_start = temp_end = 0
                is_speech = False
                has_cur = False
                continue

        if prob < neg_threshold and is_speech:
            if not temp_end:
                temp_end = cur_sample
            if (cur_sample - temp_end) > min_silence_at_max_speech:
                prev_end = temp_end
            if (cur_sample - temp_end) < min_silence_samples:
                continue
            if (temp_end - cur_start) > min_speech_samples:
                speeches.append([cur_start, temp_end])
            prev_end = next_start = temp_end = 0
            is_speech = False
            has_cur = False

    if has_cur and (audio_length_samples - cur_start) > min_speech_samples:
        speeches.append([cur_start, audio_length_samples])

    # merge adjacent segments with <200 ms gaps
    max_merge_gap = SAMPLE_RATE * 200 // 1000
    merged: list[list[int]] = []
    for s in speeches:
        if merged and s[0] - merged[-1][1] < max_merge_gap:
            merged[-1][1] = s[1]
        else:
            merged.append(list(s))
    speeches = [s for s in merged if s[1] - s[0] >= min_speech_samples]

    # padding
    out: list[VadSegment] = []
    for i, s in enumerate(speeches):
        if i == 0:
            s[0] = max(0, s[0] - speech_pad_samples)
        if i < len(speeches) - 1:
            gap = speeches[i + 1][0] - s[1]
            if gap < 2 * speech_pad_samples:
                s[1] += gap // 2
                speeches[i + 1][0] = max(0, speeches[i + 1][0] - gap // 2)
            else:
                s[1] = min(s[1] + speech_pad_samples, audio_length_samples)
                speeches[i + 1][0] = max(0, speeches[i + 1][0] - speech_pad_samples)
        else:
            s[1] = min(s[1] + speech_pad_samples, audio_length_samples)
        out.append(VadSegment(_samples_to_cs(s[0]), _samples_to_cs(s[1])))
    return out


@dataclasses.dataclass
class VadFilterResult:
    samples: np.ndarray                  # spliced speech + silence gaps
    mapping: list[tuple[int, int]]       # (processed_cs, original_cs), sorted
    segments: list[VadSegment]           # original-time segments


def filter_samples(samples: np.ndarray, segments: list[VadSegment],
                   params: VadParams) -> VadFilterResult:
    """Splice speech segments (+0.1 s silence gaps) and build the mapping
    table (whisper.cpp:6675-6810)."""
    n_samples = len(samples)
    overlap_samples = int(params.samples_overlap * SAMPLE_RATE)
    silence_samples = int(0.1 * SAMPLE_RATE)

    pieces: list[np.ndarray] = []
    mapping: list[tuple[int, int]] = []
    offset = 0

    for i, seg in enumerate(segments):
        start = _cs_to_samples(seg.start)
        end = _cs_to_samples(seg.end)
        if i < len(segments) - 1:
            end += overlap_samples
        start = min(start, n_samples - 1)
        end = min(end, n_samples - 1)
        seg_len = end - start
        if seg_len <= 0:
            continue

        vad_start = _samples_to_cs(offset)
        vad_end = _samples_to_cs(offset + seg_len)
        mapping.append((vad_start, int(seg.start)))
        mapping.append((vad_end, int(seg.end)))

        # intermediate interpolation points every 200 ms for long segments
        if vad_end - vad_start > 100:
            dur = vad_end - vad_start
            n_pts = dur // 20 - 1
            for j in range(1, n_pts + 1):
                vt = vad_start + j * 20
                if vt >= vad_end:
                    continue
                ot = int(seg.start) + (vt - vad_start) * (int(seg.end) - int(seg.start)) // dur
                mapping.append((vt, ot))

        pieces.append(samples[start:end])
        offset += seg_len

        if i < len(segments) - 1:
            sil_start = _samples_to_cs(offset)
            sil_end = _samples_to_cs(offset + silence_samples)
            mapping.append((sil_start, int(seg.end)))
            mapping.append((sil_end, int(segments[i + 1].start)))
            pieces.append(np.zeros(silence_samples, np.float32))
            offset += silence_samples

    mapping.sort(key=lambda m: m[0])
    dedup: list[tuple[int, int]] = []
    for m in mapping:
        if dedup and dedup[-1][0] == m[0]:
            continue
        dedup.append(m)

    filtered = (np.concatenate(pieces).astype(np.float32)
                if pieces else np.zeros(0, np.float32))
    return VadFilterResult(filtered, dedup, segments)


def map_processed_to_original(t: int, mapping: list[tuple[int, int]]) -> int:
    """Binary-search + linear interpolation (whisper.cpp:7947-7986)."""
    if not mapping:
        return t
    keys = [m[0] for m in mapping]
    if t <= keys[0]:
        return mapping[0][1]
    if t >= keys[-1]:
        return mapping[-1][1]
    hi = bisect.bisect_left(keys, t)
    if keys[hi] == t:
        return mapping[hi][1]
    lo = hi - 1
    pdiff = keys[hi] - keys[lo]
    odiff = mapping[hi][1] - mapping[lo][1]
    if pdiff == 0:
        return mapping[lo][1]
    return mapping[lo][1] + (t - keys[lo]) * odiff // pdiff
