# Source: open_whisper_kit_tpu/audio/wav.py, copied without the native
# decoder branch (the numpy decoder serves every load here).
"""Audio loading: WAV decode + resample to 16 kHz mono float32.

Equivalent capability to the reference's audio loaders (miniaudio in
examples/common-whisper.cpp; AVFoundation in
Sources/OpenWhisperKit/AudioProcessor.swift) using stdlib `wave` + numpy and
a polyphase resampler (scipy) for non-16k inputs.
"""

from __future__ import annotations

import wave
from fractions import Fraction
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16000


def load_wav(path: str | Path, stereo: bool = False) -> np.ndarray:
    """Load a WAV file → float32 in [-1, 1] at 16 kHz.

    Returns shape (n,) mono, or (n, 2) if `stereo` and the file has 2 channels
    (used by the CLI's channel-energy pseudo-diarization mode).
    """
    with wave.open(str(path), "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")

    if n_ch > 1:
        data = data.reshape(-1, n_ch)
        mono = data.mean(axis=1)
    else:
        mono = data
        data = data[:, None]

    if rate != SAMPLE_RATE:
        mono = resample(mono, rate, SAMPLE_RATE)
        if stereo and n_ch == 2:
            data = np.stack([resample(data[:, 0], rate, SAMPLE_RATE),
                             resample(data[:, 1], rate, SAMPLE_RATE)], axis=1)

    if stereo and n_ch == 2:
        return data[:, :2].astype(np.float32)
    return mono.astype(np.float32)


def resample(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate:
        return x
    from scipy.signal import resample_poly

    frac = Fraction(dst_rate, src_rate).limit_denominator(1000)
    return resample_poly(x, frac.numerator, frac.denominator).astype(np.float32)
