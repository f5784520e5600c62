"""Whisper log-mel spectrogram (port of open_whisper_kit_tpu/audio/mel.py,
Whisper variant; the NeMo / SortFormer front-end is still to come).

Reference semantics (src/whisper.cpp:3170-3260): SR 16000, n_fft 400, hop
160, periodic Hann, front reflect-pad 200, end zero-pad 30 s + 200,
power spectrum x mel filterbank, log10(max(p, 1e-10)), clamp to the max
over live frames minus 8, (x+4)/4. The power spectrum is two f32 matmuls
against real-DFT cos/sin matrices, as on the JAX side.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES_CHUNK = SAMPLE_RATE * CHUNK_LENGTH   # 480000
N_FRAMES_CHUNK = N_SAMPLES_CHUNK // HOP_LENGTH  # 3000

_FRAME_BUCKET = 1024  # frames per bucket (~10.24 s of audio)


def hann_window(length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann as in the reference (src/whisper.cpp:3023-3031)."""
    denom = length if periodic else length - 1
    i = np.arange(length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / denom))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _rdft_mats(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin matrices (n_fft, n_fft//2+1), f64-built, f32-stored."""
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@dataclasses.dataclass
class Mel:
    data: torch.Tensor   # (>= n_len, n_mel) f32, frame-major; rows beyond
                         # n_len are zero bucket padding
    n_len: int           # total frames incl. the 30 s zero tail
    n_len_org: int       # frames covering the real audio (seek bound)

    @property
    def n_mel(self) -> int:
        return int(self.data.shape[1])


def _bucket_chunks(n_chunks: int) -> int:
    """Frame-count buckets of the JAX package: exact up to 8 chunks, then
    multiples of 8 (kept so both sides return the same shape)."""
    return n_chunks if n_chunks <= 8 else -(-n_chunks // 8) * 8


def log_mel_spectrogram(samples: np.ndarray, filters: np.ndarray,
                        device: str | torch.device) -> Mel:
    """Whisper log-mel of 16 kHz mono float32 `samples`, computed on
    `device`. `filters` is the (n_mel, 201) filterbank."""
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    n = samples.shape[0]
    pad_half = N_FFT // 2  # 200

    n_len = (n + N_SAMPLES_CHUNK + 2 * pad_half - N_FFT) // HOP_LENGTH
    n_len_org = 1 + (n + pad_half - N_FFT) // HOP_LENGTH if n + pad_half >= N_FFT else 0

    n_frames = _bucket_chunks(max(1, -(-n_len // _FRAME_BUCKET))) * _FRAME_BUCKET
    padded = np.zeros(n_frames * HOP_LENGTH + (N_FFT - HOP_LENGTH), np.float32)
    if n > 0:
        padded[pad_half:pad_half + n] = samples
        # reflect-pad the head: padded[0:200] = samples[200:0:-1]
        m = min(pad_half, n - 1)
        if m > 0:
            padded[pad_half - m:pad_half] = samples[m:0:-1]

    cos, sin = _rdft_mats(N_FFT)
    x = torch.from_numpy(padded).to(device)
    window = torch.from_numpy(hann_window(N_FFT)).to(device)
    frames = x.unfold(0, N_FFT, HOP_LENGTH) * window          # (n_frames, 400)
    re = frames @ torch.from_numpy(cos).to(device)
    im = frames @ torch.from_numpy(sin).to(device)
    power = re * re + im * im
    filters_t = torch.from_numpy(np.ascontiguousarray(filters.T, dtype=np.float32))
    logmel = torch.log10(torch.clamp_min(power @ filters_t.to(device), 1e-10))

    live = (torch.arange(n_frames, device=device) < n_len)[:, None]
    mmax = torch.where(live, logmel, float("-inf")).max() - 8.0
    out = (torch.maximum(logmel, mmax) + 4.0) / 4.0
    return Mel(data=torch.where(live, out, 0.0), n_len=n_len, n_len_org=n_len_org)
