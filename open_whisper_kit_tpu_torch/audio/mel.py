"""Log-mel spectrograms (port of open_whisper_kit_tpu/audio/mel.py): the
Whisper variant, and the NeMo / SortFormer front-end (`nemo_log_mel`).

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

    def ref_layout(self) -> np.ndarray:
        """(n_mel, n_len) float32 layout used by reference debug dumps."""
        return self.data[:self.n_len].T.cpu().numpy()


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


# ---------------------------------------------------------------------------
# NeMo / SortFormer variant
# ---------------------------------------------------------------------------

NEMO_N_FFT = 512
NEMO_WIN = 400
NEMO_HOP = 160
NEMO_PREEMPH = 0.97
NEMO_LOG_GUARD = 2.0 ** -24


def nemo_log_mel(samples: np.ndarray, filters: np.ndarray, pad_to: int = 16, *,
                 device: str | torch.device) -> torch.Tensor:
    """SortFormer mel front-end -> (n_frames_padded, n_mel=128) float32 on
    `device`.

    Mirrors streaming-sortformer/src/sortformer.cpp:779-894: preemphasis,
    center constant-pad n_fft//2, window 400 centered in 512-point frame,
    log(x + 2^-24), frames log-guard-padded to a multiple of `pad_to`. The
    JAX package computes the frames in 256-frame buckets; each frame's value
    does not depend on its bucket."""
    x = np.ascontiguousarray(samples, dtype=np.float32)
    # preemphasis y[t] = x[t] - 0.97 x[t-1], y[0] = x[0]
    y = np.empty_like(x)
    if x.shape[0] > 0:
        y[0] = x[0]
        y[1:] = x[1:] - NEMO_PREEMPH * x[:-1]
    pad = NEMO_N_FFT // 2
    padded = np.concatenate([np.zeros(pad, np.float32), y, np.zeros(pad, np.float32)])
    n_frames = (1 + (padded.shape[0] - NEMO_N_FFT) // NEMO_HOP
                if padded.shape[0] >= NEMO_N_FFT else 0)

    # center the 400-sample Hann in the 512-point frame (NeMo's torch.stft
    # center-pads the window symmetrically: 56 zeros either side)
    win = np.zeros(NEMO_N_FFT, np.float32)
    off = (NEMO_N_FFT - NEMO_WIN) // 2
    win[off:off + NEMO_WIN] = hann_window(NEMO_WIN, periodic=False)

    n_out = -(-n_frames // pad_to) * pad_to
    out = torch.full((n_out, filters.shape[0]), float(np.log(NEMO_LOG_GUARD)),
                     dtype=torch.float32, device=device)
    if n_frames > 0:
        cos, sin = _rdft_mats(NEMO_N_FFT)
        buf = torch.from_numpy(padded).to(device)
        frames = buf.unfold(0, NEMO_N_FFT, NEMO_HOP)[:n_frames] * torch.from_numpy(win).to(device)
        re = frames @ torch.from_numpy(cos).to(device)
        im = frames @ torch.from_numpy(sin).to(device)
        filters_t = torch.from_numpy(np.ascontiguousarray(filters.T, dtype=np.float32))
        out[:n_frames] = torch.log((re * re + im * im) @ filters_t.to(device) + NEMO_LOG_GUARD)
    return out
