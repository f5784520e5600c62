# Source: open_whisper_kit_tpu/models/sortformer/mel_fb.py, copied as it stands (pure Python and numpy, no JAX).
"""Slaney-style mel filterbank (librosa.filters.mel equivalent, norm='slaney').

Used only for random-init test models; real checkpoints carry their own
filterbank ('preprocessor.featurizer.fb' in the GGUF).
"""

from __future__ import annotations

import numpy as np


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asanyarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    m = np.asanyarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular filters with Slaney normalization."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fb = np.zeros((n_mels, n_bins), np.float64)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for m in range(n_mels):
        lower = -ramps[m] / fdiff[m]
        upper = ramps[m + 2] / fdiff[m + 1]
        fb[m] = np.maximum(0, np.minimum(lower, upper))
    # slaney normalization: constant energy per channel
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)
