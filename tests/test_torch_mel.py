"""The port's Whisper log-mel against the JAX package's device mel and its
numpy oracle."""

import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.audio import mel as JMEL
from open_whisper_kit_tpu_torch.audio import mel as TMEL
from open_whisper_kit_tpu_torch.decode.full import _synthetic_mel_filters

torch.set_num_threads(2)


def _filters(kind: str, n_mels: int) -> np.ndarray:
    if kind == "synthetic":
        return _synthetic_mel_filters(n_mels)
    return (np.random.default_rng(n_mels).random((n_mels, 201)) / 50).astype(np.float32)


@pytest.mark.parametrize("seconds,kind,n_mels", [
    (0.01, "synthetic", 80),     # shorter than one frame: n_len_org == 0
    (2.5, "random", 80),
    (11.3, "synthetic", 128),
    (65.0, "random", 80),        # past 8 buckets: multiple-of-8 bucket rounding
])
def test_log_mel_matches_jax_and_numpy(seconds, kind, n_mels):
    samples = (np.random.default_rng(int(seconds * 10)).standard_normal(
        int(16000 * seconds)) * 0.2).astype(np.float32)
    filters = _filters(kind, n_mels)
    got = TMEL.log_mel_spectrogram(samples, filters, "cpu")
    ref = JMEL.log_mel_spectrogram(samples, filters)
    assert (got.n_len, got.n_len_org) == (ref.n_len, ref.n_len_org)
    assert tuple(got.data.shape) == tuple(ref.data.shape)
    assert got.data.dtype == torch.float32
    np.testing.assert_allclose(got.data.numpy(), np.asarray(ref.data), atol=1e-4)
    oracle = JMEL.log_mel_spectrogram_numpy(samples, filters)
    np.testing.assert_allclose(got.data[:got.n_len].numpy().T, oracle, atol=1e-4)
    assert not got.data[got.n_len:].any()     # bucket padding stays zero


def test_hann_window_is_the_same():
    np.testing.assert_array_equal(TMEL.hann_window(400), JMEL.hann_window(400))
    np.testing.assert_array_equal(TMEL.hann_window(400, periodic=False),
                                  JMEL.hann_window(400, periodic=False))
