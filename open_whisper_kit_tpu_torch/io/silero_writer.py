"""Silero-VAD ggml-bin writer and seeded random weights.

Writes the format `io/ggml_silero.load_silero` reads (the reference
converter's, models/convert-silero-vad-to-ggml.py:33-170): the silero-16k
header, then f32 tensor records. `random_silero_tensors(seed)` gives
random weights of the v5/v6 shapes; tests and `chip_smoke.py` build their
VAD files from it, so nothing has to be downloaded.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .ggml_whisper import GGML_MAGIC

# (in_ch, out_ch, kernel) of the four encoder convs (strides 1, 2, 2, 1)
ENCODER_DIMS = ((129, 128, 3), (128, 64, 3), (64, 64, 3), (64, 128, 3))
_F32 = 0


def random_silero_tensors(seed: int = 0, scale: float = 0.1) -> dict[str, np.ndarray]:
    """Seeded normal weights of every tensor the model reads, by name."""
    rng = np.random.default_rng(seed)

    def w(*shape, sc=scale):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    t = {"_model.stft.forward_basis_buffer": w(258, 1, 256, sc=0.05)}
    for i, (ci, co, k) in enumerate(ENCODER_DIMS):
        t[f"_model.encoder.{i}.reparam_conv.weight"] = w(co, ci, k)
        t[f"_model.encoder.{i}.reparam_conv.bias"] = w(co)
    t["_model.decoder.rnn.weight_ih"] = w(512, 128)
    t["_model.decoder.rnn.weight_hh"] = w(512, 128)
    t["_model.decoder.rnn.bias_ih"] = w(512)
    t["_model.decoder.rnn.bias_hh"] = w(512)
    # an output scale and bias that put silence well under the 0.35 release
    # threshold and seeded noise of 0.3 rms mostly over 0.5, so segments,
    # gaps and the splice all occur
    t["_model.decoder.decoder.2.weight"] = w(1, 128, 1, sc=4.0)
    t["_model.decoder.decoder.2.bias"] = np.full(1, -2.0, np.float32)
    return t


def write_silero(path: str | Path, tensors: dict[str, np.ndarray],
                 version: tuple[int, int, int] = (6, 2, 0)) -> None:
    """A silero-16k ggml-bin file of f32 `tensors`."""
    with open(path, "wb") as f:
        name = b"silero-16k"
        f.write(struct.pack("<2i", GGML_MAGIC, len(name)) + name)
        f.write(struct.pack("<3i", *version))
        f.write(struct.pack("<3i", 512, 64, len(ENCODER_DIMS)))
        for dims in ENCODER_DIMS:
            f.write(struct.pack("<3i", *dims))
        f.write(struct.pack("<4i", 128, 128, 128, 1))
        for tname, a in tensors.items():
            a = np.ascontiguousarray(a, np.float32)
            key = tname.encode()
            f.write(struct.pack("<3i", a.ndim, len(key), _F32))
            f.write(struct.pack(f"<{a.ndim}i", *reversed(a.shape)))
            f.write(key)
            f.write(a.tobytes())
