# Source: open_whisper_kit_tpu/io/ggml_silero.py, copied as it stands (pure Python and numpy, no JAX).
"""Silero-VAD ggml-bin checkpoint reader.

Format written by the reference converter models/convert-silero-vad-to-ggml.py:33-170
and consumed by whisper_vad_init_from_file_with_params (src/whisper.cpp:4345+):

    i32 magic 'ggml' ; i32 len ; bytes model_type ("silero-16k")
    i32 major, minor, patch
    i32 window_size (512), context_size (64), n_encoder_layers (4)
    per layer: i32 in_ch, out_ch, kernel
    i32 lstm_input (128), lstm_hidden (128)
    i32 final_conv_in (128), final_conv_out (1)
    tensor records as in the whisper ggml-bin (n_dims, name_len, ftype,
    dims[n_dims], name, data)
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from . import quant
from .ggml_whisper import GGML_MAGIC, RawTensor, _read_struct


@dataclasses.dataclass(frozen=True)
class SileroHParams:
    model_type: str
    version: tuple[int, int, int]
    window_size: int
    context_size: int
    n_encoder_layers: int
    encoder_dims: tuple[tuple[int, int, int], ...]  # (in_ch, out_ch, kernel)
    lstm_input_size: int
    lstm_hidden_size: int
    final_conv_in: int
    final_conv_out: int


@dataclasses.dataclass
class SileroCheckpoint:
    hparams: SileroHParams
    tensors: dict[str, RawTensor]
    path: str = ""

    def to_float(self, name: str) -> np.ndarray:
        return self.tensors[name].to_float()


def load_silero(path: str | Path) -> SileroCheckpoint:
    path = Path(path)
    with open(path, "rb") as f:
        (magic,) = _read_struct(f, "<i")
        if magic != GGML_MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x}")
        (slen,) = _read_struct(f, "<i")
        model_type = f.read(slen).decode("utf-8")
        version = _read_struct(f, "<3i")
        window_size, context_size, n_enc = _read_struct(f, "<3i")
        enc_dims = tuple(_read_struct(f, "<3i") for _ in range(n_enc))
        lstm_in, lstm_hidden = _read_struct(f, "<2i")
        fc_in, fc_out = _read_struct(f, "<2i")
        hp = SileroHParams(model_type, version, window_size, context_size,
                           n_enc, enc_dims, lstm_in, lstm_hidden, fc_in, fc_out)

        tensors: dict[str, RawTensor] = {}
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            n_dims, name_len, ttype = struct.unpack("<3i", head)
            dims = _read_struct(f, f"<{n_dims}i")
            name = f.read(name_len).decode("utf-8")
            shape = tuple(reversed(dims))
            n_elems = int(np.prod(shape))
            data = f.read(quant.nbytes_for(ttype, n_elems))
            tensors[name] = RawTensor(name, shape, ttype, data)

    return SileroCheckpoint(hp, tensors, str(path))
