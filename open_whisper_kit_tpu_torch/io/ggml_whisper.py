# Source: open_whisper_kit_tpu/io/ggml_whisper.py, copied as it stands (pure Python and numpy, no JAX).
"""Whisper ggml-bin checkpoint reader.

File layout (as produced by the reference converter models/convert-pt-to-ggml.py:268-337
and consumed by src/whisper.cpp:1485-1958):

    i32 magic = 0x67676d6c ('ggml')
    i32 n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
        n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels, ftype
    i32 filters.n_mel, filters.n_fft ; f32 data[n_mel*n_fft]
    i32 n_tokens ; repeated { i32 len ; bytes token }
    repeated tensor records until EOF:
        i32 n_dims, name_len, ttype
        i32 dims[n_dims]          (ggml order: dims[0] = fastest/contiguous axis)
        bytes name[name_len]
        raw tensor data (ttype-encoded), row-major over reversed dims

Pure Python/numpy parsing; no device interaction.  Quantized tensors are kept
as raw block bytes so the TPU path can choose fused dequant-matmul; call
`.to_float(name)` for eager float32.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from . import quant

GGML_MAGIC = 0x67676D6C

# ggml_ftype → dominant ggml_type for the 2-D weights (ggml/include/ggml.h:437-468)
_FTYPE_TO_TYPE = {
    0: quant.GGML_TYPE_F32,
    1: quant.GGML_TYPE_F16,
    2: quant.GGML_TYPE_Q4_0,
    3: quant.GGML_TYPE_Q4_1,
    7: quant.GGML_TYPE_Q8_0,
    8: quant.GGML_TYPE_Q5_0,
    9: quant.GGML_TYPE_Q5_1,
    10: quant.GGML_TYPE_Q2_K,
    11: quant.GGML_TYPE_Q3_K,
    12: quant.GGML_TYPE_Q4_K,
    13: quant.GGML_TYPE_Q5_K,
    14: quant.GGML_TYPE_Q6_K,
    24: quant.GGML_TYPE_BF16,
}

QNT_VERSION_FACTOR = 1000


@dataclasses.dataclass(frozen=True)
class WhisperHParams:
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    n_mels: int
    ftype: int          # ggml_ftype after qnt-version strip
    qntvr: int

    @property
    def model_type(self) -> str:
        # model type inferred from n_audio_layer (src/whisper.cpp:1524-1546)
        t = {4: "tiny", 6: "base", 12: "small", 24: "medium", 32: "large"}.get(
            self.n_audio_layer, f"custom{self.n_audio_layer}"
        )
        if self.n_audio_layer == 32:
            if self.n_vocab == 51866:
                t = "large-v3"
            if self.n_text_layer == 4:
                t = "large-v3-turbo"
        return t

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - (1 if self.is_multilingual else 0)


@dataclasses.dataclass
class RawTensor:
    name: str
    shape: tuple[int, ...]   # numpy/row-major order (reversed ggml dims)
    ggml_type: int
    data: bytes | np.ndarray  # raw encoded bytes

    @property
    def n_elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def to_float(self) -> np.ndarray:
        return quant.dequantize(self.data, self.ggml_type, self.n_elems).reshape(self.shape)


@dataclasses.dataclass
class WhisperCheckpoint:
    hparams: WhisperHParams
    mel_filters: np.ndarray          # (n_mel, n_fft_bins) float32
    tokens: list[bytes]              # id → token bytes (may be < n_vocab)
    tensors: dict[str, RawTensor]
    path: str = ""

    def to_float(self, name: str) -> np.ndarray:
        return self.tensors[name].to_float()

    @property
    def n_loaded(self) -> int:
        return len(self.tensors)


def _read_struct(f, fmt: str):
    size = struct.calcsize(fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise EOFError("unexpected EOF in ggml-bin file")
    return struct.unpack(fmt, buf)


def load_checkpoint(path: str | Path | bytes,
                    load_tensors: bool = True) -> WhisperCheckpoint:
    """Parse a whisper ggml-bin from a file path or an in-memory buffer
    (whisper_init_from_buffer, include/whisper.h:133)."""
    if isinstance(path, (bytes, bytearray, memoryview)):
        import io as _io
        return _load_checkpoint_stream(_io.BytesIO(path), "<buffer>",
                                       load_tensors)
    path = Path(path)
    with open(path, "rb") as f:
        return _load_checkpoint_stream(f, str(path), load_tensors)


def _load_checkpoint_stream(f, path: str,
                            load_tensors: bool = True) -> WhisperCheckpoint:
    (magic,) = _read_struct(f, "<i")
    if magic != GGML_MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x} (expected ggml)")
    vals = _read_struct(f, "<11i")
    ftype_raw = vals[10]
    hp = WhisperHParams(*vals[:10], ftype=ftype_raw % QNT_VERSION_FACTOR,
                        qntvr=ftype_raw // QNT_VERSION_FACTOR)

    n_mel, n_fft = _read_struct(f, "<2i")
    filt = np.frombuffer(f.read(4 * n_mel * n_fft), dtype="<f4").reshape(n_mel, n_fft).copy()

    (n_tok,) = _read_struct(f, "<i")
    tokens: list[bytes] = []
    for _ in range(n_tok):
        (tl,) = _read_struct(f, "<i")
        tokens.append(f.read(tl) if tl > 0 else b"")

    tensors: dict[str, RawTensor] = {}
    if load_tensors:
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            n_dims, name_len, ttype = struct.unpack("<3i", head)
            dims = _read_struct(f, f"<{n_dims}i")
            name = f.read(name_len).decode("utf-8")
            shape = tuple(reversed(dims))  # ggml dims[0] is contiguous
            n_elems = int(np.prod(shape))
            nbytes = quant.nbytes_for(ttype, n_elems)
            data = f.read(nbytes)
            if len(data) != nbytes:
                raise EOFError(f"{path}: truncated tensor {name}")
            tensors[name] = RawTensor(name, shape, ttype, data)

    return WhisperCheckpoint(hp, filt, tokens, tensors, path)
