# Source: open_whisper_kit_tpu/io/gguf.py, copied as it stands (pure Python and numpy, no JAX).
"""GGUF container reader (pure Python/numpy).

Parses the GGUF v2/v3 key-value + tensor-blob format used by the reference's
streaming-sortformer model files (written by
streaming-sortformer/scripts/convert_to_gguf.py; format owned by
ggml/src/gguf.cpp).  Independent implementation from the public format spec.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Any

import numpy as np

from . import quant

GGUF_MAGIC = b"GGUF"

# gguf metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, _T_ARR, \
    _T_U64, _T_I64, _T_F64 = range(13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}


@dataclasses.dataclass
class GGUFTensor:
    name: str
    shape: tuple[int, ...]     # numpy order (reversed gguf dims)
    ggml_type: int
    offset: int                # into the data section
    data: bytes | None = None

    @property
    def n_elems(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def to_float(self) -> np.ndarray:
        assert self.data is not None
        return quant.dequantize(self.data, self.ggml_type, self.n_elems).reshape(self.shape)


@dataclasses.dataclass
class GGUFFile:
    version: int
    metadata: dict[str, Any]
    tensors: dict[str, GGUFTensor]
    path: str = ""

    def to_float(self, name: str) -> np.ndarray:
        return self.tensors[name].to_float()


def _read(f, fmt):
    size = struct.calcsize(fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise EOFError("unexpected EOF in GGUF file")
    out = struct.unpack(fmt, buf)
    return out[0] if len(out) == 1 else out


def _read_string(f) -> str:
    n = _read(f, "<Q")
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f, vtype: int):
    if vtype in _SCALAR_FMT:
        return _read(f, _SCALAR_FMT[vtype])
    if vtype == _T_BOOL:
        return bool(_read(f, "<B"))
    if vtype == _T_STR:
        return _read_string(f)
    if vtype == _T_ARR:
        etype = _read(f, "<I")
        n = _read(f, "<Q")
        if etype in _SCALAR_FMT and etype != _T_F64:
            fmt = _SCALAR_FMT[etype]
            dt = np.dtype(fmt[1]).newbyteorder("<")
            arr = np.frombuffer(f.read(dt.itemsize * n), dtype=dt)
            return arr.copy()
        return [_read_value(f, etype) for _ in range(n)]
    raise ValueError(f"GGUF: unknown value type {vtype}")


class _RawTensor:
    """Pre-encoded payload + logical shape for GGUFWriter.add_tensor_raw."""

    def __init__(self, raw: np.ndarray, logical_shape: tuple[int, ...]):
        self.raw = raw
        self.logical_shape = logical_shape


class GGUFWriter:
    """Minimal GGUF v3 writer (converter tooling + test fixtures).

    Counterpart of the reference's python writer used by
    streaming-sortformer/scripts/convert_to_gguf.py; independent
    implementation from the public format spec.
    """

    def __init__(self, path: str | Path, alignment: int = 32):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, int, Any]] = []
        self._tensors: list[tuple[str, np.ndarray, int]] = []

    def add_uint32(self, key: str, v: int):
        self._kv.append((key, _T_U32, int(v)))

    def add_float32(self, key: str, v: float):
        self._kv.append((key, _T_F32, float(v)))

    def add_string(self, key: str, v: str):
        self._kv.append((key, _T_STR, v))

    def add_bool(self, key: str, v: bool):
        self._kv.append((key, _T_BOOL, bool(v)))

    def add_array(self, key: str, vals, etype: int | None = None):
        """Array KV: list of str, or a numeric list/ndarray (f32/i32/u32)."""
        vals = list(vals) if not isinstance(vals, np.ndarray) else vals
        if etype is None:
            if len(vals) and isinstance(vals[0], str):
                etype = _T_STR
            elif isinstance(vals, np.ndarray) and vals.dtype.kind == "f":
                etype = _T_F32
            elif len(vals) and isinstance(vals[0], float):
                etype = _T_F32
            else:
                etype = _T_I32
        self._kv.append((key, _T_ARR, (etype, list(vals))))

    def add_tensor_raw(self, name: str, raw: bytes, shape: tuple[int, ...],
                       ggml_type: int):
        """Pre-encoded tensor payload (e.g. quantized blocks) with its
        LOGICAL element shape; raw length must match the block format."""
        arr = np.frombuffer(raw, np.uint8)
        arr = arr.copy()
        arr.shape = (len(raw),)
        self._tensors.append((name, _RawTensor(arr, tuple(shape)), ggml_type))

    def add_tensor(self, name: str, data: np.ndarray, ggml_type: int | None = None):
        data = np.ascontiguousarray(data)
        if ggml_type is None:
            ggml_type = (quant.GGML_TYPE_F16 if data.dtype == np.float16
                         else quant.GGML_TYPE_F32)
        if ggml_type == quant.GGML_TYPE_F16:
            data = data.astype(np.float16)
        elif ggml_type == quant.GGML_TYPE_F32:
            data = data.astype(np.float32)
        self._tensors.append((name, data, ggml_type))

    def write(self):
        def s(txt: str) -> bytes:
            b = txt.encode("utf-8")
            return struct.pack("<Q", len(b)) + b

        out = bytearray()
        out += GGUF_MAGIC
        out += struct.pack("<I", 3)
        out += struct.pack("<Q", len(self._tensors))
        out += struct.pack("<Q", len(self._kv) + 1)

        out += s("general.alignment") + struct.pack("<I", _T_U32) \
            + struct.pack("<I", self.alignment)
        for key, vtype, v in self._kv:
            out += s(key) + struct.pack("<I", vtype)
            if vtype == _T_U32:
                out += struct.pack("<I", v)
            elif vtype == _T_F32:
                out += struct.pack("<f", v)
            elif vtype == _T_STR:
                out += s(v)
            elif vtype == _T_BOOL:
                out += struct.pack("<B", 1 if v else 0)
            elif vtype == _T_ARR:
                etype, vals = v
                out += struct.pack("<I", etype) + struct.pack("<Q", len(vals))
                for x in vals:
                    if etype == _T_STR:
                        out += s(x)
                    else:
                        out += struct.pack(_SCALAR_FMT[etype], x)
            else:
                raise ValueError(f"unsupported kv type {vtype}")

        offset = 0
        blobs = []
        for name, data, ttype in self._tensors:
            shape = data.shape if not isinstance(data, _RawTensor) \
                else data.logical_shape
            if isinstance(data, _RawTensor):
                data = data.raw
            dims = list(reversed(shape))       # gguf dims: fastest first
            out += s(name)
            out += struct.pack("<I", len(dims))
            for d in dims:
                out += struct.pack("<Q", d)
            out += struct.pack("<I", ttype)
            out += struct.pack("<Q", offset)
            blob = data.tobytes()
            pad = (-len(blob)) % self.alignment
            blobs.append(blob + b"\0" * pad)
            offset += len(blob) + pad

        pad = (-len(out)) % self.alignment
        out += b"\0" * pad
        for blob in blobs:
            out += blob
        self.path.write_bytes(bytes(out))


def load_gguf(path: str | Path, load_tensors: bool = True) -> GGUFFile:
    path = Path(path)
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        version = _read(f, "<I")
        if version < 2:
            raise ValueError(f"{path}: GGUF v{version} unsupported (need >=2)")
        n_tensors = _read(f, "<Q")
        n_kv = _read(f, "<Q")

        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_string(f)
            vtype = _read(f, "<I")
            metadata[key] = _read_value(f, vtype)

        tensors: dict[str, GGUFTensor] = {}
        order: list[GGUFTensor] = []
        for _ in range(n_tensors):
            name = _read_string(f)
            n_dims = _read(f, "<I")
            dims = [_read(f, "<Q") for _ in range(n_dims)]
            ttype = _read(f, "<I")
            offset = _read(f, "<Q")
            t = GGUFTensor(name, tuple(int(d) for d in reversed(dims)), ttype, offset)
            tensors[name] = t
            order.append(t)

        alignment = int(metadata.get("general.alignment", 32))
        pos = f.tell()
        data_start = (pos + alignment - 1) // alignment * alignment

        if load_tensors:
            for t in order:
                f.seek(data_start + t.offset)
                t.data = f.read(quant.nbytes_for(t.ggml_type, t.n_elems))

    return GGUFFile(version, metadata, tensors, str(path))
