# Source: open_whisper_kit_tpu/audio/native.py, copied as it stands (ctypes and numpy, no JAX).
"""ctypes binding to the native audio runtime (native/owk_audio).

Auto-builds libowk_audio.so on first use if a toolchain is available;
callers fall back to the pure-numpy paths when the library is missing.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native" / "owk_audio"
_LIB_PATH = _NATIVE_DIR / "libowk_audio.so"

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:  # noqa: BLE001
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.owk_decode_wav.restype = ctypes.c_int64
    lib.owk_decode_wav.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                                   f32p, ctypes.c_int64]
    lib.owk_resample.restype = ctypes.c_int64
    lib.owk_resample.argtypes = [f32p, ctypes.c_int64, ctypes.c_int,
                                 f32p, ctypes.c_int64]
    lib.owk_ring_new.restype = ctypes.c_void_p
    lib.owk_ring_new.argtypes = [ctypes.c_int64]
    lib.owk_ring_free.argtypes = [ctypes.c_void_p]
    lib.owk_ring_write.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.owk_ring_get.restype = ctypes.c_int64
    lib.owk_ring_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, f32p]
    lib.owk_ring_clear.argtypes = [ctypes.c_void_p]
    lib.owk_ring_len.restype = ctypes.c_int64
    lib.owk_ring_len.argtypes = [ctypes.c_void_p]
    lib.owk_signal_energy.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, f32p]
    lib.owk_high_pass.argtypes = [f32p, ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_float]
    lib.owk_capture_start.restype = ctypes.c_int
    lib.owk_capture_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int]
    lib.owk_capture_get.restype = ctypes.c_int64
    lib.owk_capture_get.argtypes = [ctypes.c_int, f32p, ctypes.c_int64]
    lib.owk_capture_stop.restype = ctypes.c_int
    lib.owk_capture_running.restype = ctypes.c_int
    lib.owk_capture_total.restype = ctypes.c_int64
    lib.owk_capture_get_n.restype = ctypes.c_int64
    lib.owk_capture_get_n.argtypes = [ctypes.c_int64, f32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_wav(data: bytes, stereo: bool = False) -> np.ndarray | None:
    """WAV bytes -> 16 kHz f32; (n,) mono or (n,2). None if lib missing or
    the file can't be parsed natively."""
    lib = _load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    n = lib.owk_decode_wav(buf, len(data), int(stereo), None, 0)
    if n < 0:
        return None
    ch = 2 if stereo else 1
    out = np.empty(n * ch, np.float32)
    got = lib.owk_decode_wav(buf, len(data), int(stereo), _f32p(out), n)
    out = out[:got * ch]
    return out.reshape(-1, 2) if stereo else out


def resample(x: np.ndarray, src_rate: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n = lib.owk_resample(_f32p(x), len(x), src_rate, None, 0)
    out = np.empty(n, np.float32)
    lib.owk_resample(_f32p(x), len(x), src_rate, _f32p(out), n)
    return out


def signal_energy(x: np.ndarray, half_window: int = 32) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(len(x), np.float32)
    lib.owk_signal_energy(_f32p(x), len(x), half_window, _f32p(out))
    return out


def high_pass(x: np.ndarray, cutoff: float, rate: float = 16000.0) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.ascontiguousarray(x, np.float32).copy()
    lib.owk_high_pass(_f32p(out), len(out), cutoff, rate)
    return out


class NativeRing:
    """Thread-safe audio ring buffer (common-sdl audio_async analog)."""

    def __init__(self, capacity: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native audio runtime unavailable")
        self._lib = lib
        self._ptr = lib.owk_ring_new(capacity)

    def write(self, data: np.ndarray):
        data = np.ascontiguousarray(data, np.float32)
        self._lib.owk_ring_write(self._ptr, _f32p(data), len(data))

    def get(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = self._lib.owk_ring_get(self._ptr, n, _f32p(out))
        return out[:got]

    def clear(self):
        self._lib.owk_ring_clear(self._ptr)

    def __len__(self) -> int:
        return int(self._lib.owk_ring_len(self._ptr))

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.owk_ring_free(self._ptr)
            self._ptr = None


# -- live capture (ALSA mic loop; examples/common-sdl.cpp analog) ------------

CAPTURE_OK = 0
CAPTURE_ERR_NO_LIB = -1     # libasound not present on the host
CAPTURE_ERR_OPEN = -2       # device open failed
CAPTURE_ERR_PARAMS = -3
CAPTURE_ERR_BUSY = -4


class CaptureUnavailable(RuntimeError):
    def __init__(self, code: int):
        names = {CAPTURE_ERR_NO_LIB: "libasound not found",
                 CAPTURE_ERR_OPEN: "capture device open failed",
                 CAPTURE_ERR_PARAMS: "format negotiation failed",
                 CAPTURE_ERR_BUSY: "capture already running"}
        super().__init__(names.get(code, f"capture error {code}"))
        self.code = code


class LiveCapture:
    """Microphone capture into a native ring buffer (ALSA via dlopen).

    Mirrors the reference's audio_async (examples/common-sdl.cpp:18-44):
    a worker thread fills a `buffer_ms` ring; `get(ms)` returns the most
    recent window. Raises CaptureUnavailable when the host has no ALSA or
    no device — callers fall back to wav/stdin input.
    """

    def __init__(self, device: str = "default", rate: int = 16000,
                 buffer_ms: int = 30_000):
        lib = _load()
        if lib is None:
            raise CaptureUnavailable(CAPTURE_ERR_NO_LIB)
        code = lib.owk_capture_start(device.encode(), rate, buffer_ms)
        if code != CAPTURE_OK:
            raise CaptureUnavailable(code)
        self._lib = lib
        self._rate = rate
        self._max = rate * buffer_ms // 1000

    def get(self, ms: int = 0) -> np.ndarray:
        """Most recent `ms` milliseconds (0 = everything buffered)."""
        out = np.empty(self._max, np.float32)
        got = self._lib.owk_capture_get(int(ms), _f32p(out), self._max)
        return out[:got].copy()

    @property
    def total(self) -> int:
        """Samples captured since start (ring write counter)."""
        return int(self._lib.owk_capture_total())

    def get_new(self, seen: int) -> tuple[np.ndarray, int]:
        """(samples captured after position `seen`, new total) — the
        sequential-feed poller for StreamingTranscriber. Polling must
        outpace the ring (buffer_ms); older samples are gone."""
        total = self.total
        n = min(total - seen, self._max)
        if n <= 0:
            return np.zeros(0, np.float32), total
        out = np.empty(n, np.float32)
        got = self._lib.owk_capture_get_n(n, _f32p(out))
        return out[:got].copy(), total

    def clear(self):
        self._lib.owk_capture_clear()

    @property
    def running(self) -> bool:
        return bool(self._lib.owk_capture_running())

    def stop(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.owk_capture_stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
