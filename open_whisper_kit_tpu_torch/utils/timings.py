"""Timing buckets, system info, logging: the whisper.h observability surface
(port of open_whisper_kit_tpu/utils/timings.py).

Mirrors whisper_timings / whisper_print_timings (include/whisper.h:438-447,
src/whisper.cpp:4245-4297), whisper_print_system_info (:4315-4340), and the
whisper_log_set global callback (:9000-9037). `system_info` reports torch,
CUDA and the cards; `profile_trace` wraps torch.profiler and writes a
chrome trace.
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path
from typing import Callable

from ..decode.full import TranscribeResult

LOG_LEVEL_ERROR = 2
LOG_LEVEL_WARN = 3
LOG_LEVEL_INFO = 4
LOG_LEVEL_DEBUG = 5

_log_callback: Callable[[int, str], None] | None = None


def log_set(callback: Callable[[int, str], None] | None):
    """whisper_log_set: install a global log callback (None -> stderr)."""
    global _log_callback
    _log_callback = callback


def log(level: int, msg: str):
    if _log_callback is not None:
        _log_callback(level, msg)
    else:
        print(msg, file=sys.stderr, end="")


def print_timings(result: TranscribeResult, file=sys.stderr):
    """whisper_print_timings-style report from a TranscribeResult."""
    t = result.timings
    n_sample = max(1, t.n_sample)
    n_enc = max(1, t.n_encode)
    n_dec = max(1, t.n_decode)
    print("timings:", file=file)
    print(f"    mel time    = {t.t_mel_ms:8.2f} ms", file=file)
    print(f"    sample time = {t.t_sample_ms:8.2f} ms / {t.n_sample:5d} runs "
          f"({t.t_sample_ms / n_sample:8.2f} ms per run)", file=file)
    print(f"    encode time = {t.t_encode_ms:8.2f} ms / {t.n_encode:5d} runs "
          f"({t.t_encode_ms / n_enc:8.2f} ms per run)", file=file)
    print(f"    decode time = {t.t_decode_ms:8.2f} ms / {t.n_decode:5d} runs "
          f"({t.t_decode_ms / n_dec:8.2f} ms per run)", file=file)


def system_info() -> str:
    """whisper_print_system_info analog: torch, CUDA and the cards."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    parts = [
        f"torch = {torch.__version__}",
        f"cuda = {torch.version.cuda or 'none'}",
        f"backend = {'cuda' if n else 'cpu'}",
        f"devices = {n}",
    ]
    for i in range(min(n, 4)):
        parts.append(f"[{i}] {torch.cuda.get_device_name(i)}")
    try:
        from ..audio import native
        parts.append(f"native_audio = {int(native.available())}")
    except Exception:  # noqa: BLE001
        parts.append("native_audio = 0")
    return " | ".join(parts)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler scope over the CPU and, when present, the card; on
    exit writes `<logdir>/trace.json` (chrome://tracing, Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


class Stopwatch:
    """Accumulating wall-clock bucket (the ggml_time_us pattern)."""

    def __init__(self):
        self.total_ms = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total_ms += (time.perf_counter() - t0) * 1e3
            self.count += 1
