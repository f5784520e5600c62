"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel lives in `open_whisper_kit_tpu_torch/csrc/<name>.cu` (headers it
shares with others in `csrc/*.cuh`) and exports plain C functions (pointers,
ints, floats, a stream; an int cudaError_t back). `load(name)` compiles it
with nvcc for Hopper (sm_90a) into `build/kernels/lib<name>-<hash>.so` at
the repository root, at first use, and reuses that file while the sources
and flags are unchanged (the hash covers the .cu, every .cuh and the
flags). `build_all(names)` runs one nvcc per source, all at once. Nothing
here runs at import time: this module imports on machines with no CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "toolkit is needed to build the port's kernels")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: list[str]) -> list[Path]:
    """Compile csrc/<name>.cu for every name not built yet, one nvcc process
    per source, all started together; return the libraries' paths."""
    targets = [_target(n) for n in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in targets:
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {src.name}:\n{err}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent build never loads a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out for _, out in targets]


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into a shared library; return its path."""
    return build_all([name])[0]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library `name`, once per process."""
    return ctypes.CDLL(str(build(name)))
