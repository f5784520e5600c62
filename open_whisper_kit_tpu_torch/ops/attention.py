"""Encoder self-attention (port of open_whisper_kit_tpu/ops/attention.py).

`mha_full` is what the encoder calls. On a CUDA tensor it launches kernel
K1, `mha_packed` (csrc/mha_packed.cu, the Hopper counterpart of the TPU
kernel `_mha_packed`); on a CPU tensor it computes the same math with plain
torch ops (`mha_plain`). There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

HEAD_DIM = 64   # every whisper preset; the kernel takes no other
_T_MULTIPLE = 64   # the f32 kernel's T granule


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              n_head: int, scale: float,
              kv_valid: int | None = None) -> torch.Tensor:
    """Plain-torch MHA on the (B, T, S) layout: f32 scores times `scale`,
    keys at or past `kv_valid` masked, f32 softmax, probabilities cast to
    the input dtype before P.V, output in the input dtype."""
    B, Tq, S = q.shape
    Tk = k.shape[1]
    d = S // n_head
    qh = q.reshape(B, Tq, n_head, d)
    kh = k.reshape(B, Tk, n_head, d)
    vh = v.reshape(B, Tk, n_head, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    if kv_valid is not None and kv_valid < Tk:
        mask = torch.where(torch.arange(Tk, device=q.device) < kv_valid,
                           0.0, float("-inf"))
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), vh)
    return out.reshape(B, Tq, S)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("mha_packed")
    for fn in (lib.owk_mha_packed_bf16, lib.owk_mha_packed_f32):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, n_valid: int) -> torch.Tensor:
    """Kernel K1: attention over 64-wide heads packed in (B, T, S) tensors.

    CPU tensors take the plain version. CUDA tensors (bf16 or f32,
    contiguous, S a multiple of 64) launch the kernel on the current
    stream. The bf16 kernel reads any T through its TMA maps (rows past T
    load as zero; keys past `n_valid` are masked) and needs q/k/v on
    16-byte boundaries; for f32, T is zero-padded to a multiple of 64 first
    (the padded keys lie past `n_valid`, the padded query rows are sliced
    off). The `launches` attribute counts kernel launches."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, q.shape[-1] // HEAD_DIM, scale, n_valid)
    if q.device.type != "cuda":
        raise ValueError(f"mha_packed: unsupported device {q.device}")
    if not (q.shape == k.shape == v.shape and q.dim() == 3):
        raise ValueError(f"mha_packed: q/k/v shapes differ or are not 3-D: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.bfloat16, torch.float32)):
        raise ValueError(f"mha_packed: dtype must be bf16 or f32 for all of "
                         f"q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("mha_packed: q/k/v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha_packed: q/k/v must be contiguous")
    B, T, S = q.shape
    if S % HEAD_DIM:
        raise ValueError(f"mha_packed: S={S} is not a multiple of {HEAD_DIM}")
    if not 1 <= n_valid <= T:
        raise ValueError(f"mha_packed: n_valid={n_valid} outside [1, {T}]")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("mha_packed: bf16 q/k/v must start on 16-byte boundaries")
    pad = -T % _T_MULTIPLE if q.dtype == torch.float32 else 0
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    out = torch.empty_like(q)
    lib = _kernel_lib()
    fn = (lib.owk_mha_packed_bf16 if q.dtype == torch.bfloat16
          else lib.owk_mha_packed_f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T + pad, S, n_valid, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"mha_packed: kernel launch failed (cudaError {rc})")
    mha_packed.launches += 1
    return out[:, :T] if pad else out


mha_packed.launches = 0


def mha_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             n_head: int, scale: float,
             kv_valid: int | None = None) -> torch.Tensor:
    """Unmasked multi-head attention, (B, T, S) layout.

    `kv_valid`: when the caller runs pre-padded sequences, the number of
    live positions; keys beyond it are masked out and outputs at padded
    query positions are garbage the caller slices off. CUDA tensors always
    go through kernel K1; CPU tensors through the plain version."""
    d = q.shape[-1] // n_head
    if q.device.type == "cpu":
        return mha_plain(q, k, v, n_head, scale, kv_valid)
    if d != HEAD_DIM:
        raise NotImplementedError(
            f"head dim {d}: kernel K1 takes 64-wide heads only (every "
            "whisper preset); other widths are not ported")
    return mha_packed(q, k, v, scale,
                      q.shape[1] if kv_valid is None else kv_valid)
