"""Encoder self-attention (port of open_whisper_kit_tpu/ops/attention.py).

`mha_full` is what the encoder calls. On a CUDA tensor it launches kernel
K1, `mha_packed` (csrc/mha_packed.cu, the Hopper counterpart of the TPU
kernel `_mha_packed`); on a CPU tensor it computes the same math with plain
torch ops (`mha_plain`). There is no fallback between the two: a CUDA
tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .gemm import _sms

HEAD_DIM = 64   # every whisper preset; the kernel takes no other


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


# csrc/mha_packed.cu's f32 body: a block takes F32_QUERIES query rows of one
# head and one chunk of the live keys, in tiles of F32_KEYS; a query tile's
# chunks are one thread-block cluster of at most F32_MAX_CLUSTER; a block
# asks for F32_SMEM bytes of shared memory (two K and two V tiles of 272-byte
# rows) and its registers (the kernel's launch bounds) let F32_BLOCKS_PER_SM
# of them share a multiprocessor
F32_QUERIES = 64
F32_KEYS = 64
F32_MAX_CLUSTER = 8
F32_SMEM = 4 * F32_KEYS * (HEAD_DIM + 4) * 4
F32_BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """The f32 body's launch: `chunks` key chunks of `chunk_keys` (a
    multiple of F32_KEYS; the last holds the rest of the live keys) for
    each of the `pairs` (query tile, head, batch element) triples."""
    pairs: int
    chunks: int
    chunk_keys: int

    @property
    def blocks(self) -> int:
        return self.pairs * self.chunks


@functools.cache
def mha_f32_plan(B: int, T: int, S: int, n_valid: int, sms: int) -> F32Plan:
    """Split the live keys of K1's f32 body so that the grid fills the
    card's `sms` multiprocessors: of 1, 2, 4 and 8 chunks (clusters of 3, 5
    or 6 blocks ran 15-30 % slower than their neighbours on the H100), the
    one with the fewest waves of F32_BLOCKS_PER_SM blocks a multiprocessor
    times the key tiles of a chunk (plus one for the cluster's combine);
    fewer chunks on a tie."""
    pairs = B * -(-T // F32_QUERIES) * (S // HEAD_DIM)
    tiles = -(-n_valid // F32_KEYS)
    slots = sms * F32_BLOCKS_PER_SM

    def cost(c):
        return -(-pairs * c // slots) * (-(-tiles // c) + 1)
    c = min((c for c in (1, 2, 4, 8) if c <= max(tiles, 1)), key=lambda c: (cost(c), c))
    chunk_keys = -(-tiles // c) * F32_KEYS
    return F32Plan(pairs, -(-n_valid // chunk_keys), chunk_keys)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("mha_packed")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.owk_mha_packed_bf16.argtypes = [P] * 4 + [I] * 4 + [ctypes.c_float, P]
    lib.owk_mha_packed_f32.argtypes = [P] * 4 + [I] * 6 + [ctypes.c_float, P]
    for fn in (lib.owk_mha_packed_bf16, lib.owk_mha_packed_f32):
        fn.restype = ctypes.c_int
    return lib


def mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, n_valid: int) -> torch.Tensor:
    """Kernel K1: attention over 64-wide heads packed in (B, T, S) tensors.

    CPU tensors take the plain version. CUDA tensors (bf16 or f32,
    contiguous, on 16-byte boundaries, S a multiple of 64) launch the
    kernel on the current stream. Both bodies take any T (rows past T are
    neither read nor written; keys past `n_valid` are masked): bf16 through
    its TMA maps, f32 (one pass, the live keys split over a cluster as
    `mha_f32_plan` says) through its own zero-filling loads. The
    `launches` attribute counts kernel launches."""
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
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("mha_packed: q/k/v must start on 16-byte boundaries")
    out = torch.empty_like(q)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if q.dtype == torch.bfloat16:
        rc = lib.owk_mha_packed_bf16(*ptrs, B, T, S, n_valid, float(scale), stream)
    else:
        plan = mha_f32_plan(B, T, S, n_valid, _sms(q.device.index if q.device.index is not None
                                                   else torch.cuda.current_device()))
        rc = lib.owk_mha_packed_f32(*ptrs, B, T, S, n_valid, plan.chunks, plan.chunk_keys,
                                    float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"mha_packed: kernel launch failed (cudaError {rc})")
    mha_packed.launches += 1
    return out


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
            "whisper preset); other widths have no kernel")
    return mha_packed(q, k, v, scale,
                      q.shape[1] if kv_valid is None else kv_valid)
