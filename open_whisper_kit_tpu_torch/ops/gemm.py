"""Plain GEMMs on the tensor cores: kernels T1 (bf16) and T2 (s8 with scales).

Port of the two Pallas GEMMs of the JAX package's tensor-core probe,
tools/bench_int8_mxu.py (`pallas_mm_bf16`, `pallas_mm_s8`), which
`open_whisper_kit_tpu_torch.tools.bench_int8_mxu` chains:

* `mm_bf16(a, b)` (T1, csrc/mm_bf16.cu): a (M, K) bf16 @ b (K, N) bf16,
  summed in f32, rounded to bf16;
* `mm_s8(a_q, a_s, b_t, b_s)` (T2, K6's GEMM in csrc/w8a8.cu launched
  alone): the int8 rows a_q (M, K) with their f32 scales a_s (M, 1) times
  the int8 weight b (K, N), passed transposed as b_t (N, K), with its
  column scales b_s (1, N): bf16((f32(a_q @ b) * a_s) * b_s), the integer
  product exact in s32.

CPU tensors take the plain versions; CUDA tensors launch the kernel on the
current stream or raise. Each wrapper's `launches` counts its launches.
Both are persistent TMA + wgmma GEMMs on clusters of two blocks, each at
the tile its plan picks (`mm_bf16_plan`, `w8a8_plan`: the wider where its
tile pairs fill the card); both take ragged shapes as they are (TMA fills
past the edges with zeros), T1 padding only K or N that is not a multiple
of 8, T2 only K that is not a multiple of 16 or N of 8 (no preset has
them).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build

# T1's output tiles (rows, columns): mm_bf16_plan takes the wider where its
# tile pairs still fill the card
MM_BF16_TILES = ((128, 128), (128, 256))
# the output tiles of K6's GEMM and T2 (csrc/w8a8.cu), which w8a8_plan
# picks from in the same way
TILES = ((128, 128), (128, 256))
_ALIGN_BF16 = 8         # T1's K and N: TMA's row strides are multiples of 16 bytes
_ALIGN_S8_K = 16        # T2's K: 16-byte int8 rows for TMA
_ALIGN_S8_N = 8         # T2's N: 16-byte bf16 row stores
_P, _I = ctypes.c_void_p, ctypes.c_int
# T1 against another bf16 rounding of the same f32 sums (its plain version,
# JAX's kernel): the largest shares of values that may differ at all, and
# by more than one bf16 ulp (mm_bf16_within)
MM_BF16_MAX_DIFFERING = 1e-2
MM_BF16_MAX_PAST_ULP = 1e-3


# -- plain versions ------------------------------------------------------------

def mm_bf16_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """T1's function: bf16((a @ b) in f32)."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def mm_s8_plain(a_q: torch.Tensor, a_s: torch.Tensor, b_t: torch.Tensor,
                b_s: torch.Tensor) -> torch.Tensor:
    """T2's function: bf16((f32(a_q @ b_t.T) * a_s) * b_s). The integer
    product is taken in float64, exact for K * 127^2 < 2^53."""
    acc = (a_q.double() @ b_t.double().t()).float()
    return (acc * a_s * b_s).to(torch.bfloat16)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at |v| (8 significant bits); 0 at 0."""
    _, e = torch.frexp(v.abs())
    return torch.where(v == 0, 0.0, torch.ldexp(torch.ones_like(v), e - 8))


def mm_bf16_within(got: torch.Tensor, ref: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> dict:
    """Hold `got` to `ref`, two bf16 roundings (nearest even) of f32 sums of
    a @ b taken in different orders. Counts the values that differ, those
    that differ by more than one bf16 ulp (of either), and those that
    differ by more than that ulp plus what two f32 sums of the same K
    products can differ by in another order, 2 (K - 1) 2^-24 (|a| @ |b|),
    a term that matters only where the products cancel. `ok` when none is
    past the last and the shares of the first two are at most
    MM_BF16_MAX_DIFFERING and MM_BF16_MAX_PAST_ULP: a truncating
    epilogue, or a sum kept in less than f32, moves far more values."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    ulp = torch.maximum(_bf16_ulp(ref), _bf16_ulp(got))
    order = 2 * (a.shape[1] - 1) * 2.0 ** -24 * (a.float().abs() @ b.float().abs())
    n = diff.numel()
    r = {"n": n, "differing": int((diff > 0).sum()), "past_ulp": int((diff > ulp).sum()),
         "past_bound": int((diff > ulp + order).sum()), "max_abs_err": diff.max().item()}
    r["ok"] = (r["past_bound"] == 0 and r["differing"] <= MM_BF16_MAX_DIFFERING * n
            and r["past_ulp"] <= MM_BF16_MAX_PAST_ULP * n)
    return r


# -- launch plans ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MmPlan:
    """T1's grid for one shape on a card of `sms` SMs: `tiles` output tiles
    of `tile` in `pairs` of two row tiles of one column tile (a cluster of
    two blocks, which share the tile of b), walked by `grid` persistent
    blocks (cluster c takes pairs c, c + grid / 2, ...), so the busiest
    cluster computes `rounds` pairs; `fill` is the share of the card's
    SM-rounds that compute a tile."""
    tile: tuple[int, int]
    tiles: int
    pairs: int
    grid: int
    sms: int

    @property
    def rounds(self) -> int:
        return -(-self.pairs // (self.grid // 2))

    @property
    def fill(self) -> float:
        return self.tiles / (self.sms * self.rounds)


def _pair_plan(M: int, N: int, sms: int, tiles) -> MmPlan:
    def plan(t):
        m_tiles, n_tiles = -(-M // t[0]), -(-N // t[1])
        pairs = -(-m_tiles // 2) * n_tiles
        return MmPlan(tile=t, tiles=m_tiles * n_tiles, pairs=pairs,
                      grid=2 * min(pairs, sms // 2), sms=sms)
    for t in tiles[::-1]:
        if plan(t).pairs >= sms // 2:
            return plan(t)
    return plan(tiles[0])


def mm_bf16_plan(M: int, N: int, sms: int) -> MmPlan:
    """T1's plan for an (M, N) output: one block per SM (its ring of stages
    takes most of the SM's shared memory), two to a cluster, no more
    clusters than tile pairs, at the widest of MM_BF16_TILES whose pairs
    fill every cluster the card holds (fewer bytes per product from L2 and
    shared memory), else the narrowest."""
    return _pair_plan(M, N, sms, MM_BF16_TILES)


def w8a8_plan(M: int, N: int, sms: int) -> MmPlan:
    """The plan of K6's GEMM and T2 for an (M, N) output, as T1's: clusters
    of two blocks, one block per SM, at the widest of TILES whose tile
    pairs fill every cluster the card holds. At one encoder window (M =
    1536) mlp0 and qkv take 128 x 256, o and mlp1 (N = 1280: 30 pairs)
    128 x 128; at 8 windows every linear takes 128 x 256. The s32 sums are
    exact, so the tile changes no bit of the result."""
    return _pair_plan(M, N, sms, TILES)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- kernels ---------------------------------------------------------------------

@functools.cache
def _lib_bf16() -> ctypes.CDLL:
    lib = _build.load("mm_bf16")
    lib.owk_mm_bf16.argtypes = [_P] * 3 + [_I] * 5 + [_P]   # a, b, out, M, K, N, bn, grid, stream
    lib.owk_mm_bf16.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_s8() -> ctypes.CDLL:
    lib = _build.load("w8a8")
    # xq, xs, wt, ws, out, M, K, N, bn, grid, stream
    lib.owk_mm_s8.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.owk_mm_s8.restype = ctypes.c_int
    return lib


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    pr, pc = rows - t.shape[0], cols - t.shape[1]
    return F.pad(t, (0, pc, 0, pr)) if pr or pc else t


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must start on a 16-byte boundary")


def _launch_check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel T1: a (M, K) bf16 @ b (K, N) bf16 -> bf16 (M, N), f32 sums.
    CPU tensors take `mm_bf16_plain`; CUDA tensors launch csrc/mm_bf16.cu
    at `mm_bf16_plan`'s tile, or raise."""
    if a.device.type == "cpu":
        return mm_bf16_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mm_bf16: unsupported device {a.device}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mm_bf16: a and b must be 2-D, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    _check("mm_bf16: a", a, torch.bfloat16, (M, K), a.device)
    _check("mm_bf16: b", b, torch.bfloat16, (K, N), a.device)
    Kp, Np = _up(K, _ALIGN_BF16), _up(N, _ALIGN_BF16)
    a_p, b_p = _pad_to(a, M, Kp), _pad_to(b, Kp, Np)
    out = torch.empty(M, Np, dtype=torch.bfloat16, device=a.device)
    plan = mm_bf16_plan(M, Np, _sms(a.device.index if a.device.index is not None
                                    else torch.cuda.current_device()))
    rc = _lib_bf16().owk_mm_bf16(a_p.data_ptr(), b_p.data_ptr(), out.data_ptr(), M, Kp,
                                 Np, plan.tile[1], plan.grid,
                                 torch.cuda.current_stream(a.device).cuda_stream)
    _launch_check("mm_bf16", rc)
    mm_bf16.launches += 1
    return out[:, :N] if Np != N else out


mm_bf16.launches = 0


def mm_s8(a_q: torch.Tensor, a_s: torch.Tensor, b_t: torch.Tensor,
          b_s: torch.Tensor) -> torch.Tensor:
    """Kernel T2: int8 rows a_q (M, K) with f32 scales a_s (M, 1), the int8
    weight transposed b_t (N, K) with f32 column scales b_s (1, N) ->
    bf16 (M, N). CPU tensors take `mm_s8_plain`; CUDA tensors launch K6's
    GEMM (csrc/w8a8.cu, `owk_mm_s8`) at `w8a8_plan`'s tile, or raise."""
    if a_q.device.type == "cpu":
        return mm_s8_plain(a_q, a_s, b_t, b_s)
    if a_q.device.type != "cuda":
        raise ValueError(f"mm_s8: unsupported device {a_q.device}")
    if a_q.dim() != 2 or b_t.dim() != 2:
        raise ValueError(f"mm_s8: a_q and b_t must be 2-D, got {tuple(a_q.shape)}, "
                         f"{tuple(b_t.shape)}")
    M, K = a_q.shape
    N = b_t.shape[0]
    dev = a_q.device
    _check("mm_s8: a_q", a_q, torch.int8, (M, K), dev)
    _check("mm_s8: a_s", a_s, torch.float32, (M, 1), dev)
    _check("mm_s8: b_t", b_t, torch.int8, (N, K), dev)
    _check("mm_s8: b_s", b_s, torch.float32, (1, N), dev)
    Kp, Np = _up(K, _ALIGN_S8_K), _up(N, _ALIGN_S8_N)
    # zero columns of K add nothing to a sum; the pad columns of N are cut
    aq_p, bt_p, bs_p = _pad_to(a_q, M, Kp), _pad_to(b_t, Np, Kp), _pad_to(b_s, 1, Np)
    out = torch.empty(M, Np, dtype=torch.bfloat16, device=dev)
    if M:
        plan = w8a8_plan(M, Np, _sms(dev.index if dev.index is not None
                                     else torch.cuda.current_device()))
        rc = _lib_s8().owk_mm_s8(aq_p.data_ptr(), a_s.data_ptr(), bt_p.data_ptr(),
                                 bs_p.data_ptr(), out.data_ptr(), M, Kp, Np, plan.tile[1],
                                 plan.grid, torch.cuda.current_stream(dev).cuda_stream)
        _launch_check("mm_s8", rc)
        mm_s8.launches += 1
    return out[:, :N] if Np != N else out


mm_s8.launches = 0
