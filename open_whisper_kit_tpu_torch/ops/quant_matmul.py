"""Block-quantized linears: int8 and int4 weight planes and their matmuls.

Port of open_whisper_kit_tpu/ops/quant_matmul.py. Symmetric ggml formats
(q4_0/q5_0/q8_0) are repacked at load into planes for y = x @ w: an int8
value plane (K, Np) plus f32 scales per 32-row block (K/32, Np), Np padded
to a multiple of 128 (the CUDA kernels' column tile; the JAX package pads
to 512, its TPU kernel's tile). Affine and K-quant formats are
dequantized to float at load (they never reach this module). Runtime W8/W4
planes come from dense weights through `quantize_linear` /
`quantize_linear4`.

Three kernels, each beside its plain torch version:

* K3 `qmm`: y = bf16(x) @ bf16(q * s), f32 accumulation; two bodies by the
  number of rows (`qmm_route`): csrc/qmm_rows.cu for the decode rows,
  csrc/qmm.cu above them;
* K4 `qmm4` (csrc/qmm4.cu): the same over split-half int4 planes
  (low nibble = even K row, high nibble = odd), weights (nibble - 8) * s
  rounded to bf16 as the TPU kernel rounds them;
* K5 `ffn_int8` (csrc/ffn_int8.cu): gelu_tanh(x @ W0 + b0) rounded to bf16,
  then @ W1, the partial products summed in K order; two bodies by the
  number of rows (`ffn_int8_route`): the rows body of K3 twice, the second
  a dependent launch, for the decode rows, qmm_tile.cuh's tiles above them.

A wrapper takes the plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises. Each wrapper's `launches` counts its calls
on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..io import quant as Q
from . import _build

QK = 32          # ggml simple-quant block size
_BN = 128        # output-tile width the planes are padded to (the CUDA kernels')
_FFN_TILE = 512  # hidden-axis tile of the TPU kernel _ffn_int8, which
                 # ffn_int8_plain sums its partial products in


@dataclasses.dataclass
class QuantPlanes:
    """What QuantLinear and QuantLinear4 share: value planes `qs`, f32
    scales per 32-row block, and `n`, the logical output width (None =
    unpadded). Leading axes stack layers: `w[il]` is layer il's plane."""
    qs: torch.Tensor
    scales: torch.Tensor
    n: int | None = None

    @property
    def n_out(self) -> int:
        return self.n if self.n is not None else self.qs.shape[-1]

    def __getitem__(self, i):
        return dataclasses.replace(self, qs=self.qs[i], scales=self.scales[i])

    def to(self, device):
        return dataclasses.replace(self, qs=self.qs.to(device),
                                   scales=self.scales.to(device))


@dataclasses.dataclass
class QuantLinear(QuantPlanes):
    """Weight for y = x @ w, stored quantized: qs (..., K, Np) int8 values,
    scales (..., K//32, Np) f32. Np is padded to a tile multiple, so no
    per-call pad copies the weight."""

    @property
    def shape(self) -> tuple[int, ...]:
        return (*self.qs.shape[:-1], self.n_out)


@dataclasses.dataclass
class QuantLinear4(QuantPlanes):
    """4-bit planes: qs (..., K/2, Np) uint8, low nibble = even K row, high
    nibble = odd K row (a nibble pair shares its 32-row scale block).
    scales (..., K/32, Np) f32."""

    @property
    def shape(self) -> tuple[int, ...]:
        return (*self.qs.shape[:-2], self.qs.shape[-2] * 2, self.n_out)


def stack(ws: list[QuantPlanes]) -> QuantPlanes:
    """Per-layer planes -> one plane with a leading layer axis."""
    return dataclasses.replace(ws[0], qs=torch.stack([w.qs for w in ws]),
                               scales=torch.stack([w.scales for w in ws]))


def _padded(n: int) -> int:
    return -(-n // _BN) * _BN


def repack(raw: bytes | np.ndarray, ggml_type: int,
           out_features: int, in_features: int) -> QuantLinear | None:
    """ggml blocks for a (out, in) weight -> transposed planes for x @ w
    (CPU tensors). None if the type has no symmetric int8 representation."""
    n = out_features * in_features
    buf = np.frombuffer(raw, np.uint8, count=Q.nbytes_for(ggml_type, n))
    bs, bb = Q.block_info(ggml_type)
    if bs != QK:
        return None
    blocks = buf.reshape(-1, bb)

    if ggml_type == Q.GGML_TYPE_Q8_0:
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
        vals = blocks[:, 2:].copy().view(np.int8)
    elif ggml_type == Q.GGML_TYPE_Q5_0:
        d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)
        qh = blocks[:, 2:6].copy().view(np.uint32)
        ql = blocks[:, 6:]
        sh = np.arange(32, dtype=np.uint32)
        hbits = ((qh >> sh) & 1).astype(np.uint8)
        q4 = np.concatenate([ql & 0x0F, ql >> 4], axis=1)
        vals = ((q4 | (hbits << 4)).astype(np.int16) - 16).astype(np.int8)
    elif ggml_type == Q.GGML_TYPE_Q4_0:
        d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
        q = blocks[:, 2:]
        vals = np.concatenate([(q & 0x0F).astype(np.int8) - 8,
                               (q >> 4).astype(np.int8) - 8], axis=1)
    else:
        return None

    # blocks are row-major over the (out, in) weight: out*in//32 blocks
    vals = vals.reshape(out_features, in_features)         # (N, K)
    d = d.reshape(out_features, in_features // QK)         # (N, K/32)
    N = out_features
    Np = _padded(N)
    qs = np.ascontiguousarray(vals.T)                      # (K, N)
    sc = np.ascontiguousarray(d.T.astype(np.float32))      # (K/32, N)
    if Np != N:   # pre-pad to the output tile: no per-call weight pad
        qs = np.pad(qs, ((0, 0), (0, Np - N)))
        sc = np.pad(sc, ((0, 0), (0, Np - N)))
    return QuantLinear(qs=torch.from_numpy(qs), scales=torch.from_numpy(sc), n=N)


def concat_quant(ws: list[QuantLinear]) -> QuantLinear:
    """Concatenate QuantLinears along the output axis (logical widths; pad
    columns of each part are dropped, the result is re-padded)."""
    qs = torch.cat([w.qs[..., :w.n_out] for w in ws], dim=-1)
    sc = torch.cat([w.scales[..., :w.n_out] for w in ws], dim=-1)
    N = qs.shape[-1]
    Np = _padded(N)
    if Np != N:
        qs, sc = F.pad(qs, (0, Np - N)), F.pad(sc, (0, Np - N))
    return QuantLinear(qs=qs, scales=sc, n=N)


def _quantize_planes(w: torch.Tensor):
    *lead, K, N = w.shape
    x32 = w.float().reshape(*lead, K // QK, QK, N)
    amax = x32.abs().amax(dim=-2)                               # (..., K/32, N)
    # the JAX side's jitted amax / 127 compiles to a multiply by f32(1/127);
    # the same product here keeps the scales bit-equal to its planes
    scale = amax * np.float32(1.0 / 127.0).item()
    inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale), 0.0)
    qs = torch.clamp(torch.round(x32 * inv[..., None, :]), -127, 127)
    # contiguous even for a transposed weight (te.t()): the kernels take rows
    return qs.reshape(*lead, K, N).to(torch.int8).contiguous(), scale.contiguous()


def quantize_linear(w: torch.Tensor, pad: bool = True) -> QuantLinear:
    """Dense (..., K, N) weight -> symmetric per-32-K-block int8 planes
    (amax/127 scales, q8_0-level error), pre-padded to the 128-wide output
    tile; pad=False keeps the logical width (fused_ffn_int8's W0). The
    runtime W8 mode."""
    qs, scale = _quantize_planes(w)
    N = w.shape[-1]
    Np = _padded(N)
    if pad and Np != N:
        qs, scale = F.pad(qs, (0, Np - N)), F.pad(scale, (0, Np - N))
    return QuantLinear(qs=qs, scales=scale, n=N)


def quantize_linear4(w: torch.Tensor) -> QuantLinear4:
    """Dense (K, N) weight -> symmetric per-32-K-block int4 planes
    (amax/7 scales, q4_0-level error), split-half nibbles."""
    K, N = w.shape
    x32 = w.float().reshape(K // QK, QK, N)
    amax = x32.abs().amax(dim=1)
    scale = amax / 7.0
    inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale), 0.0)
    q = torch.clamp(torch.round(x32 * inv[:, None, :]), -8, 7) + 8
    q = q.reshape(K, N).to(torch.uint8)
    packed = (q[0::2] | (q[1::2] << 4)).contiguous()         # (K/2, N)
    Np = _padded(N)
    if Np != N:
        packed, scale = F.pad(packed, (0, Np - N)), F.pad(scale, (0, Np - N))
    return QuantLinear4(qs=packed, scales=scale.contiguous(), n=N)


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """(K/2, Np) packed uint8 -> (K, Np) f32 values nibble - 8, rows
    interleaved back: row 2i from the low nibble, row 2i+1 from the high."""
    q = qs.to(torch.int32)
    lo, hi = (q & 0x0F) - 8, (q >> 4) - 8
    return torch.stack([lo, hi], dim=-2).reshape(
        *qs.shape[:-2], 2 * qs.shape[-2], qs.shape[-1]).float()


def dequantize_dense(w: QuantPlanes, dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """Expand to a dense (K, N) tensor: q * s in f32, cast to `dtype`."""
    q = _nibbles(w.qs) if isinstance(w, QuantLinear4) else w.qs.float()
    s = w.scales.repeat_interleave(QK, dim=-2)
    return (q * s).to(dtype)[..., :w.n_out]


# -- plain versions of the kernels ---------------------------------------------

def _dot_bf16(x: torch.Tensor, w_bf16: torch.Tensor) -> torch.Tensor:
    """bf16(x) @ w_bf16 with every product exact and an f32 sum."""
    return torch.matmul(x.to(torch.bfloat16).float(), w_bf16.float())


def qmm_plain(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor
              ) -> torch.Tensor:
    """K3's function: x (M, K) -> (M, Np) f32; the weight is q * s in f32,
    rounded to bf16; x is rounded to bf16."""
    return _dot_bf16(x, dequantize_dense(QuantLinear(qs, scales)))


def qmm4_plain(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor
               ) -> torch.Tensor:
    """K4's function: x (M, K) -> (M, Np) f32 over int4 planes, weights
    (nibble - 8) * s rounded to bf16 (the TPU kernel's rounding; the JAX
    interpret mode keeps them f32)."""
    return _dot_bf16(x, dequantize_dense(QuantLinear4(qs, scales)))


def ffn_int8_plain(x: torch.Tensor, q0: torch.Tensor, s0: torch.Tensor,
                   b0: torch.Tensor, q1: torch.Tensor, s1: torch.Tensor
                   ) -> torch.Tensor:
    """K5's function: x (M, K) -> (M, N1p) f32. Per 512-wide tile t of the
    hidden axis, h_t = gelu_tanh(x @ W0_t + b0_t) in f32, rounded to bf16,
    times W1_t; the partial products add in tile order."""
    FF = q0.shape[1]
    bn = min(_FFN_TILE, FF)
    acc = None
    for t in range(FF // bn):
        cols, blks = slice(t * bn, (t + 1) * bn), slice(t * bn // QK, (t + 1) * bn // QK)
        h = qmm_plain(x, q0[:, cols], s0[:, cols]) + b0[cols].float()
        h = F.gelu(h, approximate="tanh").to(torch.bfloat16)
        y = qmm_plain(h, q1[cols], s1[blks])
        acc = y if acc is None else acc + y
    return acc


# -- the kernels -----------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


_X_PLANES_OUT = [_P] * 4 + [_I] * 3 + [_P]   # x qs scales out, M K Np, stream
# the C entries of each kernel library and their arguments; K3's two routes
# (qmm_route) are two libraries
_ENTRIES = {
    "qmm": {"owk_qmm_tiles": _X_PLANES_OUT},
    # x maps out, M K Np splits, stream; qs scales, K Np, maps
    "qmm_rows": {"owk_qmm_rows": [_P] * 3 + [_I] * 4 + [_P],
                 "owk_qmm_rows_maps": [_P] * 2 + [_I] * 2 + [_P]},
    "qmm4": {"owk_qmm4": _X_PLANES_OUT},
    # x q0 s0 b0 q1 s1 h out, M K FF N1p, stream; x maps b0 b0_bf16 h out, M
    # K FF N1p splits_up splits_down, stream; q0 s0, K FF, q1 s1, N1p, maps
    "ffn_int8": {"owk_ffn_int8": [_P] * 8 + [_I] * 4 + [_P],
                 "owk_ffn_int8_rows": [_P] * 3 + [_I] + [_P] * 2 + [_I] * 6 + [_P],
                 "owk_ffn_int8_maps": [_P] * 2 + [_I] * 2 + [_P] * 2 + [_I, _P]},
}


@functools.cache
def _kernel_lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for entry, argtypes in _ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, *planes: tuple[torch.Tensor, torch.dtype]):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"{name}: x must be a 2-D float tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    for t, dtype in planes:
        if t.device != x.device:
            raise ValueError(f"{name}: planes on {t.device}, x on {x.device}")
        if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: planes must be contiguous {dtype} on a "
                             f"16-byte boundary, got {t.dtype} (contiguous="
                             f"{t.is_contiguous()}, address {t.data_ptr():#x})")


def _bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """x as contiguous bf16 starting on a 16-byte boundary (the kernels
    load 8 values at a time)."""
    xb = x.to(torch.bfloat16).contiguous()
    return xb if xb.data_ptr() % 16 == 0 else xb.clone()


def _launch(name: str, *args, entry: str | None = None) -> None:
    fn = getattr(_kernel_lib(name), entry or f"owk_{name}")
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _check_shapes(name: str, K: int, rows: int, qs: torch.Tensor,
                  scales: torch.Tensor) -> int:
    Np = qs.shape[1]
    if qs.dim() != 2 or qs.shape[0] != rows or K % QK:
        raise ValueError(f"{name}: x has K={K}, planes {tuple(qs.shape)}")
    if Np % _BN or tuple(scales.shape) != (K // QK, Np):
        raise ValueError(f"{name}: Np={Np} must be a multiple of {_BN} "
                         f"and scales {(K // QK, Np)}, got {tuple(scales.shape)}")
    return Np


QMM_ROWS_MAX = 16   # K3's "rows" route takes M up to this; the "tiles" route the rest


def qmm_route(M: int) -> str:
    """The K3 body a CUDA call with M rows launches: "rows" (csrc/qmm_rows.cu,
    the split weight stream, for the decode rows) when M <= QMM_ROWS_MAX,
    else "tiles" (the TMA + wgmma kernel of csrc/qmm.cu, 128 x 128 output
    tiles)."""
    return "rows" if M <= QMM_ROWS_MAX else "tiles"


# the rows route's launch plan (csrc/qmm_rows.cuh): about ROWS_BLOCKS blocks
# (the decoder's 1.8 MB planes are then in flight whole on the H100, and
# more splits cost more in their combine than they gain); the splits of a
# column tile are one thread-block cluster, of at most ROWS_MAX_SPLITS
# blocks (the portable cluster size); a block holds its split of x's rows in
# at most ROWS_X_SMEM bytes of shared memory, and the first split the
# others' partial sums in at most ROWS_GATHER
ROWS_BLOCKS = 100
ROWS_MAX_SPLITS = 8
ROWS_X_SMEM = 40 << 10
ROWS_GATHER = 24 << 10


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """A rows-route launch: `tiles` column tiles of 128 (the grid's x) times
    `splits` of K (its y, one cluster per tile); split s takes the 32-row
    scale blocks [s * nkb // splits, (s + 1) * nkb // splits) of nkb = K / 32."""
    M: int
    K: int
    Np: int
    splits: int

    @property
    def tiles(self) -> int:
        return self.Np // _BN

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_rows(self) -> list[tuple[int, int]]:
        """The K rows [start, stop) of each split, in split order."""
        nkb = self.K // QK
        return [(s * nkb // self.splits * QK, (s + 1) * nkb // self.splits * QK)
                for s in range(self.splits)]

    @property
    def x_smem(self) -> int:
        """Bytes of a block's x rows in shared memory (8 or 16 rows of the
        longest split; the kernel adds 16 bytes of padding a row)."""
        return (8 if self.M <= 8 else 16) * -(-self.K // QK // self.splits) * QK * 2

    @property
    def gather_smem(self) -> int:
        """Bytes of the other splits' partial sums (M x 128 f32 each) that
        the first split of a tile receives."""
        return (self.splits - 1) * self.M * _BN * 4

    def smem(self, stages: int) -> int:
        """Dynamic shared memory a block asks for with a ring of `stages`
        (csrc/qmm_rows.cuh's smem_bytes): 1024 bytes of alignment, the
        ring, the gather barrier, x's rows padded by 16 bytes each, the
        gathered sums."""
        x_rows = 8 if self.M <= 8 else 16
        return (1024 + stages * (32 * _BN + _BN * 4 + 16) + 16 + self.x_smem + 16 * x_rows
                + self.gather_smem)


@functools.cache
def qmm_rows_plan(M: int, K: int, Np: int) -> RowsPlan:
    """The rows route's splits for x (M, K) @ planes (K, Np): as many as
    make ROWS_BLOCKS blocks, at most one per scale block, ROWS_MAX_SPLITS
    and as many as ROWS_GATHER holds; more if x's rows of a split would not
    fit ROWS_X_SMEM (a K the decoder does not have)."""
    nkb, tiles = K // QK, Np // _BN
    splits = max(1, min(nkb, -(-ROWS_BLOCKS // tiles), ROWS_MAX_SPLITS,
                        1 + ROWS_GATHER // (M * _BN * 4)))
    while RowsPlan(M, K, Np, splits).x_smem > ROWS_X_SMEM:
        splits += 1
    plan = RowsPlan(M, K, Np, splits)
    if plan.splits > min(nkb, ROWS_MAX_SPLITS) or plan.gather_smem > ROWS_GATHER:
        raise ValueError(f"qmm: no rows-route plan for M={M} K={K} Np={Np}")
    return plan


# K5's two halves on the rows body (csrc/ffn_int8.cu's kUpStages,
# kDownStages): rings as deep as their splits at whisper-large, so each
# block asks for its whole split at once (the second half before its wait)
FFN_UP_STAGES = 14
FFN_DOWN_STAGES = 20
# K5's cap on the partial sums a first split gathers (qmm_rows.cuh's
# kFfnGatherCap): 7 other splits at 16 rows, so that its splits depend on
# K and N alone and a row's bits on nothing but its own inputs
FFN_GATHER = 7 * 16 * _BN * 4


@dataclasses.dataclass(frozen=True)
class FfnRowsPlan:
    """K5's launches at M <= 16: `up` (x @ W0, M x K -> FF) and `down` (h @
    W1, M x FF -> N1p), each a rows-body plan; `smem` what a block of each
    asks for."""
    up: RowsPlan
    down: RowsPlan

    @property
    def smem(self) -> tuple[int, int]:
        return self.up.smem(FFN_UP_STAGES), self.down.smem(FFN_DOWN_STAGES)


def _ffn_splits(K: int, Np: int) -> int:
    nkb, tiles = K // QK, Np // _BN
    splits = max(1, min(nkb, -(-ROWS_BLOCKS // tiles), ROWS_MAX_SPLITS))
    while RowsPlan(QMM_ROWS_MAX, K, Np, splits).x_smem > ROWS_X_SMEM:
        splits += 1
    if splits > min(nkb, ROWS_MAX_SPLITS):
        raise ValueError(f"ffn_int8: no rows-body plan for K={K} Np={Np}")
    return splits


@functools.cache
def ffn_int8_rows_plan(M: int, K: int, FF: int, N1p: int) -> FfnRowsPlan:
    """K5's plan at M <= 16 rows: each half splits K as the rows route does
    (about ROWS_BLOCKS blocks, at most ROWS_MAX_SPLITS, x's rows of a split
    within ROWS_X_SMEM), but for 16 rows whatever M is, with FFN_GATHER
    room for the gathered sums: the splits, and so the order of every f32
    sum, depend on K and N alone, and a verify row is bit-equal to the same
    row run alone."""
    if not 1 <= M <= QMM_ROWS_MAX:
        raise ValueError(f"ffn_int8: the rows body takes 1..{QMM_ROWS_MAX} rows, got {M}")
    return FfnRowsPlan(up=RowsPlan(M, K, FF, _ffn_splits(K, FF)),
                       down=RowsPlan(M, FF, N1p, _ffn_splits(FF, N1p)))


def ffn_int8_route(M: int) -> str:
    """The K5 body a CUDA call with M rows launches: "rows" (the rows body
    twice, the second a dependent launch) when M <= QMM_ROWS_MAX, else
    "tiles" (qmm_tile.cuh's 64-row tiles)."""
    return "rows" if M <= QMM_ROWS_MAX else "tiles"


# The rows route keeps the two tensor maps of each plane between calls, so
# that a token step's wrapper encodes nothing: keyed on the planes'
# addresses, K, Np and the device (a map is a function of those alone, so a
# plane freed and another allocated at its address with its shape reuse it
# rightly). It needs no workspace: the splits meet in shared memory.
_rows_maps: dict[tuple, tuple[ctypes.Array, int]] = {}
_ROWS_MAPS_MAX = 4096   # entries kept before the cache starts over


def _cached_maps(key: tuple, size: int, encode) -> int:
    """The address of the tensor maps kept under `key`, encoding them into
    `size` bytes with encode(address) -> cudaError_t the first time."""
    hit = _rows_maps.get(key)
    if hit is None:
        if len(_rows_maps) >= _ROWS_MAPS_MAX:
            _rows_maps.clear()
        buf = ctypes.create_string_buffer(size)
        rc = encode(ctypes.addressof(buf))
        if rc != 0:
            raise RuntimeError(f"{key[0]}: tensor map encoding failed (cudaError {rc})")
        hit = _rows_maps[key] = (buf, ctypes.addressof(buf))
    return hit[1]


def _rows_tensor_maps(qs: torch.Tensor, scales: torch.Tensor, K: int, Np: int) -> int:
    return _cached_maps(
        ("qmm", qs.data_ptr(), scales.data_ptr(), K, Np, qs.device.index), 256,
        lambda addr: _kernel_lib("qmm_rows").owk_qmm_rows_maps(
            qs.data_ptr(), scales.data_ptr(), K, Np, addr))


def _ffn_tensor_maps(q0, s0, q1, s1, K: int, FF: int, N1p: int) -> int:
    """K5's four maps (W0's two, then W1's), kept per pair of planes."""
    return _cached_maps(
        ("ffn_int8", q0.data_ptr(), s0.data_ptr(), q1.data_ptr(), s1.data_ptr(), K, FF, N1p,
         q0.device.index), 512,
        lambda addr: _kernel_lib("ffn_int8").owk_ffn_int8_maps(
            q0.data_ptr(), s0.data_ptr(), K, FF, q1.data_ptr(), s1.data_ptr(), N1p, addr))


def qmm(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel K3: x (M, K) @ int8 planes -> (M, Np) f32. CPU tensors take
    `qmm_plain`; CUDA tensors launch the body of the route `qmm_route(M)`
    names on the current stream (rows: csrc/qmm_rows.cu, planned by
    `qmm_rows_plan`; tiles: csrc/qmm.cu). `launches` counts launches,
    `launches_by_route` the same by route."""
    if x.device.type == "cpu":
        return qmm_plain(x, qs, scales)
    _check("qmm", x, (qs, torch.int8), (scales, torch.float32))
    M, K = x.shape
    Np = _check_shapes("qmm", K, K, qs, scales)
    out = torch.empty(M, Np, dtype=torch.float32, device=x.device)
    if M:
        xb = _bf16_rows(x)
        route = qmm_route(M)
        if route == "rows":
            rc = _kernel_lib("qmm_rows").owk_qmm_rows(
                xb.data_ptr(), _rows_tensor_maps(qs, scales, K, Np), out.data_ptr(), M, K, Np,
                qmm_rows_plan(M, K, Np).splits, torch.cuda.current_stream(x.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"qmm: kernel launch failed (cudaError {rc})")
        else:
            _launch("qmm", xb.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), M, K, Np, entry="owk_qmm_tiles")
        qmm.launches += 1
        qmm.launches_by_route[route] += 1
    return out


def qmm4(x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Kernel K4: x (M, K) @ split-half int4 planes (K/2, Np) -> (M, Np)
    f32. CPU tensors take `qmm4_plain`; CUDA tensors launch csrc/qmm4.cu."""
    if x.device.type == "cpu":
        return qmm4_plain(x, qs, scales)
    _check("qmm4", x, (qs, torch.uint8), (scales, torch.float32))
    M, K = x.shape
    Np = _check_shapes("qmm4", K, K // 2, qs, scales)
    out = torch.empty(M, Np, dtype=torch.float32, device=x.device)
    if M:
        xb = _bf16_rows(x)
        _launch("qmm4", xb.data_ptr(), qs.data_ptr(), scales.data_ptr(),
                out.data_ptr(), M, K, Np)
        qmm4.launches += 1
    return out


def ffn_int8(x: torch.Tensor, q0: torch.Tensor, s0: torch.Tensor,
             b0: torch.Tensor, q1: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    """Kernel K5: gelu_tanh(x @ W0 + b0) @ W1 -> (M, N1p) f32, W0 (K, FF)
    unpadded, W1 (FF, N1p). CPU tensors take `ffn_int8_plain`; CUDA tensors
    launch csrc/ffn_int8.cu on the current stream, two kernels (the
    up-projection writes h in bf16, the down-projection sums over h in
    order) of the body `ffn_int8_route(M)` names: at M <= 16 the rows body
    planned by `ffn_int8_rows_plan`, the second a dependent launch; above,
    the 64-row tiles. `launches` counts calls, `launches_by_route` the same
    by route."""
    if x.device.type == "cpu":
        return ffn_int8_plain(x, q0, s0, b0, q1, s1)
    M, K = x.shape
    route = ffn_int8_route(M)
    # the rows body reads a bf16 or f32 bias as it is; the tiles body f32
    bias = (b0 if route == "rows" and b0.dtype in (torch.bfloat16, torch.float32)
            else b0.float()).contiguous()
    _check("ffn_int8", x, (q0, torch.int8), (s0, torch.float32), (bias, bias.dtype),
           (q1, torch.int8), (s1, torch.float32))
    FF = _check_shapes("ffn_int8", K, K, q0, s0)
    N1p = _check_shapes("ffn_int8", FF, FF, q1, s1)
    if tuple(bias.shape) != (FF,):
        raise ValueError(f"ffn_int8: b0 {tuple(bias.shape)} != ({FF},)")
    out = torch.empty(M, N1p, dtype=torch.float32, device=x.device)
    if M:
        xb = _bf16_rows(x)
        h = torch.empty(M, FF, dtype=torch.bfloat16, device=x.device)
        if route == "rows":
            plan = ffn_int8_rows_plan(M, K, FF, N1p)
            _launch("ffn_int8", xb.data_ptr(), _ffn_tensor_maps(q0, s0, q1, s1, K, FF, N1p),
                    bias.data_ptr(), int(bias.dtype == torch.bfloat16), h.data_ptr(),
                    out.data_ptr(), M, K, FF, N1p, plan.up.splits, plan.down.splits,
                    entry="owk_ffn_int8_rows")
        else:
            _launch("ffn_int8", xb.data_ptr(), q0.data_ptr(), s0.data_ptr(),
                    bias.data_ptr(), q1.data_ptr(), s1.data_ptr(), h.data_ptr(),
                    out.data_ptr(), M, K, FF, N1p)
        ffn_int8.launches += 1
        ffn_int8.launches_by_route[route] += 1
    return out


qmm.launches = 0
qmm.launches_by_route = {"rows": 0, "tiles": 0}
qmm4.launches = 0
ffn_int8.launches = 0
ffn_int8.launches_by_route = {"rows": 0, "tiles": 0}


# -- what the model calls --------------------------------------------------------

def qmatmul(x: torch.Tensor, w: QuantPlanes) -> torch.Tensor:
    """y = x @ w for quantized w (QuantLinear or QuantLinear4);
    x (..., K) -> (..., n_out) f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    mm = qmm4 if isinstance(w, QuantLinear4) else qmm
    out = mm(x2, w.qs, w.scales)
    n = w.n_out
    if n != out.shape[-1]:   # a contiguous result, as torch.matmul gives
        out = out[:, :n].contiguous()
    return out.reshape(*lead, n)


def fused_ffn_int8(x: torch.Tensor, w0: QuantLinear, b0: torch.Tensor,
                   w1: QuantLinear) -> torch.Tensor:
    """y = gelu(x @ w0 + b0) @ w1 with int8 weight planes (kernel K5).
    The caller adds the final bias."""
    # W0 must be unpadded: pad columns would shift W1's row indexing
    if w0.qs.shape[-1] != w0.n_out:
        raise ValueError("fused_ffn_int8: quantize W0 with pad=False")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = ffn_int8(x2, w0.qs, w0.scales, b0, w1.qs, w1.scales)
    n = w1.n_out
    if n != out.shape[-1]:
        out = out[:, :n].contiguous()
    return out.reshape(*lead, n)
