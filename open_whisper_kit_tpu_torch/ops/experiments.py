"""Cross-attention over int8 cross-KV planes (port of
open_whisper_kit_tpu/ops/experiments.py): kernels K9b and K9a.

One decoder query row per (stream, head) against K/V planes stored as int8
with one f32 scale per (position, head):

    s_k = (q_h . kq[b,h,k]) * ks[b,h,k] * scale      for keys k < ta_valid
    p   = softmax(s)
    out = sum_k round(p_k * vs[b,h,k]) * vq[b,h,k]

in q's dtype: bf16 activations take the TPU kernels' rounding points (bf16
q, int8 exact in bf16, f32 dot products, scales folded after the dot, f32
softmax with e / sum before the multiply by vs, p * vs rounded to bf16,
f32 accumulation against V, the output rounded to bf16); f32 activations
stay f32 where the TPU kernel, which feeds a bf16 matrix unit, rounds. So
at every dtype the function is JAX's `_attention_hm_q` for one query row
(models/whisper/model.py), which `cross_attention_q8_plain` computes.

* `cross_attention_q8` (K9b, csrc/cross_q8.cu) takes JAX's head-major
  QuantKV planes: kq/vq (Bk, H, Ta, dh) int8, ks/vs (Bk, H, Ta) f32.
* `cross_attention_q8_nat` (K9a, the same source) takes the natural
  QuantKVNat planes: kq/vq (Bk, Tap, S) int8 and ks/vs (Bk, Hs, Tap) f32
  with Ta and H padded, and masks keys at or past `ta_valid`.

Bk is B, or 1 for planes that every row shares (the kernel reads them with
batch stride 0). CPU tensors take the plain versions; CUDA tensors launch
the kernel or raise. Each wrapper's `launches` counts its kernel launches.
The JAX package keeps both TPU kernels off its user paths; the port sends
every one-row int8 cross-attention of `decode_impl` to K9b on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build

HEAD_DIM = 64          # every whisper preset; the kernels take no other
# the kernel's launch plan (csrc/cross_q8.cu): one thread-block cluster of at
# most K9_MAX_CLUSTER blocks (the portable cluster size) per (head, row
# group), each block a chunk of the live keys, a multiple of 32 keys and at
# most K9_MAX_CHUNK (its K and V rows in shared memory), and at most
# K9_MAX_ROWS query rows of one shared plane
K9_MAX_CLUSTER = 8
K9_MAX_CHUNK = 256
K9_MAX_ROWS = 8
_K9_WARPS = 8          # the kernel's block: eight warps
_K9_Q_LD = 80          # floats of a query row in shared memory (64 + padding)


# -- plain versions ------------------------------------------------------------

def cross_attention_q8_plain(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                             vq: torch.Tensor, vs: torch.Tensor, n_head: int,
                             scale: float, with_probs: bool = False):
    """Attention of q (B, T, S) over head-major int8 planes kq/vq
    (Bk, H, Ta, dh) with scales ks/vs (Bk, H, Ta), Bk = B or 1 (shared):
    JAX's `_attention_hm_q` without the mask. The dequantized K/V are
    products of exact values, so the f32 matmuls reproduce its f32 einsums.
    `with_probs`: also return the f32 probabilities (B, H, T, Ta)."""
    B, T, S = q.shape
    d = S // n_head
    qh = q.reshape(B, T, n_head, d).transpose(1, 2)                    # (B,H,T,d)
    scores = torch.matmul(qh.float(), kq.float().transpose(-1, -2))    # (B,H,T,Ta)
    scores = scores * ks[:, :, None, :] * scale
    probs = torch.softmax(scores, dim=-1)
    pv = (probs * vs[:, :, None, :]).to(q.dtype)
    out = torch.matmul(pv.float(), vq.float()).to(q.dtype)             # (B,H,T,d)
    out = out.transpose(1, 2).reshape(B, T, S)
    return (out, probs) if with_probs else out


def _nat_to_head_major(kq: torch.Tensor, ks: torch.Tensor, n_head: int, n_keys: int):
    """Natural (Bk, Tap, S) planes and (Bk, Hs, Tap) scales -> head-major
    (Bk, H, n_keys, dh) planes and (Bk, H, n_keys) scales."""
    Bk, _, S = kq.shape
    hm = kq[:, :n_keys].reshape(Bk, n_keys, n_head, S // n_head).transpose(1, 2)
    return hm, ks[:, :n_head, :n_keys]


def cross_attention_q8_nat_plain(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                                 vq: torch.Tensor, vs: torch.Tensor, n_head: int,
                                 scale: float, ta_valid: int | None = None
                                 ) -> torch.Tensor:
    """K9a's function on the natural layout: the keys at or past
    `ta_valid` (default: all Tap) are left out, which is what masking them
    to -inf before the softmax gives."""
    n = kq.shape[1] if ta_valid is None else int(ta_valid)
    kh, ksh = _nat_to_head_major(kq, ks, n_head, n)
    vh, vsh = _nat_to_head_major(vq, vs, n_head, n)
    return cross_attention_q8_plain(q, kh, ksh, vh, vsh, n_head, scale)


# -- the kernels ---------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("cross_q8")
    for fn in (lib.owk_cross_q8_bf16, lib.owk_cross_q8_f32):
        # q, kq, ks, vq, vs, out; B, H, n_keys, chunk, rows, key batch/head/row
        # strides, scale batch/head strides; scale; stream
        fn.argtypes = [_P] * 6 + [_I] * 10 + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


@dataclasses.dataclass(frozen=True)
class CrossQ8Plan:
    """One K9 launch: a cluster of `chunks` blocks per (head, row group),
    block c taking the live keys [c * chunk, min((c + 1) * chunk, n_keys));
    a row group is `rows` query rows that read one plane (all B rows of a
    shared batch-1 plane, up to K9_MAX_ROWS a group; one row where each row
    has its own plane)."""
    B: int
    H: int
    n_keys: int
    shared: bool
    chunks: int
    chunk: int
    rows: int

    @property
    def groups(self) -> int:
        return -(-self.B // self.rows)

    @property
    def blocks(self) -> int:
        return self.chunks * self.H * self.groups

    def key_chunks(self) -> list[tuple[int, int]]:
        """The live keys [start, stop) of each block, in chunk order."""
        return [(c * self.chunk, min((c + 1) * self.chunk, self.n_keys))
                for c in range(self.chunks)]

    @property
    def sums_in_k_rows(self) -> bool:
        """Whether the warps' partial sums and the gathered ones fit where
        the K rows were (csrc/cross_q8.cu's Layout reuses them there)."""
        return ((_K9_WARPS + self.chunks - 1) * self.rows * HEAD_DIM * 4
                <= self.chunk * HEAD_DIM)

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block asks for (csrc/cross_q8.cu's
        Layout): K and V rows and scales of a chunk, the query rows, the
        scores, every block's (max, sum) per row, each row's (M, L), the
        gather barrier, and the eight warps' partial sums with the other
        blocks' ones unless they fit in the K rows' place."""
        rows, chunk = self.rows, self.chunk
        base = (2 * chunk * HEAD_DIM + 2 * chunk * 4 + rows * _K9_Q_LD * 4 + rows * chunk * 4
                + K9_MAX_CLUSTER * K9_MAX_ROWS * 8 + K9_MAX_ROWS * 8 + 16)
        sums = (_K9_WARPS + self.chunks - 1) * rows * HEAD_DIM * 4
        return base if self.sums_in_k_rows else base + sums


@functools.cache
def cross_q8_plan(B: int, H: int, n_keys: int, shared: bool) -> CrossQ8Plan:
    """The plan of B query rows over H heads and n_keys live keys, on one
    shared batch-1 plane or a plane a row: as many chunks as the cluster
    takes (K9_MAX_CLUSTER, fewer where there are fewer 32-key blocks of
    keys), each a multiple of 32 keys; rows of a shared plane in as few
    groups of at most K9_MAX_ROWS as hold them, evenly."""
    if n_keys < 1:
        raise ValueError(f"cross_attention_q8: {n_keys} live keys")
    chunks = min(K9_MAX_CLUSTER, -(-n_keys // 32))
    chunk = -(-n_keys // (32 * chunks)) * 32   # ceil(n_keys / chunks), up to 32 keys
    if chunk > K9_MAX_CHUNK:
        raise ValueError(f"cross_attention_q8: {n_keys} live keys; the kernel takes at most "
                         f"{K9_MAX_CLUSTER * K9_MAX_CHUNK}")
    rows = 1
    if shared and B > 1:
        rows = -(-B // -(-B // K9_MAX_ROWS))
    return CrossQ8Plan(B=B, H=H, n_keys=n_keys, shared=shared and B > 1,
                       chunks=-(-n_keys // chunk), chunk=chunk, rows=rows)


def _launch(name: str, q: torch.Tensor, kq, ks, vq, vs, n_head: int, scale: float,
            n_keys: int, key_strides: tuple[int, int, int],
            scale_strides: tuple[int, int]) -> torch.Tensor:
    """Check the operands and launch csrc/cross_q8.cu: planes read at
    element strides (batch, head, row) and scales at (batch, head); a batch
    stride of 0 shares batch-1 planes."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 3 or q.shape[1] != 1 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: q must be (B, 1, S) bf16 or f32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, _, S = q.shape
    if S != n_head * HEAD_DIM:
        raise NotImplementedError(f"{name}: head dim {S // n_head}; the kernel takes "
                                  f"{HEAD_DIM}-wide heads only (every whisper preset)")
    if kq.shape != vq.shape or ks.shape != vs.shape or kq.shape[0] not in (1, B):
        raise ValueError(f"{name}: planes {tuple(kq.shape)} / {tuple(vq.shape)}, scales "
                         f"{tuple(ks.shape)} / {tuple(vs.shape)} do not fit q {tuple(q.shape)}")
    if not (kq.dtype == vq.dtype == torch.int8 and ks.dtype == vs.dtype == torch.float32):
        raise ValueError(f"{name}: planes must be int8 and scales f32")
    if any(t.device != q.device for t in (kq, ks, vq, vs)):
        raise ValueError(f"{name}: operands on different devices")
    if not all(t.is_contiguous() for t in (kq, ks, vq, vs)):
        raise ValueError(f"{name}: planes and scales must be contiguous")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError(f"{name}: planes must start on a 16-byte boundary")
    q = q.contiguous()
    shared = kq.shape[0] == 1 and B > 1
    kb, kh, kr = key_strides
    sb, sh = scale_strides
    if shared:
        kb = sb = 0
    plan = cross_q8_plan(B, n_head, n_keys, shared)
    out = torch.empty_like(q)
    lib = _kernel_lib()
    fn = lib.owk_cross_q8_bf16 if q.dtype == torch.bfloat16 else lib.owk_cross_q8_f32
    rc = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
            out.data_ptr(), B, n_head, n_keys, plan.chunk, plan.rows, kb, kh, kr, sb, sh,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    return out


def cross_attention_q8(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor, n_head: int,
                       scale: float) -> torch.Tensor:
    """Kernel K9b: q (B, 1, S) over head-major int8 planes kq/vq
    (Bk, H, Ta, dh) with scales ks/vs (Bk, H, Ta) -> (B, 1, S) in q's
    dtype. CPU tensors take `cross_attention_q8_plain`."""
    if q.device.type == "cpu":
        return cross_attention_q8_plain(q, kq, ks, vq, vs, n_head, scale)
    if (kq.dim() != 4 or kq.shape[1] != n_head or kq.shape[3] != HEAD_DIM
            or tuple(ks.shape) != tuple(kq.shape[:3])):
        raise ValueError(f"cross_attention_q8: planes {tuple(kq.shape)} and scales "
                         f"{tuple(ks.shape)} are not (Bk, {n_head}, Ta, {HEAD_DIM}) "
                         "and (Bk, H, Ta)")
    Ta = kq.shape[2]
    out = _launch("cross_attention_q8", q, kq, ks, vq, vs, n_head, scale, Ta,
                  (n_head * Ta * HEAD_DIM, Ta * HEAD_DIM, HEAD_DIM), (n_head * Ta, Ta))
    cross_attention_q8.launches += 1
    return out


cross_attention_q8.launches = 0


def cross_attention_q8_nat(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                           vq: torch.Tensor, vs: torch.Tensor, n_head: int,
                           scale: float, ta_valid: int | None = None) -> torch.Tensor:
    """Kernel K9a: q (B, 1, S) over natural int8 planes kq/vq (Bk, Tap, S)
    with scales ks/vs (Bk, Hs, Tap), keys at or past `ta_valid` (default
    Tap) masked -> (B, 1, S) in q's dtype. CPU tensors take
    `cross_attention_q8_nat_plain`."""
    if q.device.type == "cpu":
        return cross_attention_q8_nat_plain(q, kq, ks, vq, vs, n_head, scale, ta_valid)
    if kq.dim() != 3 or ks.dim() != 3 or ks.shape[1] < n_head or ks.shape[2] != kq.shape[1]:
        raise ValueError(f"cross_attention_q8_nat: planes {tuple(kq.shape)} and scales "
                         f"{tuple(ks.shape)} are not (Bk, Tap, S) and (Bk, Hs >= H, Tap)")
    Tap, S = kq.shape[1], kq.shape[2]
    n = Tap if ta_valid is None else int(ta_valid)
    if not 1 <= n <= Tap:
        raise ValueError(f"cross_attention_q8_nat: ta_valid={n} outside [1, {Tap}]")
    Hs = ks.shape[1]
    out = _launch("cross_attention_q8_nat", q, kq, ks, vq, vs, n_head, scale, n,
                  (Tap * S, HEAD_DIM, S), (Hs * Tap, Tap))
    cross_attention_q8_nat.launches += 1
    return out


cross_attention_q8_nat.launches = 0
