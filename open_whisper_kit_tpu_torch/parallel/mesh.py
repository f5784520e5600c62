"""Device mesh, sharding specs and collectives for multi-GPU inference.

Port of open_whisper_kit_tpu/parallel/mesh.py over torch.distributed. The
JAX package builds one `jax.sharding.Mesh` over every device of one SPMD
program and lets GSPMD insert the collectives; here every device is one
process (torchrun, tools/launch_multihost.py, or a world of one made on
first use), the mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the ranks, and the model code (models/whisper/model.py, ops/attention.py,
ops/decode_tp.py) issues its collectives itself:

* `dp` splits work over 30 s windows / files (whisper_full_parallel
  semantics, src/whisper.cpp:7801-7929): each dp rank runs its own share
  of a lockstep batch and `fetch_np` assembles the results on every rank;
* `tp` splits attention heads and the MLP hidden axis: column-sharded
  projections (q/k/v, the fused qkv, cq/ck/cv, mlp0) give each rank its
  heads, row-sharded ones (o, co, mlp1) are followed by `all_reduce_sum`.

Specs are tuples in the shape of JAX's PartitionSpec (one entry a tensor
dim: None, a mesh dim name, or a tuple of names; `()` is replicated), the
same specs the JAX package returns; `placements` turns one into DTensor
placements. The port keeps its caches in the natural (L, B, T, S) layout,
so `kv_sharding` and `cross_kv_sharding` put the heads' S axis on `tp`
where JAX's head-major specs put the head axis.

Collectives run on the group's backend. NCCL takes CUDA tensors; Gloo
takes CPU tensors, and CUDA tensors only through the host, which
`all_gather_last` and `all_reduce_sum` then do and count in
`COLLECTIVES["staged"]` (several ranks on one card share no NCCL group).
A backend that cannot take a tensor's device raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.quant_matmul import QuantPlanes

if TYPE_CHECKING:
    from ..models.whisper.model import WhisperConfig

# collectives issued by this module's helpers, and how many of them went
# through the host because the group's backend takes no CUDA tensor
COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "staged": 0}


# -- the mesh ------------------------------------------------------------------

def _mesh_device_type(device: str | torch.device) -> str:
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"mesh device {device!r}: cuda or cpu")
    return kind


def _ensure_world(device_type: str) -> None:
    """A process group of one when the caller made none: NCCL for the card,
    Gloo for the CPU."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)


def _build(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def _world(n_devices: int | None) -> int:
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: a mesh spans every rank of the world "
                         f"({n}), one process per device")
    return n


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh over every rank of the default process group (made,
    a world of one, when there is none: NCCL for "cuda", Gloo for "cpu").
    tp defaults to 2 when the rank count is even and above one, else 1,
    as in the JAX package. On the card each rank takes the card of its
    LOCAL_RANK (or rank) modulo the cards it sees."""
    kind = _mesh_device_type(device)
    _ensure_world(kind)
    n = _world(n_devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // tp
    assert dp * tp == n, (n, dp, tp)
    return _build(kind, (dp, tp), ("dp", "tp"))


def make_mesh3(n_devices: int | None = None,
               device: str | torch.device = "cuda") -> DeviceMesh:
    """A (dp, sp, tp) mesh: data over windows, sequence-parallel over the
    encoder's frames, tensor-parallel over heads / MLP; needs a rank count
    divisible by 4 (sp = tp = 2)."""
    kind = _mesh_device_type(device)
    _ensure_world(kind)
    n = _world(n_devices)
    assert n % 4 == 0, f"need a multiple of 4 devices for (dp,sp,tp), got {n}"
    return _build(kind, (n // 4, 2, 2), ("dp", "sp", "tp"))


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """The size of mesh dim `name` (1 without a mesh or without the dim)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh: DeviceMesh | None, name: str) -> int:
    """This rank's coordinate on mesh dim `name` (0 without it)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# -- specs (JAX's PartitionSpecs as tuples) ---------------------------------------

def seq_sharding(mesh: DeviceMesh) -> tuple:
    """Encoder activations (B, T, S): batch on dp, frames on sp (when the
    mesh has it), state on tp."""
    if "sp" in mesh.mesh_dim_names:
        return ("dp", "sp", "tp")
    return ("dp", None, "tp")


def _block_specs(cross: bool) -> dict[str, tuple]:
    s = {
        "attn_ln_w": (), "attn_ln_b": (),
        "q_w": (None, None, "tp"), "q_b": (None, "tp"),
        "k_w": (None, None, "tp"),
        "v_w": (None, None, "tp"), "v_b": (None, "tp"),
        "o_w": (None, "tp", None), "o_b": (),
        "mlp_ln_w": (), "mlp_ln_b": (),
        "mlp0_w": (None, None, "tp"), "mlp0_b": (None, "tp"),
        "mlp1_w": (None, "tp", None), "mlp1_b": (),
    }
    if cross:
        s.update({
            "cross_ln_w": (), "cross_ln_b": (),
            "cq_w": (None, None, "tp"), "cq_b": (None, "tp"),
            "ck_w": (None, None, "tp"),
            "cv_w": (None, None, "tp"), "cv_b": (None, "tp"),
            "co_w": (None, "tp", None), "co_b": (),
        })
    return s


def whisper_param_specs(cfg: WhisperConfig, fsdp_axis: str | None = None) -> dict[str, Any]:
    """Specs matching models/whisper/model.py params. `fsdp_axis` also
    shards each block's stacked layer axis over that mesh dim."""
    enc_blocks = _block_specs(cross=False)
    dec_blocks = _block_specs(cross=True)
    if fsdp_axis is not None:
        def layer_sharded(spec: tuple) -> tuple:
            return (fsdp_axis, *spec[1:])
        enc_blocks = {k: layer_sharded(v) for k, v in enc_blocks.items()}
        dec_blocks = {k: layer_sharded(v) for k, v in dec_blocks.items()}
    return {
        "encoder": {
            "conv1_w": (), "conv1_b": (), "conv2_w": (), "conv2_b": (),
            "pos": (),
            "blocks": enc_blocks,
            "ln_post_w": (), "ln_post_b": (),
        },
        "decoder": {
            "te": (), "pe": (),
            "blocks": dec_blocks,
            "ln_w": (), "ln_b": (),
        },
    }


def prepared_param_specs(cfg: WhisperConfig, fsdp_axis: str | None = None) -> dict[str, Any]:
    """Specs matching a live WhisperContext's params: after
    model.prepare_decoder fused the decoder's q/k/v into qkv_w / qkv_b."""
    specs = whisper_param_specs(cfg, fsdp_axis)
    blocks = dict(specs["decoder"]["blocks"])
    lead = (fsdp_axis,) if fsdp_axis else (None,)
    for k in ("q_w", "k_w", "v_w", "q_b", "v_b"):
        blocks.pop(k)
    blocks["qkv_w"] = (*lead, None, "tp")
    blocks["qkv_b"] = (*lead, "tp")
    dec = dict(specs["decoder"])
    dec["blocks"] = blocks
    out = dict(specs)
    out["decoder"] = dec
    return out


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Activations / mel windows: the leading batch axis on dp."""
    return ("dp",)


def kv_sharding(mesh: DeviceMesh) -> tuple:
    """Self-KV cache (L, B, C, S), natural layout: batch on dp, the heads'
    S axis on tp (JAX's (L, B, H, C, dh) spec with H on tp)."""
    return (None, "dp", None, "tp")


def cross_kv_sharding(mesh: DeviceMesh) -> tuple:
    """Cross-KV (L, B, Ta, S), natural layout: as kv_sharding."""
    return (None, "dp", None, "tp")


def placements(spec: tuple, mesh: DeviceMesh) -> list:
    """A spec as DTensor placements, one per mesh dim: Shard(tensor dim)
    where the spec names the mesh dim, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


# -- placing tensors --------------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_tensor(x: torch.Tensor, spec: tuple, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of `x` under `spec` (a copy, so the whole tensor
    can go). A spec longer than the tensor's rank replicates it, as the
    JAX package's shard_context_params does; a dim its mesh dims do not
    divide raises."""
    if len(spec) > x.dim():
        return x
    out = x
    for d, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        n, idx = 1, 0
        for name in names:       # row-major over the named mesh dims
            idx = idx * axis_size(mesh, name) + axis_rank(mesh, name)
            n *= axis_size(mesh, name)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split {n} ways")
        w = x.shape[d] // n
        out = out.narrow(d, idx * w, w)
    return out if out is x else out.clone()


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in s)


def _leaf_spec(p: dict, k: str, s):
    """The spec entry `k` of dict `p` is placed by: its entry in `s`, but
    () for the bias of a layer whose weight is a quantized plane (the
    layer stays whole on every rank)."""
    spec = s.get(k) if isinstance(s, dict) else None
    if k.endswith("_b") and isinstance(p.get(k[:-2] + "_w"), QuantPlanes):
        return ()
    return spec


def shard_context_params(params, cfg: WhisperConfig, mesh: DeviceMesh,
                         fsdp_axis: str | None = None):
    """A live WhisperContext's params (after prepare_decoder) -> this rank's
    shards per `prepared_param_specs`; every leaf the specs do not name
    (te_logits, quantized planes' extra tables) is replicated, as in the
    JAX package. One departure: a QuantLinear / QuantLinear4 plane stays
    whole on every rank (as in JAX), and so does the bias of its layer
    (JAX shards it), so a quantized layer runs whole on every rank.

    The encoder and decoder dicts gain a "mesh" entry, which the model's
    encode / decode_impl read to issue their collectives."""
    specs = prepared_param_specs(cfg, fsdp_axis)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, _leaf_spec(p, k, s)) for k, v in p.items()}
        if _is_spec(s) and isinstance(p, torch.Tensor):
            return shard_tensor(p, s, mesh)
        return p

    out = walk(params, specs)
    for part in ("encoder", "decoder"):
        out[part]["mesh"] = mesh
    return out


def shard_params(params, mesh: DeviceMesh, specs=None):
    """Every tensor of `params` cut to this rank's block of its spec in
    `specs` (a tree of the same keys)."""
    if specs is None:
        raise ValueError("specs required")
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, specs[k]) for k, v in params.items()}
    return shard_tensor(params, specs, mesh)


def gather_tensor(x: torch.Tensor, spec: tuple, mesh: DeviceMesh) -> torch.Tensor:
    """The inverse of shard_tensor: the whole tensor on every rank, its tp
    (or other single-name) sharded dims all-gathered."""
    if len(spec) > x.dim():
        return x
    for d, entry in reversed(list(enumerate(spec))):
        names = _names(entry)
        if not names or all(axis_size(mesh, n) == 1 for n in names):
            continue
        if len(names) != 1:
            raise NotImplementedError(f"gathering a dim sharded over {names}")
        x = all_gather_last(x.movedim(d, -1), mesh.get_group(names[0])).movedim(-1, d)
    return x.contiguous()


def gather_context_params(params, cfg: WhisperConfig):
    """A sharded context's params (shard_context_params) -> the whole params
    on every rank, without the "mesh" entries: what the decode-step
    kernels' planes are built from (they run whole on every rank)."""
    mesh = next((part["mesh"] for part in params.values() if "mesh" in part), None)
    if mesh is None:
        return params
    specs = prepared_param_specs(cfg)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, _leaf_spec(p, k, s)) for k, v in p.items() if k != "mesh"}
        if _is_spec(s) and isinstance(p, torch.Tensor):
            return gather_tensor(p, s, mesh)
        return p
    return walk(params, specs)


# -- collectives -------------------------------------------------------------------

def _through_host(x: torch.Tensor, group) -> bool:
    """Whether a collective of `x` on `group` must copy it through the
    host; raises where the group's backend cannot take its device."""
    backend = str(dist.get_backend(group))
    if x.device.type == "cuda":
        if "nccl" in backend:
            return False
        if "gloo" in backend:
            return True
    elif x.device.type == "cpu" and "gloo" in backend:
        return False
    raise ValueError(f"process group backend {backend!r} takes no {x.device.type} tensor")


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ranks' `x` concatenated on the last dim in rank order,
    on every rank (the JAX package's tiled all_gather). Exact: 16-bit
    floats travel as their bytes (Gloo takes no bf16)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    staged = _through_host(x, group)
    y = x.detach().contiguous()
    y = y.cpu() if staged else y
    bits = y.view(torch.uint8) if y.element_size() == 2 and y.is_floating_point() else y
    parts = [torch.empty_like(bits) for _ in range(n)]
    dist.all_gather(parts, bits, group=group)
    out = torch.cat(parts, dim=-1)
    if bits is not y:
        out = out.view(y.dtype)
    COLLECTIVES["all_gather"] += 1
    if staged:
        COLLECTIVES["staged"] += 1
        out = out.to(x.device)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ranks' `x` (a new tensor), the same bits on
    every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    staged = _through_host(x, group)
    y = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    if staged:
        COLLECTIVES["staged"] += 1
        y = y.to(x.device)
    return y


def fetch_np(x, mesh: DeviceMesh | None = None, axis: str = "dp"):
    """Host copy of `x`. With a mesh whose `axis` has several ranks, `x` is
    this rank's share of a result split over that axis (a tensor, an array
    or a list): the shares are all-gathered and joined in rank order on
    their leading axis, so every rank holds the whole result."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if axis_size(mesh, axis) == 1:
        return np.asarray(x) if isinstance(x, np.ndarray) else x
    parts = [None] * axis_size(mesh, axis)
    dist.all_gather_object(parts, x, group=mesh.get_group(axis))
    if isinstance(x, np.ndarray):
        return np.concatenate(parts, axis=0)
    return [item for part in parts for item in part]


@dataclasses.dataclass(frozen=True)
class TP:
    """The tp side of a mesh as the model code uses it: `size` ranks,
    this rank's `rank`, their process `group`."""
    size: int
    rank: int
    group: Any

    def cols(self, n: int) -> slice:
        """This rank's block of an axis of `n` split tp ways."""
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)


def tp_of(mesh: DeviceMesh | None) -> TP | None:
    """The mesh's tp side, or None without a mesh or with tp = 1 (the
    model then runs exactly its one-device code)."""
    size = axis_size(mesh, "tp")
    if size == 1:
        return None
    return TP(size, axis_rank(mesh, "tp"), mesh.get_group("tp"))
