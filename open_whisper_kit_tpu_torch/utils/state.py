"""Serializable run state: checkpoint/resume for the streaming subsystems
(port of open_whisper_kit_tpu/utils/state.py, the same .npz layout).

The reference keeps all resumable state in opaque device tensors (VAD LSTM
h/c, sortformer spkcache/FIFO/silence profile, prompt context -
SURVEY.md §5 checkpoint/resume). Here every piece is an explicit numpy
snapshot that round-trips through a single .npz file, so a streaming
session can be suspended, migrated across hosts, and resumed. A file saved
by the JAX package resumes here and the other way round: `snapshot` moves
device tensors (the Silero LSTM state) to the host, and `restore` puts them
back on the live object's own device.
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import torch


def save_state(path: str | Path, **components) -> None:
    """Save named state components. Supported values: numpy arrays, torch
    tensors (saved from the host), lists of ints/floats, scalars, dicts
    thereof, plus the framework state objects (SileroVAD, StreamState,
    StreamingTranscriber)."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {}

    def put(prefix: str, value):
        if value is None:
            meta[prefix] = {"_type": "none"}
        elif isinstance(value, (np.ndarray, torch.Tensor)):
            arrays[prefix] = _host(value)
            meta[prefix] = {"_type": "array"}
        elif isinstance(value, (int, float, str, bool)):
            meta[prefix] = {"_type": "scalar", "value": value}
        elif isinstance(value, (list, tuple)):
            meta[prefix] = {"_type": "list", "value": list(value)}
        elif isinstance(value, dict):
            meta[prefix] = {"_type": "dict", "keys": list(value.keys())}
            for k, v in value.items():
                put(f"{prefix}.{k}", v)
        else:
            snap = snapshot(value)
            meta[prefix] = {"_type": "object",
                            "class": type(value).__name__,
                            "keys": list(snap.keys())}
            for k, v in snap.items():
                put(f"{prefix}.{k}", v)

    for name, value in components.items():
        put(name, value)

    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    Path(path).write_bytes(buf.getvalue())


def load_state(path: str | Path) -> dict:
    """Load a saved state file -> nested dict of arrays/values."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    def get(prefix: str):
        m = meta[prefix]
        t = m["_type"]
        if t == "none":
            return None
        if t == "array":
            return arrays[prefix]
        if t in ("scalar", "list"):
            return m["value"]
        if t in ("dict", "object"):
            return {k: get(f"{prefix}.{k}") for k in m["keys"]}
        raise ValueError(t)

    roots = [k for k in meta if "." not in k]
    return {k: get(k) for k in roots}


def _host(x) -> np.ndarray:
    """A numpy array of `x`, read from the device when it is a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- framework object snapshots ---------------------------------------------

def snapshot(obj) -> dict:
    """Extract the resumable state of a framework object (host arrays)."""
    name = type(obj).__name__
    if name == "SileroVAD":
        return {"h": _host(obj.h), "c": _host(obj.c)}
    if name == "StreamState":  # sortformer AOSC
        return {
            "spkcache": _host(obj.spkcache),
            "spkcache_preds": _host(obj.spkcache_preds),
            "spkcache_preds_valid": bool(obj.spkcache_preds_valid),
            "fifo": _host(obj.fifo), "fifo_preds": _host(obj.fifo_preds),
            "mean_sil_emb": _host(obj.mean_sil_emb),
            "n_sil_frames": int(obj.n_sil_frames),
            "d_model": int(obj.d_model),
        }
    if name == "StreamingTranscriber":
        return {
            "buf": obj._buf, "old": obj._old,
            "prompt_tokens": list(obj._prompt_tokens),
            "n_iter": int(obj.n_iter),
        }
    raise TypeError(f"don't know how to snapshot {name}")


def restore(obj, snap: dict) -> None:
    """Restore a snapshot into a compatible live object; device state goes
    to the object's own device."""
    name = type(obj).__name__
    if name == "SileroVAD":
        obj.h = torch.as_tensor(np.asarray(snap["h"], np.float32), device=obj.device)
        obj.c = torch.as_tensor(np.asarray(snap["c"], np.float32), device=obj.device)
        return
    if name == "StreamState":
        obj.spkcache = np.asarray(snap["spkcache"], np.float32)
        obj.spkcache_preds = np.asarray(snap["spkcache_preds"], np.float32)
        obj.spkcache_preds_valid = bool(snap["spkcache_preds_valid"])
        obj.fifo = np.asarray(snap["fifo"], np.float32)
        obj.fifo_preds = np.asarray(snap["fifo_preds"], np.float32)
        obj.mean_sil_emb = np.asarray(snap["mean_sil_emb"], np.float32)
        obj.n_sil_frames = int(snap["n_sil_frames"])
        return
    if name == "StreamingTranscriber":
        obj._buf = np.asarray(snap["buf"], np.float32)
        obj._old = np.asarray(snap["old"], np.float32)
        obj._prompt_tokens = [int(t) for t in snap["prompt_tokens"]]
        obj.n_iter = int(snap["n_iter"])
        return
    raise TypeError(f"don't know how to restore {name}")
