"""Export a whisper params tree back to reference tensor names/shapes
(port of open_whisper_kit_tpu/models/whisper/export.py).

Inverse of model.params_from_checkpoint (before prepare_decoder fuses the
decoder's q/k/v) — used by the converter tools, the requantizer
round-trip tests, and checkpoint saving. Returns the JAX module's numpy
arrays: the same names, f32, the same layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import Params, WhisperConfig


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def tensors_from_params(cfg: WhisperConfig, params: Params) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}

    def put(name, x, transpose=False):
        a = _f32(x)
        out[name] = a.T if transpose else a

    enc = params["encoder"]
    put("encoder.conv1.weight", _f32(enc["conv1_w"]).transpose(2, 1, 0))
    put("encoder.conv1.bias", _f32(enc["conv1_b"]).reshape(-1, 1))
    put("encoder.conv2.weight", _f32(enc["conv2_w"]).transpose(2, 1, 0))
    put("encoder.conv2.bias", _f32(enc["conv2_b"]).reshape(-1, 1))
    put("encoder.positional_embedding", enc["pos"])
    put("encoder.ln_post.weight", enc["ln_post_w"])
    put("encoder.ln_post.bias", enc["ln_post_b"])

    eb = enc["blocks"]
    for i in range(cfg.n_audio_layer):
        p = f"encoder.blocks.{i}"
        put(f"{p}.attn_ln.weight", eb["attn_ln_w"][i])
        put(f"{p}.attn_ln.bias", eb["attn_ln_b"][i])
        put(f"{p}.attn.query.weight", eb["q_w"][i], True)
        put(f"{p}.attn.query.bias", eb["q_b"][i])
        put(f"{p}.attn.key.weight", eb["k_w"][i], True)
        put(f"{p}.attn.value.weight", eb["v_w"][i], True)
        put(f"{p}.attn.value.bias", eb["v_b"][i])
        put(f"{p}.attn.out.weight", eb["o_w"][i], True)
        put(f"{p}.attn.out.bias", eb["o_b"][i])
        put(f"{p}.mlp_ln.weight", eb["mlp_ln_w"][i])
        put(f"{p}.mlp_ln.bias", eb["mlp_ln_b"][i])
        put(f"{p}.mlp.0.weight", eb["mlp0_w"][i], True)
        put(f"{p}.mlp.0.bias", eb["mlp0_b"][i])
        put(f"{p}.mlp.2.weight", eb["mlp1_w"][i], True)
        put(f"{p}.mlp.2.bias", eb["mlp1_b"][i])

    dec = params["decoder"]
    put("decoder.token_embedding.weight", dec["te"])
    put("decoder.positional_embedding", dec["pe"])
    put("decoder.ln.weight", dec["ln_w"])
    put("decoder.ln.bias", dec["ln_b"])

    db = dec["blocks"]
    for i in range(cfg.n_text_layer):
        p = f"decoder.blocks.{i}"
        put(f"{p}.attn_ln.weight", db["attn_ln_w"][i])
        put(f"{p}.attn_ln.bias", db["attn_ln_b"][i])
        put(f"{p}.attn.query.weight", db["q_w"][i], True)
        put(f"{p}.attn.query.bias", db["q_b"][i])
        put(f"{p}.attn.key.weight", db["k_w"][i], True)
        put(f"{p}.attn.value.weight", db["v_w"][i], True)
        put(f"{p}.attn.value.bias", db["v_b"][i])
        put(f"{p}.attn.out.weight", db["o_w"][i], True)
        put(f"{p}.attn.out.bias", db["o_b"][i])
        put(f"{p}.cross_attn_ln.weight", db["cross_ln_w"][i])
        put(f"{p}.cross_attn_ln.bias", db["cross_ln_b"][i])
        put(f"{p}.cross_attn.query.weight", db["cq_w"][i], True)
        put(f"{p}.cross_attn.query.bias", db["cq_b"][i])
        put(f"{p}.cross_attn.key.weight", db["ck_w"][i], True)
        put(f"{p}.cross_attn.value.weight", db["cv_w"][i], True)
        put(f"{p}.cross_attn.value.bias", db["cv_b"][i])
        put(f"{p}.cross_attn.out.weight", db["co_w"][i], True)
        put(f"{p}.cross_attn.out.bias", db["co_b"][i])
        put(f"{p}.mlp_ln.weight", db["mlp_ln_w"][i])
        put(f"{p}.mlp_ln.bias", db["mlp_ln_b"][i])
        put(f"{p}.mlp.0.weight", db["mlp0_w"][i], True)
        put(f"{p}.mlp.0.bias", db["mlp0_b"][i])
        put(f"{p}.mlp.2.weight", db["mlp1_w"][i], True)
        put(f"{p}.mlp.2.bias", db["mlp1_b"][i])

    return out
