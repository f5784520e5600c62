"""Sortformer params -> GGUF under the reference tensor names.

Port of open_whisper_kit_tpu/models/sortformer/export.py: the inverse of
`params_from_gguf` (model.py), writing a GGUF the reference C++ engine
(streaming-sortformer/src/sortformer.cpp:287-631) loads directly. The
tensors are read back to host f32 first, so the file is byte-identical to
the JAX package's from the same weights. Dtype policy mirrors the reference
converter (streaming-sortformer/scripts/convert_to_gguf.py:229-343):
everything F16 except `preprocessor.featurizer.{fb,window}`, which the C
engine reads as raw float* and therefore must stay F32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...io.gguf import GGUFWriter


def _host_f32(tree):
    if isinstance(tree, dict):
        return {k: _host_f32(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def write_sortformer_gguf(path: str | Path, cfg, params,
                          half: bool = True) -> Path:
    """Write `params` (the model.py dict of tensors, on any device) as a
    reference-layout GGUF."""
    params = _host_f32(params)
    w = GGUFWriter(Path(path))

    def A(x):
        a = np.asarray(x, np.float32)
        return a.astype(np.float16) if half else a

    def F32(x):
        return np.asarray(x, np.float32)

    w.add_string("general.architecture", "sortformer")
    w.add_uint32("sortformer.mel.n_mels", cfg.n_mels)
    w.add_uint32("sortformer.mel.n_fft", cfg.n_fft)
    w.add_uint32("sortformer.mel.hop_length", cfg.hop_length)
    w.add_uint32("sortformer.mel.win_length", cfg.win_length)
    w.add_uint32("sortformer.mel.sample_rate", cfg.sample_rate)
    w.add_uint32("sortformer.encoder.n_layers", cfg.n_layers)
    w.add_uint32("sortformer.encoder.d_model", cfg.d_model)
    w.add_uint32("sortformer.encoder.n_heads", cfg.n_heads)
    w.add_uint32("sortformer.encoder.conv_kernel_size", cfg.conv_kernel)
    w.add_uint32("sortformer.encoder.ff_expansion", cfg.ff_expansion)
    w.add_uint32("sortformer.encoder.subsampling_factor", cfg.subsampling)
    w.add_uint32("sortformer.encoder.subsampling_conv_channels",
                 cfg.subsampling_channels)
    w.add_uint32("sortformer.transformer.n_layers", cfg.tf_layers)
    w.add_uint32("sortformer.transformer.d_model", cfg.tf_d_model)
    w.add_uint32("sortformer.transformer.n_heads", cfg.tf_heads)
    w.add_uint32("sortformer.transformer.ff_inner", cfg.tf_ff)
    w.add_uint32("sortformer.n_speakers", cfg.n_spk)

    w.add_tensor("preprocessor.featurizer.fb", F32(params["mel_fb"]))
    w.add_tensor("preprocessor.featurizer.window", F32(params["mel_window"]))

    pe = params["preenc"]
    # jax HWIO -> torch OIHW
    for i, key in ((0, "conv0"), (2, "conv2"), (3, "conv3"), (5, "conv5"),
                   (6, "conv6")):
        w.add_tensor(f"encoder.pre_encode.conv.{i}.weight",
                     A(pe[f"{key}_w"]).transpose(3, 2, 0, 1))
        w.add_tensor(f"encoder.pre_encode.conv.{i}.bias", A(pe[f"{key}_b"]))
    w.add_tensor("encoder.pre_encode.out.weight", A(pe["out_w"]).T)
    w.add_tensor("encoder.pre_encode.out.bias", A(pe["out_b"]))

    cl = params["conformer"]
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}"

        def L(name):
            return A(cl[name][i])

        w.add_tensor(f"{p}.norm_feed_forward1.weight", L("norm_ff1_w"))
        w.add_tensor(f"{p}.norm_feed_forward1.bias", L("norm_ff1_b"))
        w.add_tensor(f"{p}.feed_forward1.linear1.weight", L("ff1_up_w").T)
        w.add_tensor(f"{p}.feed_forward1.linear1.bias", L("ff1_up_b"))
        w.add_tensor(f"{p}.feed_forward1.linear2.weight", L("ff1_down_w").T)
        w.add_tensor(f"{p}.feed_forward1.linear2.bias", L("ff1_down_b"))
        w.add_tensor(f"{p}.norm_self_att.weight", L("norm_sa_w"))
        w.add_tensor(f"{p}.norm_self_att.bias", L("norm_sa_b"))
        w.add_tensor(f"{p}.self_attn.linear_q.weight", L("q_w").T)
        w.add_tensor(f"{p}.self_attn.linear_q.bias", L("q_b"))
        w.add_tensor(f"{p}.self_attn.linear_k.weight", L("k_w").T)
        w.add_tensor(f"{p}.self_attn.linear_k.bias", L("k_b"))
        w.add_tensor(f"{p}.self_attn.linear_v.weight", L("v_w").T)
        w.add_tensor(f"{p}.self_attn.linear_v.bias", L("v_b"))
        w.add_tensor(f"{p}.self_attn.linear_out.weight", L("out_w").T)
        w.add_tensor(f"{p}.self_attn.linear_out.bias", L("out_b"))
        w.add_tensor(f"{p}.self_attn.linear_pos.weight", L("pos_w").T)
        w.add_tensor(f"{p}.self_attn.pos_bias_u", L("pos_bias_u"))
        w.add_tensor(f"{p}.self_attn.pos_bias_v", L("pos_bias_v"))
        w.add_tensor(f"{p}.norm_conv.weight", L("norm_conv_w"))
        w.add_tensor(f"{p}.norm_conv.bias", L("norm_conv_b"))
        w.add_tensor(f"{p}.conv.pointwise_conv1.weight",
                     L("pw1_w").T[:, :, None])
        w.add_tensor(f"{p}.conv.pointwise_conv1.bias", L("pw1_b"))
        w.add_tensor(f"{p}.conv.depthwise_conv.weight",
                     L("dw_w").T[:, None, :])
        w.add_tensor(f"{p}.conv.depthwise_conv.bias", L("dw_b"))
        w.add_tensor(f"{p}.conv.pointwise_conv2.weight",
                     L("pw2_w").T[:, :, None])
        w.add_tensor(f"{p}.conv.pointwise_conv2.bias", L("pw2_b"))
        w.add_tensor(f"{p}.norm_feed_forward2.weight", L("norm_ff2_w"))
        w.add_tensor(f"{p}.norm_feed_forward2.bias", L("norm_ff2_b"))
        w.add_tensor(f"{p}.feed_forward2.linear1.weight", L("ff2_up_w").T)
        w.add_tensor(f"{p}.feed_forward2.linear1.bias", L("ff2_up_b"))
        w.add_tensor(f"{p}.feed_forward2.linear2.weight", L("ff2_down_w").T)
        w.add_tensor(f"{p}.feed_forward2.linear2.bias", L("ff2_down_b"))
        w.add_tensor(f"{p}.norm_out.weight", L("norm_out_w"))
        w.add_tensor(f"{p}.norm_out.bias", L("norm_out_b"))

    tl = params["transformer"]
    for i in range(cfg.tf_layers):
        p = f"transformer_encoder.layers.{i}"

        def T(name):
            return A(tl[name][i])

        w.add_tensor(f"{p}.first_sub_layer.query_net.weight", T("q_w").T)
        w.add_tensor(f"{p}.first_sub_layer.query_net.bias", T("q_b"))
        w.add_tensor(f"{p}.first_sub_layer.key_net.weight", T("k_w").T)
        w.add_tensor(f"{p}.first_sub_layer.key_net.bias", T("k_b"))
        w.add_tensor(f"{p}.first_sub_layer.value_net.weight", T("v_w").T)
        w.add_tensor(f"{p}.first_sub_layer.value_net.bias", T("v_b"))
        w.add_tensor(f"{p}.first_sub_layer.out_projection.weight",
                     T("out_w").T)
        w.add_tensor(f"{p}.first_sub_layer.out_projection.bias", T("out_b"))
        w.add_tensor(f"{p}.layer_norm_1.weight", T("ln1_w"))
        w.add_tensor(f"{p}.layer_norm_1.bias", T("ln1_b"))
        w.add_tensor(f"{p}.second_sub_layer.dense_in.weight", T("ff_up_w").T)
        w.add_tensor(f"{p}.second_sub_layer.dense_in.bias", T("ff_up_b"))
        w.add_tensor(f"{p}.second_sub_layer.dense_out.weight",
                     T("ff_down_w").T)
        w.add_tensor(f"{p}.second_sub_layer.dense_out.bias", T("ff_down_b"))
        w.add_tensor(f"{p}.layer_norm_2.weight", T("ln2_w"))
        w.add_tensor(f"{p}.layer_norm_2.bias", T("ln2_b"))

    w.add_tensor("sortformer_modules.encoder_proj.weight",
                 A(params["proj_w"]).T)
    w.add_tensor("sortformer_modules.encoder_proj.bias", A(params["proj_b"]))
    w.add_tensor("sortformer_modules.first_hidden_to_hidden.weight",
                 A(params["pred_hidden_w"]).T)
    w.add_tensor("sortformer_modules.first_hidden_to_hidden.bias",
                 A(params["pred_hidden_b"]))
    w.add_tensor("sortformer_modules.single_hidden_to_spks.weight",
                 A(params["pred_spk_w"]).T)
    w.add_tensor("sortformer_modules.single_hidden_to_spks.bias",
                 A(params["pred_spk_b"]))
    w.write()
    return w.path
