"""Convert a NeMo streaming-SortFormer .nemo checkpoint to GGUF (port of the
JAX package's tools/convert_nemo_to_gguf.py, over the port's io/gguf.py).

The counterpart of streaming-sortformer/scripts/convert_to_gguf.py: read
the state dict and the config from the .nemo tar, fuse each depthwise
conv's BatchNorm into the conv's weight and bias, and write the GGUF that
the port's SortFormer (api.Diarizer) loads. It needs `pyyaml` for the
config (imported when a file is read). The output is the JAX tool's, byte
for byte.

    python -m open_whisper_kit_tpu_torch.tools.convert_nemo_to_gguf model.nemo out.gguf
"""

from __future__ import annotations

import io
import sys
import tarfile

import numpy as np

from ..io import quant
from ..io.gguf import GGUFWriter

SKIP_PREFIXES = (
    "preprocessor.featurizer.filter_banks",
    "encoder.pre_encode.out_proj",
)


def load_nemo(path: str):
    import torch
    import yaml
    with tarfile.open(path) as tar:
        cfg = {}
        state = None
        for m in tar.getmembers():
            if m.name.endswith("model_config.yaml"):
                cfg = yaml.safe_load(tar.extractfile(m).read())
            elif m.name.endswith(".ckpt"):
                state = torch.load(io.BytesIO(tar.extractfile(m).read()),
                                   map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state, cfg


def fuse_batchnorm(state, layer: int):
    """Fuse conv.batch_norm into conv.depthwise_conv's weight and bias."""
    p = f"encoder.layers.{layer}.conv"
    w = state[f"{p}.depthwise_conv.weight"].float().numpy()   # (C, 1, K)
    bias_key = f"{p}.depthwise_conv.bias"
    b = (state[bias_key].float().numpy() if bias_key in state
         else np.zeros(w.shape[0], np.float32))
    gamma = state[f"{p}.batch_norm.weight"].float().numpy()
    beta = state[f"{p}.batch_norm.bias"].float().numpy()
    mean = state[f"{p}.batch_norm.running_mean"].float().numpy()
    var = state[f"{p}.batch_norm.running_var"].float().numpy()
    eps = 1e-5
    scale = gamma / np.sqrt(var + eps)
    fw = w * scale[:, None, None]
    fb = (b - mean) * scale + beta
    return fw.astype(np.float32), fb.astype(np.float32)


def convert(state, cfg: dict, out_path: str):
    w = GGUFWriter(out_path)
    w.add_string("general.architecture", "sortformer")
    w.add_uint32("sortformer.mel.n_mels", 128)
    w.add_uint32("sortformer.mel.n_fft", 512)
    w.add_uint32("sortformer.mel.hop_length", 160)
    w.add_uint32("sortformer.mel.win_length", 400)
    w.add_uint32("sortformer.mel.sample_rate", 16000)
    w.add_float32("sortformer.mel.dither", 1e-5)

    enc = cfg.get("encoder", {})
    w.add_uint32("sortformer.encoder.n_layers", enc.get("n_layers", 17))
    w.add_uint32("sortformer.encoder.d_model", enc.get("d_model", 512))
    w.add_uint32("sortformer.encoder.n_heads", enc.get("n_heads", 8))
    w.add_uint32("sortformer.encoder.conv_kernel_size",
                 enc.get("conv_kernel_size", 9))
    w.add_uint32("sortformer.encoder.ff_expansion",
                 enc.get("ff_expansion_factor", 4))
    w.add_uint32("sortformer.encoder.subsampling_factor",
                 enc.get("subsampling_factor", 8))
    w.add_uint32("sortformer.encoder.subsampling_conv_channels",
                 enc.get("subsampling_conv_channels", 256))
    tf = cfg.get("transformer_encoder", {})
    w.add_uint32("sortformer.transformer.n_layers", tf.get("num_layers", 18))
    w.add_uint32("sortformer.transformer.d_model", tf.get("hidden_size", 192))
    w.add_uint32("sortformer.transformer.n_heads",
                 tf.get("num_attention_heads", 8))
    w.add_uint32("sortformer.transformer.ff_inner", tf.get("inner_size", 768))
    w.add_uint32("sortformer.n_speakers", cfg.get("max_num_of_spks", 4))

    n_layers = enc.get("n_layers", 17)
    fused = {}
    for i in range(n_layers):
        fw, fb = fuse_batchnorm(state, i)
        fused[f"encoder.layers.{i}.conv.depthwise_conv.weight"] = fw
        fused[f"encoder.layers.{i}.conv.depthwise_conv.bias"] = fb

    n = 0
    for name in sorted(state.keys()):
        if any(name.startswith(p) for p in SKIP_PREFIXES):
            continue
        if ".batch_norm." in name:
            continue
        if name == "preprocessor.featurizer.fb":
            data = state[name].squeeze(0).float().numpy()
            w.add_tensor(name, data, quant.GGML_TYPE_F32)
            n += 1
            continue
        if name == "preprocessor.featurizer.window":
            w.add_tensor(name, state[name].float().numpy(), quant.GGML_TYPE_F32)
            n += 1
            continue
        data = fused.get(name)
        if data is None:
            if name.endswith(".bias") and ".depthwise_conv" in name:
                continue  # replaced by the fused bias
            data = state[name].float().numpy()
        is_small = data.ndim <= 1 or "bias" in name or "norm" in name
        w.add_tensor(name, data,
                     quant.GGML_TYPE_F32 if is_small else quant.GGML_TYPE_F16)
        n += 1
    # a fused bias where the conv had none
    for name, data in fused.items():
        if name.endswith(".bias") and name not in state:
            w.add_tensor(name, data, quant.GGML_TYPE_F32)
            n += 1
    w.write()
    print(f"wrote {out_path}: {n} tensors")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    state, cfg = load_nemo(argv[0])
    convert(state, cfg, argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
