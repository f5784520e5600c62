"""Convert a HuggingFace Whisper model to ggml-bin (port of the JAX
package's tools/convert_hf_to_ggml.py, over the port's io/ writers).

The counterpart of whisper.cpp's models/convert-h5-to-ggml.py. The mel
filterbank is computed here (slaney, bit-identical to the OpenAI assets);
the vocabulary comes from the HF tokenizer. It needs `transformers` (imported
when `main` runs; without it the tool raises ImportError). The output is
the JAX tool's, byte for byte.

    python -m open_whisper_kit_tpu_torch.tools.convert_hf_to_ggml <model_dir_or_name> out.bin [--f32]
"""

from __future__ import annotations

import sys

import numpy as np

from ..io import quant
from ..io.ggml_whisper import WhisperHParams
from ..io.ggml_writer import write_checkpoint
from ..models.sortformer.mel_fb import mel_filterbank
from .convert_pt_to_ggml import _byte_decoder

# HF module path -> reference tensor name fragment
_LAYER_MAP = [
    ("self_attn_layer_norm", "attn_ln"),
    ("self_attn.q_proj", "attn.query"),
    ("self_attn.k_proj", "attn.key"),
    ("self_attn.v_proj", "attn.value"),
    ("self_attn.out_proj", "attn.out"),
    ("encoder_attn_layer_norm", "cross_attn_ln"),
    ("encoder_attn.q_proj", "cross_attn.query"),
    ("encoder_attn.k_proj", "cross_attn.key"),
    ("encoder_attn.v_proj", "cross_attn.value"),
    ("encoder_attn.out_proj", "cross_attn.out"),
    ("final_layer_norm", "mlp_ln"),
    ("fc1", "mlp.0"),
    ("fc2", "mlp.2"),
]

# HF names that map one to one (after the "model." prefix)
_DIRECT = {
    "encoder.conv1.weight": "encoder.conv1.weight",
    "encoder.conv1.bias": "encoder.conv1.bias",
    "encoder.conv2.weight": "encoder.conv2.weight",
    "encoder.conv2.bias": "encoder.conv2.bias",
    "encoder.embed_positions.weight": "encoder.positional_embedding",
    "decoder.embed_tokens.weight": "decoder.token_embedding.weight",
    "decoder.embed_positions.weight": "decoder.positional_embedding",
}


def map_hf_name(name: str) -> str | None:
    """HF state-dict key -> reference ggml tensor name (None: skipped; the
    output projection is tied to the token embedding)."""
    if name.startswith("model."):
        name = name[len("model."):]
    if name in _DIRECT:
        return _DIRECT[name]
    if name.startswith("encoder.layer_norm."):
        return "encoder.ln_post." + name.rsplit(".", 1)[1]
    if name.startswith("decoder.layer_norm."):
        return "decoder.ln." + name.rsplit(".", 1)[1]
    for side in ("encoder", "decoder"):
        prefix = f"{side}.layers."
        if name.startswith(prefix):
            idx, _, tail = name[len(prefix):].partition(".")
            for hf, ref in _LAYER_MAP:
                if tail.startswith(hf + "."):
                    return f"{side}.blocks.{idx}.{ref}.{tail[len(hf) + 1:]}"
            return None
    return None


def hf_vocab_bytes(tokenizer, n_vocab: int) -> list[bytes]:
    """HF byte-level BPE vocabulary -> raw byte token list (GPT-2 byte
    decoder), as whisper.cpp's converter writes it
    (models/convert-pt-to-ggml.py:171-255)."""
    byte_decoder = _byte_decoder()
    # <|endoftext|> is dropped (whisper.cpp PR 725)
    id_to_tok: dict[int, bytes] = {}
    for tok, idx in tokenizer.get_vocab().items():
        if tok == "<|endoftext|>":
            continue
        try:
            raw = bytes(byte_decoder[c] for c in tok)
        except KeyError:
            raw = tok.encode("utf-8")
        id_to_tok[idx] = raw
    n_base = max(id_to_tok.keys()) + 1 if id_to_tok else 0
    return [id_to_tok.get(i, b"") for i in range(min(n_base, n_vocab))]


def convert(model, tokenizer, out_path: str, use_f16: bool = True):
    """model: transformers.WhisperForConditionalGeneration (or the base model)."""
    cfg = model.config
    hp = WhisperHParams(
        n_vocab=cfg.vocab_size,
        n_audio_ctx=cfg.max_source_positions,
        n_audio_state=cfg.d_model,
        n_audio_head=cfg.encoder_attention_heads,
        n_audio_layer=cfg.encoder_layers,
        n_text_ctx=cfg.max_target_positions,
        n_text_state=cfg.d_model,
        n_text_head=cfg.decoder_attention_heads,
        n_text_layer=cfg.decoder_layers,
        n_mels=cfg.num_mel_bins,
        ftype=1 if use_f16 else 0, qntvr=0)

    filters = mel_filterbank(cfg.num_mel_bins, 400, 16000)

    tensors: dict[str, np.ndarray] = {}
    for name, t in model.state_dict().items():
        ref = map_hf_name(name)
        if ref is None:
            continue
        data = t.detach().cpu().float().numpy()
        if ref in ("encoder.conv1.bias", "encoder.conv2.bias"):
            data = data.reshape(-1, 1)
        tensors[ref] = data

    tokens = (hf_vocab_bytes(tokenizer, cfg.vocab_size)
              if tokenizer is not None else
              [b"<%d>" % i for i in range(50257)])

    write_checkpoint(out_path, hp, filters, tokens, tensors,
                     wtype=quant.GGML_TYPE_F16 if use_f16 else quant.GGML_TYPE_F32)
    print(f"wrote {out_path}: {len(tensors)} tensors, "
          f"{'f16' if use_f16 else 'f32'}")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    model_name, out_path = argv[0], argv[1]
    use_f16 = "--f32" not in argv

    from transformers import WhisperForConditionalGeneration, WhisperTokenizer
    model = WhisperForConditionalGeneration.from_pretrained(model_name)
    try:
        tokenizer = WhisperTokenizer.from_pretrained(model_name)
    except Exception:  # noqa: BLE001
        tokenizer = None
    convert(model, tokenizer, out_path, use_f16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
