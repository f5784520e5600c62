"""Convert an OpenAI Whisper .pt checkpoint to ggml-bin (port of the JAX
package's tools/convert_pt_to_ggml.py, over the port's io/ writers).

The counterpart of whisper.cpp's models/convert-pt-to-ggml.py. The mel
filterbank is computed here (the slaney filters, bit-identical to the
OpenAI assets), so the OpenAI repository is needed only for the tokenizer;
--vocab-from borrows the tokenizer of an existing ggml-bin instead. The
output is the JAX tool's, byte for byte.

    python -m open_whisper_kit_tpu_torch.tools.convert_pt_to_ggml medium.pt out-dir [--f32]
        [--whisper-repo ~/whisper] [--vocab-from ggml-base.bin]
"""

from __future__ import annotations

import base64
import json
import sys
from pathlib import Path

import numpy as np

from ..io import quant
from ..io.ggml_whisper import WhisperHParams, load_checkpoint
from ..io.ggml_writer import write_checkpoint
from ..models.sortformer.mel_fb import mel_filterbank


def load_tiktoken_vocab(path: Path) -> list[bytes]:
    tokens: dict[int, bytes] = {}
    for line in path.read_bytes().splitlines():
        if not line:
            continue
        tok_b64, rank = line.split()
        tokens[int(rank)] = base64.b64decode(tok_b64)
    return [tokens.get(i, b"") for i in range(max(tokens) + 1)]


def _byte_decoder() -> dict[str, int]:
    """The inverse of GPT-2's bytes_to_unicode."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def load_vocab_json(path: Path) -> list[bytes]:
    byte_decoder = _byte_decoder()
    raw = json.loads(path.read_text())
    raw.pop("<|endoftext|>", None)
    out: dict[int, bytes] = {}
    for tok, idx in raw.items():
        out[idx] = bytes(byte_decoder[c] for c in tok)
    return [out.get(i, b"") for i in range(max(out) + 1)]


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    import torch

    pt_path = Path(argv[0])
    out_dir = Path(argv[1])
    use_f16 = "--f32" not in argv
    whisper_repo = None
    vocab_from = None
    for i, a in enumerate(argv):
        if a == "--whisper-repo":
            whisper_repo = Path(argv[i + 1])
        if a == "--vocab-from":
            vocab_from = Path(argv[i + 1])

    checkpoint = torch.load(pt_path, map_location="cpu", weights_only=False)
    dims = checkpoint["dims"]
    hp = WhisperHParams(
        n_vocab=dims["n_vocab"], n_audio_ctx=dims["n_audio_ctx"],
        n_audio_state=dims["n_audio_state"], n_audio_head=dims["n_audio_head"],
        n_audio_layer=dims["n_audio_layer"], n_text_ctx=dims["n_text_ctx"],
        n_text_state=dims["n_text_state"], n_text_head=dims["n_text_head"],
        n_text_layer=dims["n_text_layer"], n_mels=dims["n_mels"],
        ftype=1 if use_f16 else 0, qntvr=0)

    filters = mel_filterbank(hp.n_mels, 400, 16000)

    multilingual = hp.n_vocab >= 51865
    if vocab_from is not None:
        tokens = load_checkpoint(vocab_from, load_tensors=False).tokens
    elif whisper_repo is not None:
        assets = whisper_repo / "whisper" / "assets"
        tik = assets / ("multilingual.tiktoken" if multilingual else "gpt2.tiktoken")
        if tik.is_file():
            tokens = load_tiktoken_vocab(tik)
        else:
            vj = assets / ("multilingual" if multilingual else "gpt2") / "vocab.json"
            tokens = load_vocab_json(vj)
    else:
        print("error: need --whisper-repo or --vocab-from for the tokenizer",
              file=sys.stderr)
        return 1

    tensors: dict[str, np.ndarray] = {}
    for name, t in checkpoint["model_state_dict"].items():
        data = t.squeeze().numpy().astype(np.float32)
        if name in ("encoder.conv1.bias", "encoder.conv2.bias"):
            data = data.reshape(-1, 1)
        tensors[name] = data

    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / ("ggml-model.bin" if use_f16 else "ggml-model-f32.bin")
    write_checkpoint(out_path, hp, filters, tokens, tensors,
                     wtype=quant.GGML_TYPE_F16 if use_f16 else quant.GGML_TYPE_F32)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
