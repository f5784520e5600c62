"""Shared set-up of the examples' parity tests (test_torch_examples*.py):
the port's examples (open_whisper_kit_tpu_torch/examples/) against the
repo's example scripts (examples/*.py, on the JAX package) on the CPU,
where each `main -ng` prints what the script prints on the same inputs.

Whisper is the narrow checkpoint of `_torch_parity.write_checkpoint`
(three decoder layers), whose token strings from id 1000 on are the words
the examples' grammars and prompts use; both packages load it in bf16, as
the examples do. The LLM is tests/test_torch_llama.py's TINY GGUF. Every
whisper_full runs with temperature_inc 0 in both packages (the sampled
fallback draws from torch's generator in the port and jax.random in JAX).
The grammar requests (wchess, voice_command's command list) read a copy
whose other token strings are empty and never picked (`write_checkpoint`'s
`named`): over tiny.en's 50256 "<id>" strings one build of the chess
grammar's token automaton takes ~20 s in each package. The audio seeds
used keep their JAX transcripts when the input is scaled by 1 + 2^-20.
"""

import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import write_checkpoint
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu_torch.decode import full as TF
from test_torch_llama import write_gguf

# the example scripts import as `examples.<name>` from the repo's root
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

torch.set_num_threads(2)

WORDS = ([b" up", b" down", b" left", b" right", b" stop", b" to", b"to", b" ",
          b" pawn", b" knight", b" bishop", b" rook", b" queen", b" king"]
         + [c.encode() for c in "abcdefgh12345678"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from test_torch_diarize import TINY as SF_TINY
    from open_whisper_kit_tpu_torch.models.sortformer import export as SE
    from open_whisper_kit_tpu_torch.models.sortformer import model as SM
    d = tmp_path_factory.mktemp("examples")
    return {"whisper": write_checkpoint(d / "narrow.bin", words=WORDS),
            "grammar": write_checkpoint(d / "narrow-words.bin", words=WORDS,
                                        named=1000 + len(WORDS)),
            "llama": write_gguf(d / "tiny-llama.gguf"),
            "sortformer": SE.write_sortformer_gguf(
                d / "sortformer.gguf", SF_TINY,
                SM.init_params(SF_TINY, seed=0, device="cpu")),
            "dir": d}


@pytest.fixture(autouse=True)
def no_fallback(monkeypatch):
    for mod in (JF, TF):
        def run(ctx, p, *a, _f=mod.whisper_full, **kw):
            p.temperature_inc = 0.0
            return _f(ctx, p, *a, **kw)
        monkeypatch.setattr(mod, "whisper_full", run)



def write_wav(path, seconds: float, seed: int, spans=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(int(16000 * seconds)) * 0.1
    if spans is not None:        # speech-like noise over spans, silence elsewhere
        x = np.zeros_like(x)
        for a, b in spans:
            x[int(a * 16000):int(b * 16000)] = rng.standard_normal(
                int(b * 16000) - int(a * 16000)) * 0.3
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def outputs(capsys, jmain, tmain, args, targs=()):
    assert jmain(list(args)) == 0
    jout = capsys.readouterr()
    assert tmain(list(args) + ["-ng", *targs]) == 0
    tout = capsys.readouterr()
    return jout, tout
