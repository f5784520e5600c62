"""ggml-bin checkpoints in the port against the JAX package (CPU): the
writer's bytes, the loader, the params built from quantized checkpoints,
and whisper_full on narrow q8_0 / q5_0 checkpoints."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import audio, segments
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu.io import ggml_whisper as JG
from open_whisper_kit_tpu.io import ggml_writer as JW
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.ops import quant_matmul as JQ
from open_whisper_kit_tpu_torch import Transcriber
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.io import ggml_whisper as TG
from open_whisper_kit_tpu_torch.io import ggml_writer as TW
from open_whisper_kit_tpu_torch.io import quant as TQF
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import quant_matmul as TQ

torch.set_num_threads(2)

# narrow widths (S=128, 4S=512: the decoder MLP planes are unpadded, so
# K5 runs), tiny.en's vocabulary and context lengths, three decoder layers
# (two would force no_timestamps)
HP = JG.WhisperHParams(n_vocab=51864, n_audio_ctx=1500, n_audio_state=128,
                       n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                       n_text_state=128, n_text_head=2, n_text_layer=3,
                       n_mels=80, ftype=1, qntvr=0)
TOKENS = [b"<%d>" % i for i in range(50257)]
FILTERS = JF._synthetic_mel_filters(80)


def _write(path, qtype: str, writer=JW, tensors=None):
    if tensors is None:
        tensors = writer.random_reference_tensors(HP, seed=0)
    writer.write_checkpoint(path, HP, FILTERS, TOKENS, tensors,
                            wtype=writer.TYPE_FOR_NAME[qtype])
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    return {q: _write(d / f"narrow-{q}.bin", q) for q in ("q8_0", "q5_0")}


@pytest.mark.parametrize("qtype", ["q8_0", "q5_0", "q4_0"])
def test_writer_bytes_equal_jax(tmp_path, qtype):
    """The port's writer (block encoders as array ops) writes the JAX
    writer's bytes, whole files (a small vocabulary keeps the JAX writer's
    per-block loop short) and odd blocks (zeros, a lone spike)."""
    hp = dataclasses.replace(HP, n_vocab=1000)
    tensors = JW.random_reference_tensors(hp, seed=1)
    files = []
    for name, writer in (("jax", JW), ("port", TW)):
        writer.write_checkpoint(tmp_path / name, hp, FILTERS, TOKENS[:1000], tensors,
                                wtype=writer.TYPE_FOR_NAME[qtype])
        files.append((tmp_path / name).read_bytes())
    assert files[0] == files[1]
    x = np.random.default_rng(2).standard_normal(32 * 40).astype(np.float32)
    x[:32], x[32:64], x[64] = 0.0, 1e-30, 7.0
    t = TW.TYPE_FOR_NAME[qtype]
    assert TW._encode_tensor(x, t) == JW._encode_tensor(x, t)


def test_load_checkpoint_matches_jax(ckpts):
    a, b = JG.load_checkpoint(ckpts["q8_0"]), TG.load_checkpoint(ckpts["q8_0"])
    assert dataclasses.astuple(a.hparams) == dataclasses.astuple(b.hparams)
    assert b.hparams.model_type == "custom2" and b.hparams.ftype == 7
    assert a.tokens == b.tokens and np.array_equal(a.mel_filters, b.mel_filters)
    assert list(a.tensors) == list(b.tensors)
    for name, t in a.tensors.items():
        u = b.tensors[name]
        assert (t.shape, t.ggml_type, t.data) == (u.shape, u.ggml_type, u.data), name
    buf = TG.load_checkpoint(ckpts["q8_0"].read_bytes())
    assert buf.n_loaded == b.n_loaded and buf.path == "<buffer>"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("qtype,dtype", [("q5_0", "float32"), ("q8_0", "bfloat16")])
def test_params_from_checkpoint_equal_jax(ckpts, qtype, dtype):
    """Quantized linears become planes equal to JAX's; everything else
    dequantizes to the same floats (cross-K/V and the encoder included)."""
    ck = JG.load_checkpoint(ckpts[qtype])
    j = dict(_leaves(M.params_from_checkpoint(ck, dtype=getattr(jnp, dtype))))
    t = dict(_leaves(TM.params_from_checkpoint(TG.load_checkpoint(ckpts[qtype]),
                                               dtype=getattr(torch, dtype))))
    assert sorted(j) == sorted(t)
    n_planes = 0
    for name, a in j.items():
        b = t[name]
        if isinstance(a, JQ.QuantLinear):
            # equal on the logical columns (the port pads to 128, JAX to 512)
            assert isinstance(b, TQ.QuantLinear) and a.n == b.n, name
            n = b.n_out
            np.testing.assert_array_equal(np.asarray(a.qs)[..., :n], b.qs[..., :n].numpy(),
                                          err_msg=name)
            np.testing.assert_array_equal(np.asarray(a.scales)[..., :n],
                                          b.scales[..., :n].numpy(), err_msg=name)
            n_planes += 1
        else:
            assert tuple(a.shape) == tuple(b.shape) and b.dtype == getattr(torch, dtype), name
            np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy(),
                                          err_msg=name)
    assert n_planes == 6 + 10      # encoder q/k/v/o/mlp0/mlp1, decoder 10 linears


def _full_both(path, seconds, seed):
    jctx = JF.WhisperContext.from_file(str(path), dtype=jnp.float32)
    tctx = TF.WhisperContext.from_file(path, dtype=torch.float32, device="cpu")
    assert isinstance(tctx.params["decoder"]["blocks"]["qkv_w"], TQ.QuantLinear)
    jp, tp = JFullParams(print_progress=False), FullParams(print_progress=False)
    jp.temperature_inc = tp.temperature_inc = 0
    samples = audio(seconds, seed)
    return JF.whisper_full(jctx, jp, samples), TF.whisper_full(tctx, tp, samples)


@pytest.mark.parametrize("qtype,seed", [("q8_0", 4), ("q5_0", 3)])
def test_whisper_full_on_quantized_checkpoint_matches_jax(ckpts, qtype, seed):
    """Greedy, temperature_inc = 0, 35 s (two windows): token ids,
    timestamps and text of every segment equal (the JAX kernels in
    interpret mode, the port's plain versions).

    Every linear of a quantized model rounds its input to bf16, so a
    last-place f32 difference upstream (XLA's and torch's sums, tanh)
    flips an occasional rounding; with random weights' near-tied logits
    some requests then decode differently. Such a request changes in the
    JAX package itself when its input is scaled by 1 + 2^-20 (q8_0 with
    audio seed 3 does); the two requests here do not."""
    jres, tres = _full_both(ckpts[qtype], 35, seed)
    js, ts = segments(jres), segments(tres)
    assert len(js) == len(ts) > 0
    assert js == ts
    assert tres.timings.n_encode == jres.timings.n_encode == 2


def test_from_buffer_equals_from_file(ckpts):
    path = ckpts["q8_0"]
    a = TF.WhisperContext.from_file(path, dtype=torch.float32, device="cpu")
    b = TF.WhisperContext.from_buffer(path.read_bytes(), dtype=torch.float32,
                                      device="cpu")
    for (name, x), (_, y) in zip(_leaves(a.params), _leaves(b.params)):
        if isinstance(x, TQ.QuantPlanes):
            assert torch.equal(x.qs, y.qs) and torch.equal(x.scales, y.scales), name
        else:
            assert torch.equal(x, y), name


def test_stub_checkpoint_round_trip(tmp_path):
    """A checkpoint with no tensors loads (n_loaded == 0), runs on zero
    weights and gives an empty transcript, as the JAX package does."""
    path = tmp_path / "stub.bin"
    TW.write_checkpoint(path, HP, FILTERS, TOKENS, {}, wtype=TQF.GGML_TYPE_Q8_0)
    ck = TG.load_checkpoint(path)
    assert ck.n_loaded == 0 and ck.hparams.ftype == 7 and len(ck.tokens) == 50257
    assert dataclasses.astuple(JG.load_checkpoint(path).hparams) == \
        dataclasses.astuple(ck.hparams)
    tr = Transcriber(model_path=path, dtype=torch.float32, device="cpu")
    assert tr.ctx.n_loaded == 0
    assert all(not v.any() for _, v in _leaves(tr.ctx.params))
    res = tr.transcribe(audio(3, 1), FullParams(print_progress=False))
    jctx = JF.WhisperContext.from_file(str(path), dtype=jnp.float32)
    jres = JF.whisper_full(jctx, JFullParams(print_progress=False), audio(3, 1))
    assert res.segments == [] and jres.segments == []


def test_gguf_and_unported_options_raise(tmp_path):
    """A GGUF file given for a Whisper model fails as in the JAX package,
    whose ggml-bin reader refuses its magic (neither package loads a Whisper
    GGUF); a mesh is not ported."""
    path = tmp_path / "m.gguf"
    path.write_bytes(b"GGUF" + bytes(60))
    with pytest.raises(ValueError) as ref:
        JF.WhisperContext.from_file(str(path))
    for load in (lambda: TF.WhisperContext.from_file(path, device="cpu"),
                 lambda: TF.WhisperContext.from_buffer(path.read_bytes(), device="cpu")):
        with pytest.raises(ValueError) as got:
            load()
        assert "bad magic" in str(got.value)
        assert str(got.value).split(":")[-1] == str(ref.value).split(":")[-1]
    with pytest.raises(NotImplementedError, match="not ported"):
        Transcriber(model_path=path, device="cpu", mesh=object())


def test_transcriber_draft_model_path(ckpts):
    """Transcriber(draft_model_path=...) attaches the draft checkpoint (it
    raised before the port had speculative decoding): its own int8 planes,
    the target's device and dtype."""
    tr = Transcriber(model_path=ckpts["q8_0"], draft_model_path=ckpts["q5_0"],
                     dtype=torch.float32, device="cpu")
    draft = tr.ctx.draft
    assert draft is not None and draft.n_loaded > 0
    assert draft.dtype == torch.float32 and draft.device == tr.ctx.device
    assert isinstance(draft.params["decoder"]["blocks"]["qkv_w"], TQ.QuantLinear)
    assert not torch.equal(draft.params["decoder"]["blocks"]["qkv_w"].qs,
                           tr.ctx.params["decoder"]["blocks"]["qkv_w"].qs)
