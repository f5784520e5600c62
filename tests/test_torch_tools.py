"""The port's tools (open_whisper_kit_tpu_torch/tools/) against the JAX
package's (repo-root tools/) on the CPU, at a tiny size: the same inputs
through both, and the same output files byte for byte, the same printed
lines and exit codes, the same DER dicts.

eval_wer runs end to end with -ng on the seed-0 f32 checkpoint of
`_torch_parity.write_checkpoint` (three decoder layers; token ids 1000-1099
are English words and the ids from 1100 to the end of text are empty, so
that the transcripts hold words), read in bf16 as both harnesses do. Its
two 4 s audio seeds, 0 and 4, keep the JAX transcript when the input is
scaled by 1 +- 2^-20, 2^-16 and 2^-13.
"""

import io
import os
import random
import sys
import tarfile
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
# transformers (the HF converter's model, the JAX tool's normalizer) need
# not import TensorFlow, which takes seconds here
os.environ.setdefault("USE_TF", "0")

import compare_rttm as JCR  # noqa: E402
import convert_hf_to_ggml as JHF  # noqa: E402
import convert_nemo_to_gguf as JNEMO  # noqa: E402
import convert_pt_to_ggml as JPT  # noqa: E402
import eval_wer as JWER  # noqa: E402
import validate_gguf as JVG  # noqa: E402
from tools.english_normalizer import build_normalizer as j_build_normalizer  # noqa: E402

from open_whisper_kit_tpu_torch.io import ggml_whisper as TGW  # noqa: E402
from open_whisper_kit_tpu_torch.io import ggml_writer as TW  # noqa: E402
from open_whisper_kit_tpu_torch.io.gguf import GGUFWriter, load_gguf  # noqa: E402
from open_whisper_kit_tpu_torch.models.sortformer.mel_fb import mel_filterbank  # noqa: E402
from open_whisper_kit_tpu_torch.tools import compare_rttm as TCR  # noqa: E402
from open_whisper_kit_tpu_torch.tools import convert_hf_to_ggml as THF  # noqa: E402
from open_whisper_kit_tpu_torch.tools import convert_nemo_to_gguf as TNEMO  # noqa: E402
from open_whisper_kit_tpu_torch.tools import convert_pt_to_ggml as TPT  # noqa: E402
from open_whisper_kit_tpu_torch.tools import eval_wer as TWER  # noqa: E402
from open_whisper_kit_tpu_torch.tools import validate_gguf as TVG  # noqa: E402
from open_whisper_kit_tpu_torch.tools.english_normalizer import build_normalizer  # noqa: E402

torch.set_num_threads(2)

WORDS = ("the a of and to in is you that it he was for on are as with his they at be this "
         "have from or one had by word but not what all were we when your can said there use "
         "an each which she do how their if will up other about out many then them these so "
         "some her would make like him into time has look two more write go see number no way "
         "could people my than first water been call who oil its now find long down day did "
         "get come made may part").split()


# -- english_normalizer and wer ----------------------------------------------

# the JAX tool's goldens (tests/test_tools.py), observed outputs of OpenAI's pipeline
GOLDENS = {
    "Mr. Brown's dog won't eat one hundred and twenty-three biscuits!":
        "mister brown is dog will not eat 123 biscuits",
    "It costs twenty dollars and fifty cents.": "it costs $20.50",
    "[APPLAUSE] He said (quietly): let's go": "he said let us go",
    "I have 1,000 reasons; nineteen eighty-four was a year.":
        "i have 1000 reasons 1984 was a year",
    "three point one four one five nine": "3.14159",
    "Dr. Smith lives on 5th Ave.": "doctor smith lives on 5th ave",
    "a hundred percent": "a 100%",
    "My favourite colour is grey": "my favorite color is gray",
    "Hello, World!": "hello world",
    "I can't do it.": "i can not do it",
    "a  [noise]  b": "a b",
}

FUZZ_WORDS = ("one two three four five six seven eight nine ten eleven twelve thirteen nineteen "
              "twenty thirty forty ninety hundred thousand million billion first second third "
              "fifth twelfth ninth twentieth thirties sixes ones hundreds thousandth oh o zero "
              "and a half point double triple minus plus negative dollars dollar cents cent "
              "pounds euro per cent percent the cat mr dr st won't i'm it's colour grey 1,000 "
              "3.5 $20 20% 1960s 21st $ . , ! ? [noise] (aside) <x> uh um café naïve œuvre 7 42 "
              "0.5 $0.07 £3 and i'll you're they'd 5th 1").split()


def fuzz_texts(n: int, seed: int):
    rng = random.Random(seed)
    return [" ".join(rng.choice(FUZZ_WORDS) for _ in range(rng.randint(1, 12)))
            for _ in range(n)]


@pytest.mark.parametrize("src", sorted(GOLDENS))
def test_normalizer_goldens_equal_jax(src):
    got = build_normalizer()(src)
    assert got == GOLDENS[src] == j_build_normalizer()(src)
    assert TWER.normalize_text(src) == JWER.normalize_text(src)


@pytest.mark.parametrize("seed", [0, 1])
def test_normalizer_equals_jax_on_seeded_number_phrases(seed):
    """Spoken numbers, currency, percent, titles, contractions, brackets and
    diacritics in random order: the port's own pipeline against the JAX
    tool's (transformers' copy of OpenAI's), string for string."""
    port, jax_side = build_normalizer(), j_build_normalizer()
    for s in fuzz_texts(1500, seed):
        assert port(s) == jax_side(s), s


@pytest.mark.parametrize("ref,hyp", [
    ("a b c", "a b c"), ("a b c", "a x c"), ("a b", "a x b"), ("a b c d", "a b"),
    ("", ""), ("", "x"), ("a b c d", "a x c d e"), ("a b", "a b"),
    ("the cat sat on the mat", "cat sat on a mat mat")])
def test_wer_equals_jax(ref, hyp):
    assert TWER.wer(ref, hyp) == JWER.wer(ref, hyp)


# -- convert_pt_to_ggml ------------------------------------------------------

PT_HP = (51864, 64, 64, 2, 2, 32, 64, 2, 2, 80)


def write_pt(path: Path, args, seed: int = 0):
    """An OpenAI-format checkpoint: dims and a state dict of f32 tensors,
    the conv biases 1-D."""
    hp = TW.WhisperHParams(*args, ftype=0, qntvr=0)
    tensors = TW.random_reference_tensors(hp, seed=seed)
    names = ("n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
             "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer", "n_mels")
    state = {k: torch.from_numpy(v.reshape(-1) if k.endswith("conv1.bias")
                                 or k.endswith("conv2.bias") else v)
             for k, v in tensors.items()}
    torch.save({"dims": dict(zip(names, args)), "model_state_dict": state}, path)
    return hp, tensors


def gpt2_byte_encoder():
    dec = TPT._byte_decoder()
    return {b: c for c, b in dec.items()}


def write_whisper_repo(root: Path, multilingual: bool, tiktoken: bool, seed: int):
    """A whisper checkout's assets: a tiktoken ranks file, or a vocab.json
    in GPT-2's byte-to-unicode alphabet, of 300 seeded byte strings."""
    rng = np.random.default_rng(seed)
    toks = [bytes([i]) for i in range(256)] + [
        bytes(rng.integers(0, 256, rng.integers(2, 6)).tolist()) for _ in range(44)]
    assets = root / "whisper" / "assets"
    if tiktoken:
        import base64
        assets.mkdir(parents=True)
        name = "multilingual.tiktoken" if multilingual else "gpt2.tiktoken"
        (assets / name).write_bytes(b"".join(
            base64.b64encode(t) + b" %d\n" % i for i, t in enumerate(toks)))
    else:
        import json
        d = assets / ("multilingual" if multilingual else "gpt2")
        d.mkdir(parents=True)
        enc = gpt2_byte_encoder()
        vocab = {"".join(enc[b] for b in t): i for i, t in enumerate(toks)}
        vocab["<|endoftext|>"] = len(toks)
        (d / "vocab.json").write_text(json.dumps(vocab))


@pytest.fixture(scope="module")
def vocab_ggml(tmp_path_factory):
    """A ggml-bin to borrow a tokenizer from (--vocab-from)."""
    path = tmp_path_factory.mktemp("vocab") / "ggml-vocab.bin"
    hp = TW.WhisperHParams(1000, 8, 64, 2, 1, 8, 64, 2, 1, 80, ftype=0, qntvr=0)
    words = [b" " + w.encode() for w in WORDS] + [b"<%d>" % i for i in range(50257 - len(WORDS))]
    TW.write_checkpoint(path, hp, mel_filterbank(80, 400, 16000), words,
                        TW.random_reference_tensors(hp, seed=1), wtype=0)
    return path


@pytest.mark.parametrize("n_vocab,source", [
    (51864, "vocab-from"), (51864, "vocab.json"), (51864, "tiktoken"),
    (51866, "vocab.json"), (51866, "tiktoken")])
@pytest.mark.parametrize("f32", [False, True])
def test_convert_pt_writes_jax_s_bytes(tmp_path, vocab_ggml, capsys, n_vocab, source, f32):
    """f16 default and --f32; the tokenizer from --vocab-from, or from a
    whisper checkout's vocab.json or tiktoken file (English or
    multilingual by n_vocab): the JAX tool's file, byte for byte."""
    args = (n_vocab,) + PT_HP[1:]
    pt = tmp_path / "model.pt"
    write_pt(pt, args)
    flags = ["--f32"] if f32 else []
    if source == "vocab-from":
        flags += ["--vocab-from", str(vocab_ggml)]
    else:
        write_whisper_repo(tmp_path / "whisper", n_vocab >= 51865, source == "tiktoken", 7)
        flags += ["--whisper-repo", str(tmp_path / "whisper")]
    assert JPT.main([str(pt), str(tmp_path / "jax")] + flags) == 0
    assert TPT.main([str(pt), str(tmp_path / "port")] + flags) == 0
    name = "ggml-model-f32.bin" if f32 else "ggml-model.bin"
    out = capsys.readouterr().out.splitlines()
    assert out == [f"wrote {tmp_path / who / name}" for who in ("jax", "port")]
    got = (tmp_path / "port" / name).read_bytes()
    assert got == (tmp_path / "jax" / name).read_bytes()
    ck = TGW.load_checkpoint(tmp_path / "port" / name)
    assert len(ck.tokens) in (300, 50257) and ck.n_loaded > 0


def test_convert_pt_f32_then_q8_0_is_a_direct_write(tmp_path, vocab_ggml, capsys):
    """--f32, then the port's requantize to q8_0: the bytes of a q8_0
    write_checkpoint of the same tensors, slaney filters and tokens."""
    hp, tensors = write_pt(tmp_path / "model.pt", PT_HP)
    assert TPT.main([str(tmp_path / "model.pt"), str(tmp_path / "out"), "--f32",
                     "--vocab-from", str(vocab_ggml)]) == 0
    capsys.readouterr()
    TW.requantize(tmp_path / "out" / "ggml-model-f32.bin", tmp_path / "q8.bin", "q8_0")
    tokens = TGW.load_checkpoint(vocab_ggml, load_tensors=False).tokens
    TW.write_checkpoint(tmp_path / "direct.bin", TW.WhisperHParams(*PT_HP, ftype=1, qntvr=0),
                        mel_filterbank(80, 400, 16000), tokens, tensors,
                        wtype=TW.TYPE_FOR_NAME["q8_0"])
    assert (tmp_path / "q8.bin").read_bytes() == (tmp_path / "direct.bin").read_bytes()


def test_convert_pt_without_a_tokenizer_fails_as_jax(tmp_path, capsys):
    write_pt(tmp_path / "model.pt", PT_HP)
    argv = [str(tmp_path / "model.pt"), str(tmp_path / "out")]
    assert JPT.main(argv) == TPT.main(argv) == 1
    assert JPT.main([]) == TPT.main([]) == 1
    err = capsys.readouterr().err
    assert err.count("need --whisper-repo or --vocab-from") == 2


# -- convert_hf_to_ggml ------------------------------------------------------

@pytest.fixture(scope="module")
def hf_model():
    """tests/test_hf_convert.py's tiny random HF Whisper."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration
    cfg = WhisperConfig(
        vocab_size=51864, num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=64, max_target_positions=32,
        activation_function="gelu_new",  # tanh-approx, like ggml
    )
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(cfg)
    model.eval()
    return model


@pytest.fixture(scope="module")
def hf_converted(hf_model, tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    for who, mod in (("jax", JHF), ("port", THF)):
        for f16 in (False, True):
            mod.convert(hf_model, None, str(d / f"{who}-{int(f16)}.bin"), use_f16=f16)
    return d


@pytest.mark.parametrize("f16", [False, True])
def test_convert_hf_writes_jax_s_bytes(hf_converted, f16):
    port = (hf_converted / f"port-{int(f16)}.bin").read_bytes()
    assert port == (hf_converted / f"jax-{int(f16)}.bin").read_bytes()


def test_hf_names_and_vocab_equal_jax(hf_model):
    names = list(hf_model.state_dict()) + ["proj_out.weight", "lm_head.weight",
                                            "model.encoder.layers.0.unknown.weight", "x"]
    assert [THF.map_hf_name(n) for n in names] == [JHF.map_hf_name(n) for n in names]
    assert THF.map_hf_name("model.decoder.layers.1.fc1.weight") == "decoder.blocks.1.mlp.0.weight"

    class FakeTok:
        def get_vocab(self):
            return {"Ġhello": 1, "a": 0, "<|endoftext|>": 2, "✓x": 4, "Ċ": 3}

    assert THF.hf_vocab_bytes(FakeTok(), 10) == JHF.hf_vocab_bytes(FakeTok(), 10)
    assert THF.hf_vocab_bytes(FakeTok(), 10)[:2] == [b"a", b" hello"]


def test_hf_converted_file_runs_like_hf_in_the_port(hf_model, hf_converted):
    """The converted f32 file in the port's loader: encoder output and
    decoder logits on the CPU against the HF model's own forward, within
    tests/test_hf_convert.py's tolerances."""
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    ck = TGW.load_checkpoint(hf_converted / "port-0.bin")
    cfg = TM.WhisperConfig.from_hparams(ck.hparams)
    params = TM.params_from_checkpoint(ck, dtype=torch.float32)
    assert hf_model.model.decoder.layers[0].self_attn.k_proj.bias is None

    rng = np.random.default_rng(1)
    mel = rng.standard_normal((1, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, size=(1, 5))
    with torch.no_grad():
        enc = TM.encode(cfg, params["encoder"], torch.from_numpy(mel))
        dec = TM.prepare_decoder(params["decoder"])
        xk, xv = TM.cross_kv(cfg, dec, enc)
        kv_k, kv_v = TM.init_kv_cache(cfg, 1, torch.float32, device="cpu")
        logits = TM.decode_impl(cfg, dec, torch.from_numpy(tokens), kv_k, kv_v, 0, xk, xv)[0]
        feats = torch.from_numpy(mel.transpose(0, 2, 1))
        hf_enc = hf_model.model.encoder(input_features=feats).last_hidden_state
        hf_logits = hf_model(input_features=feats, decoder_input_ids=torch.from_numpy(tokens)).logits
    assert enc.shape == hf_enc.shape and logits.shape == hf_logits.shape
    np.testing.assert_allclose(enc.numpy(), hf_enc.numpy(), atol=5e-4)
    np.testing.assert_allclose(logits.numpy(), hf_logits.numpy(), atol=2e-3)


# -- convert_nemo_to_gguf ----------------------------------------------------

SORT_ARGS = dict(n_mels=128, d_model=32, n_layers=2, n_heads=4, conv_kernel=5,
                 ff_expansion=2, subsampling_channels=8, tf_layers=2, tf_d_model=16,
                 tf_heads=4, tf_ff=32)
NEMO_YAML = {"encoder": {"n_layers": 2, "d_model": 32, "n_heads": 4, "conv_kernel_size": 5,
                         "ff_expansion_factor": 2, "subsampling_factor": 8,
                         "subsampling_conv_channels": 8},
             "transformer_encoder": {"num_layers": 2, "hidden_size": 16,
                                     "num_attention_heads": 4, "inner_size": 32},
             "max_num_of_spks": 4}


@pytest.fixture(scope="module")
def nemo_file(tmp_path_factory):
    """A .nemo tar (model_config.yaml, model_weights.ckpt) of tiny seed-0
    SortFormer tensors under NeMo's names, each depthwise conv followed by a
    seeded BatchNorm (the converter fuses it), with a skipped filter bank."""
    import yaml

    from open_whisper_kit_tpu_torch.models.sortformer import export as SE
    from open_whisper_kit_tpu_torch.models.sortformer import model as SM
    d = tmp_path_factory.mktemp("nemo")
    cfg = SM.SortformerConfig(**SORT_ARGS)
    src = SE.write_sortformer_gguf(d / "src.gguf", cfg, SM.init_params(cfg, seed=0, device="cpu"),
                                   half=False)
    state = {n: torch.from_numpy(t.to_float().copy()) for n, t in load_gguf(src).tensors.items()}
    state["preprocessor.featurizer.fb"] = state["preprocessor.featurizer.fb"][None]
    state["preprocessor.featurizer.filter_banks"] = torch.ones(3)
    rng = np.random.default_rng(5)
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}.conv.batch_norm"
        C = cfg.d_model
        state[f"{p}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
        state[f"{p}.bias"] = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
        state[f"{p}.running_mean"] = torch.from_numpy(
            (rng.standard_normal(C) * 0.1).astype(np.float32))
        state[f"{p}.running_var"] = torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32))
        state[f"{p}.num_batches_tracked"] = torch.tensor(7)
    ckpt = io.BytesIO()
    torch.save(state, ckpt)
    path = d / "tiny.nemo"
    with tarfile.open(path, "w") as tar:
        for name, blob in (("./model_config.yaml", yaml.safe_dump(NEMO_YAML).encode()),
                           ("./model_weights.ckpt", ckpt.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return path


def test_convert_nemo_writes_jax_s_bytes_and_the_port_loads_it(nemo_file, tmp_path, capsys):
    from open_whisper_kit_tpu_torch import api as TAPI
    assert JNEMO.main([str(nemo_file), str(tmp_path / "jax.gguf")]) == 0
    assert TNEMO.main([str(nemo_file), str(tmp_path / "port.gguf")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(": ")[1] for line in out] == [out[0].split(": ")[1]] * 2
    port = (tmp_path / "port.gguf").read_bytes()
    assert port == (tmp_path / "jax.gguf").read_bytes()
    di = TAPI.Diarizer(model_path=tmp_path / "port.gguf", device="cpu")
    cfg = di.engine.cfg
    assert {k: getattr(cfg, k) for k in SORT_ARGS} == SORT_ARGS
    x = (np.random.default_rng(3).standard_normal(32000) * 0.1).astype(np.float32)
    probs, _ = di.diarize(x, "offline")
    assert probs.shape[1] == 4 and probs.shape[0] > 0 and np.isfinite(probs).all()
    assert TNEMO.main([str(nemo_file)]) == JNEMO.main([str(nemo_file)]) == 1


# -- validate_gguf -----------------------------------------------------------

def write_gguf(path: Path, kind: str) -> Path:
    w = GGUFWriter(path)
    w.add_string("general.architecture", "test")
    w.add_uint32("test.dim", 8)
    w.add_string("test.long", "x" * 100)
    a = np.arange(32, dtype=np.float32)
    if kind == "nan":
        a[3], a[7] = np.nan, np.inf
    w.add_tensor("a", a)
    w.add_tensor("b", np.ones((4, 8), np.float16))
    w.write()
    if kind == "truncated":
        path.write_bytes(path.read_bytes()[:-40])
    return path


@pytest.mark.parametrize("kind,flags", [
    ("ok", ["--stats"]), ("ok", []), ("ok", ["--max-print", "1"]), ("nan", ["--stats"]),
    ("nan", []), ("truncated", []), ("missing", [])])
def test_validate_gguf_prints_jax_s_report(tmp_path, capsys, kind, flags):
    path = (tmp_path / "none.gguf" if kind == "missing"
            else write_gguf(tmp_path / "m.gguf", kind))
    got = []
    for mod in (JVG, TVG):
        rc = mod.main([str(path)] + flags)
        got.append((rc, capsys.readouterr()))
    (jrc, jout), (trc, tout) = got
    assert trc == jrc == (0 if kind == "ok" or kind == "nan" and not flags else 1)
    assert tout.out == jout.out and tout.err == jout.err
    if kind != "missing":
        assert tout.out.splitlines()[-1] == ("OK" if trc == 0 else "FAIL (1 problems)")


# -- compare_rttm ------------------------------------------------------------

REF = ("SPEAKER f 1 0.00 5.00 <NA> <NA> speaker_0 <NA> <NA>\n"
       "SPEAKER f 1 5.00 5.00 <NA> <NA> speaker_1 <NA> <NA>\n")
HYPS = {
    "relabelled": "SPEAKER f 1 0.00 5.00 <NA> <NA> spkA <NA> <NA>\n"
                  "SPEAKER f 1 5.00 5.00 <NA> <NA> spkB <NA> <NA>\n",
    "missed": "SPEAKER f 1 0.00 5.00 <NA> <NA> spkA <NA> <NA>\n"
              "SPEAKER f 1 5.00 3.00 <NA> <NA> spkB <NA> <NA>\n",
    "one_speaker": "SPEAKER f 1 0.00 5.00 <NA> <NA> x <NA> <NA>\n"
                   "SPEAKER f 1 5.00 5.00 <NA> <NA> x <NA> <NA>\n",
}


def random_rttm(rng, n_spk: int, n_seg: int) -> str:
    lines = []
    for _ in range(n_seg):
        start = rng.uniform(0, 20)
        lines.append(f"SPEAKER r 1 {start:.2f} {rng.uniform(0.1, 4):.2f} <NA> <NA> "
                     f"s{rng.integers(n_spk)} <NA> <NA>")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("collar", [0.0, 0.25])
@pytest.mark.parametrize("case", sorted(HYPS) + ["seeded"])
def test_compare_rttm_equals_jax(tmp_path, capsys, case, collar):
    ref, hyp = tmp_path / "ref.rttm", tmp_path / "hyp.rttm"
    if case == "seeded":
        rng = np.random.default_rng(11)
        ref.write_text(random_rttm(rng, 3, 12))
        hyp.write_text(random_rttm(rng, 4, 15))
    else:
        ref.write_text(REF)
        hyp.write_text(HYPS[case])
    got = TCR.der(str(ref), str(hyp), collar)
    assert got == JCR.der(str(ref), str(hyp), collar)
    if case == "relabelled":
        assert got["der"] == 0.0
    argv = [str(ref), str(hyp), "--collar", str(collar)]
    assert JCR.main(argv) == TCR.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 12 and out[:6] == out[6:]


# -- eval_wer ----------------------------------------------------------------

def write_wav(path: Path, seconds: float, seed: int) -> Path:
    x = np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


@pytest.fixture(scope="module")
def wer_corpus(tmp_path_factory):
    """A word checkpoint and a corpus of two 4 s seeded-noise WAVs (audio
    seeds 0 and 4): a.wav with an a.txt beside it, b.wav under x/ with its
    line in x/x.trans.txt; references drawn from WORDS with a seeded rng."""
    from _torch_parity import NARROW_TS, write_checkpoint
    d = tmp_path_factory.mktemp("wer")
    words = [b" " + w.encode() for w in WORDS]
    model = write_checkpoint(d / "words-f32.bin", NARROW_TS, words=words,
                             named=1000 + len(words))
    corpus = d / "corpus"
    (corpus / "x").mkdir(parents=True)
    rng = np.random.default_rng(23)
    refs = [" ".join(rng.choice(WORDS, n)) for n in (6, 9)]
    write_wav(corpus / "a.wav", 4.0, 0)
    (corpus / "a.txt").write_text(f"More, {refs[0]}!\n")
    write_wav(corpus / "x" / "b.wav", 4.0, 4)
    (corpus / "x" / "x.trans.txt").write_text(f"b {refs[1].upper()}\nc NOT IN THE CORPUS\n")
    return model, corpus


def test_eval_wer_no_gpu_prints_jax_s_lines(wer_corpus, capsys):
    """The port's harness with -ng against the JAX harness, greedy without
    fallback: the same per-file and total lines."""
    model, corpus = wer_corpus
    argv = ["--model", str(model), "--corpus", str(corpus), "--no-fallback"]
    assert JWER.main(argv) == 0
    jout = capsys.readouterr().out
    assert TWER.main(argv + ["-ng"]) == 0
    tout = capsys.readouterr().out
    assert tout == jout
    lines = tout.splitlines()
    assert lines[:2] == ["a.wav: wer=0.857", "b.wav: wer=1.000"], lines
    assert lines[-1] == "TOTAL WER: 0.9375 over 16 words, 2 files"
    assert TWER.main(argv + ["-ng", "--limit", "1"]) == 0
    assert capsys.readouterr().out.splitlines() == [lines[0], "", lines[-1].replace(
        "0.9375 over 16 words, 2 files", "0.8571 over 7 words, 1 files")]


def test_eval_wer_corpus_layouts_and_device_flags_equal_jax(wer_corpus, tmp_path, capsys):
    model, corpus = wer_corpus
    assert TWER.collect_corpus(corpus) == JWER.collect_corpus(corpus)
    assert [p.name for p, _ in TWER.collect_corpus(corpus)] == ["a.wav", "b.wav"]
    empty = ["--model", str(model), "--corpus", str(tmp_path)]
    assert JWER.main(empty) == TWER.main(empty + ["-ng"]) == 1
    assert capsys.readouterr().err.count("no (audio, transcript) pairs found") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TWER.main(["--model", str(model), "--corpus", str(corpus)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TWER.main(["--model", str(model), "--corpus", str(corpus), "-dev", "1"])
