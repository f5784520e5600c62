"""The port's command lines (cli/main, outputs, quantize, vad_segments,
bench, stream) on the CPU, against the JAX package's.

whisper-cli runs on the narrow f32 weights of `_torch_parity.contexts`
(three decoder layers) written as a ggml-bin, with `-nf` (no sampled
fallback: it would draw from torch's generator here and jax.random there).
The 16 s request (audio seed 1, 31 segments) keeps its JAX transcript when
the input is scaled by 1 +- 2^-20, 2^-16 and 2^-13.
"""

import io
import json
import wave

import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.cli import main as JMAIN
from open_whisper_kit_tpu.cli import outputs as JO
from open_whisper_kit_tpu.cli import quantize as JQ
from open_whisper_kit_tpu.cli import vad_segments as JVS
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode import tokenizer as JTOK
from open_whisper_kit_tpu_torch.cli import bench as TB
from open_whisper_kit_tpu_torch.cli import main as TMAIN
from open_whisper_kit_tpu_torch.cli import outputs as TO
from open_whisper_kit_tpu_torch.cli import quantize as TQ
from open_whisper_kit_tpu_torch.cli import stream as TSTREAM
from open_whisper_kit_tpu_torch.cli import vad_segments as TVS
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import tokenizer as TTOK
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.io import ggml_writer as TW

from _torch_parity import write_checkpoint

torch.set_num_threads(2)

OUTPUTS = ("txt", "srt", "vtt", "csv", "lrc", "json")


def write_wav(path, seconds: float, seed: int, channels: int = 1, spans=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((int(16000 * seconds), channels)) * 0.1
    if spans is not None:        # speech-like noise over spans, silence elsewhere
        x = np.zeros_like(x)
        for a, b in spans:
            x[int(a * 16000):int(b * 16000)] = rng.standard_normal(
                (int(b * 16000) - int(a * 16000), channels)) * 0.3
    if channels == 2:
        x[:, 1] *= 0.01
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return str(write_checkpoint(tmp_path_factory.mktemp("cli") / "narrow-f32.bin"))


def result_pair():
    """One transcript in both packages' result types: three segments, one
    with a speaker turn, tokens with times, probabilities and a special."""
    segs = []
    for i, (t0, t1, text) in enumerate(((0, 250, " Hello there,"), (250, 612, " world"),
                                        (612, 1830, " again & \"quoted\" <x>"))):
        toks = [dict(id=50363 + t0 // 2, tid=0, p=1.0, plog=0.0, pt=1.0, ptsum=1.0,
                     t0=t0, t1=t0)]
        for k, tid in enumerate((400 + i, 1000 + i)):
            toks.append(dict(id=tid, tid=50400 + k, p=0.25 + 0.3 * k + 0.01 * i,
                             plog=-1.5 + 0.25 * k, pt=0.5, ptsum=0.75,
                             t0=t0 + 10 * k, t1=t0 + 10 * (k + 1), t_dtw=t0 + 5 * k,
                             vlen=0.5))
        segs.append(dict(t0=t0, t1=t1, text=text, no_speech_prob=0.125 * i,
                         speaker_turn_next=(i == 1), toks=toks))

    def build(F):
        return F.TranscribeResult(segments=[
            F.Segment(s["t0"], s["t1"], s["text"], s["no_speech_prob"],
                      [F.TokenData(**t) for t in s["toks"]], s["speaker_turn_next"])
            for s in segs], lang_id=0)
    return build(JF), build(TF)


def vocabs():
    tokens = [b"<%d>" % i for i in range(50257)]
    return JTOK.build_vocab(tokens, 51864), TTOK.build_vocab(tokens, 51864)


@pytest.mark.parametrize("writer,kw", [
    ("write_txt", {}), ("write_vtt", {}), ("write_srt", {"offset_n": 3}), ("write_csv", {}),
    ("write_lrc", {}), ("write_json", {"full": False}), ("write_json", {"full": True}),
    ("write_score", {}), ("write_wts", {})])
@pytest.mark.parametrize("stereo", [False, True])
def test_output_writers_byte_equal_jax(writer, kw, stereo):
    """Every writer of the copied cli/outputs.py on the port's result type
    writes the JAX writer's bytes, mono and with the stereo speaker
    guess."""
    jres, tres = result_pair()
    jv, tv = vocabs()
    st = None
    if stereo:
        rng = np.random.default_rng(0)
        st = rng.standard_normal((16000 * 19, 2)).astype(np.float32)
        st[16000 * 3:, 0] *= 0.01
    extra = {"write_json": lambda v, P: dict(model_type="tiny", language="en", vocab=v,
                                             params=P(print_progress=False)),
             "write_score": lambda v, P: dict(vocab=v),
             "write_wts": lambda v, P: dict(audio_path="a.wav", duration_s=19.0,
                                            font="f.ttf", vocab=v)}
    from open_whisper_kit_tpu.decode.params import FullParams as JP
    jkw = dict(kw, **extra.get(writer, lambda v, P: {})(jv, JP))
    tkw = dict(kw, **extra.get(writer, lambda v, P: {})(tv, FullParams))
    if writer != "write_score":
        jkw["stereo"], tkw["stereo"] = st, st
    a, b = io.StringIO(), io.StringIO()
    getattr(JO, writer)(jres, a, **jkw)
    getattr(TO, writer)(tres, b, **tkw)
    assert b.getvalue() == a.getvalue() and b.getvalue()


def test_renderers_equal_jax():
    jres, tres = result_pair()
    jv, tv = vocabs()
    assert TO.to_timestamp(612, True) == JO.to_timestamp(612, True)
    for mode in ("colors", "confidence"):
        for seg_j, seg_t in zip(jres.segments, tres.segments):
            assert (TO.render_segment_tokens(seg_t, tv, mode=mode, print_special=True,
                                             speaker="(speaker 1)")
                    == JO.render_segment_tokens(seg_j, jv, mode=mode, print_special=True,
                                                speaker="(speaker 1)"))


def close_json(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            close_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-5, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_whisper_cli_no_gpu_writes_jax_s_files(model, tmp_path, capsys):
    """whisper-cli -ng with every output format: the txt, srt, vtt, csv and
    lrc files are the JAX CLI's bytes, the JSON its tree with the
    probabilities within 1e-5, and the printed segments the same."""
    wav = write_wav(tmp_path / "a.wav", 16, 1)
    flags = ["-m", model, "-f", str(wav), "-nf", "--dtype", "f32",
             "-otxt", "-osrt", "-ovtt", "-ocsv", "-olrc", "-ojf"]
    assert JMAIN.main(flags + ["-of", str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr().out
    assert TMAIN.main(flags + ["-of", str(tmp_path / "port"), "-ng"]) == 0
    tout = capsys.readouterr().out
    assert tout == jout and tout.count("-->") >= 20
    for ext in OUTPUTS:
        j, t = ((tmp_path / f"{who}.{ext}").read_text() for who in ("jax", "port"))
        if ext == "json":
            jd, td = json.loads(j), json.loads(t)
            assert td["transcription"] and td.pop("systeminfo") == jd.pop("systeminfo")
            close_json(td, jd)
        else:
            assert t == j, ext


def test_whisper_cli_processors_and_device_flags(model, tmp_path, capsys):
    """-p 2 runs the port's full_parallel (the direct call's segments);
    -ng is the CPU and -dev N the card cuda:N."""
    wav = write_wav(tmp_path / "b.wav", 8, 2)
    assert TMAIN.main(["-m", model, "-f", str(wav), "-nf", "--dtype", "f32", "-ng", "-p", "2",
                       "-otxt", "-of", str(tmp_path / "p2"), "-np"]) == 0
    capsys.readouterr()
    from open_whisper_kit_tpu_torch import api
    from open_whisper_kit_tpu_torch.audio.wav import load_wav
    tr = api.Transcriber(model_path=model, dtype=torch.float32, device="cpu")
    args = TMAIN.build_parser().parse_args(["-nf", "-ng"])
    res = tr.full_parallel(TMAIN.params_from_args(args), load_wav(wav), 2)
    buf = io.StringIO()
    TO.write_txt(res, buf)
    assert (tmp_path / "p2.txt").read_text() == buf.getvalue()
    p = TMAIN.build_parser()
    assert TMAIN.device_from_args(p.parse_args(["-ng"])) == "cpu"
    assert TMAIN.device_from_args(p.parse_args(["-dev", "1"])) == "cuda:1"
    assert TMAIN.device_from_args(p.parse_args([])) == "cuda:0"


def test_quantize_cli_writes_jax_s_bytes(tmp_path):
    """quantize model-f32 -> q5_0 / q8_0: the JAX CLI's file, byte for byte."""
    hp = TW.WhisperHParams(1000, 64, 128, 2, 1, 32, 128, 2, 1, 80, ftype=0, qntvr=0)
    src = tmp_path / "f32.bin"
    TW.write_checkpoint(src, hp, TF._synthetic_mel_filters(80), [b"<%d>" % i for i in range(1000)],
                        TW.random_reference_tensors(hp, seed=0), wtype=0)
    for qt in ("q5_0", "q8_0"):
        assert TQ.main([str(src), str(tmp_path / f"t-{qt}.bin"), qt]) == 0
        assert JQ.main([str(src), str(tmp_path / f"j-{qt}.bin"), qt]) == 0
        assert ((tmp_path / f"t-{qt}.bin").read_bytes()
                == (tmp_path / f"j-{qt}.bin").read_bytes())
    assert TQ.main([str(src), str(tmp_path / "x.bin"), "q9_9"]) == 1
    assert TQ.main([]) == 1


def test_vad_segments_cli_prints_jax_s_segments(tmp_path, capsys):
    from open_whisper_kit_tpu_torch.io import silero_writer as SW
    SW.write_silero(tmp_path / "silero.bin", SW.random_silero_tensors(seed=0))
    wav = write_wav(tmp_path / "s.wav", 12, 3, spans=((1, 3.5), (5, 6), (7.5, 11)))
    args = ["-vm", str(tmp_path / "silero.bin"), "-f", str(wav), "--threshold", "0.55"]
    assert JVS.main(args) == 0
    jout = capsys.readouterr().out
    assert TVS.main(args + ["-ng"]) == 0
    tout = capsys.readouterr().out
    assert tout == jout and tout.count("Speech segment") >= 2


def test_bench_cli_runs_on_the_cpu(tmp_path, capsys):
    """whisper-bench -ng on a small random checkpoint (the bench's 256-token
    prompt pass needs n_text_ctx >= 256): one row of four finite times,
    labelled with the device."""
    hp = TW.WhisperHParams(1000, 64, 64, 2, 1, 256, 64, 2, 1, 80, ftype=0, qntvr=0)
    path = tmp_path / "small.bin"
    TW.write_checkpoint(path, hp, TF._synthetic_mel_filters(80),
                        [b"<%d>" % i for i in range(1000)],
                        TW.random_reference_tensors(hp, seed=0), wtype=0)
    assert TB.main(["-m", str(path), "-ng"]) == 0
    row = capsys.readouterr().out.splitlines()[0]
    cells = [c.strip() for c in row.strip("|").split("|")]
    assert cells[0] == "cpu" and cells[1]
    assert all(np.isfinite(float(c)) and float(c) > 0 for c in cells[2:])


def test_stream_cli_replays_a_wav(model, tmp_path, capsys):
    """whisper-stream -ng --input-wav: the committed lines in -f's file are
    the final events of a StreamingTranscriber fed the same pieces."""
    from open_whisper_kit_tpu_torch.audio.wav import load_wav
    from open_whisper_kit_tpu_torch.decode import stream as TS
    wav = write_wav(tmp_path / "c.wav", 9, 4)
    out = tmp_path / "stream.txt"
    assert TSTREAM.main(["-m", model, "--input-wav", str(wav), "-ng", "-nf", "--step", "3000",
                         "--length", "6000", "-f", str(out)]) == 0
    capsys.readouterr()
    ctx = TF.WhisperContext.from_file(model, dtype=torch.bfloat16, device="cpu")
    st = TS.StreamingTranscriber(ctx, TS.StreamParams(step_ms=3000, length_ms=6000,
                                                      no_fallback=True))
    x = load_wav(wav)
    finals = [e.text for i in range(0, len(x), 48000) for e in st.feed(x[i:i + 48000])
              if e.final]
    assert finals and out.read_text() == "".join(t + "\n" for t in finals)


def test_packaging_names_the_port_s_scripts_and_kernel_headers():
    """pyproject.toml ships every kernel source and header of the port
    (ops/_build.py hashes the headers too) and names the port's console
    scripts, each a callable main."""
    import fnmatch
    import importlib
    import tomllib
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    meta = tomllib.loads((repo / "pyproject.toml").read_text())
    globs = meta["tool"]["setuptools"]["package-data"]["open_whisper_kit_tpu_torch"]
    csrc = sorted(p.name for p in (repo / "open_whisper_kit_tpu_torch" / "csrc").iterdir())
    assert any(n.endswith(".cuh") for n in csrc)
    assert all(any(fnmatch.fnmatch(f"csrc/{n}", g) for g in globs) for n in csrc)
    scripts = {k: v for k, v in meta["project"]["scripts"].items() if k.startswith("owk-torch-")}
    assert set(scripts) == {"owk-torch-whisper-cli", "owk-torch-whisper-stream",
                            "owk-torch-whisper-server", "owk-torch-whisper-bench",
                            "owk-torch-quantize", "owk-torch-vad-segments", "owk-torch-diarize",
                            "owk-torch-whisper-lsp"}
    for target in scripts.values():
        mod, fn = target.split(":")
        assert mod.startswith("open_whisper_kit_tpu_torch.")
        assert callable(getattr(importlib.import_module(mod), fn))
