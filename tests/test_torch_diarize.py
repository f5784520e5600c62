"""The port's diarization surface against the JAX package (CPU, f32):
`api.Diarizer` from a GGUF file and from (cfg, params), its RTTM text,
batches and streams, word <-> speaker `api.align` on a narrow
Transcriber's words, and the diarize CLI with `--device cpu`.

The TINY SortFormer (the JAX tests' config) is written by the port's
exporter and read by both packages. Every diarized input here keeps its
JAX RTTM segments when it is scaled by 1 +- 2^-20, 2^-16 and 2^-13
(`python tests/sortformer_seed_scan.py`)."""

import dataclasses
import wave

import jax
import numpy as np
import pytest
import torch

from _torch_parity import NARROW_TS, contexts
from open_whisper_kit_tpu import api as JAPI
from open_whisper_kit_tpu.align import rttm as JR
from open_whisper_kit_tpu.cli import diarize as JCLI
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu.models.sortformer import model as JM
from open_whisper_kit_tpu_torch import api as TAPI
from open_whisper_kit_tpu_torch.cli import diarize as TCLI
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.models.sortformer import export as TE
from open_whisper_kit_tpu_torch.models.sortformer import model as TM

torch.set_num_threads(2)

TINY = TM.SortformerConfig(n_mels=32, d_model=32, n_layers=2, n_heads=4, conv_kernel=5,
                           ff_expansion=2, subsampling_channels=8,
                           tf_layers=2, tf_d_model=16, tf_heads=4, tf_ff=32)


def audio(seconds: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """The seed-0 TINY weights as an f16 GGUF (the reference converter's
    dtype policy), from the port's exporter."""
    path = tmp_path_factory.mktemp("sortformer") / "tiny-sortformer.gguf"
    return TE.write_sortformer_gguf(path, TINY, TM.init_params(TINY, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def diarizers(model_file):
    return JAPI.Diarizer(model_path=model_file), TAPI.Diarizer(model_path=model_file,
                                                               device="cpu")


def test_diarizer_defaults_to_the_card_and_host_loop_on_cpu(diarizers):
    import inspect
    assert inspect.signature(TAPI.Diarizer.__init__).parameters["device"].default == "cuda"
    d = diarizers[1]
    assert d.device == torch.device("cpu") and d.engine.params["mel_fb"].device.type == "cpu"
    assert d._auto_device_state(None) is False and d._auto_device_state(True) is True
    assert {"Diarizer", "align", "DiarizedTranscription", "RttmSegment"} <= set(TAPI.__all__)
    with pytest.raises(ValueError, match="model_path or"):
        TAPI.Diarizer(device="cpu")


@pytest.mark.parametrize("preset,device_state", [("offline", None), ("low_latency", None),
                                                 ("low_latency", True), ("2s", True)])
def test_diarize_to_rttm_matches_jax(diarizers, preset, device_state):
    """The RTTM text of 16 s (the f16 file's weights, both loaders): equal
    to JAX's, from the host loop (the CPU default) and the device loop
    (one read for the file); the probabilities within 1e-5."""
    x = audio(16.0, 0)
    kw = dict(stream_config=preset, device_state=device_state)
    jprobs, jsegments = diarizers[0].diarize(x, file_id="meeting", **kw)
    n0 = diarizers[1].engine.reads.n
    got = diarizers[1].diarize_to_rttm(x, file_id="meeting", **kw)
    if device_state:
        assert diarizers[1].engine.reads.n - n0 == 1
    assert got == JR.to_rttm(jsegments) and got.count("SPEAKER meeting 1 ") >= 1
    probs, segments = diarizers[1].diarize(x, **kw)
    np.testing.assert_allclose(probs, jprobs, atol=1e-5 * np.abs(jprobs).max(), rtol=0)
    assert [s.file for s in segments] == ["unknown"] * len(jsegments)


def test_diarizer_from_params_batch_matches_jax():
    """Diarizer(cfg, params) on the f32 weights; diarize_batch of uneven
    files with ids, on both loops, equal to JAX's (probabilities and
    segments)."""
    jcfg = JM.SortformerConfig(**dataclasses.asdict(TINY))
    jp = JM.init_params(jcfg, seed=0)
    jd = JAPI.Diarizer(cfg=jcfg, params=jp)
    td = TAPI.Diarizer(cfg=TINY, params=TM.params_from_jax(jax.tree.map(np.asarray, jp),
                                                           device="cpu"), device="cpu")
    xs = [audio(12.0, 1), audio(9.0, 2)]
    for device_state in (False, True):
        got = td.diarize_batch(xs, "3s", file_ids=["a", "b"], device_state=device_state)
        ref = jd.diarize_batch(xs, "3s", file_ids=["a", "b"], device_state=device_state)
        for (p, s), (jp_, js) in zip(got, ref):
            np.testing.assert_allclose(p, jp_, atol=1e-5 * np.abs(jp_).max(), rtol=0)
            assert [dataclasses.astuple(x) for x in s] == [dataclasses.astuple(x) for x in js]
        assert [s.file for s in got[0][1][:1] + got[1][1][:1]] == ["a", "b"]


def test_diarizer_stream_matches_jax(diarizers):
    """Diarizer.stream fed 0.5 s pieces: the host-state and device-state
    sessions equal JAX's stream (1e-5)."""
    x = audio(16.0, 3)
    ref = diarizers[0].stream("low_latency", device_state=False)
    for i in range(0, len(x), 8000):
        ref.feed(x[i:i + 8000])
    ref.finish()
    for device_state in (None, True):
        s = diarizers[1].stream("low_latency", device_state=device_state)
        assert s.device_state is bool(device_state)
        for i in range(0, len(x), 8000):
            s.feed(x[i:i + 8000])
        s.finish()
        np.testing.assert_allclose(s.probs(), ref.probs(), atol=1e-5, rtol=0)


def test_align_matches_jax(diarizers):
    """Token timestamps of a narrow Transcriber (f32, 25 s) grouped into
    words, the TINY diarizer's segments on the same audio, then api.align:
    the same DiarizedTranscription as JAX's (words, speakers, utterances)."""
    jctx, tctx = contexts(NARROW_TS)
    x = audio(25.0, 2)
    jres = JF.whisper_full(jctx, JFullParams(print_progress=False, token_timestamps=True,
                                             temperature_inc=0.0), x)
    tres = TF.whisper_full(tctx, FullParams(print_progress=False, token_timestamps=True,
                                            temperature_inc=0.0), x)
    jwords = JAPI.words_from_result(jres, ctx=jctx)
    twords = TAPI.words_from_result(tres, ctx=tctx)
    _, jsegs = diarizers[0].diarize(x, stream_config="low_latency", median_win=3)
    _, tsegs = diarizers[1].diarize(x, stream_config="low_latency", median_win=3)
    assert [dataclasses.astuple(s) for s in tsegs] == [dataclasses.astuple(s) for s in jsegs]
    assert len({s.speaker for s in tsegs}) >= 2 and len(twords) > 3
    for opts in (None, TAPI.AlignmentOptions(fill_nearest=True, sentence_smoothing=False)):
        jopts = None if opts is None else JAPI.AlignmentOptions(**dataclasses.asdict(opts))
        got = TAPI.align(twords, tsegs, opts)
        ref = JAPI.align(jwords, jsegs, jopts)
        assert isinstance(got, TAPI.DiarizedTranscription)
        assert got.text == ref.text
        assert ([(w.word, w.start, w.end, w.speaker) for w in got.words]
                == [(w.word, w.start, w.end, w.speaker) for w in ref.words])
        np.testing.assert_allclose([w.probability for w in got.words],
                                   [w.probability for w in ref.words], rtol=1e-5)
        assert ([(u.speaker, u.text, u.start, u.end, len(u.words)) for u in got.segments]
                == [(u.speaker, u.text, u.start, u.end, len(u.words)) for u in ref.segments])
        assert any(w.speaker is not None for w in got.words)


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.mark.parametrize("preset", ["offline", "low_latency"])
def test_cli_rttm_matches_jax(model_file, tmp_path, capsys, preset):
    """cli/diarize.py --device cpu writes the RTTM file JAX's CLI writes,
    and prints the same probabilities."""
    wav = tmp_path / "call.wav"
    _write_wav(wav, audio(20.0, 1))
    args = ["-m", str(model_file), "-f", str(wav), "--preset", preset, "--print-probs"]
    assert JCLI.main(args + ["-o", str(tmp_path / "j.rttm")]) == 0
    jout = capsys.readouterr().out
    assert TCLI.main(args + ["-o", str(tmp_path / "t.rttm"), "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    text = (tmp_path / "t.rttm").read_text()
    assert text == (tmp_path / "j.rttm").read_text() and text.startswith("SPEAKER call 1 ")
    assert tout.replace("t.rttm", "j.rttm") == jout
    if preset == "offline":   # the default preset and output path (the wav's)
        assert TCLI.main(["-m", str(model_file), "-f", str(wav), "--device", "cpu"]) == 0
        assert (tmp_path / "call.rttm").read_text() == text
    assert TCLI.build_parser().parse_args(["-m", "a", "-f", "b"]).device == "cuda"
