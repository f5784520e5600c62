"""The port's whisper_full and Transcriber against the JAX package, end to
end on seeded audio (CPU, f32), its options included."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW, NARROW_TS, audio, contexts, segments
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu_torch import Transcriber
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode.params import FullParams, SamplingStrategy

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def narrow():
    return contexts(NARROW)


@pytest.fixture(scope="module")
def narrow_ts():
    return contexts(NARROW_TS)


def _both(pair, samples, **kw):
    jctx, tctx = pair
    jp, tp = JFullParams(print_progress=False, **kw), FullParams(print_progress=False, **kw)
    jp.temperature_inc = tp.temperature_inc = 0
    reads0 = tctx.reads.n
    tres = TF.whisper_full(tctx, tp, samples)
    return JF.whisper_full(jctx, jp, samples), tres, tctx.reads.n - reads0


def _assert_same_segments(jres, tres):
    js, ts = segments(jres), segments(tres)
    assert len(js) == len(ts) > 0
    for k, (a, b) in enumerate(zip(js, ts)):
        if a[3] != b[3]:
            i = next(i for i, (x, y) in enumerate(zip(a[3], b[3])) if x != y)
            pytest.fail(f"segment {k}: first differing token {i}: jax {a[3][i]} "
                        f"port {b[3][i]}")
        assert a == b, f"segment {k}"
    for sj, st in zip(jres.segments, tres.segments):
        np.testing.assert_allclose(st.no_speech_prob, sj.no_speech_prob, atol=1e-5)
        for tj, tt in zip(sj.tokens, st.tokens):
            assert tt.tid == tj.tid
            np.testing.assert_allclose([tt.p, tt.plog, tt.pt, tt.ptsum],
                                       [tj.p, tj.plog, tj.pt, tj.ptsum], atol=1e-4)


@pytest.mark.parametrize("which", ["narrow", "narrow_ts"])
def test_whisper_full_matches_jax(which, request):
    """~65 s of seeded audio (3 windows) through the K-window loop with no
    fallback: token ids, segment t0/t1 and text exactly equal. `narrow` is
    forced to no_timestamps (2-layer decoder); `narrow_ts` keeps them."""
    jres, tres, reads = _both(request.getfixturevalue(which), audio(65, 0))
    _assert_same_segments(jres, tres)
    tm = tres.timings
    assert tm.n_encode == jres.timings.n_encode == 3
    # host reads on the K-window path: done-flag polls every POLL tokens and
    # one control read per window, one packed result per call
    assert reads <= tm.n_sample / 16 + 2 * tm.n_encode + 1
    assert reads * 4 < tm.n_sample


def test_one_window_loop_matches_jax(narrow_ts):
    """device_windows=0: one window per call through _device_greedy_window."""
    jres, tres, _ = _both(narrow_ts, audio(35, 3), device_windows=0)
    _assert_same_segments(jres, tres)


def test_host_stepped_greedy_matches_jax(narrow):
    """use_device_loops=False: the host-stepped loop, greedy at t=0."""
    jres, tres, _ = _both(narrow, audio(12, 4), use_device_loops=False)
    _assert_same_segments(jres, tres)


@pytest.fixture(scope="module")
def silero_path(tmp_path_factory):
    from open_whisper_kit_tpu_torch.io import silero_writer as SW
    path = tmp_path_factory.mktemp("vad") / "silero-random.bin"
    SW.write_silero(path, SW.random_silero_tensors(seed=0))
    return str(path)


@pytest.mark.parametrize("field,value", [
    ("strategy+ref_sampling", (SamplingStrategy.BEAM_SEARCH, True)),
    ("grammar_rules", "root ::= \"a\""),
    ("vad", True), ("token_timestamps", True), ("dtw_token_timestamps", True),
    ("ref_sampling", True),
    ("abort_callback", lambda: False),
    ("logits_filter_callback", lambda *a: None),
])
def test_unported_features_raise(narrow_ts, silero_path, field, value):
    """Each whisper_full option the port once refused, set alone (with the
    temperature fallback off but under ref_sampling, whose fallback draws
    are mt19937's on both sides): the same segments and token
    t0 / t1 / t_dtw and sampled-token count as the JAX package, on 25 s of audio
    (one window, six segments), with a grammar on 6 s, with VAD on speech
    spans between silences (the random
    Silero file's segments, spliced, times mapped back). Beams with
    ref_sampling take the mt19937 draws; the callbacks route the windows to
    the host-stepped loop; the logits filter is never called, as in JAX."""
    from open_whisper_kit_tpu.decode.params import SamplingStrategy as JStrategy
    fields = field.split("+")
    values = value if len(fields) > 1 else (value,)
    kw = dict(zip(fields, values))
    if "ref_sampling" not in kw:
        # the sampled fallback draws from torch's and JAX's own generators
        kw["temperature_inc"] = 0.0
    samples = audio(25, 2)
    if field == "vad":
        kw["vad_model_path"] = silero_path
        rng = np.random.default_rng(1)
        samples = np.zeros(16000 * 32, np.float32)
        for lo, hi in ((2, 12), (15, 19), (22, 31)):
            samples[lo * 16000:hi * 16000] = rng.standard_normal((hi - lo) * 16000) * 0.3
    elif field == "grammar_rules":
        # no token of the synthetic vocabulary spells "a": every text token
        # takes the penalty, and each window ends on timestamps alone
        samples = audio(6, 2)
    jkw = dict(kw, strategy=JStrategy.BEAM_SEARCH) if "strategy" in kw else kw
    jres = JF.whisper_full(narrow_ts[0], JFullParams(print_progress=False, **jkw), samples)
    tres = TF.whisper_full(narrow_ts[1], FullParams(print_progress=False, **kw), samples)
    assert segments(tres) == segments(jres)
    # (n_encode is not compared: the port also counts the in-loop encoder
    # pass of a window the K-window loop hands to the fallback)
    assert tres.timings.n_sample == jres.timings.n_sample
    assert len(tres.segments) > 0 or (field == "grammar_rules" and tres.timings.n_encode > 1)
    assert ([(t.t0, t.t1, t.t_dtw) for s in tres.segments for t in s.tokens]
            == [(t.t0, t.t1, t.t_dtw) for s in jres.segments for t in s.tokens])


def test_import_leaves_jax_out():
    code = ("import sys, open_whisper_kit_tpu_torch, open_whisper_kit_tpu_torch.api; "
            "import open_whisper_kit_tpu_torch.decode.full; "
            "import open_whisper_kit_tpu_torch.decode.device_beam; "
            "import open_whisper_kit_tpu_torch.models.llama, open_whisper_kit_tpu_torch.cli.lsp; "
            "import open_whisper_kit_tpu_torch.models.whisper.export; "
            "import open_whisper_kit_tpu_torch.parallel.mesh, "
            "open_whisper_kit_tpu_torch.ops.decode_tp, "
            "open_whisper_kit_tpu_torch.tools.launch_multihost; "
            "import open_whisper_kit_tpu_torch.examples.talk, "
            "open_whisper_kit_tpu_torch.examples.voice_command, "
            "open_whisper_kit_tpu_torch.examples.wchess, "
            "open_whisper_kit_tpu_torch.examples.diarized_transcript; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'open_whisper_kit_tpu.')) "
            "or m == 'open_whisper_kit_tpu' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"


def test_port_sources_never_import_jax():
    banned = re.compile(r"^\s*(from|import)\s+(jax|open_whisper_kit_tpu)\b")
    for path in (REPO / "open_whisper_kit_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not banned.match(line), f"{path}: {line}"


@pytest.mark.parametrize("name", ["decode/tokenizer.py", "decode/params.py",
                                  "io/quant.py", "io/_iq_tables.py",
                                  "io/ggml_whisper.py", "decode/grammar.py",
                                  "utils/mt19937.py", "timestamps/energy.py",
                                  "vad/segments.py", "io/ggml_silero.py",
                                  "io/gguf.py", "models/sortformer/mel_fb.py",
                                  "align/rttm.py", "align/aligner.py",
                                  "audio/native.py", "cli/outputs.py",
                                  "decode/stream.py", "models/llama/tokenizer.py"])
def test_copied_host_modules_match_their_source(name):
    src = (REPO / "open_whisper_kit_tpu" / name).read_text()
    copy = (REPO / "open_whisper_kit_tpu_torch" / name).read_text()
    assert copy.splitlines()[0].startswith("# Source: open_whisper_kit_tpu/")
    assert copy.split("\n", 1)[1] == src


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transcriber(preset="tiny.en", dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("entry", ["Transcriber(preset)", "Transcriber(model_path)",
                                   "WhisperContext", "from_preset", "from_file",
                                   "from_buffer", "Diarizer", "serve", "ServerState",
                                   "server main", "compat use_gpu", "compat VAD",
                                   "compat bench", "whisper-cli", "whisper-stream",
                                   "whisper-bench", "vad-segments", "diarize-cli",
                                   "LlamaContext", "whisper-lsp", "talk", "voice_command",
                                   "wchess", "diarized_transcript", "make_mesh",
                                   "launch_multihost"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """With no `device`, every entry point targets the card: on a machine
    without CUDA it raises before building anything, and never falls back
    to the CPU."""
    import inspect
    from open_whisper_kit_tpu_torch import compat as TC
    from open_whisper_kit_tpu_torch.api import Diarizer
    from open_whisper_kit_tpu_torch.cli import bench as TCB
    from open_whisper_kit_tpu_torch.cli import diarize as TCD
    from open_whisper_kit_tpu_torch.cli import lsp as TCL
    from open_whisper_kit_tpu_torch.cli import main as TCM
    from open_whisper_kit_tpu_torch.cli import stream as TCS
    from open_whisper_kit_tpu_torch.cli import vad_segments as TCV
    from open_whisper_kit_tpu_torch.examples import diarized_transcript as TED
    from open_whisper_kit_tpu_torch.examples import talk as TET
    from open_whisper_kit_tpu_torch.examples import voice_command as TEV
    from open_whisper_kit_tpu_torch.examples import wchess as TEW
    from open_whisper_kit_tpu_torch.models.llama import model as TLM
    from open_whisper_kit_tpu_torch.models.sortformer import model as TSM
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.io import ggml_writer as TW
    from open_whisper_kit_tpu_torch.io import silero_writer as SW
    from open_whisper_kit_tpu_torch.parallel import mesh as TX
    from open_whisper_kit_tpu_torch.server import http_server as TH
    from open_whisper_kit_tpu_torch.tools import launch_multihost as TLH
    for fn in (TX.make_mesh, TX.make_mesh3, Transcriber.__init__, TF.WhisperContext.__init__,
               TF.WhisperContext.from_preset, TF.WhisperContext.from_file,
               TF.WhisperContext.from_buffer, Diarizer.__init__, TH.serve,
               TH.ServerState.__init__, TC.whisper_bench_memcpy_str,
               TC.whisper_bench_ggml_mul_mat_str, TLM.LlamaContext.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert TC.WhisperContextParams().use_gpu and TC.WhisperVadContextParams().use_gpu
    assert TCM.device_from_args(TCM.build_parser().parse_args([])) == "cuda:0"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TM.WhisperConfig(*NARROW)
    path = tmp_path / "stub.bin"
    TW.write_checkpoint(path, TW.WhisperHParams(*NARROW, ftype=1, qntvr=0),
                        JF._synthetic_mel_filters(80), [b"a"], {})
    calls = {
        "Transcriber(preset)": lambda: Transcriber(preset="tiny.en"),
        "Transcriber(model_path)": lambda: Transcriber(model_path=path),
        "WhisperContext": lambda: TF.WhisperContext(
            cfg, {"encoder": {}, "decoder": {}}, None, None, n_loaded=1),
        "from_preset": lambda: TF.WhisperContext.from_preset("tiny.en"),
        "from_file": lambda: TF.WhisperContext.from_file(path),
        "from_buffer": lambda: TF.WhisperContext.from_buffer(path.read_bytes()),
        "Diarizer": lambda: Diarizer(cfg=TSM.SortformerConfig(), params={}),
        "serve": lambda: TH.serve(str(path), port=0),
        "ServerState": lambda: TH.ServerState(str(path)),
        "server main": lambda: TH.main(["-m", str(path), "--port", "0"]),
        "compat use_gpu": lambda: TC.whisper_init_from_file_with_params(str(path)),
        "compat VAD": lambda: TC.whisper_vad_init_from_file_with_params(str(silero)),
        "compat bench": lambda: TC.whisper_bench_memcpy_str(),
        "whisper-cli": lambda: TCM.main(["-m", str(path), "-f", str(wav)]),
        "whisper-stream": lambda: TCS.main(["-m", str(path), "--input-wav", str(wav)]),
        "whisper-bench": lambda: TCB.main(["-m", str(path)]),
        "vad-segments": lambda: TCV.main(["-vm", str(silero), "-f", str(wav)]),
        "diarize-cli": lambda: TCD.main(["-m", str(tmp_path / "none.gguf"), "-f", str(wav)]),
        "LlamaContext": lambda: TLM.LlamaContext(
            cfg=TLM.LlamaConfig(320, 64, 64, 1, 4, 2, 128), params={}, vocab=None),
        "whisper-lsp": lambda: TCL.main(["-m", str(path)]),
        "talk": lambda: TET.main(["-mw", str(path), "-ml", str(tmp_path / "none.gguf"),
                                  "--input-wav", str(wav)]),
        "voice_command": lambda: TEV.main(["-m", str(path), "--input-wav", str(wav)]),
        "wchess": lambda: TEW.main(["-m", str(path), "--audio", str(wav)]),
        "diarized_transcript": lambda: TED.main([str(wav), "-m", str(path), "-dm",
                                                 str(tmp_path / "none.gguf")]),
        "make_mesh": lambda: TX.make_mesh(),
        "launch_multihost": lambda: TLH.main(["--coordinator", "127.0.0.1:1", "--num-hosts",
                                              "1", "--host-id", "0", "--model", str(path)]),
    }
    silero = tmp_path / "silero.bin"
    SW.write_silero(silero, SW.random_silero_tensors(seed=0))
    wav = tmp_path / "a.wav"
    import wave
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(b"\0\0" * 16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_transcriber_detect_language_and_tokenize_match_jax():
    """The public facade on the multilingual `tiny` preset: same weights as
    the JAX package's preset, same language probabilities."""
    from open_whisper_kit_tpu import api as JAPI
    tr = Transcriber(preset="tiny", dtype=torch.float32, device="cpu", seed=0)
    jt = JAPI.Transcriber(preset="tiny", dtype=jnp.float32)
    samples = audio(4, 9)
    lang, probs = tr.detect_language(samples)
    jlang, jprobs = jt.detect_language(samples)
    assert lang == jlang
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    for text in ("<12><7>", "hello world", ""):
        assert tr.tokenize(text) == jt.tokenize(text)
    assert tr.is_multilingual and tr.model_type == "tiny"
    # VAD leaves the lockstep route for whisper_full per file, which needs a
    # Silero model, as in the JAX package
    for t, P in ((tr, FullParams), (jt, JFullParams)):
        with pytest.raises(ValueError, match="vad=True requires vad_model_path"):
            t.transcribe_batch([samples, samples], P(print_progress=False, vad=True))


def test_transcribe_wav_path(tmp_path, narrow):
    """transcribe() from a WAV file equals whisper_full on its samples."""
    import wave
    samples = audio(3, 5)
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    tr = Transcriber.__new__(Transcriber)
    tr.ctx = narrow[1]
    p = FullParams(print_progress=False, temperature_inc=0)
    got = tr.transcribe(path, p)
    want = TF.whisper_full(narrow[1], p, pcm.astype(np.float32) / 32768.0)
    assert segments(got) == segments(want) and len(got.segments) > 0


def test_wrap_segment_matches_jax(narrow):
    jctx, tctx = narrow
    ids = [5, 17, 220, 31, 1000, 50256, 48, 49]
    for max_len, split in ((6, False), (9, True), (100, False)):
        results = []
        for mod, ctx in ((JF, jctx), (TF, tctx)):
            toks = [mod.TokenData(i, i, 0.5, -0.7, 0.1, 0.2, t0=10 * k, t1=10 * k + 9)
                    for k, i in enumerate(ids)]
            res = mod.TranscribeResult(segments=[mod.Segment(0, 90, "x", 0.1, toks)])
            n = mod._wrap_segment(ctx, res, max_len, split)
            results.append((n, [(s.t0, s.t1, s.text, [t.id for t in s.tokens])
                                for s in res.segments]))
        assert results[0] == results[1]
