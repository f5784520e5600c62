"""The port's streaming Whisper (decode/stream.py) and run-state files
(utils/state.py, utils/timings.py) against the JAX package on the CPU.

The stream runs the narrow f32 weights of `_torch_parity.contexts` (three
decoder layers), fed the same 0.5 s pieces on both sides, with
`no_fallback=True` (the server's /stream setting): a sampled fallback would
draw from torch's generator here and jax.random there. Audio seeds 3 (14 s, step
mode) and 1 (the speech spans of VAD mode) keep their JAX events when the
input is scaled by 1 +- 2^-20, 2^-16 and 2^-13.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.decode import stream as JS
from open_whisper_kit_tpu.models.silero import vad as JV
from open_whisper_kit_tpu.models.sortformer import streaming as JSS
from open_whisper_kit_tpu.utils import state as JST
from open_whisper_kit_tpu_torch.decode import stream as TS
from open_whisper_kit_tpu_torch.io import silero_writer as SW
from open_whisper_kit_tpu_torch.models.silero import vad as TV
from open_whisper_kit_tpu_torch.models.sortformer import streaming as TSS
from open_whisper_kit_tpu_torch.utils import state as TST
from open_whisper_kit_tpu_torch.utils import timings as TTM

from _torch_parity import NARROW_TS, audio, contexts

torch.set_num_threads(2)

PIECE = 8000          # 0.5 s of samples a feed


@pytest.fixture(scope="module")
def pair():
    return contexts(NARROW_TS)


def speech(seconds: float, spans, seed: int = 1) -> np.ndarray:
    """Silence with seeded noise (0.3 rms) over `spans` of (start, end) s."""
    rng = np.random.default_rng(seed)
    x = np.zeros(int(16000 * seconds), np.float32)
    for a, b in spans:
        x[int(a * 16000):int(b * 16000)] = rng.standard_normal(
            int(b * 16000) - int(a * 16000)) * 0.3
    return x


def events(evs):
    return [(e.text, e.t0, e.t1, e.final, e.speaker_turn_next, e.n_iter) for e in evs]


def run(st, samples, flush=True):
    out = []
    for i in range(0, len(samples), PIECE):
        out += st.feed(samples[i:i + PIECE])
    if flush:
        out += st.flush()
    return events(out)


def both(pair, samples, flush=True, **kw):
    """(JAX events, port events) of one stream over `samples`."""
    sp = dict(no_fallback=True, **kw)
    return (run(JS.StreamingTranscriber(pair[0], JS.StreamParams(**sp)), samples, flush),
            run(TS.StreamingTranscriber(pair[1], TS.StreamParams(**sp)), samples, flush))


@pytest.mark.parametrize("case", ["speech", "steady", "short", "dc", "no_filter"])
def test_high_pass_and_vad_simple_equal_jax(case):
    """The filter's samples and the gate's verdict, exactly as JAX's."""
    rng = np.random.default_rng(7)
    x = {"speech": np.concatenate([rng.standard_normal(16000) * 0.3,
                                   rng.standard_normal(16000) * 0.01]),
         "steady": np.sin(np.arange(32000) * 0.2) + rng.standard_normal(32000) * 0.1,
         "short": rng.standard_normal(8000),
         "dc": np.ones(32000) + rng.standard_normal(32000) * 1e-3,
         "no_filter": np.concatenate([rng.standard_normal(24000) * 0.2,
                                      np.zeros(8000)])}[case].astype(np.float32)
    cutoff = 0.0 if case == "no_filter" else 100.0
    if cutoff > 0:
        np.testing.assert_array_equal(TS.high_pass_filter(x, cutoff),
                                      JS.high_pass_filter(x, cutoff))
    for thold in (0.1, 0.6, 1.5):
        assert (TS.vad_simple(x, 1000, thold, cutoff)
                == JS.vad_simple(x, 1000, thold, cutoff))


@pytest.mark.parametrize("keep_context", [False, True])
def test_step_mode_events_equal_jax(pair, keep_context):
    """Step 3 s, length 10 s, keep 200 ms over 14 s and a flush: every
    event's text, times, commit flag and iteration as JAX's; with
    keep_context the committed tokens prompt the next steps."""
    jev, tev = both(pair, audio(14, 3), step_ms=3000, length_ms=10000, keep_ms=200,
                    no_context=not keep_context)
    assert tev == jev
    assert {e[3] for e in tev} == {True, False} and tev[-1][5] == 5


def test_vad_mode_events_equal_jax(pair):
    """VAD mode (step 0): the energy gate fires after each spoken span that
    a quiet second follows; the flush decodes the tail."""
    x = speech(14, ((0.5, 3.0), (5.0, 7.5), (10.5, 13.5)))
    jev, tev = both(pair, x, step_ms=0, length_ms=5000)
    assert tev == jev
    assert len(tev) >= 2 and all(e[3] for e in tev)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_stream_state_resumes_across_packages(pair, saved_by, tmp_path):
    """A StreamingTranscriber suspended mid-stream (keep_context on, so the
    state holds a prompt) by one package resumes in the other, with the
    events the saving package gives when it goes on."""
    sp = dict(step_ms=3000, length_ms=10000, keep_ms=200, no_fallback=True,
              no_context=False)
    x = audio(14, 3)
    cut = 13 * PIECE          # two steps: the second commits its tokens
    mods = {"jax": (JS, JST, pair[0]), "port": (TS, TST, pair[1])}
    S, ST, ctx = mods[saved_by]
    first = S.StreamingTranscriber(ctx, S.StreamParams(**sp))
    run(first, x[:cut], flush=False)
    assert first._prompt_tokens and len(first._old)
    ST.save_state(tmp_path / "stream.npz", stream=first, note="mid")
    S2, ST2, ctx2 = mods["port" if saved_by == "jax" else "jax"]
    resumed = S2.StreamingTranscriber(ctx2, S2.StreamParams(**sp))
    loaded = ST2.load_state(tmp_path / "stream.npz")
    assert loaded["note"] == "mid"
    ST2.restore(resumed, loaded["stream"])
    assert resumed.n_iter == first.n_iter
    assert resumed._prompt_tokens == first._prompt_tokens
    assert run(resumed, x[cut:]) == run(first, x[cut:])


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_silero_state_resumes_across_packages(saved_by, tmp_path):
    """The Silero LSTM state saved after one span continues the next span's
    probabilities in the other package (within the Silero parity test's
    1e-5); the port restores it on the model's device."""
    path = tmp_path / "silero-random.bin"
    SW.write_silero(path, SW.random_silero_tensors(seed=0))
    jvad, tvad = JV.SileroVAD.from_file(str(path)), TV.SileroVAD.from_file(str(path),
                                                                          device="cpu")
    x = speech(6, ((0.5, 2.0), (3.0, 5.5)))
    src, dst = (jvad, tvad) if saved_by == "jax" else (tvad, jvad)
    src_mod, dst_mod = (JST, TST) if saved_by == "jax" else (TST, JST)
    src.detect_speech(x[:48000])
    src_mod.save_state(tmp_path / "vad.npz", vad=src)
    dst_mod.restore(dst, dst_mod.load_state(tmp_path / "vad.npz")["vad"])
    if dst is tvad:
        assert tvad.h.device == tvad.device and tvad.h.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(dst.detect_speech(x[48000:], reset=False)),
                               np.asarray(src.detect_speech(x[48000:], reset=False)),
                               atol=1e-5, rtol=0)


def test_sortformer_stream_state_roundtrip_across_packages(tmp_path):
    """The AOSC state (speaker cache, FIFO, silence profile) written by one
    package reads back field for field in the other."""
    rng = np.random.default_rng(3)
    st = JSS.StreamState(16)
    st.spkcache = rng.standard_normal((12, 16)).astype(np.float32)
    st.spkcache_preds = rng.random((12, 4)).astype(np.float32)
    st.spkcache_preds_valid = True
    st.fifo = rng.standard_normal((5, 16)).astype(np.float32)
    st.fifo_preds = rng.random((5, 4)).astype(np.float32)
    st.mean_sil_emb = rng.standard_normal(16).astype(np.float32)
    st.n_sil_frames = 9
    JST.save_state(tmp_path / "aosc.npz", aosc=st)
    back = TSS.StreamState(16)
    TST.restore(back, TST.load_state(tmp_path / "aosc.npz")["aosc"])
    TST.save_state(tmp_path / "aosc2.npz", aosc=back)
    again = JSS.StreamState(16)
    JST.restore(again, JST.load_state(tmp_path / "aosc2.npz")["aosc"])
    for f in ("spkcache", "spkcache_preds", "fifo", "fifo_preds", "mean_sil_emb"):
        np.testing.assert_array_equal(getattr(back, f), getattr(st, f))
        np.testing.assert_array_equal(getattr(again, f), getattr(st, f))
    assert (back.n_sil_frames, back.spkcache_preds_valid) == (9, True)


def test_save_state_takes_tensors_and_rejects_unknown_objects(tmp_path):
    """Tensors are saved from the host; the layout reads back in JAX."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    TST.save_state(tmp_path / "t.npz", t=x, d={"a": [1, 2], "b": None})
    got = JST.load_state(tmp_path / "t.npz")
    np.testing.assert_array_equal(got["t"], x.numpy())
    assert got["d"] == {"a": [1, 2], "b": None}
    with pytest.raises(TypeError):
        TST.snapshot(object())


def test_timings_and_log_match_jax(pair):
    """print_timings' report and the log callback as JAX's; system_info
    names torch and the device count."""
    from open_whisper_kit_tpu.decode.full import TranscribeResult as JR
    from open_whisper_kit_tpu.decode.full import Timings as JT
    from open_whisper_kit_tpu.utils import timings as JTM
    from open_whisper_kit_tpu_torch.decode.full import Timings, TranscribeResult
    t = dict(t_mel_ms=1.5, t_encode_ms=20.25, t_decode_ms=7.0, t_sample_ms=3.0,
             n_encode=2, n_decode=9, n_sample=11)
    a, b = io.StringIO(), io.StringIO()
    TTM.print_timings(TranscribeResult(segments=[], timings=Timings(**t)), file=a)
    JTM.print_timings(JR(segments=[], timings=JT(**t)), file=b)
    assert a.getvalue() == b.getvalue()
    got = []
    TTM.log_set(lambda lvl, msg: got.append((lvl, msg)))
    TTM.log(TTM.LOG_LEVEL_WARN, "w")
    TTM.log_set(None)
    assert got == [(JTM.LOG_LEVEL_WARN, "w")]
    info = TTM.system_info()
    assert "torch = " in info and "devices = " in info
    sw = TTM.Stopwatch()
    with sw.measure():
        pass
    assert sw.count == 1 and sw.total_ms >= 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with TTM.profile_trace(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_stream_params_and_events_are_jax_s(pair):
    """StreamParams' defaults and StreamEvent's fields as JAX's."""
    assert dataclasses.asdict(TS.StreamParams()) == dataclasses.asdict(JS.StreamParams())
    assert ([f.name for f in dataclasses.fields(TS.StreamEvent)]
            == [f.name for f in dataclasses.fields(JS.StreamEvent)])
    st = TS.StreamingTranscriber(pair[1], TS.StreamParams(step_ms=1000, no_fallback=True))
    for _ in range(9):
        assert st.feed(np.zeros(1600, np.float32)) == []
    assert st.n_iter == 0


def test_step_mode_with_audio_ctx_equals_jax(pair):
    """audio_ctx 750 (half the window's positions, the encoder and the
    cross-attention at a shape of their own) in two steps and a flush."""
    jev, tev = both(pair, audio(6.5, 3), step_ms=3000, length_ms=10000, keep_ms=200,
                    audio_ctx=750)
    assert tev == jev and len(tev) >= 2
