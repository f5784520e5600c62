"""The port's whisper.h surface (compat.py) against the JAX package's on the
CPU, on the narrow f32 weights of `_torch_parity.contexts` (three decoder
layers) written as a ggml-bin. The 25 s whisper_full request (audio seed
2, six segments) keeps its JAX transcript when the input is scaled by
1 +- 2^-20, 2^-16 and 2^-13.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import open_whisper_kit_tpu.compat as J
import open_whisper_kit_tpu_torch.compat as T
from open_whisper_kit_tpu_torch.parallel import dp as TDP

from _torch_parity import audio, write_checkpoint

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return str(write_checkpoint(tmp_path_factory.mktemp("compat") / "narrow-f32.bin"))


@pytest.fixture(scope="module")
def ctxs(model):
    return (J.whisper_init_from_file_with_params(model, J.WhisperContextParams(dtype=jnp.float32)),
            T.whisper_init_from_file_with_params(
                model, T.WhisperContextParams(use_gpu=False, dtype=torch.float32)))


def test_every_jax_symbol_exists(ctxs):
    """The port names every whisper_* function and constant of JAX's
    compat (the 123 whisper.h symbols and the extras)."""
    names = [n for n in dir(J) if n.startswith(("whisper_", "WHISPER_"))]
    assert len([n for n in names if callable(getattr(J, n))]) >= 123
    assert [n for n in names if not hasattr(T, n)] == []
    for n in names:
        if n.startswith("WHISPER_") and not n.startswith("WHISPER_SAMPLING"):
            assert getattr(T, n) == getattr(J, n), n


def test_context_params_pick_the_device(ctxs):
    """use_gpu / gpu_device pick the torch device as whisper.cpp does; the
    VAD context params likewise."""
    assert ctxs[1].ctx.device == torch.device("cpu")
    assert T._device(True, 0) == "cuda:0" and T._device(True, 2) == "cuda:2"
    assert T._device(False, 3) == "cpu"
    assert T.whisper_context_default_params().use_gpu
    assert T.whisper_vad_default_context_params().use_gpu


def test_model_dimensions_tokens_and_languages_equal_jax(ctxs):
    jc, tc = ctxs
    for name in dir(J):
        if name.startswith(("whisper_n_", "whisper_model_", "whisper_token_")) and \
                name not in ("whisper_token_lang", "whisper_token_to_str") and \
                not name.endswith("_from_state"):
            assert getattr(T, name)(tc) == getattr(J, name)(jc), name
    assert T.whisper_is_multilingual(tc) == J.whisper_is_multilingual(jc)
    for i in (0, 1, 5, 99):
        assert T.whisper_token_lang(tc, i) == J.whisper_token_lang(jc, i)
        assert T.whisper_lang_str(i) == J.whisper_lang_str(i)
        assert T.whisper_lang_str_full(i) == J.whisper_lang_str_full(i)
    assert T.whisper_lang_str_full(1000) == "??"
    assert T.whisper_lang_max_id() == J.whisper_lang_max_id() == 99
    for lang in ("en", "spanish", "de"):
        assert T.whisper_lang_id(lang) == J.whisper_lang_id(lang)
    toks = T.whisper_tokenize(tc, "<12><400> <7>")
    assert toks == J.whisper_tokenize(jc, "<12><400> <7>")
    assert ([T.whisper_token_to_str(tc, t) for t in toks + [12, 400, 50257, 50363]]
            == [J.whisper_token_to_str(jc, t) for t in toks + [12, 400, 50257, 50363]])
    assert T.whisper_version() == J.whisper_version()


def test_pcm_to_mel_encode_decode_and_logits_equal_jax(ctxs):
    """The low-level state path: the mel, then the logits of a one-token and
    a three-token decode through the state's KV cache, within the model
    tests' 1e-4."""
    jc, tc = ctxs
    pcm = audio(3, 3)
    for c, M in ((jc, J), (tc, T)):
        assert M.whisper_pcm_to_mel(c, pcm, len(pcm)) == 0
        assert M.whisper_encode(c, 0) == 0
    assert T.whisper_n_len(tc) == J.whisper_n_len(jc) > 0
    np.testing.assert_allclose(tc.state.mel.ref_layout(), jc.state.mel.ref_layout(),
                               atol=1e-5, rtol=0)
    sot = T.whisper_token_sot(tc)
    for toks, n_past in (([sot], 0), ([50259, 50359, 400], 1)):
        for c, M in ((jc, J), (tc, T)):
            assert M.whisper_decode(c, toks, len(toks), n_past) == 0
        tl, jl = T.whisper_get_logits(tc), J.whisper_get_logits(jc)
        assert tl.shape == jl.shape == (len(toks), 51864)
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    st = T.whisper_init_state(tc)
    assert T.whisper_decode_with_state(tc, st, [sot]) == -1      # not encoded
    assert T.whisper_encode_with_state(tc, st, 0) == -1          # no mel


def test_set_mel_roundtrip(ctxs):
    tc = ctxs[1]
    state = T.whisper_init_state(tc)
    pcm = audio(1, 4)
    T.whisper_pcm_to_mel_with_state(tc, state, pcm, len(pcm))
    n_len = T.whisper_n_len_from_state(state)
    flat = state.mel.ref_layout().reshape(-1)
    state2 = T.whisper_init_state(tc)
    assert T.whisper_set_mel_with_state(tc, state2, flat, n_len,
                                        T.whisper_model_n_mels(tc)) == 0
    np.testing.assert_array_equal(state2.mel.data[:n_len].numpy(),
                                  state.mel.data[:n_len].numpy())
    assert T.whisper_set_mel_with_state(tc, state2, flat, n_len, 3) == -1


def test_full_and_every_getter_equal_jax(ctxs):
    """whisper_full on 25 s, then every segment and token getter, on the
    context and from the state: ids, texts and times exact, probabilities
    within 1e-5."""
    jc, tc = ctxs
    x = audio(25, 2)
    for c, M in ((jc, J), (tc, T)):
        p = M.whisper_full_default_params(M.WHISPER_SAMPLING_GREEDY)
        p.print_progress, p.temperature_inc = False, 0.0
        assert M.whisper_full(c, p, x, len(x)) == 0
    n = T.whisper_full_n_segments(tc)
    assert n == J.whisper_full_n_segments(jc) >= 4
    assert T.whisper_full_lang_id(tc) == J.whisper_full_lang_id(jc)
    exact = ("text", "t0", "t1", "speaker_turn_next")
    for i in range(n):
        for g in exact:
            f = f"whisper_full_get_segment_{g}"
            assert getattr(T, f)(tc, i) == getattr(J, f)(jc, i), (f, i)
            assert (getattr(T, f + "_from_state")(tc.state, i)
                    == getattr(J, f + "_from_state")(jc.state, i))
        assert abs(T.whisper_full_get_segment_no_speech_prob(tc, i)
                   - J.whisper_full_get_segment_no_speech_prob(jc, i)) <= 1e-5
        nt = T.whisper_full_n_tokens(tc, i)
        assert nt == J.whisper_full_n_tokens(jc, i) == T.whisper_full_n_tokens_from_state(
            tc.state, i)
        for j in range(nt):
            assert T.whisper_full_get_token_id(tc, i, j) == J.whisper_full_get_token_id(jc, i, j)
            assert (T.whisper_full_get_token_text(tc, i, j)
                    == J.whisper_full_get_token_text_from_state(jc, jc.state, i, j))
            assert abs(T.whisper_full_get_token_p_from_state(tc.state, i, j)
                       - J.whisper_full_get_token_p(jc, i, j)) <= 1e-5
            td, jd = (dataclasses.asdict(T.whisper_full_get_token_data(tc, i, j)),
                      dataclasses.asdict(J.whisper_full_get_token_data_from_state(jc.state, i, j)))
            assert {k: td[k] for k in ("id", "tid", "t0", "t1", "t_dtw")} == \
                {k: jd[k] for k in ("id", "tid", "t0", "t1", "t_dtw")}
            for k in ("p", "plog", "pt", "ptsum"):
                assert abs(td[k] - jd[k]) <= 1e-5, k
    t = T.whisper_get_timings(tc)
    assert isinstance(t, T.WhisperTimings) and t.decode_ms > 0
    T.whisper_print_timings(tc)
    T.whisper_reset_timings(tc)
    assert T.whisper_get_timings(tc).decode_ms == 0


def test_lang_auto_detect_equals_jax(ctxs):
    jc, tc = ctxs
    x = audio(5, 4)
    jp, tp = np.zeros(100, np.float64), np.zeros(100, np.float64)
    lid = T.whisper_lang_auto_detect(tc, 0, lang_probs=tp, samples=x)
    assert lid == J.whisper_lang_auto_detect(jc, 0, lang_probs=jp, samples=x)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)
    assert T.whisper_lang_auto_detect_with_state(tc, T.whisper_init_state(tc), 0) == -6


def test_no_state_buffer_and_loader_inits(model):
    """*_no_state contexts need an explicit state; buffer and loader inits
    load the file's weights."""
    cp = T.WhisperContextParams(use_gpu=False, dtype=torch.float32)
    ns = T.whisper_init_from_file_with_params_no_state(model, cp)
    with pytest.raises(ValueError):
        T.whisper_n_len(ns)
    st = T.whisper_init_state(ns)
    x = audio(2, 1)
    p = T.whisper_full_default_params()
    p.print_progress, p.temperature_inc = False, 0.0
    assert T.whisper_full_with_state(ns, st, p, x, len(x)) == 0
    data = open(model, "rb").read()
    for c in (T.whisper_init_from_buffer_with_params(data, cp),
              T.whisper_init_with_params(data, cp)):
        assert T.whisper_full_with_state(c, c.state, p, x) == 0
        assert ([s.text for s in c.state.result.segments]
                == [s.text for s in st.result.segments])
        assert c.hparams.ftype == 0 and T.whisper_model_ftype(c) == 0
    T.whisper_free_state(st)
    assert T.whisper_full_n_segments_from_state(st) == 0
    assert T.whisper_ctx_init_openvino_encoder(ns) == 1


def test_full_parallel_equals_direct(ctxs):
    tc = ctxs[1]
    x = audio(8, 5)
    p = T.whisper_full_default_params()
    p.print_progress, p.temperature_inc = False, 0.0
    assert T.whisper_full_parallel(tc, p, x, len(x), 2) == 0
    want = TDP.full_parallel(tc.ctx, p, x, 2)
    assert [(s.t0, s.t1, s.text) for s in tc.result.segments] == \
        [(s.t0, s.t1, s.text) for s in want.segments]


def test_vad_surface_equals_jax(tmp_path):
    from open_whisper_kit_tpu_torch.io import silero_writer as SW
    path = str(tmp_path / "silero.bin")
    SW.write_silero(path, SW.random_silero_tensors(seed=0))
    jv = J.whisper_vad_init_from_file_with_params(path, J.whisper_vad_default_context_params())
    tv = T.whisper_vad_init_from_file_with_params(path, T.WhisperVadContextParams(use_gpu=False))
    assert tv.vad.device == torch.device("cpu")
    rng = np.random.default_rng(2)
    x = np.zeros(16000 * 8, np.float32)
    for a, b in ((1, 3.5), (5, 7)):
        x[a * 16000:int(b * 16000)] = rng.standard_normal(int(b * 16000) - a * 16000) * 0.3
    for vc, M in ((jv, J), (tv, T)):
        assert M.whisper_vad_detect_speech(vc, x, len(x))
    assert T.whisper_vad_n_probs(tv) == J.whisper_vad_n_probs(jv) == 250
    np.testing.assert_allclose(T.whisper_vad_probs(tv), J.whisper_vad_probs(jv),
                               atol=1e-5, rtol=0)
    tsegs = T.whisper_vad_segments_from_samples(tv, T.whisper_vad_default_params(), x)
    jsegs = J.whisper_vad_segments_from_samples(jv, J.whisper_vad_default_params(), x)
    n = T.whisper_vad_segments_n_segments(tsegs)
    assert n == J.whisper_vad_segments_n_segments(jsegs) >= 1
    for i in range(n):
        assert (T.whisper_vad_segments_get_segment_t0(tsegs, i),
                T.whisper_vad_segments_get_segment_t1(tsegs, i)) == \
            (J.whisper_vad_segments_get_segment_t0(jsegs, i),
             J.whisper_vad_segments_get_segment_t1(jsegs, i))
    for vc, M in ((jv, J), (tv, T)):
        M.whisper_vad_reset_state(vc)
        M.whisper_vad_detect_speech_stateful(vc, x[:64000])
        M.whisper_vad_detect_speech_stateful(vc, x[64000:])
    assert T.whisper_vad_n_probs(tv) == 250
    np.testing.assert_allclose(T.whisper_vad_probs(tv), J.whisper_vad_probs(jv),
                               atol=1e-5, rtol=0)
    tv2 = T.whisper_vad_init_with_params(open(path, "rb").read(),
                                         T.WhisperVadContextParams(use_gpu=False))
    assert tv2.vad.device == torch.device("cpu")
    T.whisper_vad_free_segments(tsegs)
    assert T.whisper_vad_segments_n_segments(tsegs) == 0


def test_bench_strings_and_system_info():
    """The bench helpers time copies and torch.matmul on the device they
    are given (the CPU here); system info names torch."""
    s = T.whisper_bench_memcpy_str(device="cpu")
    assert s.count("GB/s") == 2
    m = T.whisper_bench_ggml_mul_mat_str(sizes=(64,), reps=2, device="cpu")
    assert "F32" in m and "BF16" in m and "GFLOPS" in m
    assert "torch = " in T.whisper_print_system_info()
    logs = []
    T.whisper_log_set(lambda lvl, msg, ud: logs.append((lvl, msg, ud)), "u")
    from open_whisper_kit_tpu_torch.utils import timings as TM
    TM.log(TM.LOG_LEVEL_INFO, "x")
    T.whisper_log_set(None)
    assert logs == [(TM.LOG_LEVEL_INFO, "x", "u")]
