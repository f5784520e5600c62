"""The port's device token loop (decode/device_loop.py) and window loop
(decode/device_windows.py) against the JAX package's, on the same weights,
mel and prompts (CPU, f32)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW_TS, audio, contexts
from open_whisper_kit_tpu.audio import mel as JMEL
from open_whisper_kit_tpu.decode import device_loop as JDL
from open_whisper_kit_tpu.decode import device_windows as JDW
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode.params import FullParams
from open_whisper_kit_tpu_torch.audio import mel as TMEL
from open_whisper_kit_tpu_torch.decode import device_loop as TDL
from open_whisper_kit_tpu_torch.decode import device_windows as TDW
from open_whisper_kit_tpu_torch.decode import full as TF

torch.set_num_threads(2)

N_MAX = 220


@pytest.fixture(scope="module")
def pair():
    return contexts(NARROW_TS)


def _tokens_equal(j, t, what):
    """Exact token equality; on failure name the first differing step."""
    j, t = np.asarray(j), np.asarray(t)
    if not np.array_equal(j, t):
        k = int(np.flatnonzero(j != t)[0])
        pytest.fail(f"{what}: first differing step {k}: jax {j[k]} port {t[k]}")


def _windows_inputs(jctx, tctx, seconds, seed):
    samples = audio(seconds, seed)
    return (JMEL.log_mel_spectrogram(samples, jctx.filters),
            TMEL.log_mel_spectrogram(samples, tctx.filters, "cpu"))


@pytest.mark.parametrize("no_timestamps", [False, True])
def test_decode_segment_matches_jax(pair, no_timestamps):
    jctx, tctx = pair
    jmel, tmel = _windows_inputs(jctx, tctx, 20, seed=21)
    _, jxk, jxv = jctx.encode_window(jmel.data, 0, 0)
    _, txk, txv = tctx.encode_window(tmel.data, 0, 0)
    v = jctx.vocab
    prompt = [v.token_sot] + ([v.token_not] if no_timestamps else [])
    p = FullParams(no_timestamps=no_timestamps)
    jtoks, t_real = JF._pad_prompt(jctx.cfg, prompt)
    ttoks, _ = TF._pad_prompt(tctx.cfg, prompt, "cpu")
    scal = (t_real, v.token_nosp, 0, jmel.n_len_org)
    jr = JDL.unpack_segment_result(JDL.pack_segment_result(JDL.decode_segment(
        jctx.cfg, jctx.rule_config, jctx.params["decoder"], jtoks, jxk, jxv,
        *jctx.rule_masks(p), jnp.asarray(scal, jnp.int32), n_max=N_MAX,
        no_timestamps=no_timestamps, cache_dtype=jnp.float32)), N_MAX)
    reads = TDL.HostReads()
    res = TDL.decode_segment(
        tctx.cfg, tctx.rule_config, tctx.params["decoder"], ttoks, txk, txv,
        *tctx.rule_masks(p), scal, n_max=N_MAX, reads=reads,
        no_timestamps=no_timestamps, cache_dtype=torch.float32)
    tr = TDL.unpack_segment_result(reads.fetch(TDL.pack_segment_result(res)), N_MAX)

    n = jr["n_tokens"]
    assert n > 0 and tr["n_tokens"] == n
    _tokens_equal(jr["tokens"], tr["tokens"], "tokens")
    _tokens_equal(jr["tid"], tr["tid"], "tid")
    for key in ("result_len", "seek_delta", "has_ts", "completed", "failed"):
        assert tr[key] == jr[key], key
    for key in ("p", "plog", "pt", "ptsum"):
        np.testing.assert_allclose(tr[key], jr[key], atol=1e-4, err_msg=key)
    np.testing.assert_allclose(tr["no_speech_prob"], jr["no_speech_prob"], atol=1e-5)
    np.testing.assert_allclose(tr["sum_logprobs_all"], jr["sum_logprobs_all"],
                               atol=1e-3)
    # done-flag polls every POLL tokens, plus the one packed result
    assert reads.n <= math.ceil(n / TDL.POLL) + 1


def test_machine_step_matches_jax():
    rng = np.random.default_rng(0)
    beg, eot = 50363, 50256
    for _ in range(300):
        tok = int(rng.choice([eot, beg, beg + rng.integers(1, 1501),
                              rng.integers(0, 50000)]))
        i = 219 if rng.random() < 0.2 else int(rng.integers(0, 220))
        seek = int(rng.integers(0, 6000))
        kw = dict(token_beg=beg, token_eot=eot, seek=seek,
                  seek_end=seek + int(rng.integers(0, 4000)), n_max=220,
                  max_tokens=int(rng.choice([0, 50])),
                  single_segment=bool(rng.random() < 0.2),
                  no_timestamps=bool(rng.random() < 0.2),
                  stub=bool(rng.random() < 0.1))
        st = (bool(rng.random() < 0.5), bool(rng.random() < 0.5),
              bool(rng.random() < 0.5), int(rng.integers(0, 3001)),
              int(rng.integers(0, i + 1)))
        jms, jc, jf = JDL.machine_step(
            JDL.MachineState(*(jnp.asarray(x) for x in st)), jnp.int32(tok),
            jnp.int32(i), **kw)
        tms, tc, tf = TDL.machine_step(
            TDL.MachineState(*(torch.tensor(x) for x in st)), torch.tensor(tok),
            i, **kw)
        got = [bool(tc), bool(tf)] + [int(x) for x in (
            tms.last_was_ts, tms.penult_was_ts, tms.has_ts, tms.seek_delta,
            tms.result_len)]
        want = [bool(jc), bool(jf)] + [int(x) for x in jms]
        assert got == want, (tok, i, st, kw)


def test_entropy_last32_matches_jax_and_host_score():
    rng = np.random.default_rng(1)
    for _ in range(40):
        toks = rng.integers(0, int(rng.integers(1, 12)), N_MAX)
        rl = int(rng.integers(0, N_MAX + 1))
        j = float(JDW._entropy_last32(jnp.asarray(toks, jnp.int32), jnp.int32(rl)))
        t = float(TDW._entropy_last32(torch.from_numpy(toks), torch.tensor(rl)))
        np.testing.assert_allclose(t, j, atol=1e-5)
        if rl:
            d = TF._DecoderState()
            d.tokens = [TF.TokenData(int(x), 0, 0.0, 0.0, 0.0, 0.0) for x in toks]
            d.result_len = rl
            TF._score_sequence(d, -1.0)
            np.testing.assert_allclose(t, d.entropy, atol=1e-5)


@pytest.mark.parametrize("fallback_available", [False, True])
def test_decode_windows_matches_jax(pair, fallback_available):
    """Up to K=8 windows of 65 s audio. The one allowed difference: a window
    failed by the entropy gate alone reports its true result_len in the
    port and the full sampled length in the JAX loop."""
    jctx, tctx = pair
    jmel, tmel = _windows_inputs(jctx, tctx, 65, seed=0)
    v, K, P = jctx.vocab, 8, 223
    iscal = [v.token_nosp, v.token_prev, 0, 0, jmel.n_len_org, 0]
    fscal = [-1.0, 2.4, 0.6]
    p = FullParams()
    kw = dict(prompt_init=(v.token_sot,), K=K, n_max=N_MAX, P=P,
              no_timestamps=False, window_frames=3000,
              fallback_available=fallback_available)
    flat, jpast = JDW.decode_windows_packed(
        jctx.cfg, jctx.rule_config, jctx.params["encoder"], jctx.params["decoder"],
        jmel.data, *jctx.rule_masks(p), jnp.zeros(P, jnp.int32),
        jnp.asarray(iscal, jnp.int32), jnp.asarray(fscal + [-1.0], jnp.float32), **kw)
    jr = JDW.unpack_windows_result(flat, K, N_MAX)
    reads = TDL.HostReads()
    res = TDW.decode_windows(
        tctx.cfg, tctx.rule_config, tctx.params["encoder"], tctx.params["decoder"],
        tmel.data, *tctx.rule_masks(p), torch.zeros(P, dtype=torch.long), iscal,
        fscal, reads=reads, **kw)
    tr = TDW.unpack_windows_result(reads.fetch(TDW.pack_windows_result(res)),
                                   res, K, N_MAX)

    for key in ("n_done", "fallback", "next_seek", "past_len"):
        assert tr[key] == jr[key], key
    assert tr["n_done"] > 0 or tr["fallback"]
    _tokens_equal(np.asarray(jpast), res.past_buf.numpy(), "rolling context")
    n_polls = 0
    for w in range(tr["n_done"]):
        n = int(jr["n_tokens"][w])
        n_polls += math.ceil(n / TDL.POLL)
        for key in ("seek", "seek_delta", "n_tokens", "is_no_speech"):
            assert tr[key][w] == jr[key][w], (key, w)
        _tokens_equal(jr["tokens"][w], tr["tokens"][w], f"window {w} tokens")
        _tokens_equal(jr["tid"][w], tr["tid"][w], f"window {w} tid")
        for key in ("p", "plog", "pt", "ptsum"):
            np.testing.assert_allclose(tr[key][w], jr[key][w], atol=1e-4)
        np.testing.assert_allclose(tr["no_speech_prob"][w], jr["no_speech_prob"][w],
                                   atol=1e-5)
        np.testing.assert_allclose(tr["avg_logprobs"][w], jr["avg_logprobs"][w],
                                   atol=1e-4)
        rl = int(tr["result_len"][w])
        if rl != jr["result_len"][w]:     # entropy-only failure
            assert jr["result_len"][w] == n and 32 < rl < n
            d = TF._DecoderState()
            d.tokens = [TF.TokenData(int(x), 0, 0.0, 0.0, 0.0, 0.0)
                        for x in tr["tokens"][w][:rl]]
            d.result_len = rl
            TF._score_sequence(d, -1.0)
            assert d.entropy < fscal[1]
    # per window: polls of the done flag + one control read; plus the result
    windows = tr["n_done"] + int(tr["fallback"])
    assert reads.n <= n_polls + N_MAX // TDL.POLL * int(tr["fallback"]) + windows + 1
