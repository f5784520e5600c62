"""The port's whisper_full options against the JAX package (CPU, f32):
grammars in the on-device loop and host-stepped, ref_sampling's mt19937
draws, the abort and logits-filter callbacks, token-level and DTW
timestamps with the cross-attention probabilities behind them, the Silero
VAD prefilter (on a random-weight Silero file both loaders read), and
words_from_result.

The narrow random-weight models' transcripts hardly depend on the noise
they are given: 25 s of audio gives one window of six two-token segments,
30 s two windows and 74 segments. The ref_sampling requests keep their JAX
transcripts when the input is scaled by 1 +- 2^-20, 2^-16 and 2^-13 (audio
seeds 0-3 alike)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW_TS, audio, contexts, segments
from open_whisper_kit_tpu import api as JAPI
from open_whisper_kit_tpu.decode import device_loop as JDL
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode import grammar as JG
from open_whisper_kit_tpu.decode import tokenizer as JTOK
from open_whisper_kit_tpu.decode.params import BeamSearchParams as JBeam
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu.decode.params import SamplingStrategy as JStrategy
from open_whisper_kit_tpu.decode.params import VadParams as JVadParams
from open_whisper_kit_tpu.models.silero import vad as JV
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.utils import mt19937 as JMT
from open_whisper_kit_tpu.vad import segments as JVS
from open_whisper_kit_tpu_torch import api as TAPI
from open_whisper_kit_tpu_torch.decode import device_loop as TDL
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import grammar as TG
from open_whisper_kit_tpu_torch.decode import tokenizer as TTOK
from open_whisper_kit_tpu_torch.decode.params import (BeamSearchParams, FullParams,
                                                      SamplingStrategy, VadParams)
from open_whisper_kit_tpu_torch.io import silero_writer as SW
from open_whisper_kit_tpu_torch.models.silero import vad as TV
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.utils import mt19937 as TMT
from open_whisper_kit_tpu_torch.vad import segments as TVS

torch.set_num_threads(2)

SMALL_GRAMMAR = 'root ::= "<14444>" | "<2>" | "<777>" "<8>"'
# two automaton states that each allow (nearly) every token: 100513
# transitions, past build_token_dfa's budget of 100k, so host-stepped
BIG_GRAMMAR = 'root ::= "<" [0-9]+ ">" ("<" [1-9] [0-9]* ">")*'
TOKENS = [b"<%d>" % i for i in range(50257)]


@pytest.fixture(scope="module")
def pair():
    return contexts(NARROW_TS)


@pytest.fixture(scope="module")
def silero_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("silero") / "silero-random.bin"
    SW.write_silero(path, SW.random_silero_tensors(seed=0))
    return str(path)


def speech(seconds: float, spans, seed: int = 1) -> np.ndarray:
    """Silence with seeded noise (0.3 rms) over `spans` of (start, end) s."""
    rng = np.random.default_rng(seed)
    x = np.zeros(int(16000 * seconds), np.float32)
    for a, b in spans:
        x[int(a * 16000):int(b * 16000)] = rng.standard_normal(
            int(b * 16000) - int(a * 16000)) * 0.3
    return x


def both(pair, samples, jkw=None, tkw=None, **kw):
    """(JAX result, port result) of whisper_full with the same options;
    temperature_inc 0 unless given."""
    kw.setdefault("temperature_inc", 0.0)
    jp = JFullParams(print_progress=False, **kw, **(jkw or {}))
    tp = FullParams(print_progress=False, **kw, **(tkw or {}))
    return JF.whisper_full(pair[0], jp, samples), TF.whisper_full(pair[1], tp, samples)


def token_times(res):
    return [(t.id, t.t0, t.t1, t.t_dtw) for s in res.segments for t in s.tokens]


def test_mt19937_known_vector():
    """std::mt19937's required 10000th output from the default seed, and the
    copy's draws and discrete_distribution picks equal to the JAX package's."""
    rng = TMT.MT19937()
    for _ in range(9999):
        rng.draw()
    assert rng.draw() == 4123659995
    a, b = TMT.MT19937(7), JMT.MT19937(7)
    assert [a.draw() for _ in range(700)] == [b.draw() for _ in range(700)]
    w = np.random.default_rng(0).random(300).astype(np.float32)
    assert (TMT.DiscreteDistribution(w).draw_k(TMT.MT19937(3), 50)
            == JMT.DiscreteDistribution(w).draw_k(JMT.MT19937(3), 50))


def test_grammar_dfa_and_device_ops_match_jax():
    """build_token_dfa's tables equal the JAX package's on the synthetic
    vocabulary, and GrammarOps' penalty rows and steps equal JAX's
    grammar_mask_row / grammar_step along an accepted path and after a
    rejected token (the dead state)."""
    jv, tv = (m.build_vocab(TOKENS, 51864) for m in (JTOK, TTOK))
    jd = JG.build_token_dfa(JG.Grammar.from_gbnf(SMALL_GRAMMAR), jv)
    td = TG.build_token_dfa(TG.Grammar.from_gbnf(SMALL_GRAMMAR), tv)
    for f in ("allowed", "nxt", "cand", "skip"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f), err_msg=f)
    assert td.dead == jd.dead and td.n_states >= 4
    jops, tops = JDL.GrammarOps.from_dfa(jd, 100.0), TDL.GrammarOps.from_dfa(td, 100.0, "cpu")
    for path in ([777, 8, 50, 3], [14444, 2], [5, 777]):
        js, ts = jnp.int32(0), torch.zeros((), dtype=torch.long)
        for tok in path + [tv.token_eot]:
            np.testing.assert_array_equal(TDL.grammar_mask_row(tops, ts).numpy(),
                                          np.asarray(JDL.grammar_mask_row(jops, js)))
            js = JDL.grammar_step(jops, js, jnp.int32(tok))
            ts = TDL.grammar_step(tops, ts, torch.tensor(tok))
            assert int(ts) == int(js)


def test_grammar_in_the_device_loop_matches_jax(pair, monkeypatch):
    """A grammar whose automaton fits runs in the on-device greedy loop (the
    port routes it there, GrammarOps given) with JAX's token ids, and reads
    the host exactly as often as that loop does without a grammar: per
    window the done-flag polls every POLL tokens and one packed result."""
    seen = []
    real = TDL.decode_segment

    def recording(*a, **k):
        res = real(*a, **k)
        seen.append((k.get("grammar"), res))
        return res
    monkeypatch.setattr(TDL, "decode_segment", recording)
    samples = audio(25, 2)
    for g in (None, SMALL_GRAMMAR):
        r0, n0 = pair[1].reads.n, len(seen)
        jres, tres = both(pair, samples, grammar_rules=g, device_windows=0)
        assert segments(tres) == segments(jres) and len(tres.segments) > 0
        windows = seen[n0:]
        assert windows and all((w is None) == (g is None) for w, _ in windows)
        assert all(isinstance(w, TDL.GrammarOps) for w, _ in windows if g is not None)
        want = sum(1 + -(-int(r.n_tokens) // TDL.POLL) for _, r in windows)
        assert pair[1].reads.n - r0 == want


def test_grammar_past_the_dfa_budget_is_host_stepped(pair, monkeypatch):
    """A grammar past the DFA budget (no GrammarOps) decodes in the
    host-stepped loop with the host Grammar's penalty rows: JAX's ids."""
    calls = []
    real = TF._host_stepped_window
    monkeypatch.setattr(TF, "_host_stepped_window",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    assert TF._grammar_device_ops(pair[1], FullParams(grammar_rules=BIG_GRAMMAR)) is None
    jres, tres = both(pair, audio(25, 2), grammar_rules=BIG_GRAMMAR, max_tokens=2,
                      single_segment=True)
    assert calls and segments(tres) == segments(jres) and len(tres.segments) > 0


@pytest.mark.parametrize("strategy,t", [("greedy", 0.4), ("beam", 0.0), ("beam", 0.4)])
def test_ref_sampling_matches_jax(pair, strategy, t):
    """mt19937 draws on the host: greedy at t = 0.4 (best_of = 3 sampled
    decoders), beam search at t = 0 (beam 3, k draws a beam) and the beam
    strategy at t = 0.4 (best_of = 3 sampled decoders) take JAX's tokens;
    decoder 0's stream carries over to the next call on both sides."""
    samples = audio(25, 2)
    kw = dict(temperature=t)
    jkw = tkw = None
    if strategy == "beam":
        jkw = dict(strategy=JStrategy.BEAM_SEARCH, beam_search=JBeam(beam_size=3))
        tkw = dict(strategy=SamplingStrategy.BEAM_SEARCH, beam_search=BeamSearchParams(beam_size=3))
    for _ in range(2):
        jp = JFullParams(print_progress=False, ref_sampling=True, temperature_inc=0.0,
                         **kw, **(jkw or {}))
        tp = FullParams(print_progress=False, ref_sampling=True, temperature_inc=0.0,
                        **kw, **(tkw or {}))
        jp.greedy.best_of = tp.greedy.best_of = 3
        jres = JF.whisper_full(pair[0], jp, samples)
        tres = TF.whisper_full(pair[1], tp, samples)
        assert segments(tres) == segments(jres) and len(tres.segments) > 0
    assert pair[1]._ref_rng0.draw() == pair[0]._ref_rng0.draw()


@pytest.mark.parametrize("at", [5, 25])
def test_abort_callback_stops_at_the_same_token(pair, at):
    """The abort callback, polled once per token step of the host-stepped
    loop, stops both packages at the same step: in the first window
    (nothing emitted) or in the second (the first window's segments)."""
    out = []
    for mod, P, ctx in ((JF, JFullParams, pair[0]), (TF, FullParams, pair[1])):
        n = [0]

        def abort():
            n[0] += 1
            return n[0] >= at
        p = P(print_progress=False, temperature_inc=0.0, max_tokens=24, abort_callback=abort)
        res = mod.whisper_full(ctx, p, audio(30, 2))
        out.append((segments(res), n[0], res.timings.n_sample, res.timings.n_decode))
    assert out[0] == out[1] and out[1][1] == at
    assert (len(out[1][0]) > 0) == (at == 25)


def test_cross_qk_matches_jax(pair):
    """decode_impl(collect_cross_qk=True) over a 12-token prompt: the
    (L, B, H, T, Ta) cross-attention probabilities within 1e-5 of JAX's
    (f32), for float and int8 (QuantKV) cross-KV; the port's logits and
    caches equal its collect-free call's; QuantKVNat is refused."""
    jctx, tctx = pair
    cfg, jcfg = tctx.cfg, jctx.cfg
    mel = np.random.default_rng(3).standard_normal((1, 3000, 80)).astype(np.float32)
    _, jxk, jxv = M.encode_with_cross_kv(jcfg, jctx.params["encoder"], jctx.params["decoder"],
                                         jnp.asarray(mel))
    _, txk, txv = TM.encode_with_cross_kv(cfg, tctx.params["encoder"], tctx.params["decoder"],
                                          torch.from_numpy(mel))
    toks = np.array([[50257, 50362] + list(range(100, 110))], np.int64)
    for quant in (False, True):
        jk, jv = (M.quantize_cross_kv(jxk), M.quantize_cross_kv(jxv)) if quant else (jxk, jxv)
        tk, tv = tctx.quantize_cross_kv(FullParams(cross_kv_int8=quant), txk, txv)
        kk, kv = M.init_kv_cache(jcfg, 1, dtype=jnp.float32)
        _, _, _, jqk = M.decode(jcfg, jctx.params["decoder"], jnp.asarray(toks, jnp.int32),
                                kk, kv, jnp.int32(0), jk, jv, collect_cross_qk=True)
        outs = []
        for collect in (True, False):
            ck, cv = TM.init_kv_cache(cfg, 1, dtype=torch.float32, device="cpu")
            outs.append(TM.decode_impl(cfg, tctx.params["decoder"], torch.from_numpy(toks),
                                       ck, cv, 0, tk, tv, collect_cross_qk=collect))
        tqk = outs[0][3]
        assert tqk.shape == (cfg.n_text_layer, 1, cfg.n_text_head, 12, cfg.n_audio_ctx)
        np.testing.assert_allclose(tqk.numpy(), np.asarray(jqk), atol=1e-5, rtol=0)
        for a, b in zip(outs[0][:3], outs[1]):
            assert torch.equal(a, b)
    nat = TM.quantize_cross_kv_nat(txk, cfg.n_text_head)
    ck, cv = TM.init_kv_cache(cfg, 1, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="QuantKVNat"):
        TM.decode_impl(cfg, tctx.params["decoder"], torch.from_numpy(toks[:, :1]), ck, cv, 0,
                       nat, TM.quantize_cross_kv_nat(txv, cfg.n_text_head),
                       collect_cross_qk=True)


def test_token_and_dtw_timestamps_match_jax(pair):
    """Two windows (30 s, 74 segments) with token-level and DTW timestamps
    together, max_tokens 24: every token's t0, t1 and t_dtw exactly JAX's."""
    jres, tres = both(pair, audio(30, 2), max_tokens=24, token_timestamps=True,
                      dtw_token_timestamps=True)
    assert segments(tres) == segments(jres)
    tt = token_times(tres)
    assert tt == token_times(jres)
    assert len(tt) > 10 and any(d >= 0 for *_, d in tt) and any(t0 >= 0 for _, t0, _, _ in tt)


def test_words_from_result_matches_jax(pair):
    """Token timestamps grouped into words: the same WordTiming list."""
    jres, tres = both(pair, audio(25, 2), token_timestamps=True)
    jw = JAPI.words_from_result(jres, ctx=pair[0])
    tw = TAPI.words_from_result(tres, ctx=pair[1])
    assert [(w.word, w.start, w.end) for w in tw] == [(w.word, w.start, w.end) for w in jw]
    np.testing.assert_allclose([w.probability for w in tw], [w.probability for w in jw],
                               rtol=1e-5)
    assert len(tw) > 0 and TAPI.words_from_result(tres, vocab=pair[1].vocab) == tw


def test_silero_matches_jax(silero_file):
    """The random-weight Silero file read by both loaders: the port's
    probabilities within 1e-5 of JAX's, the same (h, c) carry, and the same
    speech segments, spliced samples and time mapping."""
    x = speech(12, ((1, 3.5), (5, 6), (7.5, 11)))
    jvad, tvad = JV.SileroVAD.from_file(silero_file), TV.SileroVAD.from_file(silero_file,
                                                                             device="cpu")
    jp, tp = jvad.detect_speech(x), tvad.detect_speech(x)
    assert tp.shape == jp.shape == (375,)
    np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvad.h.numpy(), np.asarray(jvad.h), atol=1e-5)
    # the carry: a second call without reset continues from (h, c)
    np.testing.assert_allclose(tvad.detect_speech(x[:16000], reset=False),
                               jvad.detect_speech(x[:16000], reset=False), atol=1e-5)
    for vp, jvp in ((VadParams(), JVadParams()),
                    (VadParams(threshold=0.6, speech_pad_ms=100),
                     JVadParams(threshold=0.6, speech_pad_ms=100))):
        js, ts = JVS.segments_from_probs(jp, jvp), TVS.segments_from_probs(tp, vp)
        assert [dataclasses.astuple(s) for s in ts] == [dataclasses.astuple(s) for s in js]
        assert len(ts) >= 2
        jf, tf = JVS.filter_samples(x, js, jvp), TVS.filter_samples(x, ts, vp)
        np.testing.assert_array_equal(tf.samples, jf.samples)
        assert tf.mapping == jf.mapping and 0 < tf.samples.size < x.size
        for t in range(0, 1300, 37):
            assert (TVS.map_processed_to_original(t, tf.mapping)
                    == JVS.map_processed_to_original(t, jf.mapping))
