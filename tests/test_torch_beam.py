"""Beam search in the port against the JAX package (CPU): top-k expansion,
the rolling sequence hashes, the lineage bias, the beam-step kernel K7's
plain version against the TPU kernel in interpret mode, the device beam
loop on both of its inner paths, and whisper_full with beam_size=3."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW_TS, audio, contexts, segments
from open_whisper_kit_tpu.decode import device_beam as JDB
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode import logit_rules as JLR
from open_whisper_kit_tpu.decode.params import BeamSearchParams as JBeam
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu.decode.params import SamplingStrategy as JStrategy
from open_whisper_kit_tpu.io import ggml_writer as JW
from open_whisper_kit_tpu.ops import decode_megakernel as JMK
from open_whisper_kit_tpu_torch.decode import device_beam as TDB
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import logit_rules as TLR
from open_whisper_kit_tpu_torch.decode.device_loop import HostReads
from open_whisper_kit_tpu_torch.decode.params import (BeamSearchParams, FullParams,
                                                      SamplingStrategy)
from open_whisper_kit_tpu_torch.ops import decode_megakernel as TMK
from test_torch_megakernel import (CFG, MODES, TCFG, _cross, _decoders, _exact,
                                   _for_mode, _hm_to_nat, _t)

torch.set_num_threads(2)


def _rule_configs(V):
    return (JLR.RuleConfig(n_vocab=V, token_eot=V - 2, token_beg=V - 120),
            TLR.RuleConfig(V, V - 2, V - 120))


@pytest.mark.parametrize("k", [3, 5])
def test_sample_topk_matches_jax(k):
    """Random logprobs with forced ties (equal finite values, rows with
    fewer than k finite entries, one all -inf but two entries): the ids
    equal jax.lax.top_k's exactly (the lower id first among equal values),
    the values and aggregates within 1e-6."""
    V, B = 300, 6
    jrc, trc = _rule_configs(V)
    rng = np.random.default_rng(k)
    lp = rng.standard_normal((B, V)).astype(np.float32) - 5.0
    lp[0, [7, 40, 299]] = 1.0                  # a three-way tie at the top
    lp[1, rng.choice(V, 50, replace=False)] = -3.0   # many equal values
    lp[2, :] = -np.inf
    lp[2, [11, 250]] = [-0.5, -0.9]            # two finite: the rest tie at -inf
    lp[3, :] = -np.inf
    lp[3, 100] = 0.0
    lp[4, ::2] = -np.inf
    probs = np.where(np.isneginf(lp), 0.0, np.exp(lp)).astype(np.float32)
    logits = lp.copy()
    jout = JLR.sample_topk(jrc, k, jnp.asarray(logits), jnp.asarray(lp), jnp.asarray(probs))
    tout = TLR.sample_topk(trc, k, torch.from_numpy(logits), torch.from_numpy(lp),
                           torch.from_numpy(probs))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))   # ids
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))   # tid
    for a, b in zip(jout[1:5], tout[1:5]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_rolling_hashes_match_jax():
    """The uint32 hashes h * 1000003 + tok and h * 0x9E3779B1 + tok, kept
    in int64 in the port, equal JAX's uint32 arithmetic bit for bit,
    including values near 2^32 and chains of 40 tokens."""
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 32, size=512, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    tok = rng.integers(0, 51866, size=512).astype(np.uint32)
    for c in (TDB._H1, TDB._H2):
        j = np.asarray(jnp.asarray(h) * jnp.uint32(c) + jnp.asarray(tok))
        t = TDB.rolling_hash(torch.from_numpy(h.astype(np.int64)),
                             torch.from_numpy(tok.astype(np.int64)), c)
        np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
        jh, th = jnp.zeros(8, jnp.uint32), torch.zeros(8, dtype=torch.long)
        for step in range(40):
            jh = jh * jnp.uint32(c) + jnp.asarray(tok[step * 8:(step + 1) * 8])
            th = TDB.rolling_hash(th, torch.from_numpy(tok[step * 8:(step + 1) * 8]
                                                       .astype(np.int64)), c)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int64))


@pytest.mark.parametrize("B,Tc", [(3, 64), (5, 448), (2, 200), (8, 129)])
def test_beam_attn_bias_matches_jax(B, Tc):
    """beam_attn_bias equals JAX's exactly for random origin tables, Tc
    a multiple of 128 or not, head at the block edges 127, 128 and 129."""
    rng = np.random.default_rng(B * Tc)
    origin = rng.integers(0, B, size=(B, Tc)).astype(np.int32)
    for head in sorted({0, 127, 128, 129, Tc - 1} & set(range(Tc))):
        j = np.asarray(JMK.beam_attn_bias(jnp.asarray(origin), jnp.int32(head), Tc))
        t = TMK.beam_attn_bias(torch.from_numpy(origin.astype(np.int64)),
                               torch.tensor(head), Tc)
        assert t.dtype == torch.float32 and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"head {head}")


# lineage of the five K7 steps: the sources each step's beams continue
# (None: no reorder), as the JAX package's own origin-path test
_SRCS = [None, np.array([1, 0, 1]), np.array([2, 0, 0]), None, np.array([1, 1, 2])]
# steps on both sides of the self-attention's 128-row time-block edges, in
# a 300-row cache (its last block partial), with reorders at the edges
_EDGE_TC = 300
_EDGE_STEPS = [(126, None), (127, np.array([2, 0, 1])), (128, np.array([1, 1, 0])),
               (129, None), (254, np.array([0, 2, 2])), (255, None),
               (256, np.array([2, 1, 0])), (257, None)]


def _beam_steps(mode, schedule, Tc, B=3, seed=23):
    """K7 steps at the (head, sources) of `schedule` from zero caches; the
    rows below a step's head that no step wrote first get seeded random K/V
    in every slot and a random lineage. The port's plain step against JAX's
    mega_decode_step_beam (interpret=True, compiled with _EXACT). Returns
    the largest logits and written-row errors relative to max|ref|, and
    whether every argmax agreed."""
    jdec, tdec = _for_mode(*_decoders(seed), mode)
    jmp, tmp = JMK.prepare_mega(CFG, jdec, quant=mode), TMK.prepare_mega(TCFG, tdec, quant=mode)
    xk, xv = _cross(jdec, seed)
    jxk, jxv = _hm_to_nat(xk), _hm_to_nat(xv)
    txk, txv = _t(jxk), _t(jxv)
    L, S = CFG.n_text_layer, CFG.n_text_state
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.n_vocab, size=(len(schedule), B))
    nk, nv = (jnp.zeros((L, Tc * B, S), jnp.bfloat16) for _ in range(2))
    tk, tv = (torch.zeros(L, Tc * B, S, dtype=torch.bfloat16) for _ in range(2))
    org = np.broadcast_to(np.arange(B)[:, None], (B, Tc)).copy()
    step, err, argmax_ok, filled = None, 0.0, True, 0
    for i, (head, src) in enumerate(schedule):
        if head > filled:
            hist = (rng.standard_normal((2, L, (head - filled) * B, S)) * 0.5
                    ).astype(jnp.bfloat16)
            rows = slice(filled * B, head * B)
            nk, nv = nk.at[:, rows].set(hist[0]), nv.at[:, rows].set(hist[1])
            tk[:, rows], tv[:, rows] = _t(hist[0]), _t(hist[1])
            org[:, filled:head] = rng.integers(0, B, size=(B, head - filled))
        if src is not None:
            org = org[src]
        org[:, head] = np.arange(B)
        filled = head + 1
        jb = JMK.beam_attn_bias(jnp.asarray(org, jnp.int32), jnp.int32(head), Tc)
        x0 = (jdec["te"][jnp.asarray(toks[i])]
              + jdec["pe"][jnp.asarray([head % CFG.n_text_ctx])]).astype(jnp.bfloat16)
        if step is None:
            step = _exact(JMK.mega_decode_step_beam, CFG, jmp, x0, nk, nv, jnp.int32(head),
                          jxk, jxv, attn_bias=jb, interpret=True)
        ref, nk, nv = step(jmp, x0, nk, nv, jnp.int32(head), jxk, jxv, attn_bias=jb)
        got, tk, tv = TMK.mega_decode_step_beam(
            TCFG, tmp, _t(x0), tk, tv, torch.tensor(head), txk, txv,
            origin=torch.from_numpy(org.copy()))
        r, g = np.asarray(ref), got.numpy()
        assert g.shape == r.shape == (B, CFG.n_vocab)
        err = max(err, np.abs(g - r).max() / np.abs(r).max())
        argmax_ok &= bool((g.argmax(1) == r.argmax(1)).all())
    written = np.concatenate([np.arange(h * B, (h + 1) * B) for h, _ in schedule])
    cache_err = 0.0
    for ref, got in ((nk, tk), (nv, tv)):
        ref, got = np.asarray(ref, np.float32), got.float().numpy()
        ref_w, got_w = ref[:, written], got[:, written]
        cache_err = max(cache_err, np.abs(got_w - ref_w).max() / np.abs(ref_w).max())
        assert (got[:, filled * B:] == 0).all()
    return err, cache_err, argmax_ok


@pytest.mark.parametrize("mode", MODES)
def test_beam_step_plain_matches_jax_kernel(mode):
    """K7's plain version against the TPU kernel in interpret mode, B = 3,
    five steps with two lineage reorders: logits within 2e-2 of max|logit|
    with the same argmax for every beam (the JAX package's own gate for
    this kernel), the written cache rows within 2e-2 of their max. Both
    sides round at the same points; the f32 sums run in other orders, which
    can flip a bf16 rounding (measured here: at most 7e-3)."""
    err, cache_err, argmax_ok = _beam_steps(mode, list(enumerate(_SRCS)), CFG.n_text_ctx)
    print(f"K7 plain vs JAX, mode {mode}: logits {err:.2e}, cache {cache_err:.2e} of max")
    assert err <= 2e-2 and cache_err <= 2e-2 and argmax_ok


@pytest.mark.parametrize("mode", ["none", "all"])
def test_beam_step_plain_matches_jax_kernel_across_time_blocks(mode):
    """The same comparison where the blocked online softmax carries over
    block edges: a 300-row cache with random history and lineage, steps at
    heads 126-129 and 254-257 (two and three 128-row time blocks, the last
    partial), lineage reorders at the edges. Same gate: logits within 2e-2
    of max|logit| with the same argmax, written rows within 2e-2."""
    err, cache_err, argmax_ok = _beam_steps(mode, _EDGE_STEPS, _EDGE_TC)
    print(f"K7 plain vs JAX across blocks, mode {mode}: logits {err:.2e}, "
          f"cache {cache_err:.2e} of max")
    assert err <= 2e-2 and cache_err <= 2e-2 and argmax_ok


def test_beam_step_origin_matches_physical_reorder():
    """The lineage bias over caches that never move against the same steps
    with the caches physically reordered and the identity lineage: the
    same argmax and logits within 1e-2 of max|logit| (the blocked sums
    meet the same terms in other positions)."""
    jdec, tdec = _decoders(5)
    tmp = TMK.prepare_mega(TCFG, tdec, quant="all")
    xk, xv = _cross(jdec, 5)
    txk, txv = _t(_hm_to_nat(xk)), _t(_hm_to_nat(xv))
    L, S, Tc, B = CFG.n_text_layer, CFG.n_text_state, CFG.n_text_ctx, 3
    toks = np.random.default_rng(5).integers(0, CFG.n_vocab, size=(len(_SRCS), B))
    ka, va, kb, vb = (torch.zeros(L, Tc * B, S, dtype=torch.bfloat16) for _ in range(4))
    origin = torch.arange(B)[:, None].expand(B, Tc).clone()
    ident = origin.clone()
    for i, src in enumerate(_SRCS):
        if src is not None:
            s = torch.from_numpy(src)
            origin = origin[s]
            kb = kb.view(L, Tc, B, S)[:, :, s].reshape(L, Tc * B, S)
            vb = vb.view(L, Tc, B, S)[:, :, s].reshape(L, Tc * B, S)
        origin[:, i] = torch.arange(B)
        x0 = (tdec["te"][torch.from_numpy(toks[i])] + tdec["pe"][i]).to(torch.bfloat16)
        la, ka, va = TMK.mega_decode_step_beam(TCFG, tmp, x0, ka, va, i, txk, txv,
                                               origin=origin)
        lb, kb, vb = TMK.mega_decode_step_beam(TCFG, tmp, x0, kb, vb, i, txk, txv,
                                               origin=ident)
        assert torch.equal(la.argmax(1), lb.argmax(1)), i
        assert (la - lb).abs().max() <= 1e-2 * lb.abs().max(), i


def test_beam_step_one_row_is_k2():
    """B = 1 delegates to K2's step (the origin table is not needed)."""
    _, tdec = _decoders(0)
    tmp = TMK.prepare_mega(TCFG, tdec)
    L, S, Tc, Ta = CFG.n_text_layer, CFG.n_text_state, CFG.n_text_ctx, CFG.n_audio_ctx
    g = torch.Generator().manual_seed(0)
    xk, xv = (torch.randn(L, Ta, S, generator=g).to(torch.bfloat16) for _ in range(2))
    x0 = (tdec["te"][[9]] + tdec["pe"][[0]]).to(torch.bfloat16)
    z = lambda: torch.zeros(L, Tc, S, dtype=torch.bfloat16)   # noqa: E731
    a, *_ = TMK.mega_decode_step_beam(TCFG, tmp, x0, z(), z(), 0, xk, xv)
    b, *_ = TMK.mega_decode_step(TCFG, tmp, x0, z(), z(), 0, xk, xv)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="origin table"):
        TMK.mega_decode_step_beam(TCFG, tmp, torch.cat([x0, x0]), z(), z(), 0, xk, xv)


@pytest.mark.parametrize("path", ["mega", "decode_impl"])
def test_decode_segment_beam_matches_jax(path):
    """The device beam loop against JAX's decode_segment_beam on the same
    prompt and cross-KV, B = 3: with `mega` (K7's plain step against the
    interpret-mode kernel, compiled with _EXACT) and on decode_impl with
    the physical reorder. Token ids, tid, result_len, seek_delta, n_valid,
    the done flags and n_tokens equal; p within 5e-3, sum_lp within 1e-3
    relative (bf16 weights: each logprob differs by up to ~1e-3 on
    decode_impl, where XLA and torch round at other points)."""
    jdec, tdec = _decoders(11)
    xk, xv = _cross(jdec, 11)
    txk = _t(jnp.transpose(xk, (0, 1, 3, 2, 4)).reshape(*xk.shape[:2], xk.shape[3], -1))
    txv = _t(jnp.transpose(xv, (0, 1, 3, 2, 4)).reshape(*xv.shape[:2], xv.shape[3], -1))
    jrc, trc = _rule_configs(CFG.n_vocab)
    prompt, n_max, B = [[5, 9, 0, 0]], 24, 3
    jmask, tmask = jnp.zeros((CFG.n_vocab,), jnp.float32), torch.zeros(CFG.n_vocab)
    jmp = JMK.prepare_mega(CFG, jdec) if path == "mega" else None
    tmp = TMK.prepare_mega(TCFG, tdec) if path == "mega" else None
    jxk, jxv = (xk, xv) if path == "mega" else (jnp.repeat(xk, B, 1), jnp.repeat(xv, B, 1))
    jargs = (jdec, jnp.asarray(prompt, jnp.int32), jxk, jxv, jmask, jmask,
             jnp.asarray([2, 3, 0, 3000], jnp.int32))
    jres = _exact(JDB.decode_segment_beam, CFG, jrc, *jargs, beam_size=B, n_max=n_max,
                  mega=jmp)(*jargs, mega=jmp)
    reads = HostReads()
    tres = TDB.decode_segment_beam(TCFG, trc, tdec, torch.tensor(prompt), txk, txv,
                                   tmask, tmask, (2, 3, 0, 3000), beam_size=B,
                                   n_max=n_max, reads=reads, mega=tmp)
    rows = TDB.unpack_beam_result(TDB.pack_beam_result(tres).numpy(), B, n_max)
    jrows = TDB.unpack_beam_result(np.asarray(JDB.pack_beam_result(jres)), B, n_max)
    assert rows[0]["n_tokens"] == jrows[0]["n_tokens"] > 0
    for b, (r, j) in enumerate(zip(rows, jrows)):
        for key in ("tokens", "tid", "result_len", "seek_delta", "n_valid", "has_ts",
                    "completed", "failed"):
            np.testing.assert_array_equal(r[key], j[key], err_msg=f"{key}, beam {b}")
        for key in ("p", "no_speech_prob"):
            np.testing.assert_allclose(r[key], j[key], atol=5e-3, err_msg=f"{key}, beam {b}")
        # a sum of n_max bf16-model logprobs, each ~1e-3 apart on decode_impl
        np.testing.assert_allclose(r["sum_logprobs_all"], j["sum_logprobs_all"], rtol=1e-3)
    assert len({tuple(r["tokens"].tolist()) for r in rows}) > 1    # the beams differ
    assert reads.n <= n_max // 16


def _beam_params(cls, beam_cls, strategy, **kw):
    p = cls(strategy=strategy.BEAM_SEARCH, beam_search=beam_cls(beam_size=3),
            print_progress=False, **kw)
    p.temperature_inc = 0
    return p


@pytest.fixture(scope="module")
def narrow_ts():
    return contexts(NARROW_TS)


# 40 s of noise (two windows); audio seed 1: JAX's beam-3 transcript on this
# config stays the same when the input is scaled by 1 + 2^-20 (ROADMAP
# section 3), and so does the port's
BEAM_SEED = 1


def _tokens(res):
    return [[t.id for t in s.tokens] for s in res.segments]


def test_whisper_full_beam_matches_jax(narrow_ts):
    """whisper_full with beam_size=3 through the fused K-window beam loop:
    the port's segments (t0, t1, text, token ids) equal JAX's, token data
    within 1e-4; the host reads one done flag per POLL steps per window,
    one control pair per window and one packed result per call, none per
    token."""
    jctx, tctx = narrow_ts
    samples = audio(40, BEAM_SEED)
    jres = JF.whisper_full(jctx, _beam_params(JFullParams, JBeam, JStrategy), samples)
    reads0 = tctx.reads.n
    tres = TF.whisper_full(tctx, _beam_params(FullParams, BeamSearchParams,
                                              SamplingStrategy), samples)
    reads = tctx.reads.n - reads0
    js, ts = segments(jres), segments(tres)
    assert len(js) == len(ts) > 0 and js == ts
    for sj, st in zip(jres.segments, tres.segments):
        np.testing.assert_allclose(st.no_speech_prob, sj.no_speech_prob, atol=1e-5)
        for tj, tt in zip(sj.tokens, st.tokens):
            assert tt.tid == tj.tid
            np.testing.assert_allclose([tt.p, tt.plog, tt.pt, tt.ptsum],
                                       [tj.p, tj.plog, tj.pt, tj.ptsum], atol=1e-4)
    tm = tres.timings
    assert tm.n_encode == jres.timings.n_encode == 2 and sum(map(len, _tokens(tres))) >= 100
    assert reads <= tm.n_sample / 16 + 2 * tm.n_encode + 1
    assert reads * 4 < tm.n_sample


def test_beam_windows_match_per_window_and_host_beam(narrow_ts):
    """The port's fused K-window beam loop (device_windows=8) equals its
    one-window path (device_windows=1, _device_beam_window) and the
    host-stepped beam loop (use_device_loops=False, the token-by-token
    merge _beam_expand_and_merge): the same segments and token ids."""
    _, tctx = narrow_ts
    samples = audio(40, BEAM_SEED)
    P = lambda **kw: _beam_params(FullParams, BeamSearchParams, SamplingStrategy, **kw)  # noqa: E731
    fused = TF.whisper_full(tctx, P(), samples)
    reads0 = tctx.reads.n
    per_window = TF.whisper_full(tctx, P(device_windows=1), samples)
    per_window_reads = tctx.reads.n - reads0
    host = TF.whisper_full(tctx, P(use_device_loops=False), samples)
    assert segments(fused) == segments(per_window) == segments(host)
    assert len(fused.segments) > 0
    for sd, sh in zip(fused.segments, host.segments):
        for td, th in zip(sd.tokens, sh.tokens):
            np.testing.assert_allclose(td.plog, th.plog, atol=1e-3)
    # one window per call: the done-flag polls and one packed result each
    tm = per_window.timings
    assert per_window_reads <= tm.n_sample / 16 + 2 * tm.n_encode


def test_multiwindow_eligibility_for_beams(narrow_ts):
    _, tctx = narrow_ts
    p = _beam_params(FullParams, BeamSearchParams, SamplingStrategy)
    assert TF._multiwindow_eligible(tctx, p, [0.0], 0)
    assert not TF._multiwindow_eligible(
        tctx, dataclasses.replace(p, beam_search=BeamSearchParams(beam_size=1)), [0.0], 0)
    assert not TF._multiwindow_eligible(tctx, dataclasses.replace(p, ref_sampling=True),
                                        [0.0], 0)


# a narrow bf16 q8_0 checkpoint (S = 128, three decoder layers); audio
# seeds whose JAX transcript (beam 3, megakernel="int8") stays the same when
# the input is scaled by 1 + 2^-20, and the port's also by 1 +- 2^-16 and
# 2^-13 (10 tokens each: ROADMAP section 3)
NARROW_Q = JW.WhisperHParams(n_vocab=51864, n_audio_ctx=1500, n_audio_state=128,
                             n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                             n_text_state=128, n_text_head=2, n_text_layer=3,
                             n_mels=80, ftype=1, qntvr=0)
Q8_BEAM_SEEDS = (4, 7)


def test_whisper_full_beam_q8_megakernel_int8_matches_jax(tmp_path):
    """whisper_full with beam_size=3 and megakernel="int8" on a narrow bf16
    q8_0 checkpoint: every beam token step through K7 (its plain version
    here, JAX's kernel in interpret mode), 40 s (two windows): the same
    segments."""
    path = tmp_path / "narrow-q8_0.bin"
    JW.write_checkpoint(path, NARROW_Q, JF._synthetic_mel_filters(80),
                        [b"<%d>" % i for i in range(50257)],
                        JW.random_reference_tensors(NARROW_Q, seed=0),
                        wtype=JW.TYPE_FOR_NAME["q8_0"])
    jctx = JF.WhisperContext.from_file(str(path), dtype=jnp.bfloat16)
    tctx = TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device="cpu")
    jp = _beam_params(JFullParams, JBeam, JStrategy, megakernel="int8")
    tp = _beam_params(FullParams, BeamSearchParams, SamplingStrategy, megakernel="int8")
    assert tctx.mega_mode(tp) == "all"
    calls = []
    real = TMK.mega_decode_step_beam

    def counting(*a, **k):
        calls.append(a[2].shape[0])
        return real(*a, **k)
    TMK.mega_decode_step_beam = counting
    try:
        for seed in Q8_BEAM_SEEDS:
            samples = audio(40, seed)
            jres = JF.whisper_full(jctx, jp, samples)
            tres = TF.whisper_full(tctx, tp, samples)
            js, ts = segments(jres), segments(tres)
            assert len(js) == len(ts) > 0 and js == ts, seed
            assert tres.timings.n_encode == 2
    finally:
        TMK.mega_decode_step_beam = real
    assert calls and set(calls) == {3}
