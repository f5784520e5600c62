"""Batched serving in the port against the JAX package (CPU): K8's plain
version against the TPU kernel in interpret mode, the lockstep pipeline
(transcribe_batched, transcribe_chunks_with_timings, full_parallel on
both routes) on tiny.en, the staged self-KV widths, the host reads per
round, and a narrow bf16 q8_0 batch with megakernel="int8"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import audio, segments
from open_whisper_kit_tpu.decode import batch as JB
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu.io import ggml_writer as JW
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.ops import decode_megakernel as JMK
from open_whisper_kit_tpu.parallel import dp as JDP
from open_whisper_kit_tpu_torch import Transcriber
from open_whisper_kit_tpu_torch.decode import batch as TB
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import decode_megakernel as TMK
from open_whisper_kit_tpu_torch.parallel import dp as TDP

torch.set_num_threads(2)

# K8's test config: three decoder layers, 600 audio positions (three
# 256-row cross chunks, the last partial: a plain version with one
# full-row softmax differs from the chunked one there) and a 300-row
# self-cache (steps across the 128-row time blocks)
CFG_ARGS = dict(n_vocab=640, n_audio_ctx=600, n_audio_state=256, n_audio_head=4,
                n_audio_layer=2, n_text_ctx=300, n_text_state=256, n_text_head=4,
                n_text_layer=3, n_mels=80)
CFG, TCFG = M.WhisperConfig(**CFG_ARGS), TM.WhisperConfig(**CFG_ARGS)
_EXACT = {"xla_allow_excess_precision": False}   # see test_torch_megakernel.py
_HEADS = (0, 127, 128, 129, 255, 256, 257)


def _t(a) -> torch.Tensor:
    return TM._from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", ["all"])
def test_batch_step_plain_matches_jax_kernel(mode):
    """K8's plain version against JAX's mega_decode_step_batch (interpret
    mode, compiled with _EXACT), B = 3 streams with distinct cross-KV:
    steps at heads on both sides of the 128-row time-block edges, each
    from the same cache (random history below the head): logits within
    2e-2 of max|logit| (the JAX package's own tolerance for this kernel)."""
    B, L, S, Tc, Ta = 3, CFG.n_text_layer, CFG.n_text_state, CFG.n_text_ctx, CFG.n_audio_ctx
    rng = np.random.default_rng(41)
    params = M.init_params(CFG, seed=41, dtype=jnp.bfloat16, device=False)
    jdec = M.prepare_decoder(params["decoder"])
    tdec = TM.prepare_decoder(TM.params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")["decoder"])
    jmp, tmp = JMK.prepare_mega(CFG, jdec, quant=mode), TMK.prepare_mega(TCFG, tdec, quant=mode)
    enc = jnp.asarray(rng.standard_normal((B, Ta, CFG.n_audio_state)), jnp.bfloat16)
    xk, xv = M.cross_kv(CFG, jdec, enc)                  # (L, B, H, Ta, dh)
    to_nat = lambda a: jnp.transpose(a, (0, 1, 3, 2, 4)).reshape(L, B, Ta, S)  # noqa: E731
    jxk, jxv = to_nat(xk), to_nat(xv)
    hist = (rng.standard_normal((2, L, Tc * B, S)) * 0.5).astype(jnp.bfloat16)
    toks = rng.integers(0, CFG.n_vocab, size=(len(_HEADS), B))
    step, err = None, 0.0
    for i, head in enumerate(_HEADS):
        nk = jnp.asarray(hist[0]).at[:, head * B:].set(0)
        nv = jnp.asarray(hist[1]).at[:, head * B:].set(0)
        x0 = (jdec["te"][jnp.asarray(toks[i])] + jdec["pe"][jnp.asarray([head])]
              ).astype(jnp.bfloat16)
        if step is None:
            step = JMK.mega_decode_step_batch.lower(
                CFG, jmp, x0, nk, nv, jnp.int32(head), jxk, jxv,
                interpret=True).compile(compiler_options=_EXACT)
        tk, tv = _t(nk), _t(nv)            # before the call: JAX donates its caches
        ref, rk, _ = step(jmp, x0, nk, nv, jnp.int32(head), jxk, jxv)
        got, tk, tv = TMK.mega_decode_step_batch(TCFG, tmp, _t(x0), tk, tv,
                                                 torch.tensor(head), _t(jxk), _t(jxv))
        r, g = np.asarray(ref), got.numpy()
        assert g.shape == r.shape == (B, CFG.n_vocab)
        err = max(err, np.abs(g - r).max() / np.abs(r).max())
        rk = np.asarray(rk, np.float32)[:, head * B:(head + 1) * B]
        np.testing.assert_allclose(tk[:, head * B:(head + 1) * B].float().numpy(), rk,
                                   atol=2e-2 * np.abs(rk).max())
    print(f"K8 plain vs JAX, mode {mode}: logits max|err| {err:.2e} of max|ref|")
    assert err <= 2e-2


def test_batch_step_one_stream_is_k2():
    """B = 1 delegates to K2's step on the stream's cross-KV."""
    params = M.init_params(CFG, seed=3, dtype=jnp.bfloat16, device=False)
    tdec = TM.prepare_decoder(TM.params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")["decoder"])
    tmp = TMK.prepare_mega(TCFG, tdec)
    L, S, Tc, Ta = TCFG.n_text_layer, TCFG.n_text_state, TCFG.n_text_ctx, TCFG.n_audio_ctx
    g = torch.Generator().manual_seed(0)
    xk, xv = (torch.randn(L, 1, Ta, S, generator=g).to(torch.bfloat16) for _ in range(2))
    x0 = (tdec["te"][[9]] + tdec["pe"][[0]]).to(torch.bfloat16)
    z = lambda: torch.zeros(L, Tc, S, dtype=torch.bfloat16)   # noqa: E731
    a, *_ = TMK.mega_decode_step_batch(TCFG, tmp, x0, z(), z(), 0, xk, xv)
    b, *_ = TMK.mega_decode_step(TCFG, tmp, x0, z(), z(), 0, xk[:, 0], xv[:, 0])
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def tiny_en():
    """tiny.en f32 from the preset, in both packages (the same weights)."""
    return (JF.WhisperContext.from_preset("tiny.en", dtype=jnp.float32),
            TF.WhisperContext.from_preset("tiny.en", dtype=torch.float32, device="cpu"))


def _timings(tm):
    return (tm.n_encode, tm.n_decode, tm.n_sample)


def _assert_same(jres, tres, probs=True):
    """The same segments (times, text, token ids) and Timings counts; with
    `probs` (f32 models) also the token probabilities within 1e-4."""
    js, ts = segments(jres), segments(tres)
    assert len(js) == len(ts) > 0 and js == ts
    assert _timings(tres.timings) == _timings(jres.timings)
    for sj, st in zip(jres.segments, tres.segments):
        if not probs:
            break
        np.testing.assert_allclose(st.no_speech_prob, sj.no_speech_prob, atol=1e-5)
        for tj, tt in zip(sj.tokens, st.tokens):
            assert tt.tid == tj.tid
            np.testing.assert_allclose([tt.p, tt.plog, tt.pt, tt.ptsum],
                                       [tj.p, tj.plog, tj.pt, tj.ptsum], atol=1e-4)


_REAL_BATCH_STEP = TB._make_batch_step


class _Rounds(list):
    """Each lockstep round's BatchResult; `stages`, the self-KV stage widths
    each round function was made with."""

    def __init__(self):
        super().__init__()
        self.stages = []


def _record_rounds(monkeypatch) -> _Rounds:
    """Install a _make_batch_step that records its rounds in the returned
    _Rounds."""
    rounds = _Rounds()

    def recording(sa, reads):
        run = _REAL_BATCH_STEP(sa, reads)
        rounds.stages.append(sa.kv_stages)

        def step(*a, **k):
            rounds.append(run(*a, **k))
            return rounds[-1]
        return step
    monkeypatch.setattr(TB, "_make_batch_step", recording)
    return rounds


@pytest.mark.parametrize("n_chunks", [2, 3])
def test_transcribe_batched_matches_jax(tiny_en, n_chunks, monkeypatch):
    """40 s in 2 or 3 lockstep chunks on one whole-audio mel: the same
    segments, token ids and Timings counts as the JAX package. The host
    reads one packed result per round and the done flag every POLL = 16
    steps until the round's streams have all ended: a round of k steps
    polls ceil(k / 16) times (at most (n_max - 1) // 16)."""
    jctx, tctx = tiny_en
    samples = audio(40, 0)
    jres = JB.transcribe_batched(jctx, JFullParams(print_progress=False), samples, n_chunks)
    rounds = _record_rounds(monkeypatch)
    reads0 = tctx.reads.n
    tres = TB.transcribe_batched(tctx, FullParams(print_progress=False), samples, n_chunks)
    reads = tctx.reads.n - reads0
    _assert_same(jres, tres)
    n_max = tctx.cfg.n_text_ctx // 2 - 4
    want = sum(1 + min(-(-int(r.n_tokens[0]) // 16), (n_max - 1) // 16) for r in rounds)
    assert len(rounds) > 0 and reads == want, (reads, want)


def test_transcribe_chunks_with_timings_matches_jax(tiny_en):
    """Three chunks of different lengths, each with its own mel: the same
    per-chunk segments and per-chunk Timings counts."""
    jctx, tctx = tiny_en
    chunks = [audio(s, seed) for s, seed in ((8, 1), (12, 2), (20, 3))]
    jsegs, jtms = JB.transcribe_chunks_with_timings(jctx, JFullParams(print_progress=False),
                                                    chunks)
    tsegs, ttms = TB.transcribe_chunks_with_timings(tctx, FullParams(print_progress=False),
                                                    chunks)
    for b in range(3):
        _assert_same(JF.TranscribeResult(segments=jsegs[b], timings=jtms[b]),
                     TF.TranscribeResult(segments=tsegs[b], timings=ttms[b]))


@pytest.mark.parametrize("route", ["lockstep", "threads"])
def test_full_parallel_matches_jax(tiny_en, route):
    """full_parallel over 3 chunks of 45 s: the lockstep route (greedy t=0
    defaults) and the threaded whisper_full route (no_context=False is not
    eligible for lockstep): the same merged segments and Timings counts."""
    jctx, tctx = tiny_en
    kw = {} if route == "lockstep" else {"no_context": False, "temperature_inc": 0.0}
    jp, tp = JFullParams(print_progress=False, **kw), FullParams(print_progress=False, **kw)
    assert TDP._batch_route_eligible(tctx, tp) == (route == "lockstep")
    assert JDP._batch_route_eligible(jctx, jp) == (route == "lockstep")
    samples = audio(45, 4)
    _assert_same(JDP.full_parallel(jctx, jp, samples, 3), TDP.full_parallel(tctx, tp, samples, 3))


def test_staged_widths_equal_full_width(tiny_en, monkeypatch):
    """The decode_impl branch's self-cache, 128 then 256 columns wide,
    against the same rounds on a full-width (448) cache: the same packed
    round results, bit for bit."""
    _, tctx = tiny_en
    chunks = [audio(30, 5), audio(30, 6)]
    p = FullParams(print_progress=False)
    staged = _record_rounds(monkeypatch)
    TB.transcribe_chunks_with_timings(tctx, p, chunks)
    monkeypatch.setattr(TB, "_kv_stage_widths", lambda full, need: (full,))
    full = _record_rounds(monkeypatch)
    TB.transcribe_chunks_with_timings(tctx, p, chunks)
    assert staged.stages == [(128, 256)] and full.stages == [(448,)]
    assert len(staged) == len(full) > 0
    assert max(int(r.n_tokens[0]) for r in staged) > 128 - 4   # the cache widened
    for a, b in zip(staged, full):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                          err_msg=f.name)


NARROW_Q = JW.WhisperHParams(n_vocab=51864, n_audio_ctx=1500, n_audio_state=128,
                             n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                             n_text_state=128, n_text_head=2, n_text_layer=3,
                             n_mels=80, ftype=1, qntvr=0)
# audio seeds of 30 s files whose JAX transcript (transcribe_batch,
# megakernel="int8") stays the same when the input is scaled by 1 +- 2^-20:
# of seeds 0-7 in one batch of eight, 0, 1 and 2 are stable and equal on
# both sides (148 tokens each); 3, 6 and 7 are stable but part at token
# 138, 136 and 0, since XLA on the CPU keeps excess precision in JAX's
# interpret-mode kernel (ROADMAP section 3)
Q8_BATCH_SEEDS = (0, 1)


def test_batch_q8_megakernel_int8_matches_jax(tmp_path):
    """transcribe_batch of two 30 s files on a narrow bf16 q8_0 checkpoint
    with megakernel="int8": every lockstep token step one K8 call (its
    plain version here, JAX's kernel in interpret mode): the same segments."""
    path = tmp_path / "narrow-q8_0.bin"
    JW.write_checkpoint(path, NARROW_Q, JF._synthetic_mel_filters(80),
                        [b"<%d>" % i for i in range(50257)],
                        JW.random_reference_tensors(NARROW_Q, seed=0),
                        wtype=JW.TYPE_FOR_NAME["q8_0"])
    from open_whisper_kit_tpu import api as JAPI
    jt = JAPI.Transcriber(model_path=path, dtype=jnp.bfloat16)
    tt = Transcriber(model_path=path, dtype=torch.bfloat16, device="cpu")
    jp = JFullParams(print_progress=False, megakernel="int8")
    tp = FullParams(print_progress=False, megakernel="int8")
    files = [audio(30, s) for s in Q8_BATCH_SEEDS]
    calls = []
    real = TMK.mega_decode_step_batch

    def counting(*a, **k):
        calls.append(a[2].shape[0])
        return real(*a, **k)
    TMK.mega_decode_step_batch = counting
    try:
        jres, tres = jt.transcribe_batch(files, jp), tt.transcribe_batch(files, tp)
    finally:
        TMK.mega_decode_step_batch = real
    for a, b in zip(jres, tres):
        _assert_same(a, b, probs=False)   # bf16 logits: the ids, not the probabilities
    assert calls and set(calls) == {2}


def test_unported_batch_options_raise(tiny_en, tmp_path):
    """The lockstep entry points with options that change the step program,
    as the JAX package runs them: transcribe_batch with token_timestamps
    sends each file to whisper_full (token t0/t1 set); transcribe_batched
    runs the lockstep chunks, where the option does not apply; full_parallel
    with VAD filters the samples once with the Silero model (a random-weight
    file both packages read), then splits them. Results equal JAX's."""
    from open_whisper_kit_tpu import api as JAPI
    from open_whisper_kit_tpu_torch.io import silero_writer as SW
    jctx, tctx = tiny_en
    tr, jt = Transcriber.__new__(Transcriber), JAPI.Transcriber.__new__(JAPI.Transcriber)
    tr.ctx, jt.ctx = tctx, jctx
    kw = dict(print_progress=False, token_timestamps=True, temperature_inc=0.0)
    files = [audio(6, 0), audio(8, 1)]
    jres = jt.transcribe_batch(files, JFullParams(**kw))
    tres = tr.transcribe_batch(files, FullParams(**kw))
    for a, b in zip(jres, tres):
        _assert_same(a, b)
        assert ([(t.t0, t.t1) for s in b.segments for t in s.tokens]
                == [(t.t0, t.t1) for s in a.segments for t in s.tokens])
    assert any(t.t0 >= 0 for r in tres for s in r.segments for t in s.tokens)
    _assert_same(JB.transcribe_batched(jctx, JFullParams(**kw), audio(16, 0), 2),
                 TB.transcribe_batched(tctx, FullParams(**kw), audio(16, 0), 2))
    path = tmp_path / "silero.bin"
    SW.write_silero(path, SW.random_silero_tensors(seed=0))
    rng = np.random.default_rng(1)
    samples = np.zeros(16000 * 30, np.float32)
    for lo, hi in ((1, 9), (12, 16), (19, 29)):
        samples[lo * 16000:hi * 16000] = rng.standard_normal((hi - lo) * 16000) * 0.3
    vad = dict(print_progress=False, vad=True, vad_model_path=str(path))
    _assert_same(JDP.full_parallel(jctx, JFullParams(**vad), samples, 2),
                 TDP.full_parallel(tctx, FullParams(**vad), samples, 2))
