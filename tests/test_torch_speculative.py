"""Speculative greedy decoding in the port against the JAX package and
against the port's own greedy output (CPU), the counterpart of
tests/test_speculative.py on narrow contexts.

The contract is output equality: every emitted token is the target's own
rule-filtered argmax, so a transcript equals the greedy one whatever the
draft; the draft only changes how many verify passes it takes. With K2's
verify rows (bit-identical to one-row steps) the equality holds in bf16
too. Audio seeds of the JAX comparisons are ones whose port transcript
stays the same when the input is scaled by 1 +- 2^-20, 2^-16 or 2^-13."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from _torch_parity import NARROW_TS, audio, contexts, segments
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu_torch import Transcriber
from open_whisper_kit_tpu_torch.decode import device_speculative as DS
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import tokenizer as TTOK
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.io import ggml_writer as TW
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import decode_megakernel as TMK

torch.set_num_threads(2)

# audio seeds whose port transcript survives the six input scalings
F32_SEED = 5   # 35 s, mismatched draft (gamma = 3)
Q8_SEED = 4    # 35 s, bf16 q8_0 with megakernel="int8" (gamma = 4)


def _params(**kw):
    return FullParams(print_progress=False, temperature_inc=0.0, **kw)


def _port_ctx(seed, args=NARROW_TS, dtype=torch.float32):
    cfg = TM.WhisperConfig(*args)
    tokens = [b"<%d>" % i for i in range(min(cfg.n_vocab, 50257))]
    return TF.WhisperContext(cfg, TM.init_params(cfg, seed=seed, dtype=dtype, device="cpu"),
                             TTOK.build_vocab(tokens, cfg.n_vocab),
                             TF._synthetic_mel_filters(cfg.n_mels), n_loaded=1, dtype=dtype,
                             device="cpu")


@pytest.fixture(scope="module")
def f32():
    """(JAX target, port target) of seed 0, and the port's drafts of seed 0
    (the target's own weights) and seed 1."""
    jctx, tctx = contexts(NARROW_TS, seed=0)
    return jctx, tctx, {0: _port_ctx(0), 1: _port_ctx(1)}


def _with_draft(ctx, draft, p, samples):
    ctx.set_draft(draft)
    try:
        return TF.whisper_full(ctx, p, samples)
    finally:
        ctx.draft = None


def _windows_and_rounds(res):
    """(windows, verify passes): two encoder passes and one prompt ingest
    per speculative window, one target pass per round."""
    n_win = res.timings.n_encode // 2
    return n_win, res.timings.n_decode - n_win


@pytest.fixture(scope="module")
def same_draft(f32):
    """35 s (two windows) with the target's own weights as the draft,
    gamma = 4: {"greedy": result, K: (speculative result, host reads) for
    the K-window loop (K = 8) and one window per call (K = 0)}."""
    _, ctx, drafts = f32
    samples = audio(35, 3)
    out = {"greedy": TF.whisper_full(ctx, _params(), samples)}
    for K in (8, 0):
        reads0 = ctx.reads.n
        res = _with_draft(ctx, drafts[0], _params(speculative=4, device_windows=K), samples)
        out[K] = res, ctx.reads.n - reads0
    return out


def test_speculative_equals_greedy_same_draft(same_draft):
    """Draft == target: the same output as greedy, and the acceptance
    canary: a broken draft cache (say, a missing ingest-only step) shows
    only as an acceptance collapse."""
    r0, (r1, _) = same_draft["greedy"], same_draft[8]
    assert segments(r0) == segments(r1) and r1.timings.n_sample >= 100
    assert r1.timings.n_spec_accepted >= 0.5 * r1.timings.n_sample, (
        r1.timings.n_spec_accepted, r1.timings.n_sample)


def test_speculative_mismatched_draft_equals_greedy_and_jax(f32):
    """A draft of other weights: acceptance is incidental, the output still
    equals greedy, and the port's speculative token ids equal the JAX
    package's speculative ones; the Timings counts agree too."""
    jctx, ctx, drafts = f32
    samples = audio(35, F32_SEED)
    r0 = TF.whisper_full(ctx, _params(), samples)
    r1 = _with_draft(ctx, drafts[1], _params(speculative=3), samples)
    jctx.set_draft(contexts(NARROW_TS, seed=1)[0])
    jres = JF.whisper_full(jctx, JFullParams(print_progress=False, temperature_inc=0.0,
                                             speculative=3), samples)
    assert segments(r0) == segments(r1) == segments(jres)
    assert sum(len(s[3]) for s in segments(r1)) >= 100
    for name in ("n_encode", "n_decode", "n_sample", "n_spec_accepted"):
        assert getattr(r1.timings, name) == getattr(jres.timings, name), name


def test_speculative_fused_windows_equal_per_window(same_draft):
    """The K-window loop's speculative mode against one window per call
    (device_windows=0) over two windows: the same segments and accepted
    count; each takes at most one done-flag read every POLL rounds and two
    reads a window besides."""
    for K in (8, 0):
        res, reads = same_draft[K]
        n_win, n_rounds = _windows_and_rounds(res)
        assert n_win == 2 and reads <= n_rounds / DS.POLL + 2 * n_win + 1, (K, reads, n_rounds)
    (r8, _), (r0, _) = same_draft[8], same_draft[0]
    assert segments(r8) == segments(r0)
    assert r8.timings.n_spec_accepted == r0.timings.n_spec_accepted > 0


def test_speculative_k2_draft_equals_greedy(f32):
    """Draft steps through K2 (its plain version on the CPU, int8 planes):
    the draft's numerics cannot change the transcript."""
    _, ctx, drafts = f32
    draft = drafts[1]
    dmega = TMK.prepare_mega(draft.cfg, draft.params["decoder"], quant="all")
    draft.mega_params = lambda p, draft=False: dmega
    try:
        samples = audio(6, 11)
        r0 = TF.whisper_full(ctx, _params(), samples)
        r1 = _with_draft(ctx, draft, _params(speculative=3), samples)
    finally:
        del draft.mega_params
    assert segments(r0) == segments(r1) and r1.timings.n_sample > 0


def test_speculative_without_draft_is_greedy(f32):
    """speculative > 0 with no draft attached takes the greedy loop."""
    _, ctx, _ = f32
    assert ctx.draft is None
    samples = audio(5, 3)
    assert segments(TF.whisper_full(ctx, _params(), samples)) == segments(
        TF.whisper_full(ctx, _params(speculative=4), samples))


def test_set_draft_guards(f32):
    """set_draft refuses another vocabulary, dtype or audio context."""
    _, ctx, drafts = f32
    multilingual = _port_ctx(0, args=(51865,) + NARROW_TS[1:])
    short_audio = _port_ctx(0, args=(NARROW_TS[0], 750) + NARROW_TS[2:])
    for bad, what in ((multilingual, "vocabulary"), (short_audio, "audio context")):
        with pytest.raises(ValueError, match=what):
            ctx.set_draft(bad)
    drafts[0].dtype = torch.bfloat16
    try:
        with pytest.raises(ValueError, match="dtype"):
            ctx.set_draft(drafts[0])
    finally:
        drafts[0].dtype = torch.float32
    assert ctx.draft is None


def test_mega_params_draft_ignores_cross_kv_int8():
    """mega_params(draft=True): the draft's cross-KV is never int8, so
    cross_kv_int8 does not take K2 from the draft (it does from the target)."""
    ctx = _port_ctx(0, dtype=torch.bfloat16)
    p = FullParams(megakernel="int8", cross_kv_int8=True)
    assert ctx.mega_params(p) is None
    assert isinstance(ctx.mega_params(p, draft=True).qkv_w, TMK.QPlanes)
    assert ctx.mega_mode(dataclasses.replace(p, cross_kv_int8=False)) == "all"


# a narrow bf16 q8_0 target (S = 128, three decoder layers, tiny.en's
# vocabulary and contexts) and a q4_0 draft of the same tensors
NARROW_Q = TW.WhisperHParams(*NARROW_TS, ftype=1, qntvr=0)


def test_speculative_q8_megakernel_int8_equals_k2_greedy_and_jax(tmp_path):
    """Transcriber(model_path=..., draft_model_path=...) on the narrow bf16
    q8_0 checkpoint with megakernel="int8": the draft steps run K2 at one
    row and every verify pass K2 at gamma + 1 = 5 rows (plain versions on
    the CPU), so the transcript equals K2 greedy exactly; and it equals the
    JAX package's speculative transcript (its kernel in interpret mode)."""
    tensors = TW.random_reference_tensors(NARROW_Q, seed=0)
    paths = {}
    for q in ("q8_0", "q4_0"):
        paths[q] = tmp_path / f"narrow-{q}.bin"
        TW.write_checkpoint(paths[q], NARROW_Q, TF._synthetic_mel_filters(80),
                            [b"<%d>" % i for i in range(50257)], tensors,
                            wtype=TW.TYPE_FOR_NAME[q])
    tr = Transcriber(model_path=paths["q8_0"], draft_model_path=paths["q4_0"],
                     dtype=torch.bfloat16, device="cpu")
    ctx = tr.ctx
    p = _params(megakernel="int8", speculative=4)
    assert ctx.mega_mode(p) == "all" and ctx.draft.mega_mode(p, draft=True) == "all"
    assert ctx.draft.device == ctx.device and ctx.draft.dtype == torch.bfloat16
    samples = audio(35, Q8_SEED)
    calls = []
    step = TMK.mega_decode_step

    def counting(cfg, mp, x0, *a):
        calls.append(x0.shape[0])
        return step(cfg, mp, x0, *a)
    DS.MK = type("CountingMK", (), {"__getattr__": lambda self, n: getattr(TMK, n),
                                    "mega_decode_step": staticmethod(counting)})()
    try:
        r1 = tr.transcribe(samples, p)
    finally:
        DS.MK = TMK
    r0 = tr.transcribe(samples, _params(megakernel="int8"))
    assert segments(r0) == segments(r1) and sum(len(s[3]) for s in segments(r1)) >= 100
    # a round: gamma proposing draft steps and one ingest-only (K2, one row),
    # then one verify pass (K2, five rows); rounds issued after the segment
    # ended, before the next done-flag read, run masked
    n_verify, n_rounds = calls.count(5), r1.timings.n_decode - 1
    assert n_rounds <= n_verify < n_rounds + DS.POLL
    assert calls.count(1) == 5 * n_verify and len(calls) == 6 * n_verify
    assert r1.timings.n_spec_accepted > 0
    jctx = JF.WhisperContext.from_file(str(paths["q8_0"]), dtype=jnp.bfloat16)
    jctx.set_draft(JF.WhisperContext.from_file(str(paths["q4_0"]), dtype=jnp.bfloat16))
    jres = JF.whisper_full(jctx, JFullParams(print_progress=False, temperature_inc=0.0,
                                             megakernel="int8", speculative=4), samples)
    assert segments(jres) == segments(r1)
