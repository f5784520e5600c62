"""Int8 cross-KV (`FullParams.cross_kv_int8`) in the port against the JAX
package (CPU): the quantizers bit for bit, `_attention_hm_q`, the plain
versions of kernels K9b and K9a against JAX's TPU kernels in interpret
mode, `decode_impl` over QuantKV and QuantKVNat planes, and every decode
path end to end (greedy one-window and K-window, beam, host-stepped,
speculative, transcribe_batched, full_parallel) with the same token ids and
segments. Audio seeds are ones whose port transcript stays the same when
the input is scaled by 1 +- 2^-20. The redesigned kernel's order of work
(key chunks combined in chunk order) runs here in torch against JAX's
kernels too."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW, NARROW_TS, audio, contexts, segments
from open_whisper_kit_tpu.decode import batch as JB
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode import params as JP
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.ops import experiments as JE
from open_whisper_kit_tpu.parallel import dp as JDP
from open_whisper_kit_tpu_torch.decode import batch as TB
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import params as TP
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import experiments as TE
from open_whisper_kit_tpu_torch.parallel import dp as TDP

torch.set_num_threads(2)

_EXACT = {"xla_allow_excess_precision": False}   # see test_torch_megakernel.py
# JAX's own decode_impl QuantKVNat test config (tests/test_whisper_model.py)
SMALL = (384, 64, 128, 2, 2, 48, 128, 2, 2, 80)


def _t(a) -> torch.Tensor:
    return TM._from_numpy(np.asarray(a))


def _head_major_kv(rng, L, B, H, Ta, dh, zero_row=True):
    """Float cross-KV (L, B, H, Ta, dh) with per-row magnitudes spread over
    two decades, one all-zero row (the quantizer's zero guard)."""
    x = rng.standard_normal((L, B, H, Ta, dh)) * rng.uniform(0.01, 3.0, (L, B, H, Ta, 1))
    if zero_row:
        x[0, 0, 0, 5] = 0.0
    return x.astype(np.float32)


def _natural(x: np.ndarray) -> torch.Tensor:
    L, B, H, Ta, dh = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4))
                            .reshape(L, B, Ta, H * dh))


@pytest.mark.parametrize("Ta", [100, 64])
@pytest.mark.parametrize("layout", ["head-major", "natural"])
def test_quantize_cross_kv_matches_jax(layout, Ta):
    """The port's quantizers on its natural (L, B, Ta, S) cross-KV against
    JAX's on the head-major tensor: int8 planes identical, scales bit-equal
    (an all-zero row included; Ta = 100 exercises QuantKVNat's pad to 128,
    H = 4 its head pad to 8)."""
    L, B, H, dh = 2, 3, 4, 64
    x = _head_major_kv(np.random.default_rng(Ta), L, B, H, Ta, dh)
    if layout == "head-major":
        j, t = M.quantize_cross_kv(jnp.asarray(x)), TM.quantize_cross_kv(_natural(x), H)
        assert tuple(t.qs.shape) == (L, B, H, Ta, dh) and t.qs.is_contiguous()
    else:
        j, t = M.quantize_cross_kv_nat(jnp.asarray(x)), TM.quantize_cross_kv_nat(_natural(x), H)
        assert t.ta_valid == j.ta_valid == Ta
        assert tuple(t.qs.shape) == (L, B, -(-Ta // 32) * 32, H * dh)
        assert tuple(t.scale.shape) == (L, B, 8, -(-Ta // 32) * 32)
    assert t.qs.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.qs.numpy(), np.asarray(j.qs))
    np.testing.assert_array_equal(t.scale.numpy().view(np.uint32),
                                  np.asarray(j.scale).view(np.uint32))
    assert (t.scale.numpy() == 0).sum() >= 1


@pytest.mark.parametrize("T", [1, 6])
def test_attention_hm_q_matches_jax(T):
    """_attention_hm_q in f32 (B = 3 streams, their own planes) against
    JAX's: within 1e-5 of max|ref|."""
    rng = np.random.default_rng(20 + T)
    L, B, H, Ta, dh = 2, 3, 4, 100, 64
    x = jnp.asarray(_head_major_kv(rng, L, B, H, Ta, dh))
    qk, qv = M.quantize_cross_kv(x[:1]), M.quantize_cross_kv(x[1:])
    q = rng.standard_normal((B, T, H * dh)).astype(np.float32)
    ref, _ = M._attention_hm_q(jnp.asarray(q), qk.qs[0], qk.scale[0], qv.qs[0],
                               qv.scale[0], H, 0.5)
    got = TM._attention_hm_q(torch.from_numpy(q), _t(qk.qs[0]), _t(qk.scale[0]),
                             _t(qv.qs[0]), _t(qv.scale[0]), H, 0.5)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())


def _jax_kernel(fn, args, **static):
    """JAX's TPU kernel in interpret mode, compiled without excess precision."""
    f = jax.jit(functools.partial(fn, **static, interpret=True))
    return np.asarray(f.lower(*args).compile(compiler_options=_EXACT)(*args), np.float32)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("kernel", ["K9b", "K9a"])
def test_k9_plain_matches_jax_kernel(kernel, shared):
    """The plain versions of K9b and K9a in bf16 against JAX's
    cross_attention_q8 / cross_attention_q8_nat (interpret mode, compiled
    with _EXACT), B = 3 query rows over their own planes or over one shared
    batch-1 plane (JAX reads it repeated): within 1e-2 of max|ref|. K9a
    runs Ta = 100 keys of a 128-row slab. The CPU calls launch nothing."""
    rng = np.random.default_rng(31 + shared)
    B, H, Ta, dh = 3, 4, 100, 64
    Bk = 1 if shared else B
    x = jnp.asarray(_head_major_kv(rng, 2, Bk, H, Ta, dh, zero_row=False) * 0.3)
    q = jnp.asarray(rng.standard_normal((B, 1, H * dh)), jnp.bfloat16)
    rep = (lambda a: jnp.repeat(a, B, axis=0)) if shared else (lambda a: a)  # noqa: E731
    before = (TE.cross_attention_q8.launches, TE.cross_attention_q8_nat.launches)
    if kernel == "K9b":
        kv = M.quantize_cross_kv(x)
        args = (kv.qs[0], kv.scale[0], kv.qs[1], kv.scale[1])
        ref = _jax_kernel(JE.cross_attention_q8, (q, *map(rep, args)), n_head=H, scale=0.5)
        got = TE.cross_attention_q8(_t(q), *map(_t, args), H, 0.5)
    else:
        kv = M.quantize_cross_kv_nat(x)
        args = (kv.qs[0], kv.scale[0], kv.qs[1], kv.scale[1])
        ref = _jax_kernel(JE.cross_attention_q8_nat, (q, *map(rep, args)), n_head=H,
                          scale=0.5, ta_valid=Ta)
        got = TE.cross_attention_q8_nat(_t(q), *map(_t, args), H, 0.5, Ta)
    assert tuple(got.shape) == (B, 1, H * dh) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2 * np.abs(ref).max())
    assert (TE.cross_attention_q8.launches, TE.cross_attention_q8_nat.launches) == before


def _k9_chunk_order(q, kq, ks, vq, vs, n_head, scale, n_keys, shared):
    """csrc/cross_q8.cu's arithmetic in its order, in torch, on head-major
    planes (Bk, H, Ta, 64): the keys in the chunks of cross_q8_plan, each
    chunk's max and sum of exp(s - max), the row's M the largest max and L
    the chunks' sums rescaled to M and added in chunk order, p = exp(s - M)
    / L, w = p * vs rounded to q's dtype, each chunk's w @ V in f32, the
    chunks' partial sums added in chunk order and rounded to q's dtype."""
    B, _, S = q.shape
    plan = TE.cross_q8_plan(B, n_head, n_keys, shared)
    kf = kq[:, :, :n_keys].float().expand(B, -1, -1, -1)
    vf = vq[:, :, :n_keys].float().expand(B, -1, -1, -1)
    qh = q.reshape(B, n_head, S // n_head).float()
    s = torch.einsum("bhd,bhkd->bhk", qh, kf) * ks[:, :, :n_keys] * scale
    stats = []
    for a, b in plan.key_chunks():
        m = s[..., a:b].amax(-1)
        stats.append((m, torch.exp(s[..., a:b] - m[..., None]).sum(-1)))
    big_m = torch.stack([m for m, _ in stats]).amax(0)
    big_l = torch.zeros_like(big_m)
    for m, l in stats:
        big_l = big_l + l * torch.exp(m - big_m)
    w = (torch.exp(s - big_m[..., None]) / big_l[..., None] * vs[:, :, :n_keys]).to(q.dtype)
    out = torch.zeros_like(qh)
    for a, b in plan.key_chunks():
        out = out + torch.einsum("bhk,bhkd->bhd", w[..., a:b].float(), vf[:, :, a:b])
    return out.to(q.dtype).reshape(B, 1, S)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("kernel", ["K9b", "K9a"])
def test_k9_chunk_order_matches_jax_kernel(kernel, shared):
    """The redesigned kernel's order of work (one cluster of key chunks: 4
    chunks of 32 keys over Ta = 100, the last 4 keys; statistics and partial
    sums combined in chunk order), run in torch in bf16, against JAX's
    cross_attention_q8 / cross_attention_q8_nat (interpret mode, compiled
    with _EXACT) at test_k9_plain_matches_jax_kernel's shapes and
    tolerance: within 1e-2 of max|ref|; B = 3 rows over their own planes or
    one shared batch-1 plane (one row group of three)."""
    rng = np.random.default_rng(31 + shared)
    B, H, Ta, dh = 3, 4, 100, 64
    Bk = 1 if shared else B
    x = jnp.asarray(_head_major_kv(rng, 2, Bk, H, Ta, dh, zero_row=False) * 0.3)
    q = jnp.asarray(rng.standard_normal((B, 1, H * dh)), jnp.bfloat16)
    rep = (lambda a: jnp.repeat(a, B, axis=0)) if shared else (lambda a: a)  # noqa: E731
    plan = TE.cross_q8_plan(B, H, Ta, shared)
    assert (plan.chunks, plan.chunk, plan.rows) == (4, 32, B if shared else 1)
    if kernel == "K9b":
        kv = M.quantize_cross_kv(x)
        args = (kv.qs[0], kv.scale[0], kv.qs[1], kv.scale[1])
        ref = _jax_kernel(JE.cross_attention_q8, (q, *map(rep, args)), n_head=H, scale=0.5)
        planes = [_t(a) for a in args]
    else:
        kv = M.quantize_cross_kv_nat(x)
        args = (kv.qs[0], kv.scale[0], kv.qs[1], kv.scale[1])
        ref = _jax_kernel(JE.cross_attention_q8_nat, (q, *map(rep, args)), n_head=H,
                          scale=0.5, ta_valid=Ta)
        kq, ks = TE._nat_to_head_major(_t(args[0]), _t(args[1]), H, Ta)
        vq, vs = TE._nat_to_head_major(_t(args[2]), _t(args[3]), H, Ta)
        planes = [kq, ks, vq, vs]
    got = _k9_chunk_order(_t(q), *planes, H, 0.5, Ta, shared)
    assert tuple(got.shape) == (B, 1, H * dh) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("Ta", [1500, 1350, 225])
def test_k9_chunk_order_matches_plain_in_f32(Ta):
    """In f32 the chunk order is the plain version's function up to f32 sum
    order: within 1e-5 of max|ref| at large-v3-turbo's key counts (8 chunks
    of 192, the last 156; the last 6 keys; 8 chunks of 32, the last 1), two
    rows over a shared plane."""
    g = torch.Generator().manual_seed(Ta)
    H = 2
    xk, xv = (torch.randn(1, 1, Ta, H * 64, generator=g) * 0.5 for _ in range(2))
    k, v = TM.quantize_cross_kv(xk, H), TM.quantize_cross_kv(xv, H)
    planes = (k.qs[0], k.scale[0], v.qs[0], v.scale[0])
    q = torch.randn(2, 1, H * 64, generator=g)
    ref = TE.cross_attention_q8_plain(q, *planes, H, 0.125)
    got = _k9_chunk_order(q, *planes, H, 0.125, Ta, True)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


def _decode_pair():
    """The SMALL config's prepared decoders (JAX, port) over the same f32
    weights, and a JAX head-major cross-KV of two streams."""
    cfg, tcfg = M.WhisperConfig(*SMALL), TM.WhisperConfig(*SMALL)
    params = M.init_params(cfg, seed=3, dtype=jnp.float32, device=False)
    jdec = M.prepare_decoder(params["decoder"])
    tdec = TM.prepare_decoder(TM.params_from_jax(jax.tree.map(np.asarray, params),
                                                 device="cpu")["decoder"])
    enc = jnp.asarray(np.random.default_rng(7).standard_normal((2, 64, 128)), jnp.float32)
    xk, xv = M.cross_kv(cfg, jdec, enc)
    return cfg, tcfg, jdec, tdec, xk, xv


@pytest.mark.parametrize("planes", ["QuantKV", "QuantKVNat"])
def test_decode_impl_quantized_cross_kv_matches_jax(planes, monkeypatch):
    """decode_impl over the same int8 planes as JAX's (B = 2 streams, f32):
    QuantKV through a T = 8 prompt ingest (`_attention_hm_q`) then four
    one-token steps (K9b's route), logits within 1e-4 of max|ref|;
    QuantKVNat through four one-token steps (K9a's route), within 5e-3
    (JAX's K9a rounds q and p * vs to bf16, the port's f32 route does not).
    Each one-row step calls its kernel's wrapper once per layer."""
    cfg, tcfg, jdec, tdec, xk, xv = _decode_pair()
    nat = planes == "QuantKVNat"
    quant = M.quantize_cross_kv_nat if nat else M.quantize_cross_kv
    jxk, jxv = quant(xk), quant(xv)
    if nat:
        txk = TM.QuantKVNat(_t(jxk.qs), _t(jxk.scale), jxk.ta_valid)
        txv = TM.QuantKVNat(_t(jxv.qs), _t(jxv.scale), jxv.ta_valid)
    else:
        txk, txv = (TM.QuantKV(_t(a.qs), _t(a.scale)) for a in (jxk, jxv))
    calls = {"cross_attention_q8": 0, "cross_attention_q8_nat": 0, "_attention_hm_q": 0}
    for name in calls:
        def counting(*a, _name=name, _real=getattr(TM, name), **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(TM, name, counting)
    jk, jv = M.init_kv_cache(cfg, 2, dtype=jnp.float32)
    tk, tv = TM.init_kv_cache(tcfg, 2, dtype=torch.float32, device="cpu")
    head, tol = 0, 5e-3 if nat else 1e-4
    tok = np.array([[5] * 8, [9] * 8]) if not nat else np.array([[5], [9]])
    for step in range(5 if not nat else 4):
        jl, jk, jv, _ = M.decode_impl(cfg, jdec, jnp.asarray(tok, jnp.int32), jk, jv,
                                      jnp.int32(head), jxk, jxv)
        tl, tk, tv = TM.decode_impl(tcfg, tdec, torch.from_numpy(tok).long(), tk, tv,
                                    head, txk, txv)
        ref = np.asarray(jl[:, -1])
        np.testing.assert_allclose(tl[:, -1].numpy(), ref, atol=tol * np.abs(ref).max(),
                                   err_msg=f"step {step}")
        head += tok.shape[1]
        tok = ref.argmax(1)[:, None]
    want = ({"cross_attention_q8_nat": 4 * cfg.n_text_layer} if nat else
            {"_attention_hm_q": cfg.n_text_layer, "cross_attention_q8": 4 * cfg.n_text_layer})
    assert calls == {**dict.fromkeys(calls, 0), **want}


def test_shared_planes_serve_every_row():
    """A QuantKV of batch 1 serves B = 3 rows (the beams' convention, batch
    stride 0 on the card): the same logits as its planes repeated per row."""
    cfg, tcfg, jdec, tdec, xk, xv = _decode_pair()
    one = [TM.QuantKV(_t(a.qs[:, :1]), _t(a.scale[:, :1]))
           for a in (M.quantize_cross_kv(xk), M.quantize_cross_kv(xv))]
    rep = [TM.QuantKV(a.qs.expand(-1, 3, -1, -1, -1).contiguous(),
                      a.scale.expand(-1, 3, -1, -1).contiguous()) for a in one]
    out = []
    for planes in (one, rep):
        tk, tv = TM.init_kv_cache(tcfg, 3, dtype=torch.float32, device="cpu")
        prompt = torch.tensor([[3, 4, 5, 6]] * 3)
        la, tk, tv = TM.decode_impl(tcfg, tdec, prompt, tk, tv, 0, *planes)
        lb, tk, tv = TM.decode_impl(tcfg, tdec, torch.tensor([[7], [8], [9]]), tk, tv, 4,
                                    *planes)
        out.append(torch.cat([la[:, -1], lb[:, -1]]))
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=1e-5 * out[1].abs().max().item())


@pytest.fixture(scope="module")
def narrow_ts():
    return contexts(NARROW_TS)


@pytest.fixture(scope="module")
def narrow():
    return contexts(NARROW)


def _params(mod, **kw):
    kw = {k: (v(mod) if callable(v) else v) for k, v in kw.items()}
    return mod.FullParams(print_progress=False, temperature_inc=0.0, cross_kv_int8=True, **kw)


def _beam(mod):
    return mod.SamplingStrategy.BEAM_SEARCH


def _assert_same(jres, tres):
    js, ts = segments(jres), segments(tres)
    assert len(ts) > 0 and len(js) == len(ts)
    for k, (a, b) in enumerate(zip(js, ts)):
        assert a == b, f"segment {k}"
    assert sum(len(s[3]) for s in ts) >= 100


@pytest.mark.parametrize("case", [
    "K-window 65 s", "one window 35 s", "beam 2, 40 s", "host-stepped 12 s"])
def test_whisper_full_cross_kv_int8_matches_jax(narrow_ts, narrow, case):
    """whisper_full with cross_kv_int8 on the narrow f32 configs: the
    K-window loop (three windows), one window per call, the device beam
    loop (beam 2) with timestamps, and the host-stepped loop (on the
    2-layer config, whose transcript of 12 s is longer): the same segments
    and token ids as the JAX package (audio seeds 0, 1, 2 and 4)."""
    secs, seed, kw = {
        "K-window 65 s": (65, 0, {}),
        "one window 35 s": (35, 1, {"device_windows": 0}),
        "beam 2, 40 s": (40, 2, {"strategy": _beam, "beam_search":
                                 lambda m: m.BeamSearchParams(beam_size=2)}),
        "host-stepped 12 s": (12, 4, {"use_device_loops": False}),
    }[case]
    jctx, tctx = narrow if case.startswith("host") else narrow_ts
    samples = audio(secs, seed)
    tres = TF.whisper_full(tctx, _params(TP, **kw), samples)
    _assert_same(JF.whisper_full(jctx, _params(JP, **kw), samples), tres)


def test_speculative_cross_kv_int8_matches_jax(narrow_ts):
    """Speculative greedy with a seed-1 draft (gamma 3): the target's
    cross-KV int8, the draft's float, in both packages: the same segments
    as JAX's and as the port's own greedy decode."""
    jctx, tctx = narrow_ts
    jdraft, tdraft = contexts(NARROW_TS, seed=1)
    samples = audio(35, 3)
    greedy = TF.whisper_full(tctx, _params(TP), samples)
    tctx.set_draft(tdraft)
    jctx.set_draft(jdraft)
    try:
        tres = TF.whisper_full(tctx, _params(TP, speculative=3), samples)
        jres = JF.whisper_full(jctx, _params(JP, speculative=3), samples)
    finally:
        tctx.draft = jctx.draft = None
    assert tres.timings.n_encode == 2 * 2          # target and draft, two windows
    _assert_same(jres, tres)
    assert segments(tres) == segments(greedy)


@pytest.mark.parametrize("entry", ["transcribe_batched", "full_parallel"])
def test_lockstep_cross_kv_int8_matches_jax(narrow_ts, entry):
    """Lockstep serving with int8 cross-KV: transcribe_batched of 60 s in
    two chunks and full_parallel of 90 s over three (JAX takes the flag as
    transcribe_batched's `cross_kv_int8` argument): the same segments."""
    jctx, tctx = narrow_ts
    jp, tp = _params(JP), _params(TP)
    if entry == "transcribe_batched":
        samples = audio(60, 0)
        jres = JB.transcribe_batched(jctx, jp, samples, 2, cross_kv_int8=True)
        tres = TB.transcribe_batched(tctx, tp, samples, 2)
    else:
        assert TDP._batch_route_eligible(tctx, tp) and JDP._batch_route_eligible(jctx, jp)
        samples = audio(90, 5)
        jres = JDP.full_parallel(jctx, jp, samples, 3)
        tres = TDP.full_parallel(tctx, tp, samples, 3)
    _assert_same(jres, tres)


def test_cross_kv_int8_leaves_the_step_kernels_off(narrow_ts):
    """Under cross_kv_int8 the target's K2/K7 modes and the batch's K8 are
    off, as in the JAX package; a speculative draft keeps its own mode."""
    _, tctx = narrow_ts
    p = dataclasses.replace(_params(TP), megakernel="int8")
    bf = TF.WhisperContext(tctx.cfg, TM.init_params(tctx.cfg, seed=0, device="cpu"),
                           tctx.vocab, tctx.filters, n_loaded=1, device="cpu")
    assert bf.mega_mode(dataclasses.replace(p, cross_kv_int8=False)) == "all"
    assert bf.mega_mode(p) is None
    assert bf.mega_mode(p, draft=True) == "all"
