"""The decode-step kernel K2 in the port against the JAX package (CPU): the
prepared planes, the plain step against the TPU kernel in interpret mode,
the megakernel mode policy, the greedy segment loop and whisper_full on a
narrow bf16 q8_0 checkpoint with megakernel="int8"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import audio, segments
from open_whisper_kit_tpu.decode import device_loop as JDL
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode import logit_rules as JLR
from open_whisper_kit_tpu.decode.params import FullParams as JFullParams
from open_whisper_kit_tpu.io import ggml_writer as JW
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.ops import decode_megakernel as JMK
from open_whisper_kit_tpu_torch.decode import device_loop as TDL
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import logit_rules as TLR
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import decode_megakernel as TMK

torch.set_num_threads(2)

# the JAX package's own megakernel test config (tests/test_decode_megakernel.py)
CFG_ARGS = dict(n_vocab=640, n_audio_ctx=48, n_audio_state=256, n_audio_head=4,
                n_audio_layer=2, n_text_ctx=64, n_text_state=256, n_text_head=4,
                n_text_layer=3, n_mels=80)
CFG, TCFG = M.WhisperConfig(**CFG_ARGS), TM.WhisperConfig(**CFG_ARGS)
MODES = ("none", "logits", "all", "int4")


def _t(a) -> torch.Tensor:
    return TM._from_numpy(np.asarray(a))


def _decoders(seed: int):
    """(JAX prepared decoder, the port's, bit-equal), bf16 weights."""
    params = M.init_params(CFG, seed=seed, dtype=jnp.bfloat16, device=False)
    jdec = M.prepare_decoder(params["decoder"])
    tdec = TM.prepare_decoder(TM.params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")["decoder"])
    return jdec, tdec


def _for_mode(jdec, tdec, mode):
    if mode == "logits":   # the decoder_int8 plane that prepare_mega reuses
        return (M.quantize_decoder_int8(jdec, scope="logits"),
                TM.quantize_decoder_int8(tdec, scope="logits"))
    return jdec, tdec


def _hm_to_nat(a):
    """(L, 1, H, T, dh) head-major -> (L, T, S) natural."""
    L, _, H, T, dh = a.shape
    return jnp.transpose(a[:, 0], (0, 2, 1, 3)).reshape(L, T, H * dh)


def _cross(jdec, seed):
    rng = np.random.default_rng(seed)
    enc = jnp.asarray(rng.standard_normal((1, CFG.n_audio_ctx, CFG.n_audio_state)),
                      jnp.bfloat16)
    xk, xv = M.cross_kv(CFG, jdec, enc)
    return xk, xv


# XLA on the CPU may drop the bf16 rounding between an op and an f32
# consumer (xla_allow_excess_precision, on by default): JAX's interpret-mode
# kernel then feeds its layernorms the unrounded residual sums, which the
# TPU kernel rounds (on a 3-layer model, up to 1.5e-2 of max|logit| from the
# rounding the kernel body states). The references here are compiled with
# it off, so they round where the kernel body says.
_EXACT = {"xla_allow_excess_precision": False}


def _exact(jitted, *args, **kw):
    """`jitted` compiled for these arguments' shapes with _EXACT."""
    return jitted.lower(*args, **kw).compile(compiler_options=_EXACT)


def _field_planes(mp, name):
    w = getattr(mp, name)
    return (w.qs, w.sc) if hasattr(w, "qs") else (w,)


@pytest.mark.parametrize("mode", MODES)
def test_prepare_mega_planes_equal_jax(mode):
    """Every weight field, bias and layernorm row of prepare_mega equals
    JAX's bit for bit on the logical columns (JAX pads the vocab plane to
    512, the port to 128); the 'logits' mode reuses the te_logits plane."""
    jdec, tdec = _for_mode(*_decoders(0), mode)
    jmp, tmp = JMK.prepare_mega(CFG, jdec, quant=mode), TMK.prepare_mega(TCFG, tdec, quant=mode)
    V = CFG.n_vocab
    for name in TMK.WEIGHTS:
        jw, tw = getattr(jmp, name), getattr(tmp, name)
        assert type(tw).__name__ == type(jw).__name__ or (
            not hasattr(jw, "qs") and isinstance(tw, torch.Tensor)), name
        for a, b in zip(_field_planes(jmp, name), _field_planes(tmp, name)):
            a = np.asarray(a)
            if name == "teT":
                a, b = a[..., :V], b[..., :V]
            got = b.contiguous()
            if got.dtype == torch.bfloat16:
                a, got = a.astype(np.float32), got.float()
            np.testing.assert_array_equal(a, got.numpy(), err_msg=f"{mode} {name}")
    assert tmp.vp % 128 == 0 and tmp.vp >= V
    for name in ("qkv_b", "o_b", "cq_b", "co_b", "mlp0_b", "mlp1_b", "lnw", "lnb"):
        np.testing.assert_array_equal(np.asarray(getattr(jmp, name), np.float32),
                                      getattr(tmp, name).float().numpy(), err_msg=name)
    if mode == "logits":
        assert tmp.teT.qs is tdec["te_logits"].qs
        assert isinstance(tmp.qkv_w, torch.Tensor)


@pytest.mark.parametrize("mode", MODES)
def test_plain_step_matches_jax_kernel(mode):
    """Five steps of the port's plain step against JAX's mega_decode_step
    (interpret=True, compiled with _EXACT) from the same zero caches and the
    same x0 rows: logits within 1e-2 of max|ref| with equal argmax at every
    step, the written cache rows within 1e-2 of their max, the untouched
    rows zero. Both sides round at the same points; what differs is the
    order of f32 sums and torch's tanh against XLA's, which can flip a
    bf16 rounding (most steps come out bit-equal)."""
    seed = {"none": 0, "logits": 31, "all": 21, "int4": 31}[mode]
    jdec, tdec = _for_mode(*_decoders(seed), mode)
    jmp, tmp = JMK.prepare_mega(CFG, jdec, quant=mode), TMK.prepare_mega(TCFG, tdec, quant=mode)
    xk, xv = _cross(jdec, seed)
    jxk, jxv = _hm_to_nat(xk), _hm_to_nat(xv)
    txk, txv = _t(jxk), _t(jxv)
    L, S, Tc = CFG.n_text_layer, CFG.n_text_state, CFG.n_text_ctx
    nk = jnp.zeros((L, Tc, S), jnp.bfloat16)
    nv = jnp.zeros((L, Tc, S), jnp.bfloat16)
    tk = torch.zeros(L, Tc, S, dtype=torch.bfloat16)
    tv = torch.zeros(L, Tc, S, dtype=torch.bfloat16)
    toks = np.random.default_rng(seed).integers(0, CFG.n_vocab, size=5)
    x0s = [(jdec["te"][jnp.asarray([t])] + jdec["pe"][jnp.asarray([i])]).astype(jnp.bfloat16)
           for i, t in enumerate(toks)]
    step = _exact(JMK.mega_decode_step, CFG, jmp, x0s[0], nk, nv, jnp.int32(0), jxk, jxv,
                  interpret=True)
    for i, x0 in enumerate(x0s):
        ref, nk, nv = step(jmp, x0, nk, nv, jnp.int32(i), jxk, jxv)
        got, tk, tv = TMK.mega_decode_step(TCFG, tmp, _t(x0), tk, tv, torch.tensor(i),
                                           txk, txv)
        r, g = np.asarray(ref[0]), got[0].numpy()
        assert g.shape == r.shape == (CFG.n_vocab,)
        scale = np.abs(r).max()
        np.testing.assert_allclose(g / scale, r / scale, atol=1e-2, err_msg=f"step {i}")
        assert int(np.argmax(g)) == int(np.argmax(r)), f"argmax step {i}"
    n = len(toks)
    for ref, got in ((nk, tk), (nv, tv)):
        ref = np.asarray(ref, np.float32)
        got = got.float().numpy()
        s = np.abs(ref[:, :n]).max()
        np.testing.assert_allclose(got[:, :n] / s, ref[:, :n] / s, atol=1e-2)
        assert (got[:, n:] == 0).all()


def _ctx(dec_params, cfg_args=CFG_ARGS, dtype=torch.bfloat16):
    cfg = TM.WhisperConfig(**cfg_args)
    params = {"encoder": {}, "decoder": dec_params}
    ctx = TF.WhisperContext.__new__(TF.WhisperContext)
    ctx.cfg, ctx.params, ctx.dtype = cfg, params, dtype
    ctx.device, ctx._mega = torch.device("cpu"), None
    return ctx


def test_mega_params_mode_policy():
    """The mode WhisperContext picks, as JAX's test_mega_params_mode_policy
    asks of the JAX package: auto is off on the CPU and for dense weights,
    on ("all") for all-int8 decoders on the card; True gives dense or the
    te_logits planes; "int8" all planes; mixed planes give None; "int4"
    needs S % 256; False and use_device_loops=False give None."""
    _, tdec = _decoders(0)
    ctx = _ctx(tdec)
    P = lambda **kw: FullParams(print_progress=False, **kw)   # noqa: E731
    assert ctx.mega_params(P()) is None
    assert ctx.mega_mode(P(), on_card=True) is None            # dense: decode_impl
    assert ctx.mega_params(P(megakernel=False)) is None
    assert ctx.mega_params(P(megakernel="int8", use_device_loops=False)) is None
    mp = ctx.mega_params(P(megakernel=True))
    assert isinstance(mp.teT, torch.Tensor) and isinstance(mp.qkv_w, torch.Tensor)
    mp = ctx.mega_params(P(megakernel="int8"))
    assert isinstance(mp.qkv_w, TMK.QPlanes) and isinstance(mp.teT, TMK.QPlanes)
    assert ctx.mega_params(P(megakernel="int8")) is mp         # prepared once
    mp = ctx.mega_params(P(megakernel="int4"))
    assert isinstance(mp.mlp1_w, TMK.Q4Planes) and isinstance(mp.teT, TMK.Q4Planes)

    ctx2 = _ctx(TM.quantize_decoder_int8(tdec))                # te_logits plane
    mp = ctx2.mega_params(P(megakernel=True))
    assert isinstance(mp.teT, TMK.QPlanes) and isinstance(mp.qkv_w, torch.Tensor)
    assert mp.teT.qs is ctx2.params["decoder"]["te_logits"].qs

    ctx3 = _ctx(TM.quantize_decoder_int8(tdec, scope="all"))   # all-int8 decoder
    assert ctx3.mega_params(P()) is None                       # auto, CPU: off
    assert ctx3.mega_mode(P(), on_card=True) == "all"          # auto, card: on
    assert ctx3.mega_mode(P(megakernel=True), on_card=True) == "all"

    ctx4 = _ctx(TM.quantize_decoder_int8(tdec, scope="mlp"))   # mixed planes
    assert ctx4.mega_mode(P(), on_card=True) is None
    assert ctx4.mega_mode(P(megakernel=True), on_card=True) is None

    assert _ctx(tdec, dtype=torch.float32).mega_mode(P(megakernel="int8")) is None
    narrow = dict(CFG_ARGS, n_text_state=128, n_text_head=2)   # S % 256 != 0
    assert _ctx(tdec, cfg_args=narrow).mega_mode(P(megakernel="int4")) is None
    assert _ctx(tdec, cfg_args=narrow).mega_mode(P(megakernel="int8")) == "all"


def test_decode_segment_mega_matches_plain_and_jax():
    """The greedy segment loop with K2's step against the same loop on
    decode_impl, and against JAX's decode_segment(mega=...) compiled with
    _EXACT: equal tokens, tid and state, p within 5e-3 (JAX's own test of
    the pair allows the same)."""
    jdec, tdec = _decoders(11)
    xk, xv = _cross(jdec, 11)
    txk = _t(jnp.transpose(xk, (0, 1, 3, 2, 4)).reshape(*xk.shape[:2], xk.shape[3], -1))
    txv = _t(jnp.transpose(xv, (0, 1, 3, 2, 4)).reshape(*xv.shape[:2], xv.shape[3], -1))
    V = CFG.n_vocab
    jrc = JLR.RuleConfig(n_vocab=V, token_eot=V - 2, token_beg=V - 120)
    trc = TLR.RuleConfig(V, V - 2, V - 120)
    prompt = [[5, 9, 0, 0]]
    n_max = 16
    jmask = jnp.zeros((V,), jnp.float32)
    tmask = torch.zeros(V)
    jmp, tmp = JMK.prepare_mega(CFG, jdec), TMK.prepare_mega(TCFG, tdec)
    jargs = (jdec, jnp.asarray(prompt, jnp.int32), xk, xv, jmask, jmask,
             jnp.asarray([2, 3, 0, 3000], jnp.int32))
    jres = _exact(JDL.decode_segment, CFG, jrc, *jargs, n_max=n_max, mega=jmp)(*jargs, mega=jmp)
    out = {}
    for name, mega in (("plain", None), ("mega", tmp)):
        res = TDL.decode_segment(TCFG, trc, tdec, torch.tensor(prompt), txk, txv, tmask,
                                 tmask, (2, 3, 0, 3000), n_max=n_max, reads=TDL.HostReads(),
                                 mega=mega)
        out[name] = TDL.unpack_segment_result(TDL.pack_segment_result(res).numpy(), n_max)
    j = {k: np.asarray(getattr(jres, k)) for k in ("tokens", "tid", "p")}
    for name, r in out.items():
        assert r["n_tokens"] == int(jres.n_tokens) > 0, name
        np.testing.assert_array_equal(r["tokens"], j["tokens"], err_msg=name)
        np.testing.assert_array_equal(r["tid"], j["tid"], err_msg=name)
        np.testing.assert_allclose(r["p"], j["p"], atol=5e-3, err_msg=name)
        assert (r["completed"], r["failed"], r["seek_delta"]) == (
            bool(jres.completed), bool(jres.failed), int(jres.seek_delta)), name
    assert out["mega"]["tokens"].tolist() == out["plain"]["tokens"].tolist()


def test_mega_step_refuses_verify_rows():
    """More than eight rows (the TPU kernel's sublane rows) are refused, and
    prepare_mega refuses quantized planes outside quant='all'."""
    jdec, tdec = _decoders(0)
    tmp = TMK.prepare_mega(TCFG, tdec)
    L, S, Tc, Ta = CFG.n_text_layer, CFG.n_text_state, CFG.n_text_ctx, CFG.n_audio_ctx
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)   # noqa: E731
    with pytest.raises(ValueError, match="1 to 8 rows"):
        TMK.mega_decode_step(TCFG, tmp, z(9, S), z(L, Tc, S), z(L, Tc, S), 0,
                             z(L, Ta, S), z(L, Ta, S))
    with pytest.raises(ValueError, match="quant='all'"):
        TMK.prepare_mega(TCFG, TM.quantize_decoder_int8(tdec, scope="all"))


def _verify_inputs(quant, head0, R, seed=3):
    """JAX's own verify-row case (tests/test_decode_megakernel.py::
    _verify_vs_sequential): a cache holding head0 rows of random history,
    R token + position rows from head0 on; JAX's arrays and the port's."""
    rng = np.random.default_rng(seed)
    jdec, tdec = _decoders(seed)
    jmp = JMK.prepare_mega(CFG, jdec, quant=quant)
    tmp = TMK.prepare_mega(TCFG, tdec, quant=quant)
    enc_out = jnp.asarray(rng.standard_normal((1, CFG.n_audio_ctx, CFG.n_audio_state)),
                          jnp.bfloat16)
    xk, xv = M.cross_kv(CFG, jdec, enc_out)
    jxk, jxv = _hm_to_nat(xk), _hm_to_nat(xv)
    L, S, Tc = CFG.n_text_layer, CFG.n_text_state, CFG.n_text_ctx
    toks = jnp.asarray(rng.integers(0, CFG.n_vocab, R), jnp.int32)
    hist = jnp.asarray(rng.standard_normal((L, head0, S)), jnp.bfloat16)
    base_k = jnp.zeros((L, Tc, S), jnp.bfloat16).at[:, :head0].set(hist)
    base_v = jnp.zeros((L, Tc, S), jnp.bfloat16).at[:, :head0].set(hist * .5)
    x0 = (jdec["te"][toks] + jdec["pe"][head0 + jnp.arange(R)]).astype(jnp.bfloat16)
    return (jmp, x0, base_k, base_v, jxk, jxv), (tmp, _t(x0), _t(base_k), _t(base_v),
                                                 _t(jxk), _t(jxv))


VERIFY_CASES = [("none", 9, 5), ("all", CFG.n_text_ctx - 8, 8)]


@pytest.mark.parametrize("quant,head0,R", VERIFY_CASES)
def test_plain_verify_rows_match_jax_kernel(quant, head0, R):
    """The plain R-row step (the speculative verify pass) against JAX's
    mega_decode_step with R rows (interpret=True, compiled with _EXACT), on
    JAX's own two verify cases: logits within 1e-2 of max|ref| with equal
    argmax per row, the R written cache rows within 1e-2 of their max, the
    other rows unchanged."""
    (jmp, x0, bk, bv, jxk, jxv), (tmp, tx0, tk, tv, txk, txv) = _verify_inputs(
        quant, head0, R)
    step = _exact(JMK.mega_decode_step, CFG, jmp, x0, bk, bv, jnp.int32(head0), jxk, jxv,
                  interpret=True)
    tk0, tv0 = tk.clone(), tv.clone()
    ref, nk, nv = step(jmp, x0, bk, bv, jnp.int32(head0), jxk, jxv)
    got, tk, tv = TMK.mega_decode_step(TCFG, tmp, tx0, tk, tv, torch.tensor(head0), txk, txv)
    r, g = np.asarray(ref), got.numpy()
    assert g.shape == r.shape == (R, CFG.n_vocab)
    scale = np.abs(r).max()
    np.testing.assert_allclose(g / scale, r / scale, atol=1e-2)
    assert (g.argmax(1) == r.argmax(1)).all()
    rows = slice(head0, head0 + R)
    for ref_c, got_c, before in ((nk, tk, tk0), (nv, tv, tv0)):
        ref_c = np.asarray(ref_c, np.float32)[:, rows]
        s = np.abs(ref_c).max()
        np.testing.assert_allclose(got_c[:, rows].float().numpy() / s, ref_c / s, atol=1e-2)
        assert torch.equal(got_c[:, :head0], before[:, :head0])
        assert torch.equal(got_c[:, head0 + R:], before[:, head0 + R:])


@pytest.mark.parametrize("quant,head0,R", VERIFY_CASES + [("int4", 20, 3)])
def test_plain_verify_rows_equal_sequential_steps(quant, head0, R):
    """The plain R-row step equals R sequential one-row plain steps at
    kv_head, kv_head + 1, ... bit for bit, logits and cache alike (the
    property that makes speculative output equal greedy output in bf16)."""
    _, (tmp, x0, tk, tv, xk, xv) = _verify_inputs(quant, head0, R)
    sk, sv = tk.clone(), tv.clone()
    seq = []
    for r in range(R):
        lg, sk, sv = TMK.mega_decode_step(TCFG, tmp, x0[r:r + 1], sk, sv,
                                          torch.tensor(head0 + r), xk, xv)
        seq.append(lg)
    ver, tk, tv = TMK.mega_decode_step(TCFG, tmp, x0, tk, tv, torch.tensor(head0), xk, xv)
    assert torch.equal(ver, torch.cat(seq))
    assert torch.equal(tk, sk) and torch.equal(tv, sv)


def test_plain_verify_rows_past_cache_end():
    """Rows at or past the cache's last row write nothing and attend every
    cached row, as the kernel's device-side bound does."""
    Tc = CFG.n_text_ctx
    _, (tmp, x0, tk, tv, xk, xv) = _verify_inputs("none", Tc - 8, 8)
    short_k, short_v = tk[:, :Tc - 5].clone(), tv[:, :Tc - 5].clone()
    lg, short_k, short_v = TMK.mega_decode_step(TCFG, tmp, x0, short_k, short_v,
                                                torch.tensor(Tc - 8), xk, xv)
    full, tk, tv = TMK.mega_decode_step(TCFG, tmp, x0[:3], tk, tv, torch.tensor(Tc - 8),
                                        xk, xv)
    assert torch.equal(lg[:3], full)
    assert torch.equal(short_k, tk[:, :Tc - 5]) and torch.equal(short_v, tv[:, :Tc - 5])
    assert torch.isfinite(lg).all()


# a narrow bf16 q8_0 checkpoint: S = 128 (two 64-wide heads), three decoder
# layers (two would force no_timestamps), tiny.en's vocabulary and contexts
NARROW_Q = JW.WhisperHParams(n_vocab=51864, n_audio_ctx=1500, n_audio_state=128,
                             n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                             n_text_state=128, n_text_head=2, n_text_layer=3,
                             n_mels=80, ftype=1, qntvr=0)
# an audio seed whose JAX transcript (megakernel="int8") stays the same when
# the input is scaled by 1 +- 2^-20, and the port's also by 1 +- 2^-16 and
# 2^-13 (ROADMAP section 3): 148 tokens in 74 segments
Q8_MEGA_SEED = 4


def test_whisper_full_q8_checkpoint_megakernel_int8_matches_jax(tmp_path):
    """whisper_full with megakernel="int8" on a narrow bf16 q8_0
    checkpoint: the port's K2 plain step against JAX's kernel in interpret
    mode, greedy over 35 s (two windows): the same token ids, timestamps
    and text."""
    path = tmp_path / "narrow-q8_0.bin"
    JW.write_checkpoint(path, NARROW_Q, JF._synthetic_mel_filters(80),
                        [b"<%d>" % i for i in range(50257)],
                        JW.random_reference_tensors(NARROW_Q, seed=0),
                        wtype=JW.TYPE_FOR_NAME["q8_0"])
    jctx = JF.WhisperContext.from_file(str(path), dtype=jnp.bfloat16)
    tctx = TF.WhisperContext.from_file(path, dtype=torch.bfloat16, device="cpu")
    jp = JFullParams(print_progress=False, megakernel="int8")
    tp = FullParams(print_progress=False, megakernel="int8")
    jp.temperature_inc = tp.temperature_inc = 0
    assert tctx.mega_mode(tp) == "all"
    samples = audio(35, Q8_MEGA_SEED)
    jres, tres = JF.whisper_full(jctx, jp, samples), TF.whisper_full(tctx, tp, samples)
    js, ts = segments(jres), segments(tres)
    assert len(js) == len(ts) > 0
    assert js == ts
    assert sum(len(x[3]) for x in ts) >= 100 and tres.timings.n_encode == 2
