"""The tensor-parallel decode step (ops/decode_tp.py) in the port against
the JAX package (CPU): the sharded planes, the tp = 1 step against JAX's
mega_decode_step_tp (compiled with _EXACT, the megakernel parity tests'
flags), tp = 2 (three one-row steps) and tp = 3 (a three-row step)
bit-equal to tp = 1 over 2- and 3-process Gloo groups
(tests/_torch_mesh_child.py, one spawn for the module), the step against
K2's plain version, and the two trouble spots: each shard's K3 call keeps
the whole width's splits, and the CPU's plain K3 at a shard is bit-equal
to that block of the whole product at several rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_child as child
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.ops import decode_megakernel as JMK
from open_whisper_kit_tpu.ops import decode_tp as JDTP
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import decode_megakernel as TMK
from open_whisper_kit_tpu_torch.ops import decode_tp as DTP
from open_whisper_kit_tpu_torch.ops import quant_matmul as Q

CFG = child.TP_CFG
JCFG = M.WhisperConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
K2_TOL = 2e-2
_EXACT = {"xla_allow_excess_precision": False}


def _t(a) -> torch.Tensor:
    return TM._from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def decoders():
    """(JAX prepared decoder, the port's, bit-equal), bf16, seed 0, and the
    natural cross-KV of a random 48-position encoder output, both sides."""
    params = M.init_params(JCFG, seed=0, dtype=jnp.bfloat16, device=False)
    jdec = M.prepare_decoder(params["decoder"])
    tdec = TM.prepare_decoder(TM.params_from_jax(jax.tree.map(np.asarray, params),
                                                 device="cpu")["decoder"])
    enc = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, CFG.n_audio_ctx, CFG.n_audio_state)), jnp.bfloat16)
    xk, xv = M.cross_kv(JCFG, jdec, enc)
    jxk, jxv = JMK.hm_to_natural(xk), JMK.hm_to_natural(xv)
    return jdec, tdec, jxk, jxv


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return child.run_worlds({"tp2": 2, "tp3": 3}, tmp_path_factory.mktemp("tp"))


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_prepare_mega_tp_planes_equal_jax(decoders, tp):
    """Every rank's block of every field equals JAX's (the port pads each
    block to 128 columns, JAX's planes are unpadded), the qkv columns in
    the [q_d | k_d | v_d] order; the vocabulary plane on its V columns."""
    jdec, tdec, _, _ = decoders
    jmp, tmp = JDTP.prepare_mega_tp(JCFG, jdec, tp), DTP.prepare_mega_tp(CFG, tdec, tp)
    assert tmp["tp"] == tp and tmp["n_vocab"] == CFG.n_vocab and tmp["vp"] % (128 * tp) == 0
    for f in ("qkv", "o", "cq", "co", "mlp0", "mlp1"):
        for s in ("_qs", "_sc", "_b"):
            ja = np.asarray(jmp[f + s], np.float32)
            nd = ja.shape[-1] // tp
            for rank in range(tp):
                got = DTP.shard_mega_tp(tmp, rank)[f + s]
                assert got.shape[-1] % 128 == 0
                np.testing.assert_array_equal(got[..., :nd].float().numpy(),
                                              ja[..., rank * nd:(rank + 1) * nd],
                                              err_msg=f"{f}{s} rank {rank}")
    V = CFG.n_vocab
    for s in ("_qs", "_sc"):
        np.testing.assert_array_equal(tmp["teT" + s][:, :V].numpy(),
                                      np.asarray(jmp["teT" + s])[:, :V])
    for k in ("lnw", "lnb", "ln_w", "ln_b"):
        np.testing.assert_array_equal(tmp[k].float().numpy(), np.asarray(jmp[k], np.float32))


def _x0s(seed, R, n):
    g = np.random.default_rng(seed)
    return [jnp.asarray(g.standard_normal((R, CFG.n_text_state)) * 0.1, jnp.bfloat16)
            for _ in range(n)]


@pytest.mark.parametrize("R,heads", [(1, (0, 1, 2)), (3, (4,))])
def test_tp1_step_matches_jax(decoders, R, heads):
    """The port's tp = 1 step against JAX's mega_decode_step_tp compiled
    with _EXACT, from zero caches: logits within K2_TOL of max|ref| with
    equal argmax at every row and step, the written cache rows within
    K2_TOL of their max, the rest zero."""
    jdec, tdec, jxk, jxv = decoders
    jmp = JDTP.prepare_mega_tp(JCFG, jdec, 1)
    mpa = {k: v for k, v in jmp.items() if k in JDTP.tp_param_specs(jmp)}
    tmp = DTP.prepare_mega_tp(CFG, tdec, 1)
    L, S, Tc = CFG.n_text_layer, CFG.n_text_state, 32
    nk = nv = jnp.zeros((L, Tc, S), jnp.bfloat16)
    tk, tv = torch.zeros(L, Tc, S, dtype=torch.bfloat16), torch.zeros(L, Tc, S, dtype=torch.bfloat16)
    x0s = _x0s(5, R, len(heads))
    step = JDTP._step_tp.lower(JCFG, mpa, x0s[0], nk, nv, jnp.int32(0), jxk, jxv, mesh=None,
                               axis="tp", tp=1, n_vocab=CFG.n_vocab).compile(
                                   compiler_options=_EXACT)
    for x0, head in zip(x0s, heads):
        ref, nk, nv = step(mpa, x0, jnp.copy(nk), jnp.copy(nv), jnp.int32(head), jxk, jxv)
        got, tk, tv = DTP.mega_decode_step_tp(CFG, tmp, _t(x0), tk, tv, head, _t(jxk), _t(jxv))
        r, g = np.asarray(ref[:, :CFG.n_vocab]), got.numpy()
        assert g.shape == r.shape == (R, CFG.n_vocab)
        scale = np.abs(r).max()
        np.testing.assert_allclose(g / scale, r / scale, atol=K2_TOL, err_msg=f"head {head}")
        assert (g.argmax(-1) == r.argmax(-1)).all(), f"argmax, head {head}"
    rows = slice(heads[0], heads[-1] + R)
    for ref, got in ((nk, tk), (nv, tv)):
        ref, got = np.asarray(ref, np.float32), got.float().numpy()
        s = np.abs(ref[:, rows]).max()
        np.testing.assert_allclose(got[:, rows] / s, ref[:, rows] / s, atol=K2_TOL)
        assert (got[:, rows.stop:] == 0).all() and (got[:, :rows.start] == 0).all()


@pytest.mark.parametrize("world", [2, 3])
def test_tp_bitwise_equals_tp1(worlds, world):
    """tp = 2 and tp = 3, every rank: the logits of three one-row steps and
    of one three-row step bit-equal to tp = 1's, and the rank's columns of
    the caches bit-equal to those of tp = 1's caches."""
    out = worlds[f"tp{world}"]
    S = CFG.n_text_state
    for rank, got in enumerate(out["ranks"]):
        cols = slice(rank * S // world, (rank + 1) * S // world)
        for (g_logits, g_k, g_v), (r_logits, r_k, r_v) in zip(got, out["ref"]):
            for g, r in zip(g_logits, r_logits):
                np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g_k, r_k[..., cols])
            np.testing.assert_array_equal(g_v, r_v[..., cols])


@pytest.mark.parametrize("world", [2, 3])
def test_shard_calls_keep_the_whole_width_splits(worlds, world):
    """Every K3 call of a rank passes the splits qmm_rows_plan takes for the
    whole width, the same sequence as the tp = 1 run's (a narrower plane's
    own plan can differ: see the next test)."""
    out = worlds[f"tp{world}"]
    assert len(out["calls"]) == len(out["ref_calls"]) > 0
    assert [c[2] for c in out["calls"]] == [c[2] for c in out["ref_calls"]]
    assert all(c[2] is not None for c in out["calls"])


def test_whole_width_splits_differ_from_a_shard_s_own_at_turbo():
    """Why the splits are passed: at large-v3-turbo's fused qkv (K 1280,
    3840 columns) one row takes 4 splits, a tp = 2 shard's 1920 columns
    would take 7 (another f32 sum order on the card), and mlp0 (5120
    columns) 3 against 5."""
    assert Q.qmm_rows_plan(1, 1280, 3840).splits == 4
    assert Q.qmm_rows_plan(1, 1280, 1920).splits == 7
    assert Q.qmm_rows_plan(1, 1280, 5120).splits == 3
    assert Q.qmm_rows_plan(1, 1280, 2560).splits == 5


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("M_,K,N,tp", [(3, 384, 1152, 3), (5, 1280, 1280, 4),
                                       (8, 384, 1536, 2), (16, 256, 640, 5)])
def test_plain_qmm_at_a_shard_is_shard_stable(threads, M_, K, N, tp):
    """On the CPU, qmm with splits (the shard call) sums each column in one
    order: a block of columns, padded to 128, gives that block of the whole
    product bit for bit at several rows and thread counts (a torch matmul
    does not: it blocks its sums by the shape)."""
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        g = torch.Generator().manual_seed(M_ * K)
        w = torch.randn(K, N, generator=g)
        x = torch.randn(M_, K, generator=g)
        whole = Q.quantize_linear(w)
        ref = Q.qmm(x, whole.qs, whole.scales, splits=1)
        nd = N // tp
        for d in range(tp):
            part = Q.quantize_linear(w[:, d * nd:(d + 1) * nd])
            got = Q.qmm(x, part.qs, part.scales, splits=1)
            assert torch.equal(got[:, :nd], ref[:, d * nd:(d + 1) * nd]), d
    finally:
        torch.set_num_threads(old)


def test_tp_step_matches_k2_plain(decoders):
    """The tp = 1 step against K2's plain version on planes of the same
    weights (quant "all"): logits within 2e-2 of max|ref|, argmax equal
    (the two differ in their rounding points: K2 keeps a bf16 residual,
    the tp step an f32 one)."""
    _, tdec, jxk, jxv = decoders
    L, S, Tc = CFG.n_text_layer, CFG.n_text_state, CFG.n_text_ctx
    mp = TMK.prepare_mega(CFG, tdec, quant="all")
    tmp = DTP.prepare_mega_tp(CFG, tdec, 1)
    x0 = _t(_x0s(11, 1, 1)[0])
    z = lambda: torch.zeros(L, Tc, S, dtype=torch.bfloat16)   # noqa: E731
    lm, _, _ = TMK.mega_decode_step(CFG, mp, x0, z(), z(), torch.tensor(0), _t(jxk), _t(jxv))
    lt, _, _ = DTP.mega_decode_step_tp(CFG, tmp, x0, z(), z(), 0, _t(jxk), _t(jxv))
    a, b = lm[0].float().numpy(), lt[0].numpy()
    np.testing.assert_allclose(b / np.abs(a).max(), a / np.abs(a).max(), atol=2e-2)
    assert a.argmax() == b.argmax()


def test_bad_tp_raises(decoders):
    _, tdec, jxk, jxv = decoders
    with pytest.raises(ValueError, match="tp=4"):
        DTP.prepare_mega_tp(CFG, tdec, 4)          # six heads
    mp = DTP.shard_mega_tp(DTP.prepare_mega_tp(CFG, tdec, 2), 0)
    kv = torch.zeros(CFG.n_text_layer, 8, CFG.n_text_state // 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="2 ways"):
        DTP.mega_decode_step_tp(CFG, mp, torch.zeros(1, CFG.n_text_state, dtype=torch.bfloat16),
                                kv, kv.clone(), 0, _t(jxk)[..., :192], _t(jxv)[..., :192])
