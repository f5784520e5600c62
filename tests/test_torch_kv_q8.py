"""The int8 self-KV cache (model.init_kv_cache_q8 and decode_impl's
quantized self-cache) in the port against the JAX package (CPU, f32): the
same steps from the same weights give logits within 1e-5 of max|ref| and
the same int8 planes but for rounding ties; and, as JAX's own test holds
its cache, logits within 5e-2 of the float cache's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu_torch.models.whisper import model as TM

# JAX's test_decode_impl_q8_self_kv_matches_bf16 config
ARGS = (384, 64, 128, 2, 2, 48, 128, 2, 2, 80)


def _setup():
    cfg = M.WhisperConfig(*ARGS)
    params = M.init_params(cfg, seed=3, dtype=jnp.float32, device=False)
    jdec = M.prepare_decoder(params["decoder"])
    tdec = TM.prepare_decoder(TM.params_from_jax(jax.tree.map(np.asarray, params),
                                                 device="cpu")["decoder"])
    enc = jnp.asarray(np.random.default_rng(5).standard_normal((2, 64, 128)), jnp.float32)
    xk, xv = M.cross_kv(cfg, jdec, enc)

    def nat(a):          # head-major (L, B, H, T, dh) -> natural (L, B, T, S)
        a = np.asarray(a)
        L, B, H, T, dh = a.shape
        return torch.from_numpy(a.transpose(0, 1, 3, 2, 4).reshape(L, B, T, H * dh).copy())
    return cfg, TM.WhisperConfig(*ARGS), jdec, tdec, xk, xv, nat(xk), nat(xv)


def test_init_kv_cache_q8_shapes():
    cfg = TM.WhisperConfig(*ARGS)
    kb, vb = TM.init_kv_cache_q8(cfg, 3, device="cpu")
    jk, _ = M.init_kv_cache_q8(M.WhisperConfig(*ARGS), 3)
    for t in (kb, vb):
        assert isinstance(t, TM.QuantKV)
        assert tuple(t.qs.shape) == jk.qs.shape and t.qs.dtype == torch.int8
        assert tuple(t.scale.shape) == jk.scale.shape and t.scale.dtype == torch.float32
        assert not t.qs.any() and not t.scale.any()


def test_q8_self_cache_matches_jax():
    """A three-token prompt, then five one-token steps (JAX's greedy
    tokens) on the int8 self-cache, JAX's jitted decode against the port's
    decode_impl: logits within 1e-5 of max|ref| at every step; the int8
    planes equal but for entries one apart, where the two sides' f32
    products land on either side of a rounding tie (at most 1 in 1000),
    and the scales within 1e-6."""
    cfg, tcfg, jdec, tdec, xk, xv, txk, txv = _setup()
    jk, jv = M.init_kv_cache_q8(cfg, 2)
    tk, tv = TM.init_kv_cache_q8(tcfg, 2, device="cpu")
    tok = np.asarray([[5, 7, 9], [9, 11, 13]], np.int32)
    head = 0
    for i in range(6):
        jl, jk, jv, _ = M.decode(cfg, jdec, jnp.asarray(tok), jk, jv, jnp.int32(head), xk, xv)
        tl, tk, tv = TM.decode_impl(tcfg, tdec, torch.from_numpy(tok).long(), tk, tv, head,
                                    txk, txv)
        r, g = np.asarray(jl), tl.numpy()
        scale = np.abs(r).max()
        np.testing.assert_allclose(g / scale, r / scale, atol=1e-5, err_msg=f"step {i}")
        head += tok.shape[1]
        tok = r[:, -1].argmax(-1)[:, None].astype(np.int32)
    for j, t in ((jk, tk), (jv, tv)):
        jq, tq = np.asarray(j.qs).astype(np.int32), t.qs.numpy().astype(np.int32)
        diff = np.abs(jq - tq)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=1e-6, atol=0)
        assert (tq[:, :, :, head:] == 0).all()


def test_q8_self_cache_tracks_the_float_cache():
    """JAX's own check on the port: greedy steps on the int8 and the f32
    self-cache stay within 5e-2 of max|logit| of each other."""
    _, tcfg, _, tdec, _, _, txk, txv = _setup()
    ka, va = TM.init_kv_cache(tcfg, 2, torch.float32, device="cpu")
    kb, vb = TM.init_kv_cache_q8(tcfg, 2, device="cpu")
    tok = torch.tensor([[5], [9]])
    for i in range(6):
        la, ka, va = TM.decode_impl(tcfg, tdec, tok, ka, va, i, txk, txv)
        lb, kb, vb = TM.decode_impl(tcfg, tdec, tok, kb, vb, i, txk, txv)
        ra, rb = la[:, -1], lb[:, -1]
        rel = ((ra - rb).abs().max() / (ra.abs().max() + 1e-6)).item()
        assert rel < 5e-2, (i, rel)
        tok = ra.argmax(1)[:, None]
