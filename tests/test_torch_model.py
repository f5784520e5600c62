"""The PyTorch port's Whisper model against the JAX package on the same
weights and inputs (CPU, f32, a narrow config with tiny.en's vocabulary
and context lengths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.ops.layers import layer_norm as jax_ln
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops.layers import layer_norm as torch_ln

torch.set_num_threads(2)

NARROW = (51864, 1500, 128, 2, 2, 448, 128, 2, 2, 80)
JCFG = M.WhisperConfig(*NARROW)
TCFG = TM.WhisperConfig(*NARROW)


@pytest.fixture(scope="module")
def jax_params():
    return M.init_params(JCFG, seed=0, dtype=jnp.float32, device=False)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return TM.params_from_jax(jax.tree.map(np.asarray, jax_params), device="cpu")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _bits(x) -> np.ndarray:
    """Raw bits of a jax/numpy or torch array (f32 or bf16)."""
    if isinstance(x, torch.Tensor):
        itype = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return x.contiguous().view(itype).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _nat(hm) -> np.ndarray:
    """JAX head-major (L,B,H,T,dh) -> the port's natural (L,B,T,S)."""
    a = np.asarray(hm)
    L, B, H, T, dh = a.shape
    return a.transpose(0, 1, 3, 2, 4).reshape(L, B, T, H * dh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise_equal(dtype):
    j = dict(_leaves(M.init_params(JCFG, seed=3, dtype=getattr(jnp, dtype),
                                   device=False)))
    t = dict(_leaves(TM.init_params(TCFG, seed=3, dtype=getattr(torch, dtype),
                                    device="cpu")))
    assert sorted(j) == sorted(t)
    for name in j:
        assert tuple(j[name].shape) == tuple(t[name].shape), name
        assert t[name].dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(_bits(j[name]), _bits(t[name]), err_msg=name)


def test_params_from_jax_round_trip():
    tree = jax.tree.map(np.asarray, M.init_params(JCFG, seed=1,
                                                  dtype=jnp.bfloat16, device=False))
    port = TM.params_from_jax(tree, device="cpu")
    flat_j, flat_t = dict(_leaves(tree)), dict(_leaves(port))
    assert sorted(flat_j) == sorted(flat_t)
    for name, a in flat_j.items():
        t = flat_t[name]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(t), err_msg=name)
    # linears stay (in, out), convs (k, in, out)
    assert tuple(port["encoder"]["blocks"]["mlp0_w"].shape) == (2, 128, 512)
    assert tuple(port["encoder"]["conv1_w"].shape) == (3, 80, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x, w, b = (rng.standard_normal(s).astype(np.float32) * 3
               for s in ((5, 7, 128), (128,), (128,)))
    j = jax_ln(jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b, dtype))
    t = torch_ln(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w, b)))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_mm_matches_jax(stride):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 24)).astype(np.float32)
    j = M.conv1d_mm(jnp.asarray(x), jnp.asarray(w), stride)
    t = TM.conv1d_mm(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_encode_with_cross_kv_matches_jax(jax_params, port_params):
    """Full-width window: n_ctx=1500 pads once to 1536 with masked keys."""
    mel = np.random.default_rng(5).standard_normal((1, 3000, 80)).astype(np.float32)
    j_out, j_xk, j_xv = M.encode_with_cross_kv(
        JCFG, jax_params["encoder"], M.prepare_decoder(jax_params["decoder"]),
        jnp.asarray(mel))
    t_out, t_xk, t_xv = TM.encode_with_cross_kv(
        TCFG, port_params["encoder"], TM.prepare_decoder(port_params["decoder"]),
        torch.from_numpy(mel))
    assert tuple(t_out.shape) == (1, 1500, 128)
    assert tuple(t_xk.shape) == (2, 1, 1500, 128)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_xk.numpy(), _nat(j_xk), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_xv.numpy(), _nat(j_xv), atol=1e-4, rtol=1e-4)


def test_encode_short_context_matches_jax(jax_params, port_params):
    """n_ctx < 256 (audio_ctx): no padding, no key mask."""
    mel = np.random.default_rng(6).standard_normal((1, 400, 80)).astype(np.float32)
    j = M.encode(JCFG, jax_params["encoder"], jnp.asarray(mel))
    t = TM.encode(TCFG, port_params["encoder"], torch.from_numpy(mel))
    assert tuple(t.shape) == (1, 200, 128)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)


def test_decode_impl_prompt_and_steps_match_jax(jax_params, port_params):
    """Prompt ingest (logits at the last real position) then three single
    token steps: logits and the KV cache (after the layout transpose)."""
    rng = np.random.default_rng(8)
    enc_out = rng.standard_normal((1, 1500, 128)).astype(np.float32)
    jdec = M.prepare_decoder(jax_params["decoder"])
    tdec = TM.prepare_decoder(port_params["decoder"])
    j_xk, j_xv = M.cross_kv(JCFG, jdec, jnp.asarray(enc_out))
    t_xk, t_xv = TM.cross_kv(TCFG, tdec, torch.from_numpy(enc_out))

    t_real, T_pad = 5, 64
    prompt = np.zeros((1, T_pad), np.int32)
    prompt[0, :t_real] = rng.integers(0, 50000, t_real)
    jk, jv = M.init_kv_cache(JCFG, 1, dtype=jnp.float32)
    tk, tv = TM.init_kv_cache(TCFG, 1, dtype=torch.float32, device="cpu")
    jl, jk, jv, _ = M.decode_impl(JCFG, jdec, jnp.asarray(prompt), jk, jv,
                                  jnp.int32(0), j_xk, j_xv,
                                  logits_pos=jnp.int32(t_real - 1))
    tl, tk, tv = TM.decode_impl(TCFG, tdec, torch.from_numpy(prompt).long(), tk, tv,
                                0, t_xk, t_xv, logits_pos=torch.tensor(t_real - 1))
    assert tuple(tl.shape) == (1, 1, 51864)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)

    for step in range(3):
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
        head = t_real + step
        jl, jk, jv, _ = M.decode_impl(JCFG, jdec, jnp.asarray([[tok]], jnp.int32),
                                      jk, jv, jnp.int32(head), j_xk, j_xv)
        tl, tk, tv = TM.decode_impl(TCFG, tdec, torch.tensor([[tok]]), tk, tv,
                                    torch.tensor(head), t_xk, t_xv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), _nat(jk), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), _nat(jv), atol=1e-4)
