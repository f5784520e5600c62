"""Kernel K1 (ops/attention.py::mha_packed) on the CPU: its plain version
against the JAX package's Pallas kernel in interpret mode, and the CPU
routing. The kernel itself is tested on a card in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.ops.attention import _mha_packed, mha_full_xla
from open_whisper_kit_tpu_torch.ops import _build
from open_whisper_kit_tpu_torch.ops import attention as A

torch.set_num_threads(2)


def _qkv(B, T, S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, S)).astype(dtype) for _ in range(3)]


# keep every bf16 rounding of JAX's interpret-mode kernel on the CPU (see
# test_torch_megakernel.py)
_EXACT = {"xla_allow_excess_precision": False}


def _bf16_other_rounding(q, k, v, n_valid):
    """Attention with the exponentials rounded to bf16 before the
    normalisation (out = bf16(e) V / l): the rounding point the kernel must
    not take."""
    B, T, S = q.shape
    qh, kh, vh = (x.float().reshape(B, T, S // 64, 64) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * 0.125
    s[..., n_valid:] = float("-inf")
    e = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(torch.bfloat16).float(), vh)
    return (out / e.sum(-1).transpose(1, 2)[..., None]).reshape(B, T, S)


@pytest.mark.parametrize("B,T,S,n_valid,dtype", [
    pytest.param(1, 256, 128, 250, torch.float32, id="1-256-128-250"),
    pytest.param(2, 256, 256, 200, torch.float32, id="2-256-256-200"),
    pytest.param(1, 384, 128, 384, torch.float32, id="1-384-128-384"),
    pytest.param(2, 384, 256, 250, torch.bfloat16, id="2-384-256-250-bf16")])
def test_mha_packed_plain_matches_pallas_interpret(B, T, S, n_valid, dtype):
    """f32: within 2e-4. bf16 (n_valid not a multiple of the kernels' key
    tiles): both round p = e / sum(e) to bf16, then sum P V in f32 and round
    once, so they differ only where a different f32 summation order flips a
    bf16 rounding: at most one bf16 step at the largest output (2^-8 of
    max|ref|) and in under 1 % of the outputs (0.04 % here). Rounding the
    exponentials before the normalisation instead changes about half of
    them, which the same bound catches."""
    q, k, v = _qkv(B, T, S, seed=T + S + n_valid)
    qt, kt, vt = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    before = A.mha_packed.launches
    got = A.mha_packed(qt, kt, vt, 0.125, n_valid)
    assert A.mha_packed.launches == before      # CPU tensors launch nothing
    assert tuple(got.shape) == (B, T, S) and got.dtype == dtype
    if dtype == torch.float32:
        ref = np.asarray(_mha_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     0.125, n_valid, interpret=True))
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
        return
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    kernel = jax.jit(lambda *a: _mha_packed(*a, 0.125, n_valid, interpret=True))
    ref = torch.from_numpy(np.array(
        kernel.lower(*args).compile(compiler_options=_EXACT)(*args).astype(jnp.float32)))

    def within(out):
        diff = (out.float() - ref).abs()
        return (diff.max().item() <= 2 ** -8 * ref.abs().max().item()
                and (diff > 0).float().mean().item() < 0.01)

    assert within(got)
    assert not within(_bf16_other_rounding(qt, kt, vt, n_valid).to(torch.bfloat16))


@pytest.mark.parametrize("n_head,kv_valid", [(2, None), (2, 190), (4, 150)])
def test_mha_full_cpu_matches_jax(n_head, kv_valid):
    """mha_full on CPU tensors is the plain version (any head width)."""
    q, k, v = _qkv(1, 200, 128, seed=n_head)
    ref = np.asarray(mha_full_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  n_head, 0.125, kv_valid=kv_valid))
    got = A.mha_full(*(torch.from_numpy(x) for x in (q, k, v)), n_head, 0.125,
                     kv_valid=kv_valid)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def _one_pass_chunks(q, k, v, scale, n_valid, plan):
    """K1's f32 body in plain torch (f64 sums aside): the live keys in the
    plan's chunks, each an online softmax over 64-key tiles (running max m,
    sum l, output o, rescaled by exp(m_old - m_new)), the chunks combined in
    chunk order (w = exp(m_c - max m), o / l)."""
    B, T, S = q.shape
    H = S // 64
    qh, kh, vh = (x.reshape(B, T, H, 64).transpose(1, 2) for x in (q, k, v))   # (B, H, T, 64)
    parts = []
    for c in range(plan.chunks):
        lo, hi = c * plan.chunk_keys, min((c + 1) * plan.chunk_keys, n_valid)
        m = torch.full((B, H, T, 1), float("-inf"))
        l, o = torch.zeros(B, H, T, 1), torch.zeros(B, H, T, 64)
        for t0 in range(lo, hi, A.F32_KEYS):
            t1 = min(t0 + A.F32_KEYS, hi)
            s = qh @ kh[:, :, t0:t1].transpose(-1, -2) * scale
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            a = torch.exp(m - mn)
            p = torch.exp(s - mn)
            l, o, m = l * a + p.sum(-1, keepdim=True), o * a + p @ vh[:, :, t0:t1], mn
        parts.append((m, l, o))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mx) for m, _, _ in parts]
    lsum = sum(l * wc for (_, l, _), wc in zip(parts, w))
    osum = sum(o * wc for (_, _, o), wc in zip(parts, w))
    return (osum / lsum).transpose(1, 2).reshape(B, T, S)


@pytest.mark.parametrize("B,T,S,n_valid", [(1, 1536, 128, 1500), (2, 1536, 384, 1500),
                                           (1, 200, 128, 190), (1, 384, 256, 1)])
def test_f32_one_pass_over_the_plans_chunks_matches_jax(B, T, S, n_valid):
    """K1's f32 body computes the full-row softmax of the TPU kernel in one
    pass, its keys split as mha_f32_plan says (a cluster of chunks, each an
    online softmax over 64-key tiles, combined in chunk order): with p's
    cast the identity at f32, that is the same function up to the order of
    the f32 sums, so it holds JAX's interpret-mode kernel to 2e-5 at the
    kernel's shapes (narrow, tiny-like heads, one live key); the ragged T,
    which the TPU kernel does not take, against JAX's XLA attention."""
    q, k, v = _qkv(B, T, S, seed=T + S + n_valid)
    plan = A.mha_f32_plan(B, T, S, n_valid, 132)   # the H100's multiprocessors
    got = _one_pass_chunks(*(torch.from_numpy(x) for x in (q, k, v)), 0.125, n_valid, plan)
    if T % 128:
        ref = np.asarray(mha_full_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      S // 64, 0.125, kv_valid=n_valid))
    else:
        ref = np.asarray(_mha_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     0.125, n_valid, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
