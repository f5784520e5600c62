"""The port's quantized planes and the plain versions of kernels K3, K4 and
K5 against the JAX package (CPU; the JAX kernels run in interpret mode),
and decode_impl on runtime W8/W4 decoders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.io import quant as JQF
from open_whisper_kit_tpu.io.ggml_writer import _encode_tensor
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu.ops import quant_matmul as JQ
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import quant_matmul as TQ

torch.set_num_threads(2)

NARROW = (51864, 1500, 128, 2, 2, 448, 128, 2, 2, 80)


def _eq(jax_arr, t: torch.Tensor, what: str):
    a = np.asarray(jax_arr)
    assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape), what
    np.testing.assert_array_equal(a, t.numpy(), err_msg=what)


def _planes_eq(j, t, what: str, width: int | None = None):
    """Equal on the logical columns; the port pads to a multiple of 128
    (its kernels' column tile), the JAX package to 512. `width`: the
    port's padded width when it differs (planes carried over from JAX)."""
    assert type(t).__name__ == type(j).__name__ and t.n == j.n, what
    n = t.n_out
    padded = j.qs.shape[-1] != n
    assert t.qs.shape[-1] == (width or (-(-n // 128) * 128 if padded else n)), what
    _eq(np.asarray(j.qs)[..., :n], t.qs[..., :n].contiguous(), what + ".qs")
    _eq(np.asarray(j.scales)[..., :n], t.scales[..., :n].contiguous(), what + ".scales")


@pytest.mark.parametrize("qtype", [JQF.GGML_TYPE_Q8_0, JQF.GGML_TYPE_Q5_0,
                                   JQF.GGML_TYPE_Q4_0, JQF.GGML_TYPE_Q5_1])
@pytest.mark.parametrize("out_f", [96, 512])
def test_repack_planes_equal_jax(qtype, out_f):
    """ggml blocks -> (K, Np) int8 + (K/32, Np) f32 planes, Np padded to
    128 (JAX: 512); affine formats (q5_1) have no int8 planes on either side."""
    w = (np.random.default_rng(out_f).standard_normal((out_f, 128)) * 0.1
         ).astype(np.float32)
    blob = _encode_tensor(w, qtype)
    j, t = JQ.repack(blob, qtype, out_f, 128), TQ.repack(blob, qtype, out_f, 128)
    if qtype == JQF.GGML_TYPE_Q5_1:
        assert j is None and t is None
        return
    _planes_eq(j, t, "repack")
    assert t.shape == (128, out_f) and t.qs.shape[1] % 128 == 0


@pytest.mark.parametrize("shape,dtype", [((2, 128, 600), "float32"),
                                         ((128, 1536), "bfloat16"),
                                         ((64, 96), "float32")])
@pytest.mark.parametrize("pad", [True, False])
def test_quantize_linear_planes_equal_jax(shape, dtype, pad):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 0.1
    w[..., :32, :3] = 0.0          # an all-zero block: scale 0, values 0
    j = JQ.quantize_linear(jnp.asarray(w, dtype), pad=pad)
    t = TQ.quantize_linear(torch.from_numpy(w).to(getattr(torch, dtype)), pad=pad)
    _planes_eq(j, t, "quantize_linear")


@pytest.mark.parametrize("shape", [(128, 600), (1280, 64)])
def test_quantize_linear4_planes_equal_jax(shape):
    w = np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32) * 0.1
    w[:32, :2] = 0.0
    _planes_eq(JQ.quantize_linear4(jnp.asarray(w)),
               TQ.quantize_linear4(torch.from_numpy(w)), "quantize_linear4")


def test_concat_quant_and_dequantize_dense_equal_jax():
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal((2, 64, n)).astype(np.float32) for n in (96, 96, 600)]
    j = JQ.concat_quant([JQ.quantize_linear(jnp.asarray(w)) for w in ws])
    t = TQ.concat_quant([TQ.quantize_linear(torch.from_numpy(w)) for w in ws])
    _planes_eq(j, t, "concat_quant")
    assert t.shape == (2, 64, 792)
    _eq(JQ.dequantize_dense(j, jnp.float32), TQ.dequantize_dense(t, torch.float32),
        "dequantize_dense")
    j4 = JQ.quantize_linear4(jnp.asarray(ws[2][0]))
    t4 = TQ.quantize_linear4(torch.from_numpy(ws[2][0]))
    _eq(JQ.dequantize_dense(j4, jnp.float32), TQ.dequantize_dense(t4, torch.float32),
        "dequantize_dense int4")


def _rel_err(ref, got) -> float:
    ref = np.asarray(ref)
    return float(np.abs(ref - got.numpy()).max() / np.abs(ref).max())


@pytest.mark.parametrize("M_rows", [1, 5, 37, 130, 300])
def test_qmm_plain_matches_jax_kernel(M_rows):
    """K3's plain version against the TPU kernel `_qmm` (interpret mode),
    within 1e-5 of max|ref| (f32 summation order)."""
    rng = np.random.default_rng(M_rows)
    w = rng.standard_normal((256, 1000)).astype(np.float32) * 0.1
    x = rng.standard_normal((M_rows, 256)).astype(np.float32)
    j, t = JQ.quantize_linear(jnp.asarray(w)), TQ.quantize_linear(torch.from_numpy(w))
    ref = JQ._qmm(jnp.asarray(x), j.qs, j.scales, interpret=True)
    got = TQ.qmm_plain(torch.from_numpy(x), t.qs, t.scales)
    assert tuple(got.shape) == (M_rows, 1024) and got.dtype == torch.float32
    assert _rel_err(ref, got) <= 1e-5
    # the CPU wrapper is the plain version
    assert torch.equal(TQ.qmm(torch.from_numpy(x), t.qs, t.scales), got)


def test_qmm_route_by_rows():
    """K3's route on the card: the decode rows (M <= 16) take the rows body
    (qmm_rows.cuh), every larger M the 128 x 128 TMA + wgmma tiles of
    qmm_wgmma.cuh (130 and 300 cross the 128-row tile edges)."""
    rows = [1, 5, 16, 17, 130, 300, 1500, 1536, 12288]
    assert [TQ.qmm_route(M) for M in rows] == ["rows"] * 3 + ["tiles"] * 6
    assert set(TQ.qmm.launches_by_route) == {"rows", "tiles"}


@pytest.mark.parametrize("M_rows", [1, 5, 37])
def test_qmm4_plain_matches_jax_kernel(M_rows):
    """K4's plain version rounds each weight (nibble - 8) * s to bf16, as the
    TPU kernel does; JAX's interpret mode keeps it f32. Stated tolerance:
    5e-3 of max|ref| (bf16 weight rounding, relative 2^-9 per weight)."""
    rng = np.random.default_rng(10 + M_rows)
    w = rng.standard_normal((256, 1000)).astype(np.float32) * 0.1
    x = rng.standard_normal((M_rows, 256)).astype(np.float32)
    j, t = JQ.quantize_linear4(jnp.asarray(w)), TQ.quantize_linear4(torch.from_numpy(w))
    ref = JQ._qmm4(jnp.asarray(x), j.qs, j.scales, interpret=True)
    got = TQ.qmm4_plain(torch.from_numpy(x), t.qs, t.scales)
    assert tuple(got.shape) == (M_rows, 1024)
    assert _rel_err(ref, got) <= 5e-3
    # with the same bf16 weights the two agree to f32 summation order
    wb = TQ.dequantize_dense(t, torch.bfloat16).float()
    exact = torch.from_numpy(x).to(torch.bfloat16).float() @ wb
    assert float((exact - got[:, :1000]).abs().max() / exact.abs().max()) <= 1e-5
    assert torch.equal(TQ.qmm4(torch.from_numpy(x), t.qs, t.scales), got)


def _grid_planes(rng, K, N, pad, qmax=127):
    """int8 planes with power-of-two scales: every dequantized weight and
    every product with a 1/16-grid x is exact, so x @ W0 is exact in f32
    in any summation order."""
    qs = rng.integers(-qmax, qmax + 1, (K, N)).astype(np.int8)
    sc = (2.0 ** -rng.integers(6, 9, (K // 32, N))).astype(np.float32)
    Np = -(-N // 512) * 512 if pad else N
    qs = np.pad(qs, ((0, 0), (0, Np - N)))
    sc = np.pad(sc, ((0, 0), (0, Np - N)))
    return (JQ.QuantLinear(jnp.asarray(qs), jnp.asarray(sc), N),
            TQ.QuantLinear(torch.from_numpy(qs), torch.from_numpy(sc), N))


def _ffn_both(M_rows, saturated: bool):
    rng = np.random.default_rng(20 + M_rows)
    j0, t0 = _grid_planes(rng, 128, 1024, pad=False, qmax=8 if saturated else 127)
    j1, t1 = _grid_planes(rng, 1024, 128, pad=True)
    x = (rng.integers(-16, 17, (M_rows, 128)) / 16).astype(np.float32)
    b0 = (rng.integers(-64, 65, 1024) / 256).astype(np.float32)
    if saturated:   # |x @ W0| < 1.2 here, so every |pre-activation| > 6
        b0 += np.where(b0 < 0, -7.5, 7.5).astype(np.float32)
    ref = JQ.fused_ffn_int8(jnp.asarray(x), j0, jnp.asarray(b0), j1)
    got = TQ.fused_ffn_int8(torch.from_numpy(x), t0, torch.from_numpy(b0), t1)
    assert tuple(got.shape) == (M_rows, 128)
    return ref, got


@pytest.mark.parametrize("M_rows", [1, 5, 37, 227])
def test_ffn_int8_plain_matches_jax_kernel(M_rows):
    """K5's plain version against the TPU kernel `_ffn_int8` (interpret
    mode), within 1e-5 of max|ref|: 2 hidden tiles of 512, N padded.
    Pre-activations exact in f32 and past |6|, where tanh is +-1 in both
    libraries: h is rounded to bf16 from the same f32 value on both sides,
    so what remains is the f32 order of the second product's sum."""
    ref, got = _ffn_both(M_rows, saturated=True)
    assert _rel_err(ref, got) <= 1e-5


@pytest.mark.parametrize("M_rows", [1, 5, 37, 227])
def test_ffn_int8_plain_matches_jax_kernel_on_gelu_curve(M_rows):
    """Pre-activations on gelu's curve: XLA's tanh and torch's differ in the
    last place, which flips the bf16 rounding of an occasional h by one
    bf16 step; stated tolerance 1e-3 of max|ref|."""
    ref, got = _ffn_both(M_rows, saturated=False)
    assert _rel_err(ref, got) <= 1e-3


def test_fused_ffn_int8_refuses_padded_w0():
    _, t0 = _grid_planes(np.random.default_rng(0), 128, 256, pad=True)
    with pytest.raises(ValueError, match="pad=False"):
        TQ.fused_ffn_int8(torch.zeros(1, 128), t0, torch.zeros(256), t0)


def test_qmatmul_leading_dims_and_logical_width():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 100)).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    for quant in (TQ.quantize_linear, TQ.quantize_linear4):
        ql = quant(torch.from_numpy(w))
        y = TQ.qmatmul(torch.from_numpy(x), ql)
        assert tuple(y.shape) == (2, 3, 100)
        flat = TQ.qmatmul(torch.from_numpy(x.reshape(6, 64)), ql)
        assert torch.equal(y.reshape(6, 100), flat)


def test_planes_index_stack_and_move():
    w = torch.randn(3, 64, 96, generator=torch.Generator().manual_seed(0))
    ql = TQ.quantize_linear(w)
    assert ql.shape == (3, 64, 96) and ql[1].shape == (64, 96)
    assert torch.equal(TQ.stack([ql[i] for i in range(3)]).qs, ql.qs)
    moved = ql.to("cpu")
    assert isinstance(moved, TQ.QuantLinear) and moved.n == 96
    q4 = TQ.quantize_linear4(w[0])
    assert q4.shape == (64, 96) and isinstance(q4.to("cpu"), TQ.QuantLinear4)


@pytest.fixture(scope="module")
def decoders():
    cfg = M.WhisperConfig(*NARROW)
    params = M.init_params(cfg, seed=0, dtype=jnp.float32, device=False)
    jdec = M.prepare_decoder(params["decoder"])
    tdec = TM.prepare_decoder(TM.params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")["decoder"])
    enc_out = np.random.default_rng(8).standard_normal((1, 1500, 128)).astype(np.float32)
    return jdec, tdec, enc_out


@pytest.mark.parametrize("scope,bits", [("logits", 8), ("mlp", 8), ("all", 8),
                                        ("logits", 4)])
def test_decode_impl_on_int8_decoders_matches_jax(decoders, scope, bits):
    """quantize_decoder_int8 planes equal JAX's; params_from_jax carries the
    JAX planes over bit for bit; a prompt ingest and two steps give the same
    logits (K5 runs for scope mlp/all, K4 for logits_bits=4)."""
    jdec, tdec, enc_out = decoders
    jq = M.quantize_decoder_int8(jdec, scope=scope, logits_bits=bits)
    tq = TM.quantize_decoder_int8(tdec, scope=scope, logits_bits=bits)
    carried = TM.params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    for name, jw in list(jq["blocks"].items()) + [("te_logits", jq["te_logits"])]:
        tw = tq["te_logits"] if name == "te_logits" else tq["blocks"][name]
        cw = carried["te_logits"] if name == "te_logits" else carried["blocks"][name]
        if isinstance(jw, (JQ.QuantLinear, JQ.QuantLinear4)):
            _planes_eq(jw, tw, name)
            _planes_eq(jw, cw, name + " (params_from_jax)", width=jw.qs.shape[-1])
        else:
            assert isinstance(tw, torch.Tensor), name
    quantized = {n for n, w in tq["blocks"].items() if isinstance(w, TQ.QuantPlanes)}
    assert quantized == {"logits": set(), "mlp": {"mlp0_w", "mlp1_w"},
                         "all": {"qkv_w", "o_w", "cq_w", "co_w", "mlp0_w", "mlp1_w"}}[scope]

    cfg, tcfg = M.WhisperConfig(*NARROW), TM.WhisperConfig(*NARROW)
    j_xk, j_xv = M.cross_kv(cfg, jq, jnp.asarray(enc_out))
    t_xk, t_xv = TM.cross_kv(tcfg, tq, torch.from_numpy(enc_out))
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :4] = [50257, 50362, 220, 1000]
    jk, jv = M.init_kv_cache(cfg, 1, dtype=jnp.float32)
    tk, tv = TM.init_kv_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    jl, jk, jv, _ = M.decode_impl(cfg, jq, jnp.asarray(prompt), jk, jv, jnp.int32(0),
                                  j_xk, j_xv, logits_pos=jnp.int32(3))
    tl, tk, tv = TM.decode_impl(tcfg, tq, torch.from_numpy(prompt).long(), tk, tv, 0,
                                t_xk, t_xv, logits_pos=torch.tensor(3))
    # stated tolerances: K4's plain version rounds the int4 weights to bf16
    # (TPU semantics), JAX's interpret mode does not (2e-3); K5 rounds h to
    # bf16, and a last-place difference in x @ W0 or tanh between XLA and
    # torch flips an occasional h by one bf16 step (5e-3, logits ~1)
    tol = 2e-3 if bits == 4 else 5e-3 if scope in ("mlp", "all") else 1e-4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)
    for head in (4, 5):
        tok = int(np.argmax(np.asarray(jl)[0, -1]))
        jl, jk, jv, _ = M.decode_impl(cfg, jq, jnp.asarray([[tok]], jnp.int32), jk, jv,
                                      jnp.int32(head), j_xk, j_xv)
        tl, tk, tv = TM.decode_impl(tcfg, tq, torch.tensor([[tok]]), tk, tv,
                                    torch.tensor(head), t_xk, t_xv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)


def test_quantize_decoder_int8_skips_what_jax_skips(decoders):
    """Already-quantized weights and an existing te_logits stay as they are."""
    _, tdec, _ = decoders
    once = TM.quantize_decoder_int8(tdec, scope="all")
    twice = TM.quantize_decoder_int8(once, scope="all", logits_bits=4)
    assert twice["te_logits"] is once["te_logits"]
    assert all(twice["blocks"][n] is once["blocks"][n] for n in once["blocks"])
    assert dataclasses.is_dataclass(once["blocks"]["mlp0_w"])
    assert once["blocks"]["mlp0_w"].qs.shape[-1] == 512    # unpadded W0
