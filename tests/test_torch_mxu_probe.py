"""The port's tensor-core probe (open_whisper_kit_tpu_torch/tools/
bench_int8_mxu.py) against the JAX package's tools/bench_int8_mxu.py on
the CPU: the quantizers, the operands, the plain versions of kernels T1
(mm_bf16) and T2 (mm_s8) against the probe's Pallas kernels in interpret
mode, the four chained steps and two-iteration chains, and the entry point.

The JAX probe is loaded from its file; its kernels run in interpret mode
and at a narrow shape (M, K, F) = (256, 256, 512) by patching the module's
`pl`, `M`, `K`, `F` and `NITER` (its kernels read `M` when they are built,
its steps `K` and `F`, its chain `NITER`). Nothing in tools/ changes.
"""

import functools
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from open_whisper_kit_tpu_torch.ops import gemm as G
from open_whisper_kit_tpu_torch.tools import bench_int8_mxu as P

torch.set_num_threads(2)

MN, KN, FN = 256, 256, 512        # narrow probe shape, two 128 x 128 tiles a side
EXACT = {"xla_allow_excess_precision": False}   # keep every bf16 rounding on the CPU
PROBE = Path(__file__).resolve().parent.parent / "tools" / "bench_int8_mxu.py"


@pytest.fixture(scope="module")
def jax_probe_module():
    spec = importlib.util.spec_from_file_location("_jax_bench_int8_mxu", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def J(jax_probe_module, monkeypatch):
    """The JAX probe at the narrow shape, its Pallas kernels interpreted."""
    mod = jax_probe_module
    monkeypatch.setattr(mod, "pl", SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    for name, value in (("M", MN), ("K", KN), ("F", FN), ("NITER", 2)):
        monkeypatch.setattr(mod, name, value)
    return mod


def _jx(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype in (np.int8, np.float32) else a.astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(_np(a).copy())


@pytest.fixture(scope="module")
def ops():
    """The narrow operands, the int8 planes and their JAX twins."""
    x0, w1, w2 = P.operands(MN, KN, FN, "cpu")
    w1q, w1s = P.quant_cols(w1)
    w2q, w2s = P.quant_cols(w2)
    t = SimpleNamespace(x0=x0, w1=w1, w2=w2, w1q=w1q, w1s=w1s, w2q=w2q, w2s=w2s)
    j = SimpleNamespace(**{k: _jx(v) for k, v in vars(t).items()})
    return t, j


def test_quantizers_match_jax(jax_probe_module):
    """quant_rows equals the probe's quant_rows as its chain runs it
    (jitted: the scale is amax * f32(1/127)), quant_cols the probe's eager
    quant_cols (amax / 127 by IEEE division), bit for bit, an all-zero row
    and column included. Rows span five decades of scale."""
    J = jax_probe_module
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((300, 640)) * rng.uniform(1e-3, 1e2, (300, 1))).astype(np.float32)
    x[3] = 0
    for xt, xj in ((torch.from_numpy(x), jnp.asarray(x)),
                   (torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16))):
        q, s = P.quant_rows(xt)
        jq, js = jax.jit(J.quant_rows)(xj)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert not q[3].any() and not s[3, 0]
    w = x.T.copy()                 # the zero row is now column 3
    q, s = P.quant_cols(torch.from_numpy(w))
    jq, js = J.quant_cols(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not q[:, 3].any() and not s[0, 3]


def test_operands_match_jax(jax_probe_module):
    """X0, W1, W2 at the probe's default shape: the same bf16 bits, and the
    int8 planes and scales quantized from them equal."""
    J = jax_probe_module
    got = P.operands(P.M, P.K, P.F_, "cpu")
    for name, t in zip(("X0", "W1", "W2"), got):
        ref = np.asarray(getattr(J, name)).view(np.uint16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), ref,
                                      err_msg=name)
    w1q, w1s = P.quant_cols(got[1])
    np.testing.assert_array_equal(w1q.numpy(), np.asarray(J.W1q))
    np.testing.assert_array_equal(w1s.numpy(), np.asarray(J.W1s))


@pytest.mark.parametrize("product", ["x @ W1", "h @ W2"])
def test_mm_plain_versions_match_pallas_kernels(J, ops, product):
    """mm_s8_plain is bit-equal to the probe's pallas_mm_s8 (interpret
    mode); mm_bf16_plain is within one bf16 ulp of pallas_mm_bf16 at every
    element, few values differ at all (the f32 sums run in another order;
    gemm.mm_bf16_within states the limits). Both
    products' shapes; an all-zero row of x gives a zero row."""
    t, j = ops
    if product == "x @ W1":
        x, w, wq, ws, nk, nn = t.x0.clone(), t.w1, t.w1q, t.w1s, KN, FN
    else:
        x = P.operands(MN, FN, KN, "cpu")[0] * 4
        w, wq, ws, nk, nn = t.w2, t.w2q, t.w2s, FN, KN
    x[5] = 0
    xq, xs = P.quant_rows(x)
    ref = _t(J.pallas_mm_s8(128, 128, nk, nn)(_jx(xq), _jx(xs), _jx(wq), _jx(ws)))
    got = G.mm_s8_plain(xq, xs, wq.t().contiguous(), ws)
    assert got.dtype == torch.bfloat16 and got.shape == (MN, nn)
    np.testing.assert_array_equal(got.float().numpy(), ref.numpy())
    assert not got[5].any()

    ref = _t(J.pallas_mm_bf16(128, 128, nk, nn)(_jx(x), _jx(w)))
    r = G.mm_bf16_within(G.mm_bf16_plain(x, w), ref, x, w)
    assert r["ok"], r


STEP_TOL = 4e-3    # of max|ref|: one bf16 step at the largest output
CHAIN_TOL = 1e-2   # of max|ref|, after two renormalised iterations


def _steps(J, t, j):
    """(name, JAX step, its args, port step, its args) for the four steps."""
    jw8, tw8 = (j.w1q, j.w1s, j.w2q, j.w2s), (t.w1q, t.w1s, t.w2q, t.w2s)
    return [("library bf16", J.step_bf16, (j.w1, j.w2), P.step_bf16, (t.w1, t.w2)),
            ("library W8A8", J.step_xla_s8, jw8, P.step_xla_s8, tw8),
            ("T1", J.make_step_pallas_bf16(128, 128), (j.w1, j.w2),
             P.make_step_pallas_bf16(t.w1, t.w2), ()),
            ("T2", J.make_step_pallas_s8(128, 128), jw8,
             P.make_step_pallas_s8(*tw8), ())]


@pytest.mark.parametrize("which", range(4), ids=["bf16", "xla_s8", "T1", "T2"])
def test_steps_and_chains_match_jax(J, ops, which):
    """Each step and a two-iteration chain of it against the JAX probe's,
    compiled with every bf16 rounding kept: the step within STEP_TOL of
    max|ref| (tanh gelu differs in the last f32 place between the
    frameworks, which can flip a bf16 rounding of h or move one int8
    rounding), the chain within CHAIN_TOL (the flips pass through a second
    iteration)."""
    t, j = ops
    name, jstep, jws, tstep, tws = _steps(J, t, j)[which]
    for jf, tf, tol in ((jstep, tstep, STEP_TOL),
                        (J.chain(jstep), P.chain(tstep, 2), CHAIN_TOL)):
        args = (j.x0, *jws)
        ref = _t(jax.jit(jf).lower(*args).compile(compiler_options=EXACT)(*args))
        got = tf(t.x0, *tws).float()
        assert got.shape == ref.shape == (MN, KN)
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), f"{name}: {err}"


def test_wrappers_take_plain_versions_on_cpu_only(ops):
    """On CPU tensors the wrappers are their plain versions and count no
    launch; any other device that is not CUDA raises."""
    t, _ = ops
    xq, xs = P.quant_rows(t.x0)
    w1t = t.w1q.t().contiguous()
    before = (G.mm_bf16.launches, G.mm_s8.launches)
    assert torch.equal(G.mm_bf16(t.x0, t.w1), G.mm_bf16_plain(t.x0, t.w1))
    assert torch.equal(G.mm_s8(xq, xs, w1t, t.w1s), G.mm_s8_plain(xq, xs, w1t, t.w1s))
    assert (G.mm_bf16.launches, G.mm_s8.launches) == before
    meta = torch.empty(128, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        G.mm_bf16(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        G.mm_s8(meta.to(torch.int8), meta.float()[:, :1], meta.to(torch.int8),
                meta.float()[:1])


def test_main_on_cpu_prints_rows(capsys):
    """The entry point on the CPU at the narrow shape: the header, the two
    library rows, T1 and T2 (each at its plan's tiles on the card); times
    but no share of a device peak."""
    rows = P.main(["--device", "cpu", "--shape", f"{MN},{KN},{FN}", "--niter", "2"])
    out = capsys.readouterr().out
    assert f"MLP pair ({MN},{KN})x({KN},{FN})x({FN},{KN}), 2 chained iters" in out
    assert [r["name"] for r in rows] == [
        "torch bf16 (torch.mm, f32 out)", "torch W8A8 (_int_mm, incl act quant)",
        "T1 bf16", "T2 W8A8 (incl act quant)"]
    for r in rows:
        assert r["name"] in out and r["us_per_iter"] > 0 and r["peak_share"] is None
        assert r["us_min"] <= r["us_per_iter"] <= r["us_max"]
    assert rows[0]["top_s"] == pytest.approx(P.gop(MN, KN, FN) / rows[0]["us_per_iter"] * 1e3)


def _bf16_truncated(s: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 by dropping the low 16 bits (round toward zero)."""
    return (s.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)


def _short_sums(a: torch.Tensor, b: torch.Tensor, bits: int = 14) -> torch.Tensor:
    """a @ b with the running sum rounded to `bits` significant bits after
    every 16 products (a sum kept in less than f32), then to bf16."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 16):
        m, e = torch.frexp(acc + a[:, k:k + 16].float() @ b[k:k + 16].float())
        acc = torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits, e)
    return acc.to(torch.bfloat16)


@pytest.mark.parametrize("epilogue", ["nearest even", "truncating", "14-bit sums"])
def test_mm_bf16_gate_holds_the_rounding(ops, epilogue):
    """T1's gate (gemm.mm_bf16_within) against the plain version takes a
    sum of another order rounded to nearest even, and refuses an epilogue
    that truncates and a sum kept to 14 significant bits: both stay within
    one ulp plus the f32 order term at every value, and only the shares of
    values that differ (truncating: half) or differ by more than one ulp
    (14-bit sums: 3e-3) give them away."""
    t, _ = ops
    a, b = t.x0, t.w1
    ref = G.mm_bf16_plain(a, b)
    got = {"nearest even": lambda: (a.float().flip(1) @ b.float().flip(0)).to(torch.bfloat16),
           "truncating": lambda: _bf16_truncated(a.float() @ b.float()),
           "14-bit sums": lambda: _short_sums(a, b)}[epilogue]()
    r = G.mm_bf16_within(got, ref, a, b)
    assert r["past_bound"] == 0 and r["ok"] == (epilogue == "nearest even"), r


def test_main_without_cuda_raises(monkeypatch):
    """The default device is the card: without CUDA the probe raises
    before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main([])
