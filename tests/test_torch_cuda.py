"""The port on a CUDA card: kernels K1, K2 (one row and the speculative
verify rows), K3, K4, K5, K6, K7, K8, K9a, K9b, T1 and T2 against their
plain versions (K2 and K8 also bit-equal across launches, behind a spin
and, for K8, across identical streams), the
device token loops (greedy, beam and speculative) on the card against the
same loops on the CPU, and a narrow q8_0 checkpoint's transcript on the
card and the CPU.

Every test here needs a GPU and skips without one. The file imports no jax,
so it also runs where the JAX package is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

from open_whisper_kit_tpu_torch.audio import mel as mel_mod
from open_whisper_kit_tpu_torch.decode import device_beam as DB
from open_whisper_kit_tpu_torch.decode import device_loop as DL
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.decode.tokenizer import build_vocab
from open_whisper_kit_tpu_torch.io import ggml_writer as TW
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import attention as A
from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
from open_whisper_kit_tpu_torch.ops import experiments as TE
from open_whisper_kit_tpu_torch.ops import quant_matmul as TQ

pytestmark = pytest.mark.cuda

NARROW_TS = (51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,S,tol", [(torch.bfloat16, 1280, 1e-2),
                                         (torch.float32, 128, 1e-4)])
@pytest.mark.parametrize("B,T,n_valid", [(1, 1536, 1500), (1, 200, 190), (8, 1536, 1500),
                                         (1, 1536, 1536), (8, 1536, 1536), (1, 1536, 190),
                                         (8, 1536, 190), (1, 1536, 1), (8, 1536, 1)])
def test_mha_packed_kernel_matches_plain(cuda, dtype, S, tol, B, T, n_valid):
    """The kernel against its plain version at large-v3-turbo's encoder shape
    for one window and a batched round of eight, with every key live, one
    ragged key tile, a few tiles and one key. T=200: bf16 reads the ragged
    rows through its TMA maps (zero past T), f32 through its zero-filling
    loads. The bf16 gate is relative to max|ref|."""
    g = torch.Generator(device=cuda).manual_seed(T + S + n_valid)
    q, k, v = (torch.randn(B, T, S, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    ref = A.mha_plain(q, k, v, S // 64, 0.125, n_valid)
    before = A.mha_packed.launches
    out = A.mha_packed(q, k, v, 0.125, n_valid)
    torch.cuda.synchronize()
    assert A.mha_packed.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    limit = tol * ref.float().abs().max().item() if dtype == torch.bfloat16 else tol
    assert (out.float() - ref.float()).abs().max().item() <= limit


@pytest.mark.parametrize("B,T,S,n_valid", [(1, 1536, 128, 1500), (1, 1536, 1280, 1500),
                                           (2, 1500, 384, 1500), (1, 1536, 1280, 190),
                                           (2, 1500, 384, 377), (8, 1536, 128, 1500)])
def test_mha_packed_f32_one_pass_matches_plain(cuda, B, T, S, n_valid):
    """K1's f32 body (one pass, the live keys split over a cluster as
    mha_f32_plan says, 3xTF32 products) within 2e-5 of the plain version at
    the narrow models' width, large-v3-turbo's, a ragged T that the wrapper
    no longer pads (1500 rows: the last query tile holds 28) and n_valid < T;
    every launch one cluster per query tile."""
    g = torch.Generator(device=cuda).manual_seed(B + T + S + n_valid)
    q, k, v = (torch.randn(B, T, S, generator=g, device=cuda) for _ in range(3))
    ref = A.mha_plain(q, k, v, S // 64, 0.125, n_valid)
    before = A.mha_packed.launches
    out = A.mha_packed(q, k, v, 0.125, n_valid)
    torch.cuda.synchronize()
    assert A.mha_packed.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= 2e-5


def test_mha_packed_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros(1, 128, 128, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        A.mha_packed(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, 0.1, 128)
    with pytest.raises(ValueError, match="dtype"):
        A.mha_packed(q.half(), q.half(), q.half(), 0.1, 128)
    with pytest.raises(ValueError, match="n_valid"):
        A.mha_packed(q, q, q, 0.1, 0)
    shifted = torch.zeros(128 * 128 + 1, dtype=torch.bfloat16, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):   # the TMA maps need aligned rows
        A.mha_packed(shifted.view(1, 128, 128), q.bfloat16(), q.bfloat16(), 0.1, 128)
    with pytest.raises(NotImplementedError, match="head dim"):
        A.mha_full(q, q, q, 4, 0.1)


def test_decode_segment_cuda_matches_cpu(cuda):
    """Encoder (through K1) and the greedy token loop, f32, on the card and
    on the CPU: the same tokens, probabilities within 1e-4."""
    cfg = TM.WhisperConfig(*NARROW_TS)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = [b"<%d>" % i for i in range(50257)]
    samples = (np.random.default_rng(2).standard_normal(16000 * 20)
               .astype(np.float32) * 0.1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ctx = TF.WhisperContext(cfg, params, build_vocab(tokens, cfg.n_vocab),
                                TF._synthetic_mel_filters(80), n_loaded=1,
                                dtype=torch.float32, device=dev)
        mel = mel_mod.log_mel_spectrogram(samples, ctx.filters, dev)
        enc, xk, xv = ctx.encode_window(mel.data, 0, 0)
        v = ctx.vocab
        toks, t_real = TF._pad_prompt(cfg, [v.token_sot], dev)
        res = DL.decode_segment(cfg, ctx.rule_config, ctx.params["decoder"], toks, xk,
                                xv, *ctx.rule_masks(FullParams()),
                                (t_real, v.token_nosp, 0, mel.n_len_org), n_max=220,
                                reads=ctx.reads, cache_dtype=torch.float32)
        out[dev.type] = (enc.cpu(), DL.unpack_segment_result(
            ctx.reads.fetch(DL.pack_segment_result(res)), 220))
    (enc_g, rg), (enc_c, rc) = out["cuda"], out["cpu"]
    assert (enc_g - enc_c).abs().max().item() <= 1e-4
    assert rg["n_tokens"] == rc["n_tokens"] > 0
    np.testing.assert_array_equal(rg["tokens"], rc["tokens"])
    assert (rg["result_len"], rg["seek_delta"]) == (rc["result_len"], rc["seek_delta"])
    np.testing.assert_allclose(rg["p"], rc["p"], atol=1e-4)


def _planes(cuda, K, N, seed, bits=8, pad=True):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=cuda) * K ** -0.5
    if bits == 4:
        return TQ.quantize_linear4(w)
    return TQ.quantize_linear(w, pad=pad)


def _x(cuda, M, K, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(M, K, generator=g, device=cuda).to(dtype)


def _close(out, ref, tol=1e-3):
    err = (out - ref).abs().max().item()
    assert torch.isfinite(out).all() and err <= tol * ref.abs().max().item(), err


@pytest.mark.parametrize("M,K,N,dtype", [
    (1, 1280, 51866, torch.bfloat16),     # W8 logits plane, Np = 52224
    (5, 1280, 3840, torch.bfloat16),      # decoder qkv at 5 rows, Np = 4096
    (1536, 1280, 1280, torch.bfloat16),   # encoder q/k/v/o, Np = 1536
    (37, 256, 600, torch.float32),        # an f32 model's x, odd M
    # the tiles route: the fewest rows it takes, 128-row tile edges, the
    # cross-KV's 1500 and the encoder's 1536, at every encoder (K, N)
    *[(M, K, N, torch.bfloat16) for M in (17, 130, 1500, 1536)
      for K, N in ((1280, 1280), (1280, 5120), (5120, 1280))],
])
def test_qmm_kernel_matches_plain(cuda, M, K, N, dtype):
    """K3 against its plain version within 1e-3 of max|ref| (f32 sums in
    another order); the launch counter and its route's count grow by one."""
    w = _planes(cuda, K, N, seed=M)
    x = _x(cuda, M, K, seed=M + 1, dtype=dtype)
    before, route = TQ.qmm.launches, TQ.qmm_route(M)
    on_route = TQ.qmm.launches_by_route[route]
    out = TQ.qmm(x, w.qs, w.scales)
    torch.cuda.synchronize()
    assert TQ.qmm.launches == before + 1
    assert TQ.qmm.launches_by_route[route] == on_route + 1
    assert out.shape == (M, w.qs.shape[1]) and out.dtype == torch.float32
    _close(out, TQ.qmm_plain(x, w.qs, w.scales))


@functools.cache
def _rows_plane(K, N):
    """One int8 plane per (K, N) for the rows-route cases, made once."""
    return _planes(torch.device("cuda"), K, N, seed=K + N)


@pytest.mark.parametrize("N", [1280, 3840, 51866])
@pytest.mark.parametrize("M", range(1, 17))
def test_qmm_rows_kernel_matches_plain(cuda, M, N):
    """K3's rows route (csrc/qmm_rows.cu) against its plain version for
    every M it takes, at K = 1280 and the decoder's o/cq/co, qkv and W8
    logits widths (51866 padded to 51968), within 1e-3 of max|ref|; one
    launch per call, counted on the rows route."""
    w = _rows_plane(1280, N)
    x = _x(cuda, M, 1280, seed=M + N)
    before, rows = TQ.qmm.launches, TQ.qmm.launches_by_route["rows"]
    out = TQ.qmm(x, w.qs, w.scales)
    torch.cuda.synchronize()
    assert TQ.qmm_route(M) == "rows"
    assert (TQ.qmm.launches, TQ.qmm.launches_by_route["rows"]) == (before + 1, rows + 1)
    assert out.shape == (M, w.qs.shape[1])
    _close(out, TQ.qmm_plain(x, w.qs, w.scales))


@pytest.mark.parametrize("M,K,N", [(1, 1312, 1280), (3, 1312, 1280), (9, 2080, 640),
                                   (16, 5120, 1280), (2, 96, 128)])
def test_qmm_rows_uneven_splits(cuda, M, K, N):
    """K whose 32-row scale blocks do not divide evenly into the plan's
    splits, K = 5120 at 16 rows (x's rows of a split fill the 40 KB the
    plan allows them) and a plane of three scale blocks in one column tile:
    within 1e-3 of max|ref|."""
    plan = TQ.qmm_rows_plan(M, K, -(-N // 128) * 128)
    sizes = {stop - start for start, stop in plan.split_rows()}
    assert plan.splits > 1 and (len(sizes) > 1 or K // 32 % plan.splits == 0)
    w = _planes(cuda, K, N, seed=K)
    x = _x(cuda, M, K, seed=M)
    out = TQ.qmm(x, w.qs, w.scales)
    torch.cuda.synchronize()
    _close(out, TQ.qmm_plain(x, w.qs, w.scales))


@pytest.mark.parametrize("M,N", [(1, 1280), (5, 3840), (16, 1280), (1, 51866)])
def test_qmm_rows_is_deterministic(cuda, M, N):
    """The splits' partial sums are added in split order by the last block
    of each column tile: two launches give the same bits."""
    w = _rows_plane(1280, N)
    x = _x(cuda, M, 1280, seed=3 * M)
    first = TQ.qmm(x, w.qs, w.scales)
    second = TQ.qmm(x, w.qs, w.scales)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _sass(name):
    """cuobjdump -sass of the kernel library `name` (skips without the tool)."""
    import shutil
    import subprocess
    from pathlib import Path
    from open_whisper_kit_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        pytest.skip("cuobjdump not found")
    return subprocess.run([tool, "-sass", str(_build.build(name))], capture_output=True,
                          text=True, check=True).stdout


@pytest.mark.parametrize("name", ["mha_packed", "qmm", "mm_bf16", "w8a8"])
def test_redesigned_kernels_run_wgmma(cuda, name):
    """K1's, K3's tiles route's, T1's and K6's (with T2's) libraries hold
    Hopper warpgroup products (HGMMA in the SASS; the s8 GEMM of K6 and T2
    IGMMA, the integer warpgroup product) and no warp-level mma.sync (HMMA,
    IMMA) outside K1's f32 body, whose 3xTF32 products are mma.sync in TF32
    (HMMA.1688.F32.TF32); K3's rows route (mma.sync) is a library of its
    own."""
    sass = _sass(name)
    assert ("IGMMA" if name == "w8a8" else "HGMMA") in sass
    for body in sass.split("Function : ")[1:]:
        if "mha_packed_f32_kernel" in body.split("\n", 1)[0]:
            assert "HMMA.1688.F32.TF32" in body and "HGMMA" not in body
        else:
            assert "HMMA" not in body and "IMMA" not in body


@pytest.mark.parametrize("M", [1, 5])
def test_qmm4_kernel_matches_plain(cuda, M):
    w = _planes(cuda, 1280, 51866, seed=7, bits=4)
    x = _x(cuda, M, 1280, seed=8)
    before = TQ.qmm4.launches
    out = TQ.qmm4(x, w.qs, w.scales)
    torch.cuda.synchronize()
    assert TQ.qmm4.launches == before + 1
    _close(out, TQ.qmm4_plain(x, w.qs, w.scales))


@functools.cache
def _ffn_planes(S):
    """K5's planes at model width S (W0 S -> 4S unpadded, W1 4S -> S) and
    its bias, made once per width."""
    cuda = torch.device("cuda")
    w0 = _planes(cuda, S, 4 * S, seed=9, pad=False)
    w1 = _planes(cuda, 4 * S, S, seed=10)
    b0 = torch.randn(4 * S, generator=torch.Generator(device=cuda).manual_seed(11),
                     device=cuda).to(torch.bfloat16) * 0.1
    return w0.qs, w0.scales, b0, w1.qs, w1.scales


@pytest.mark.parametrize("S", [1280, 384])
@pytest.mark.parametrize("M", [1, 2, 5, 8, 16, 40])
def test_ffn_int8_kernel_matches_plain(cuda, M, S):
    """K5 at whisper-large widths (1280 -> 5120 -> 1280) and tiny's (384 ->
    1536 -> 384) within 1e-3 of max|ref|; M <= 16 runs the rows body (two
    launches, the second a dependent launch), 40 rows the 64-row tiles.
    One call counted per call, on its route."""
    w = _ffn_planes(S)
    x = _x(cuda, M, S, seed=12 + M)
    route = TQ.ffn_int8_route(M)
    assert route == ("rows" if M <= 16 else "tiles")
    before, on_route = TQ.ffn_int8.launches, TQ.ffn_int8.launches_by_route[route]
    out = TQ.ffn_int8(x, *w)
    torch.cuda.synchronize()
    assert TQ.ffn_int8.launches == before + 1
    assert TQ.ffn_int8.launches_by_route[route] == on_route + 1
    assert out.shape == (M, S)
    _close(out, TQ.ffn_int8_plain(x, *w))


@pytest.mark.parametrize("M", [1, 5, 16])
def test_ffn_int8_back_to_back_calls(cuda, M):
    """Two K5 calls queued back to back behind a 2 ms spin, with different
    x, each output checked against its own plain version: the second
    call's first launch must not overlap the first call's second (it
    carries no dependent-launch attribute), and each dependent launch
    must read its own h only after its wait. Ten calls in a row agree with
    the same calls made one by one."""
    w = _ffn_planes(1280)
    xs = [_x(cuda, M, 1280, seed=100 + i) for i in range(10)]
    refs = [TQ.ffn_int8(x, *w) for x in xs]
    torch.cuda.synchronize()
    for x, ref in zip(xs[:2], refs[:2]):
        _close(ref, TQ.ffn_int8_plain(x, *w))
    torch.cuda._sleep(2_000_000)
    outs = [TQ.ffn_int8(x, *w) for x in xs]
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)


@pytest.mark.parametrize("M", [2, 5, 8, 16])
def test_ffn_int8_rows_equal_one_row_calls(cuda, M):
    """K5's plan at M <= 16 depends on K and N alone, so each of M rows run
    together gives the bits of that row run alone (the verify rows of a
    speculative pass against one-row steps)."""
    w = _ffn_planes(1280)
    x = _x(cuda, M, 1280, seed=200 + M)
    together = TQ.ffn_int8(x, *w)
    alone = torch.cat([TQ.ffn_int8(x[i:i + 1], *w) for i in range(M)])
    torch.cuda.synchronize()
    assert torch.equal(together, alone)


def test_ffn_int8_library_has_tma_and_dependent_launch(cuda):
    """K5's library holds TMA tile loads (UTMALDG), the dependent-launch
    trigger (PREEXIT) and wait (ACQBULK) and mma.sync (HMMA) in its SASS."""
    sass = _sass("ffn_int8")
    for op in ("UTMALDG", "PREEXIT", "ACQBULK", "HMMA"):
        assert op in sass, op


# digests of K3's rows route (rows_digest) at each (M, N), as the tree before
# qmm_rows.cuh took its epilogue, ring and launch-role template parameters
# computed them on an NVIDIA H100 80GB HBM3 with ROWS_DIGESTS_TOOLKIT (K5
# shares the header since then; K3 must keep every bit)
ROWS_DIGESTS_TOOLKIT = ("2.11.0+cu128", "12.9")   # (torch, nvcc release)
ROWS_DIGESTS = {
    (1, 1280): "51c5f9bc0093038c",
    (1, 3840): "a16ccdd34031128b",
    (5, 3840): "6ba4e4af2a4258d6",
    (8, 1280): "dddc4945f6bed355",
    (16, 1280): "216146199bf1728c",
    (1, 51866): "3dddb5dd3db5d6ef",
}


def rows_digest(cuda, M, N):
    """One K3 rows-route call at (M, 1280 -> N) on fixed seeded inputs: the
    digest of its output."""
    import hashlib
    w = _planes(cuda, 1280, N, seed=N + 1)
    x = _x(cuda, M, 1280, seed=M + 2)
    out = TQ.qmm(x, w.qs, w.scales)
    torch.cuda.synchronize()
    return hashlib.sha256(out.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("M,N", [(1, 1280), (1, 3840), (5, 3840), (8, 1280), (16, 1280),
                                 (1, 51866)])
def test_qmm_rows_bits_unchanged_by_the_shared_header(cuda, M, N):
    """K3's rows route gives the same bits as before the rows body took
    K5's template parameters (ROWS_DIGESTS), with the toolkit that computed
    them."""
    import re
    import subprocess
    from open_whisper_kit_tpu_torch.ops import _build
    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    toolkit = (torch.__version__, re.search(r"release (\d+\.\d+)", out).group(1))
    if toolkit != ROWS_DIGESTS_TOOLKIT:
        pytest.skip(f"ROWS_DIGESTS were computed with torch and nvcc {ROWS_DIGESTS_TOOLKIT}, "
                    f"this card has {toolkit}")
    assert rows_digest(cuda, M, N) == ROWS_DIGESTS[(M, N)]


def test_quant_wrappers_never_take_the_plain_version_on_cuda(cuda, monkeypatch):
    """On a CUDA tensor each wrapper launches its kernel (the counters
    grow) and never reaches the plain version; what it cannot take raises."""
    def boom(*a, **k):
        raise AssertionError("plain version reached from a CUDA tensor")
    for name in ("qmm_plain", "qmm4_plain", "ffn_int8_plain"):
        monkeypatch.setattr(TQ, name, boom)
    w8, w4 = _planes(cuda, 256, 512, 1), _planes(cuda, 256, 512, 2, bits=4)
    w0 = _planes(cuda, 256, 1024, 3, pad=False)
    x = _x(cuda, 3, 256, 4)
    counts = (TQ.qmm.launches, TQ.qmm4.launches, TQ.ffn_int8.launches)
    TQ.qmatmul(x, w8)
    TQ.qmatmul(x, w4)
    TQ.fused_ffn_int8(x, w0, torch.zeros(1024, device=cuda), _planes(cuda, 1024, 256, 5))
    torch.cuda.synchronize()
    assert (TQ.qmm.launches, TQ.qmm4.launches, TQ.ffn_int8.launches) == tuple(
        c + 1 for c in counts)
    with pytest.raises(ValueError, match="planes"):
        TQ.qmm(x, w8.qs.cpu(), w8.scales.cpu())
    with pytest.raises(ValueError, match="K="):
        TQ.qmm(x[:, :128], w8.qs, w8.scales)
    with pytest.raises(ValueError, match="multiple of 128"):
        TQ.qmm(x, w8.qs[:, :100].contiguous(), w8.scales[:, :100].contiguous())


def test_q8_checkpoint_tokens_cuda_match_cpu(cuda, tmp_path):
    """A narrow q8_0 checkpoint (S=128: the decoder MLP runs K5) through
    whisper_full on the card and on the CPU, 35 s over two windows: the
    same token ids, at least 100 of them. Audio seed 4 is one whose CPU
    transcript stays the same when the input is scaled by 1 +- 2^-20,
    2^-16 or 2^-13."""
    hp = TW.WhisperHParams(51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80, ftype=1, qntvr=0)
    path = tmp_path / "narrow-q8_0.bin"
    TW.write_checkpoint(path, hp, TF._synthetic_mel_filters(80),
                        [b"<%d>" % i for i in range(50257)],
                        TW.random_reference_tensors(hp, seed=0),
                        wtype=TW.TYPE_FOR_NAME["q8_0"])
    samples = (np.random.default_rng(4).standard_normal(16000 * 35)
               .astype(np.float32) * 0.1)
    ids, n_enc = {}, {}
    for dev in ("cuda", "cpu"):
        ctx = TF.WhisperContext.from_file(path, dtype=torch.float32, device=dev)
        p = FullParams(print_progress=False)
        p.temperature_inc = 0
        counts = (TQ.qmm.launches, TQ.ffn_int8.launches)
        res = TF.whisper_full(ctx, p, samples)
        ids[dev] = [[t.id for t in s.tokens] for s in res.segments]
        n_enc[dev] = res.timings.n_encode
        grew = (TQ.qmm.launches - counts[0], TQ.ffn_int8.launches - counts[1])
        assert (grew[0] > 0 and grew[1] > 0) if dev == "cuda" else grew == (0, 0)
    assert n_enc["cuda"] == n_enc["cpu"] == 2
    assert ids["cuda"] == ids["cpu"] and sum(map(len, ids["cpu"])) >= 100


@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_step_kernel_matches_plain(cuda, mode):
    """K2 against its plain version at the narrow config of the CPU parity
    tests (S=256, 4 heads, 3 layers, 64 cache rows, vocabulary 640, 48
    audio positions), 5 steps from the same caches: logits within 1e-2 of
    max|ref| and equal argmax, the cache rows within 1e-2 of their max;
    one launch per step."""
    cfg = TM.WhisperConfig(640, 48, 256, 4, 2, 64, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    if mode == "logits":
        dec = TM.quantize_decoder_int8(dec)
    mp = MK.prepare_mega(cfg, dec, quant=mode)
    g = torch.Generator(device=cuda).manual_seed(6)
    L, S, Tc, Ta = 3, 256, 64, 48
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    caches = [torch.zeros(L, Tc, S, dtype=torch.bfloat16, device=cuda) for _ in range(4)]
    for i, tok in enumerate((3, 77, 500, 12, 639)):
        x0 = (dec["te"][tok] + dec["pe"][i])[None].to(torch.bfloat16)
        head = torch.tensor(i, device=cuda)
        ref, _, _ = MK.mega_decode_step_plain(cfg, mp, x0, caches[0], caches[1], head, xk, xv)
        before = MK.mega_decode_step.launches
        got, _, _ = MK.mega_decode_step(cfg, mp, x0, caches[2], caches[3], head, xk, xv)
        torch.cuda.synchronize()
        assert MK.mega_decode_step.launches == before + 1
        assert got.shape == ref.shape == (1, 640)
        _close(got, ref, 1e-2)
        assert int(got.argmax()) == int(ref.argmax())
    for r, k in ((caches[0], caches[2]), (caches[1], caches[3])):
        _close(k[:, :5].float(), r[:, :5].float(), 1e-2)
        assert not k[:, 5:].any()


def _k2_narrow(cuda, mode, Tc=64):
    """The narrow config of the K2 tests (S=256, 4 heads, 3 layers,
    vocabulary 640, 48 audio positions), its MegaParams in `mode`, cross-KV
    and a (L, Tc, S) self-cache with 20 rows of random history."""
    cfg = TM.WhisperConfig(640, 48, 256, 4, 2, 64, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    if mode == "logits":
        dec = TM.quantize_decoder_int8(dec)
    mp = MK.prepare_mega(cfg, dec, quant=mode)
    g = torch.Generator(device=cuda).manual_seed(7)
    xk, xv = ((torch.randn(3, 48, 256, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, 3, Tc, 256, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    hist[:, :, 20:] = 0
    return cfg, dec, mp, xk, xv, hist


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_step_two_launches_bit_equal(cuda, mode, R):
    """Two launches from the same inputs give the same bits (logits and
    cache): the splits and the key chunks combine in a fixed order, with no
    float atomics."""
    cfg, dec, mp, xk, xv, hist = _k2_narrow(cuda, mode)
    x0 = (dec["te"][torch.arange(R, device=cuda) * 7] + dec["pe"][20:20 + R]).to(torch.bfloat16)
    out = []
    for _ in range(2):
        k, v = hist[0].clone(), hist[1].clone()
        out.append((MK.mega_decode_step(cfg, mp, x0, k, v, torch.tensor(20, device=cuda),
                                        xk, xv)[0], k, v))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert not torch.equal(out[0][1], hist[0])   # the step wrote its rows


@pytest.mark.parametrize("mode", ["none", "all", "int4"])
def test_mega_step_reads_step_data_after_the_wait(cuda, mode):
    """x0 and kv_head written by ops queued behind a 2 ms spin (their
    tensors hold other values until the spin ends) give the bits of the
    call whose inputs were ready: no launch of the chain reads the step's
    data before its dependent-launch wait, however early it is launched."""
    cfg, dec, mp, xk, xv, hist = _k2_narrow(cuda, mode)
    R = 5
    x0 = (dec["te"][torch.arange(R, device=cuda) * 11] + dec["pe"][20:20 + R]).to(torch.bfloat16)
    head = torch.tensor(20, device=cuda)
    k, v = hist[0].clone(), hist[1].clone()
    ref = MK.mega_decode_step(cfg, mp, x0, k, v, head, xk, xv)[0]
    torch.cuda.synchronize()
    for _ in range(3):
        x0_late = torch.full_like(x0, float("nan"))
        head_late = torch.tensor(3, device=cuda)
        k2, v2 = hist[0].clone(), hist[1].clone()
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        x0_late.copy_(x0)
        head_late.copy_(head)
        got = MK.mega_decode_step(cfg, mp, x0_late, k2, v2, head_late, xk, xv)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(k2, k) and torch.equal(v2, v)


def test_mega_step_library_has_tma_and_dependent_launch(cuda):
    """K2's library (csrc/mega_step.cu on mega_stream.cuh) holds TMA tile
    loads (UTMALDG), the dependent-launch trigger (PREEXIT,
    griddepcontrol.launch_dependents) and wait (ACQBULK,
    griddepcontrol.wait) in its SASS, and warp-level mma.sync (HMMA)."""
    import shutil
    import subprocess
    from pathlib import Path

    from open_whisper_kit_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        pytest.skip("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(_build.build("mega_step"))],
                          capture_output=True, text=True, check=True).stdout
    for op in ("UTMALDG", "PREEXIT", "ACQBULK", "HMMA"):
        assert op in sass, op


@pytest.mark.parametrize("R", [2, 5, 8])
@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_step_verify_rows(cuda, mode, R, monkeypatch):
    """K2's speculative verify rows at the narrow config of the K2 test on a
    cache of 64 + 11 rows (the loop's n_text_ctx + gamma + 4): from random
    history at heads 9 and Tc - R, one R-row launch is bit-equal to R
    one-row launches at head, head + 1, ... (logits and every cache row),
    at head 9 also to one-row launches on a 64-row cache (the greedy
    loop's), and within 2e-2 of max|ref| of the plain R-row step, with its argmax
    except at a near tie; the wrapper never takes the plain version on the
    card, and counts the launch under its row count."""
    cfg = TM.WhisperConfig(640, 48, 256, 4, 2, 64, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    if mode == "logits":
        dec = TM.quantize_decoder_int8(dec)
    mp = MK.prepare_mega(cfg, dec, quant=mode)
    g = torch.Generator(device=cuda).manual_seed(10 + R)
    L, S, Tc, Ta = 3, 256, 64 + 11, 48
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, Tc, S, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    for head in (9, Tc - R):
        caches = [hist[c % 2].clone() for c in range(6)]
        for c in caches:
            c[:, head:] = 0
        toks = torch.randint(0, 640, (R,), generator=g, device=cuda)
        pos = (head + torch.arange(R, device=cuda)).clamp(max=cfg.n_text_ctx - 1)
        x0 = (dec["te"][toks] + dec["pe"][pos]).to(torch.bfloat16)
        ht = torch.tensor(head, device=cuda)
        ref, _, _ = MK.mega_decode_step_plain(cfg, mp, x0, caches[0], caches[1], ht, xk, xv)
        before = (MK.mega_decode_step.launches, MK.mega_decode_step.launches_by_rows.get(R, 0))
        with monkeypatch.context() as m:
            m.setattr(MK, "mega_decode_step_plain", None)
            got, _, _ = MK.mega_decode_step(cfg, mp, x0, caches[2], caches[3], ht, xk, xv)
            seq = torch.cat([MK.mega_decode_step(cfg, mp, x0[r:r + 1], caches[4], caches[5],
                                                 ht + r, xk, xv)[0] for r in range(R)])
            if head + R <= cfg.n_text_ctx:
                gk, gv = (hist[c, :, :cfg.n_text_ctx].clone() for c in range(2))
                gk[:, head:] = gv[:, head:] = 0
                greedy = torch.cat([MK.mega_decode_step(cfg, mp, x0[r:r + 1], gk, gv, ht + r,
                                                        xk, xv)[0] for r in range(R)])
                torch.cuda.synchronize()
                assert torch.equal(got, greedy), (head, (got - greedy).abs().max().item())
                assert torch.equal(caches[2][:, :cfg.n_text_ctx], gk)
        torch.cuda.synchronize()
        assert MK.mega_decode_step.launches == before[0] + 1 + R * (2 if head == 9 else 1)
        assert MK.mega_decode_step.launches_by_rows[R] == before[1] + 1
        assert got.shape == ref.shape == (R, 640) and bool(torch.isfinite(got).all())
        assert torch.equal(got, seq), (head, (got - seq).abs().max().item())
        assert torch.equal(caches[2], caches[4]) and torch.equal(caches[3], caches[5])
        _close(got, ref, 2e-2)
        pick = got.argmax(1)
        gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
        assert bool((gap <= 1e-2 * ref.abs().max()).all()), gap
        rows = slice(head, head + R)
        for r, k in ((caches[0], caches[2]), (caches[1], caches[3])):
            _close(k[:, rows].float(), r[:, rows].float(), 1e-2)
            assert torch.equal(k[:, :head], r[:, :head])


def test_wide_rows_in_every_kernel_library(cuda):
    """K2 at five verify rows, then K7 with five beams and K8 with five
    streams, at turbo width (S = 1280, so five rows of mlp1's 4S input pass
    the default 48 KB of dynamic shared memory) with a 640-word vocabulary,
    one layer: each library's GEMV must be allowed its own shared memory (a
    flag shared across the libraries once let K7 launch without it and
    fail), and the workspace must hold a split counter for each of mlp0's
    80 column tiles (it was sized by the vocabulary plane's 10, and the
    counters ran past it). Each step within 2e-2 of max|ref| of its plain
    version."""
    cfg = TM.WhisperConfig(640, 48, 1280, 20, 2, 64, 1280, 20, 1, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    mp = MK.prepare_mega(cfg, dec, quant="all")
    g = torch.Generator(device=cuda).manual_seed(12)
    R, L, S, Tc, Ta = 5, 1, 1280, 64, 48
    xk, xv = ((torch.randn(L, R, Ta, S, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    x0 = (dec["te"][torch.arange(R, device=cuda) * 7] + dec["pe"][3]).to(torch.bfloat16)
    head = torch.tensor(3, device=cuda)
    origin = torch.arange(R, device=cuda)[:, None].expand(R, Tc).contiguous()
    steps = (
        (MK.mega_decode_step, MK.mega_decode_step_plain, Tc, (xk[:, 0], xv[:, 0]), ()),
        (MK.mega_decode_step_beam, MK.mega_decode_step_beam_plain, Tc * R,
         (xk[:, 0], xv[:, 0]), (origin,)),
        (MK.mega_decode_step_batch, MK.mega_decode_step_batch_plain, Tc * R, (xk, xv), ()))
    errs = {}
    for kernel, plain, rows, cross, extra in steps:
        caches = [torch.zeros(L, rows, S, dtype=torch.bfloat16, device=cuda) for _ in range(4)]
        ref, _, _ = plain(cfg, mp, x0, caches[0], caches[1], head, *cross, *extra)
        got, _, _ = kernel(cfg, mp, x0, caches[2], caches[3], head, *cross, *extra)
        torch.cuda.synchronize()
        errs[kernel.__name__] = ((got - ref).abs().max() / ref.abs().max()).item()
    assert all(e <= 2e-2 for e in errs.values()), errs


def test_speculative_whisper_full_cuda_matches_cpu(cuda, tmp_path):
    """Speculative greedy decoding (gamma = 4) on a narrow bf16 q8_0
    checkpoint with a q4_0 draft of the same tensors and megakernel="int8":
    draft steps run K2 at one row and verify passes K2 at five rows on the
    card, their plain versions on the CPU. 35 s over two windows: the same
    token ids on both, at least 100 of them, and on the card the same as
    K2 greedy. Audio seed 4: its CPU transcript stays the same when the
    input is scaled by 1 +- 2^-20, 2^-16 or 2^-13."""
    hp = TW.WhisperHParams(51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80, ftype=1, qntvr=0)
    tensors = TW.random_reference_tensors(hp, seed=0)
    paths = {}
    for q in ("q8_0", "q4_0"):
        paths[q] = tmp_path / f"narrow-{q}.bin"
        TW.write_checkpoint(paths[q], hp, TF._synthetic_mel_filters(80),
                            [b"<%d>" % i for i in range(50257)], tensors,
                            wtype=TW.TYPE_FOR_NAME[q])
    samples = (np.random.default_rng(4).standard_normal(16000 * 35)
               .astype(np.float32) * 0.1)
    p = FullParams(print_progress=False, megakernel="int8", speculative=4)
    p.temperature_inc = 0
    ids = {}
    for dev in ("cuda", "cpu"):
        ctx = TF.WhisperContext.from_file(paths["q8_0"], dtype=torch.bfloat16, device=dev)
        ctx.set_draft(TF.WhisperContext.from_file(paths["q4_0"], dtype=torch.bfloat16,
                                                  device=dev))
        verify = MK.mega_decode_step.launches_by_rows.get(5, 0)
        res = TF.whisper_full(ctx, p, samples)
        ids[dev] = [t.id for s in res.segments for t in s.tokens]
        if dev == "cuda":
            assert MK.mega_decode_step.launches_by_rows.get(5, 0) > verify
            assert res.timings.n_spec_accepted > 0
            ctx.draft = None
            greedy = TF.whisper_full(ctx, FullParams(print_progress=False, megakernel="int8",
                                                     temperature_inc=0.0), samples)
            assert [t.id for s in greedy.segments for t in s.tokens] == ids[dev]
    assert ids["cuda"] == ids["cpu"] and len(ids["cpu"]) >= 100


# the K7 steps below: (head, the sources each step's beams continue, None
# for no reorder), on both sides of the 128-row time-block edges
_STEPS = [(0, None), (1, [1, 0, 1]), (2, [2, 0, 0]), (3, None), (4, [1, 1, 2]),
          (126, None), (127, [2, 0, 1]), (128, [1, 1, 0]), (129, None),
          (254, [0, 2, 2]), (255, None), (256, [2, 1, 0]), (257, None)]


@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_beam_kernel_matches_plain(cuda, mode, monkeypatch):
    """K7 against its plain version at the narrow config of the CPU parity
    tests (S=256, 4 heads, 3 layers, vocabulary 640, 48 audio positions)
    with a 300-row cache (three 128-row time blocks, the last partial),
    B = 3: steps at heads 0-4, 126-129 and 254-257 with lineage reorders,
    the rows no step wrote holding random K/V and a random lineage: logits
    within 2e-2 of max|ref| (the JAX package's gate for this kernel), the
    same argmax for every beam except where the kernel's pick lies within
    1e-2 of max|ref| of the plain best (a near tie: the two sum in other
    f32 orders), the written cache rows within 1e-2 of their max, the rows
    past the last head zero; one launch per step, never the plain
    version. Prints each step's error."""
    cfg = TM.WhisperConfig(640, 48, 256, 4, 2, 300, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    if mode == "logits":
        dec = TM.quantize_decoder_int8(dec)
    mp = MK.prepare_mega(cfg, dec, quant=mode)
    g = torch.Generator(device=cuda).manual_seed(6)
    L, S, Tc, Ta, B = 3, 256, 300, 48, 3
    xk, xv = ((torch.randn(L, Ta, S, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    caches = [torch.zeros(L, Tc * B, S, dtype=torch.bfloat16, device=cuda) for _ in range(4)]
    origin = torch.arange(B, device=cuda)[:, None].expand(B, Tc).clone()
    toks = torch.randint(0, 640, (len(_STEPS), B), generator=g, device=cuda)
    plain = MK.mega_decode_step_beam_plain
    filled, written, steps = 0, [], []
    for i, (head, src) in enumerate(_STEPS):
        if head > filled:
            rows = slice(filled * B, head * B)
            for c in range(2):
                hist = (torch.randn(L, (head - filled) * B, S, generator=g, device=cuda)
                        * 0.5).to(torch.bfloat16)
                caches[c][:, rows] = hist
                caches[c + 2][:, rows] = hist
            origin[:, filled:head] = torch.randint(0, B, (B, head - filled), generator=g,
                                                   device=cuda)
        if src is not None:
            origin = origin[torch.tensor(src, device=cuda)]
        origin[:, head] = torch.arange(B, device=cuda)
        filled = head + 1
        written += range(head * B, (head + 1) * B)
        x0 = (dec["te"][toks[i]] + dec["pe"][head]).to(torch.bfloat16)
        ht = torch.tensor(head, device=cuda)
        ref, _, _ = plain(cfg, mp, x0, caches[0], caches[1], ht, xk, xv, origin)
        before = (MK.mega_decode_step_beam.launches, MK.mega_decode_step.launches)
        with monkeypatch.context() as m:
            m.setattr(MK, "mega_decode_step_beam_plain", None)
            got, _, _ = MK.mega_decode_step_beam(cfg, mp, x0, caches[2], caches[3], ht,
                                                 xk, xv, origin=origin)
        torch.cuda.synchronize()
        assert (MK.mega_decode_step_beam.launches, MK.mega_decode_step.launches) == (
            before[0] + 1, before[1])
        assert got.shape == ref.shape == (B, 640) and bool(torch.isfinite(got).all())
        m = ref.abs().max().item()
        pick = got.argmax(1)
        gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
        steps.append((head, (got - ref).abs().max().item() / m,
                      int((pick != ref.argmax(1)).sum()), gap.max().item() / m))
    print(f"K7 {mode}: (head, max|err| / max|ref|, argmax flips, plain gap / max|ref|) "
          f"{[(h, f'{e:.2e}', n, f'{g:.1e}') for h, e, n, g in steps]}")
    assert all(e <= 2e-2 and g <= 1e-2 for _, e, _, g in steps), steps
    w = torch.tensor(written, device=cuda)
    for r, k in ((caches[0], caches[2]), (caches[1], caches[3])):
        _close(k[:, w].float(), r[:, w].float(), 1e-2)
        assert not k[:, filled * B:].any()


def test_mega_beam_one_row_runs_k2(cuda):
    """One beam delegates to K2: its counter grows, K7's does not, and the
    result is K2's own."""
    cfg = TM.WhisperConfig(640, 48, 256, 4, 2, 64, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    mp = MK.prepare_mega(cfg, dec, quant="all")
    g = torch.Generator(device=cuda).manual_seed(7)
    xk, xv = ((torch.randn(3, 48, 256, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    x0 = (dec["te"][[17]] + dec["pe"][[0]]).to(torch.bfloat16)
    caches = [torch.zeros(3, 64, 256, dtype=torch.bfloat16, device=cuda) for _ in range(4)]
    before = (MK.mega_decode_step_beam.launches, MK.mega_decode_step.launches)
    a, _, _ = MK.mega_decode_step_beam(cfg, mp, x0, caches[0], caches[1], 0, xk, xv)
    b, _, _ = MK.mega_decode_step(cfg, mp, x0, caches[2], caches[3], 0, xk, xv)
    torch.cuda.synchronize()
    assert (MK.mega_decode_step_beam.launches, MK.mega_decode_step.launches) == (
        before[0], before[1] + 2)
    assert torch.equal(a, b) and torch.equal(caches[0], caches[2])


def _k7_narrow(cuda, mode, B, Tc=300, Ta=600):
    """K7's narrow config (S=256, 4 heads, 3 layers, vocabulary 640; Tc
    cache rows a beam across the 128-row time blocks, Ta audio positions
    over K2's cross chunks), its MegaParams in `mode`, a shared cross-KV, a
    (L, Tc * B, S) self-cache of random history and a random lineage."""
    cfg = TM.WhisperConfig(640, Ta, 256, 4, 2, Tc, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    if mode == "logits":
        dec = TM.quantize_decoder_int8(dec)
    mp = MK.prepare_mega(cfg, dec, quant=mode)
    g = torch.Generator(device=cuda).manual_seed(13 + B)
    xk, xv = ((torch.randn(3, Ta, 256, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, 3, Tc * B, 256, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    origin = torch.randint(0, B, (B, Tc), generator=g, device=cuda)
    return cfg, dec, mp, xk, xv, hist, origin, g


# heads on both sides of the first 128-row time-block edge, and the sources
# each step's beams continue (a permutation of a random draw), per B
_EDGE_HEADS = (126, 127, 128, 129)


@pytest.mark.parametrize("B", [2, 5, 8])
@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_beam_kernel_matches_plain_across_a_block_edge(cuda, mode, B, monkeypatch):
    """K7 on K2's chain at B = 2, 5 and 8 beams against its plain version,
    four steps at heads 126-129 (the self-attention's online softmax
    rescales at the 128-row edge) with a lineage reorder before each, from
    a cache of random history with a random lineage: logits within 2e-2 of
    max|ref| (K2_TOL), the same argmax for every beam except where the
    kernel's pick lies within 1e-2 of max|ref| of the plain best (a near
    tie: the two sum in other f32 orders), the written cache rows within
    1e-2 of their max and every other row untouched; one K7 launch per
    step, never the plain version. Prints each step's error."""
    cfg, dec, mp, xk, xv, hist, origin, g = _k7_narrow(cuda, mode, B)
    caches = [hist[i % 2].clone() for i in range(4)]
    steps = []
    for head in _EDGE_HEADS:
        for c in caches:
            c[:, head * B:] = 0
        origin = origin[torch.randint(0, B, (B,), generator=g, device=cuda)]
        origin[:, head] = torch.arange(B, device=cuda)
        toks = torch.randint(0, 640, (B,), generator=g, device=cuda)
        x0 = (dec["te"][toks] + dec["pe"][head]).to(torch.bfloat16)
        ht = torch.tensor(head, device=cuda)
        ref, _, _ = MK.mega_decode_step_beam_plain(cfg, mp, x0, caches[0], caches[1], ht, xk,
                                                   xv, origin)
        before = MK.mega_decode_step_beam.launches
        with monkeypatch.context() as m:
            m.setattr(MK, "mega_decode_step_beam_plain", None)
            got, _, _ = MK.mega_decode_step_beam(cfg, mp, x0, caches[2], caches[3], ht, xk, xv,
                                                 origin=origin)
        torch.cuda.synchronize()
        assert MK.mega_decode_step_beam.launches == before + 1
        assert got.shape == ref.shape == (B, 640) and bool(torch.isfinite(got).all())
        mx = ref.abs().max().item()
        pick = got.argmax(1)
        gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
        steps.append((head, (got - ref).abs().max().item() / mx,
                      int((pick != ref.argmax(1)).sum()), gap.max().item() / mx))
        rows = slice(head * B, (head + 1) * B)
        for r, k in ((caches[0], caches[2]), (caches[1], caches[3])):
            _close(k[:, rows].float(), r[:, rows].float(), 1e-2)
            assert torch.equal(k[:, :head * B], r[:, :head * B])
            assert not k[:, (head + 1) * B:].any()
            k[:, rows] = r[:, rows]   # the next step from the same history
    print(f"K7 {mode}, B={B}: (head, max|err| / max|ref|, argmax flips, plain gap / "
          f"max|ref|) {[(h, f'{e:.2e}', n, f'{gp:.1e}') for h, e, n, gp in steps]}")
    assert all(e <= 2e-2 and gp <= 1e-2 for _, e, _, gp in steps), steps


@pytest.mark.parametrize("B", [2, 5, 8])
@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_beam_two_launches_bit_equal(cuda, mode, B):
    """Two K7 launches from the same inputs at head 257 (the third time
    block) give the same bits, logits and caches: every split, time block
    and cross chunk combines in a fixed order, with no float atomics."""
    cfg, dec, mp, xk, xv, hist, origin, _ = _k7_narrow(cuda, mode, B)
    head = 257
    for c in hist:
        c[:, head * B:] = 0
    origin[:, head] = torch.arange(B, device=cuda)
    x0 = (dec["te"][torch.arange(B, device=cuda) * 7] + dec["pe"][head]).to(torch.bfloat16)
    out = []
    for _ in range(2):
        k, v = hist[0].clone(), hist[1].clone()
        out.append((MK.mega_decode_step_beam(cfg, mp, x0, k, v, torch.tensor(head, device=cuda),
                                             xk, xv, origin=origin)[0], k, v))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert out[0][1][:, head * B:(head + 1) * B].any()   # the step wrote its rows


@pytest.mark.parametrize("mode", ["none", "all", "int4"])
def test_mega_beam_reads_step_data_after_the_wait(cuda, mode):
    """x0, kv_head and the origin table written by ops queued behind a 2 ms
    spin (their tensors hold other values until the spin ends) give the
    bits of the call whose inputs were ready: no launch of K7's chain reads
    the step's data, the lineage included, before its dependent-launch
    wait."""
    B, head = 5, 130
    cfg, dec, mp, xk, xv, hist, origin, _ = _k7_narrow(cuda, mode, B)
    for c in hist:
        c[:, head * B:] = 0
    origin[:, head] = torch.arange(B, device=cuda)
    x0 = (dec["te"][torch.arange(B, device=cuda) * 11] + dec["pe"][head]).to(torch.bfloat16)
    ht = torch.tensor(head, device=cuda)
    k, v = hist[0].clone(), hist[1].clone()
    ref = MK.mega_decode_step_beam(cfg, mp, x0, k, v, ht, xk, xv, origin=origin)[0]
    torch.cuda.synchronize()
    for _ in range(3):
        x0_late = torch.full_like(x0, float("nan"))
        head_late = torch.tensor(3, device=cuda)
        origin_late = (origin + 1) % B
        k2, v2 = hist[0].clone(), hist[1].clone()
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        x0_late.copy_(x0)
        head_late.copy_(ht)
        origin_late.copy_(origin)
        got = MK.mega_decode_step_beam(cfg, mp, x0_late, k2, v2, head_late, xk, xv,
                                       origin=origin_late)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(k2, k) and torch.equal(v2, v)


@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_beam_identical_beams_give_identical_rows(cuda, mode):
    """Eight beams with the same token and one lineage (every beam reads the
    same slot at every earlier time, a slot that differs from time to time)
    give eight bit-equal logits rows and new cache rows: no row's sums
    depend on another row or on its index."""
    B, head = 8, 200
    cfg, dec, mp, xk, xv, hist, origin, _ = _k7_narrow(cuda, mode, B)
    for c in hist:
        c[:, head * B:] = 0
    origin = origin[:1].expand(B, -1).contiguous()
    origin[:, head] = torch.arange(B, device=cuda)
    x0 = (dec["te"][5] + dec["pe"][head])[None].expand(B, -1).to(torch.bfloat16).contiguous()
    k, v = hist[0].clone(), hist[1].clone()
    got = MK.mega_decode_step_beam(cfg, mp, x0, k, v, torch.tensor(head, device=cuda), xk, xv,
                                   origin=origin)[0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert all(torch.equal(got[b], got[0]) for b in range(1, B))
    rows = k[:, head * B:(head + 1) * B], v[:, head * B:(head + 1) * B]
    assert all(torch.equal(r[:, b], r[:, 0]) for r in rows for b in range(1, B))
    assert rows[0].any()


def test_mega_beam_library_has_tma_and_dependent_launch(cuda):
    """K7's library (csrc/mega_beam.cu on mega_stream.cuh and
    mega_blocks.cuh) holds TMA tile loads (UTMALDG), the dependent-launch
    trigger (PREEXIT) and wait (ACQBULK) and warp-level mma.sync (HMMA) in
    its SASS."""
    import shutil
    import subprocess
    from pathlib import Path

    from open_whisper_kit_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        pytest.skip("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(_build.build("mega_beam"))],
                          capture_output=True, text=True, check=True).stdout
    for op in ("UTMALDG", "PREEXIT", "ACQBULK", "HMMA"):
        assert op in sass, op


# SHA-256 (first 16 hex digits) of one step's logits and written cache rows,
# K2 (mega_step) at R rows and K8 (mega_batch) at B streams, on the narrow
# configs of the tests above (step_digest), as the tree before mega_blocks.cuh
# and the shared attend() helper existed computed them on an NVIDIA H100
# 80GB HBM3 with STEP_DIGESTS_TOOLKIT: moving that code into the shared
# headers must leave every bit of K2 and K8 as it was. Another toolkit may
# compile other sums, so the test runs only with that one; K2 and K8 are
# held to their plain versions with any toolkit by the tests above
STEP_DIGESTS_TOOLKIT = ("2.11.0+cu128", "12.9")   # (torch, nvcc release)
STEP_DIGESTS = {
    ("mega_step", "none", 1): "c513be32706e2031",
    ("mega_step", "logits", 1): "c6bc8337e5ac5bed",
    ("mega_step", "all", 1): "5a8a614384ac5854",
    ("mega_step", "int4", 1): "99461d77e2f0fcbe",
    ("mega_step", "none", 8): "904e1ccb33e3b922",
    ("mega_step", "logits", 8): "bbde43f432d67bf3",
    ("mega_step", "all", 8): "e93b634c0e7c54cb",
    ("mega_step", "int4", 8): "f94375c64d20aa47",
    ("mega_batch", "none", 2): "a86547ef4e0cd762",
    ("mega_batch", "logits", 2): "7a7ba85fffb61773",
    ("mega_batch", "all", 2): "5e57782e96527291",
    ("mega_batch", "int4", 2): "3dce0449fd3a0743",
    ("mega_batch", "none", 8): "4e9d304d9cc39456",
    ("mega_batch", "logits", 8): "1f1fb08516f00106",
    ("mega_batch", "all", 8): "6da9a6be7eefe3fa",
    ("mega_batch", "int4", 8): "0f5ca7291894457a",
}


def step_digest(cuda, kernel, mode, R):
    """One K2 step of R rows at head 20 of _k2_narrow's cache, or one K8 step
    of R streams at head 257 of _k8_narrow's; the digest of its logits and
    its written cache rows."""
    import hashlib
    if kernel == "mega_step":
        cfg, dec, mp, xk, xv, hist = _k2_narrow(cuda, mode)
        head, rows = 20, slice(20, 20 + R)
        x0 = (dec["te"][torch.arange(R, device=cuda) * 7] + dec["pe"][head:head + R])
        run = MK.mega_decode_step
    else:
        cfg, dec, mp, xk, xv, hist = _k8_narrow(cuda, mode, R)
        head, rows = 257, slice(257 * R, 258 * R)
        for c in hist:
            c[:, head * R:] = 0
        x0 = dec["te"][torch.arange(R, device=cuda) * 7] + dec["pe"][head]
        run = MK.mega_decode_step_batch
    k, v = hist[0].clone(), hist[1].clone()
    logits = run(cfg, mp, x0.to(torch.bfloat16), k, v, torch.tensor(head, device=cuda),
                 xk, xv)[0]
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in (logits, k[:, rows], v[:, rows]):
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("kernel,R", [("mega_step", 1), ("mega_step", 8), ("mega_batch", 2),
                                      ("mega_batch", 8)])
@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_k2_and_k8_bits_unchanged_by_the_shared_headers(cuda, mode, kernel, R):
    """K2 and K8 give the same bits as before their attention code moved
    into the shared headers (STEP_DIGESTS), with the toolkit that computed
    those."""
    import re
    import subprocess
    from open_whisper_kit_tpu_torch.ops import _build
    out = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    toolkit = (torch.__version__, re.search(r"release (\d+\.\d+)", out).group(1))
    if toolkit != STEP_DIGESTS_TOOLKIT:
        pytest.skip(f"STEP_DIGESTS were computed with torch and nvcc {STEP_DIGESTS_TOOLKIT}, "
                    f"this card has {toolkit}")
    assert step_digest(cuda, kernel, mode, R) == STEP_DIGESTS[(kernel, mode, R)]


def test_decode_segment_beam_cuda_matches_cpu(cuda):
    """The device beam loop (B = 3, decode_impl with the physical reorder)
    on the card and on the CPU, f32, from the same CPU-made cross-KV: the
    same tokens, result lengths and n_valid, probabilities within 1e-4."""
    cfg = TM.WhisperConfig(*NARROW_TS)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = [b"<%d>" % i for i in range(50257)]
    samples = (np.random.default_rng(1).standard_normal(16000 * 20)
               .astype(np.float32) * 0.1)
    ctx = TF.WhisperContext(cfg, params, build_vocab(tokens, cfg.n_vocab),
                            TF._synthetic_mel_filters(80), n_loaded=1,
                            dtype=torch.float32, device="cpu")
    mel = mel_mod.log_mel_spectrogram(samples, ctx.filters, "cpu")
    _, xk, xv = ctx.encode_window(mel.data, 0, 0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        dctx = ctx if dev.type == "cpu" else TF.WhisperContext(
            cfg, params, build_vocab(tokens, cfg.n_vocab), TF._synthetic_mel_filters(80),
            n_loaded=1, dtype=torch.float32, device=dev)
        v = dctx.vocab
        toks, t_real = TF._pad_prompt(cfg, [v.token_sot], dev)
        res = DB.decode_segment_beam(
            cfg, dctx.rule_config, dctx.params["decoder"], toks, xk.to(dev), xv.to(dev),
            *dctx.rule_masks(FullParams()), (t_real, v.token_nosp, 0, mel.n_len_org),
            beam_size=3, n_max=220, reads=dctx.reads, cache_dtype=torch.float32)
        out[dev.type] = DB.unpack_beam_result(
            dctx.reads.fetch(DB.pack_beam_result(res)), 3, 220)
    assert out["cuda"][0]["n_tokens"] == out["cpu"][0]["n_tokens"] > 0
    for b, (rg, rc) in enumerate(zip(out["cuda"], out["cpu"])):
        for key in ("tokens", "result_len", "n_valid", "seek_delta", "completed", "failed"):
            np.testing.assert_array_equal(rg[key], rc[key], err_msg=f"{key}, beam {b}")
        np.testing.assert_allclose(rg["p"], rc["p"], atol=1e-4)


@pytest.mark.parametrize("M,K,N,dtype", [
    (1536, 1280, 3840, torch.bfloat16), (300, 5120, 1280, torch.bfloat16),
    (13, 32, 72, torch.float32), (40, 2176, 64, torch.bfloat16), (130, 1280, 1280, torch.float32),
    # the 8-window mlp0 and mlp1 (128 x 256 tiles), one window's o and mlp1
    # (128 x 128), ragged M and K (K = 1000 is padded to 1008, 200 to 208)
    (12288, 1280, 5120, torch.bfloat16), (12288, 5120, 1280, torch.bfloat16),
    (1536, 1280, 1280, torch.bfloat16), (1536, 5120, 1280, torch.bfloat16),
    (1500, 1000, 1280, torch.bfloat16), (777, 200, 3000, torch.float32)])
def test_w8a8_kernel_matches_plain(cuda, M, K, N, dtype, monkeypatch):
    """K6 against its plain version, bit for bit: turbo encoder shapes at
    one and eight windows (both planned tiles), the padding case (13 x 72,
    K = 32), wide K, f32 input, ragged M and K, rows past a tile edge; an
    all-zero row gives zeros, and a row of half-integers at scale 1 holds
    the quantizer to round-half-to-even. One launch per call, never the
    plain version."""
    from open_whisper_kit_tpu_torch.ops import encoder_int8 as E8
    from open_whisper_kit_tpu_torch.ops import gemm as G
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    x[1] = 0
    # a row whose scale is 1 (amax 127): its values round on the ties, to even
    x[2] = 0
    x[2, :8] = torch.tensor([127, .5, 1.5, 2.5, -.5, -1.5, -2.5, 126.5])
    w = torch.randn(K, N, generator=g, device=cuda) * K ** -0.5
    wq, ws = E8.quantize_w_cols(w)
    wq_t = wq.t().contiguous()
    ref = E8.w8a8_mm_plain(x, wq_t, ws)
    before = E8.w8a8_mm.launches
    with monkeypatch.context() as m:
        m.setattr(E8, "w8a8_mm_plain", None)
        got = E8.w8a8_mm(x, wq_t, ws)
    torch.cuda.synchronize()
    assert E8.w8a8_mm.launches == before + 1
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    n_diff = int((got.float() != ref.float()).sum())
    assert n_diff == 0, f"{n_diff} of {got.numel()} values differ"
    assert not got[1].any()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if (M, K, N) in ((12288, 1280, 5120), (1536, 1280, 1280)):
        assert G.w8a8_plan(M, N, sms).tile == ((128, 256) if M == 12288 else (128, 128))


def test_w8a8_back_to_back_calls(cuda):
    """Ten K6 calls with different x queued behind a 2 ms spin equal the
    same calls made one by one: each GEMM (a dependent launch) reads its
    own quantize launch's rows and scales, after its wait."""
    from open_whisper_kit_tpu_torch.ops import encoder_int8 as E8
    g = torch.Generator(device=cuda).manual_seed(5)
    wq, ws = E8.quantize_w_cols(torch.randn(1280, 5120, generator=g, device=cuda) * 0.03)
    wq_t = wq.t().contiguous()
    xs = [torch.randn(1536, 1280, generator=g, device=cuda).to(torch.bfloat16)
          for _ in range(10)]
    refs = []
    for x in xs:
        refs.append(E8.w8a8_mm(x, wq_t, ws))
        torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    outs = [E8.w8a8_mm(x, wq_t, ws) for x in xs]
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)
    assert torch.equal(refs[0], E8.w8a8_mm_plain(xs[0], wq_t, ws))


@pytest.mark.parametrize("mode", ["none", "all", "int4"])
def test_mega_batch_kernel_matches_plain(cuda, mode, monkeypatch):
    """K8 against its plain version at S=256, 4 heads, 3 layers, vocabulary
    640, 600 audio positions (three 256-row cross chunks, the last partial),
    a 300-row cache, B = 3 streams with distinct cross-KV: steps at heads
    0-1, 126-129 and 254-257 from the same caches (random history below
    the head): logits within 2e-2 of max|ref|, the argmax rule of K7's
    test, the written rows within 1e-2 of their max; one launch per step,
    never the plain version."""
    cfg = TM.WhisperConfig(640, 600, 256, 4, 2, 300, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    mp = MK.prepare_mega(cfg, dec, quant=mode)
    g = torch.Generator(device=cuda).manual_seed(8)
    L, S, Tc, Ta, B = 3, 256, 300, 600, 3
    xk, xv = ((torch.randn(L, B, Ta, S, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, L, Tc * B, S, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    steps = []
    for head in (0, 1, 126, 127, 128, 129, 254, 255, 256, 257):
        caches = [hist[c % 2].clone() for c in range(4)]
        for c in caches:
            c[:, head * B:] = 0
        toks = torch.randint(0, 640, (B,), generator=g, device=cuda)
        x0 = (dec["te"][toks] + dec["pe"][head]).to(torch.bfloat16)
        ht = torch.tensor(head, device=cuda)
        ref, _, _ = MK.mega_decode_step_batch_plain(cfg, mp, x0, caches[0], caches[1], ht,
                                                    xk, xv)
        before = MK.mega_decode_step_batch.launches
        with monkeypatch.context() as m:
            m.setattr(MK, "mega_decode_step_batch_plain", None)
            got, _, _ = MK.mega_decode_step_batch(cfg, mp, x0, caches[2], caches[3], ht,
                                                  xk, xv)
        torch.cuda.synchronize()
        assert MK.mega_decode_step_batch.launches == before + 1
        assert got.shape == ref.shape == (B, 640) and bool(torch.isfinite(got).all())
        m_ = ref.abs().max().item()
        pick = got.argmax(1)
        gap = ref.max(1).values - ref.gather(1, pick[:, None])[:, 0]
        steps.append((head, (got - ref).abs().max().item() / m_,
                      int((pick != ref.argmax(1)).sum()), gap.max().item() / m_))
        rows = slice(head * B, (head + 1) * B)
        for r, k in ((caches[0], caches[2]), (caches[1], caches[3])):
            _close(k[:, rows].float(), r[:, rows].float(), 1e-2)
            assert torch.equal(k[:, :head * B], r[:, :head * B])
            assert not k[:, (head + 1) * B:].any()
    print(f"K8 {mode}: (head, max|err| / max|ref|, argmax flips, plain gap / max|ref|) "
          f"{[(h, f'{e:.2e}', n, f'{g:.1e}') for h, e, n, g in steps]}")
    assert all(e <= 2e-2 and g <= 1e-2 for _, e, _, g in steps), steps


def _k8_narrow(cuda, mode, B, Tc=300, Ta=600):
    """K8's narrow config (S=256, 4 heads, 3 layers, vocabulary 640; Tc
    cache rows a stream and Ta audio positions, across the 128-row time
    blocks and the 256-row cross chunks), its MegaParams in `mode`, each
    stream's cross-KV and a (L, Tc * B, S) self-cache of random history."""
    cfg = TM.WhisperConfig(640, Ta, 256, 4, 2, Tc, 256, 4, 3, 80)
    params = TM.init_params(cfg, seed=5, dtype=torch.bfloat16, device=cuda)
    dec = TM.prepare_decoder(params["decoder"])
    if mode == "logits":
        dec = TM.quantize_decoder_int8(dec)
    mp = MK.prepare_mega(cfg, dec, quant=mode)
    g = torch.Generator(device=cuda).manual_seed(9)
    xk, xv = ((torch.randn(3, B, Ta, 256, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
              for _ in range(2))
    hist = (torch.randn(2, 3, Tc * B, 256, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    return cfg, dec, mp, xk, xv, hist


@pytest.mark.parametrize("B", [2, 5, 8])
@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_batch_two_launches_bit_equal(cuda, mode, B):
    """Two K8 launches from the same inputs at head 257 (the third time
    block, past 128 and 256) give the same bits, logits and caches: every
    split, key block and chunk combines in a fixed order, with no float
    atomics."""
    cfg, dec, mp, xk, xv, hist = _k8_narrow(cuda, mode, B)
    head = 257
    for c in hist:
        c[:, head * B:] = 0
    x0 = (dec["te"][torch.arange(B, device=cuda) * 7] + dec["pe"][head]).to(torch.bfloat16)
    out = []
    for _ in range(2):
        k, v = hist[0].clone(), hist[1].clone()
        out.append((MK.mega_decode_step_batch(cfg, mp, x0, k, v, torch.tensor(head, device=cuda),
                                              xk, xv)[0], k, v))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert out[0][1][:, head * B:(head + 1) * B].any()   # the step wrote its rows


@pytest.mark.parametrize("mode", ["none", "all", "int4"])
def test_mega_batch_reads_step_data_after_the_wait(cuda, mode):
    """x0 and kv_head written by ops queued behind a 2 ms spin (their
    tensors hold other values until the spin ends) give the bits of the
    call whose inputs were ready: no launch of K8's chain reads the step's
    data before its dependent-launch wait (the cross-KV, fixed for the
    window, is read before it)."""
    B, head = 5, 130
    cfg, dec, mp, xk, xv, hist = _k8_narrow(cuda, mode, B)
    for c in hist:
        c[:, head * B:] = 0
    x0 = (dec["te"][torch.arange(B, device=cuda) * 11] + dec["pe"][head]).to(torch.bfloat16)
    ht = torch.tensor(head, device=cuda)
    k, v = hist[0].clone(), hist[1].clone()
    ref = MK.mega_decode_step_batch(cfg, mp, x0, k, v, ht, xk, xv)[0]
    torch.cuda.synchronize()
    for _ in range(3):
        x0_late = torch.full_like(x0, float("nan"))
        head_late = torch.tensor(3, device=cuda)
        k2, v2 = hist[0].clone(), hist[1].clone()
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        x0_late.copy_(x0)
        head_late.copy_(ht)
        got = MK.mega_decode_step_batch(cfg, mp, x0_late, k2, v2, head_late, xk, xv)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(k2, k) and torch.equal(v2, v)


@pytest.mark.parametrize("mode", ["none", "logits", "all", "int4"])
def test_mega_batch_identical_streams_give_identical_rows(cuda, mode):
    """Eight streams with the same token, history and cross-KV give eight
    bit-equal logits rows and new cache rows: no row's sums depend on
    another row or on its index."""
    B, head = 8, 200
    cfg, dec, mp, xk, xv, hist = _k8_narrow(cuda, mode, 1)
    hist[:, :, head:] = 0
    k = hist[0].repeat_interleave(B, dim=1).contiguous()   # row t * B + b: stream 0's row t
    v = hist[1].repeat_interleave(B, dim=1).contiguous()
    sk, sv = xk.expand(-1, B, -1, -1).contiguous(), xv.expand(-1, B, -1, -1).contiguous()
    x0 = (dec["te"][5] + dec["pe"][head])[None].expand(B, -1).to(torch.bfloat16).contiguous()
    got = MK.mega_decode_step_batch(cfg, mp, x0, k, v, torch.tensor(head, device=cuda), sk, sv)[0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert all(torch.equal(got[b], got[0]) for b in range(1, B))
    rows = k[:, head * B:(head + 1) * B], v[:, head * B:(head + 1) * B]
    assert all(torch.equal(r[:, b], r[:, 0]) for r in rows for b in range(1, B))
    assert rows[0].any()


def test_mega_batch_library_has_tma_and_dependent_launch(cuda):
    """K8's library (csrc/mega_batch.cu on mega_stream.cuh) holds TMA tile
    loads (UTMALDG), the dependent-launch trigger (PREEXIT) and wait
    (ACQBULK) and warp-level mma.sync (HMMA) in its SASS."""
    import shutil
    import subprocess
    from pathlib import Path

    from open_whisper_kit_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        pytest.skip("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(_build.build("mega_batch"))],
                          capture_output=True, text=True, check=True).stdout
    for op in ("UTMALDG", "PREEXIT", "ACQBULK", "HMMA"):
        assert op in sass, op


def test_chain_libraries_keep_their_own_flags(cuda):
    """K2's, K7's and K8's libraries all include mega_stream.cuh; each keeps
    its own shared-memory opt-in flags: none exports a flag or any GNU
    unique symbol (`nm -D` type u), which the dynamic linker would make one
    object for every library in the process."""
    import shutil
    import subprocess

    from open_whisper_kit_tpu_torch.ops import _build
    if shutil.which("nm") is None:
        pytest.skip("nm not found")
    for name in ("mega_step", "mega_beam", "mega_batch"):
        table = subprocess.run(["nm", "-D", "-C", "--defined-only", str(_build.build(name))],
                               capture_output=True, text=True, check=True).stdout.splitlines()
        kinds = [line.split()[1] for line in table if len(line.split()) >= 3]
        assert "u" not in kinds, name
        assert not any("allowed" in line for line in table), name


def _int8_cross_kv(cuda, B, H, Ta, seed, nat=False):
    """Int8 planes of a random (1, B, Ta, H * 64) cross-KV pair, head-major
    QuantKV or natural QuantKVNat, on the card: (kq, ks, vq, vs)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    quant = TM.quantize_cross_kv_nat if nat else TM.quantize_cross_kv
    k, v = (quant(torch.randn(1, B, Ta, H * 64, generator=g, device=cuda) * 0.5, H)
            for _ in range(2))
    return k.qs[0], k.scale[0], v.qs[0], v.scale[0]


@pytest.mark.parametrize("dtype,H,tol", [(torch.bfloat16, 20, 1e-2), (torch.float32, 2, 1e-5)])
@pytest.mark.parametrize("kernel,B,Bk", [("K9b", 1, 1), ("K9b", 5, 1), ("K9b", 8, 8),
                                         ("K9a", 8, 8), ("K9a", 3, 1)])
def test_cross_q8_kernels_match_plain(cuda, kernel, B, Bk, dtype, H, tol):
    """K9b and K9a against their plain versions on the same inputs, at
    large-v3-turbo's 20 heads (bf16, gate 1e-2 of max|ref|) and a narrow
    f32 shape (gate 1e-5 of max|ref|), 1500 audio positions: one stream,
    five rows over a shared batch-1 plane (batch stride 0), eight streams;
    K9a on a 1504-row slab with ta_valid = 1500. Each call is one launch."""
    nat = kernel == "K9a"
    kq, ks, vq, vs = _int8_cross_kv(cuda, Bk, H, 1500, 70 + B, nat)
    g = torch.Generator(device=cuda).manual_seed(B)
    q = torch.randn(B, 1, H * 64, generator=g, device=cuda).to(dtype)
    if nat:
        assert kq.shape[1] == 1504
        fn, plain, extra = TE.cross_attention_q8_nat, TE.cross_attention_q8_nat_plain, (1500,)
    else:
        fn, plain, extra = TE.cross_attention_q8, TE.cross_attention_q8_plain, ()
    before = fn.launches
    out = fn(q, kq, ks, vq, vs, H, 0.125, *extra)
    torch.cuda.synchronize()
    ref = plain(q, kq, ks, vq, vs, H, 0.125, *extra)
    assert fn.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert bool(torch.isfinite(out).all()) and err <= tol * ref.float().abs().max().item()


def test_cross_q8_wrappers_never_take_the_plain_version_on_cuda(cuda, monkeypatch):
    """On CUDA tensors the K9 wrappers launch their kernel (decode_impl's
    one-row QuantKV and QuantKVNat steps too) and never reach the plain
    versions; what the kernel cannot take raises."""
    def boom(*a, **k):
        raise AssertionError("plain version reached from a CUDA tensor")
    monkeypatch.setattr(TE, "cross_attention_q8_plain", boom)
    monkeypatch.setattr(TE, "cross_attention_q8_nat_plain", boom)
    cfg = TM.WhisperConfig(*NARROW_TS)
    dec = TM.prepare_decoder(TM.init_params(cfg, seed=0, dtype=torch.float32, device=cuda)[
        "decoder"])
    xk, xv = (torch.randn(cfg.n_text_layer, 2, 64, 128, device=cuda) for _ in range(2))
    for quant, fn in ((TM.quantize_cross_kv, TE.cross_attention_q8),
                      (TM.quantize_cross_kv_nat, TE.cross_attention_q8_nat)):
        kv_k, kv_v = TM.init_kv_cache(cfg, 2, dtype=torch.float32, device=cuda)
        before = fn.launches
        logits, _, _ = TM.decode_impl(cfg, dec, torch.tensor([[5], [9]], device=cuda),
                                      kv_k, kv_v, 0, quant(xk, 2), quant(xv, 2))
        torch.cuda.synchronize()
        assert fn.launches == before + cfg.n_text_layer
        assert bool(torch.isfinite(logits).all())
    kq, ks, vq, vs = _int8_cross_kv(cuda, 2, 2, 100, 3)
    q = torch.randn(2, 1, 128, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        TE.cross_attention_q8(q, kq.cpu(), ks, vq, vs, 2, 0.1)
    with pytest.raises(ValueError, match="16-byte"):
        TE.cross_attention_q8(q, kq.flatten()[1:1 + 2 * 2 * 99 * 64].view(2, 2, 99, 64),
                              ks[:, :, :99].contiguous(), vq[:, :, :99].contiguous(),
                              vs[:, :, :99].contiguous(), 2, 0.1)
    with pytest.raises(ValueError, match=r"\(B, 1, S\)"):
        TE.cross_attention_q8(q.expand(2, 3, 128), kq, ks, vq, vs, 2, 0.1)
    with pytest.raises(NotImplementedError, match="head dim"):
        TE.cross_attention_q8(q, kq.view(2, 4, 50, 64), ks.view(2, 4, 50), vq.view(2, 4, 50, 64),
                              vs.view(2, 4, 50), 4, 0.1)


def test_cross_kv_int8_whisper_full_cuda_matches_cpu(cuda):
    """whisper_full with cross_kv_int8 (f32, the narrow timestamp config)
    on the card and on the CPU, greedy on 35 s (audio seed 0) and beam 3 on
    40 s (seed 1), two windows each: the same token ids, at least 100 of
    them; on the card every one-row decoder step runs K9b once per layer,
    and the ingests none. Both seeds' CPU transcripts stay the same when
    the input is scaled by 1 +- 2^-20, 2^-16 or 2^-13."""
    from open_whisper_kit_tpu_torch.decode.params import BeamSearchParams, SamplingStrategy
    cfg = TM.WhisperConfig(*NARROW_TS)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = [b"<%d>" % i for i in range(50257)]
    greedy = FullParams(print_progress=False, cross_kv_int8=True, temperature_inc=0.0)
    beam = FullParams(print_progress=False, cross_kv_int8=True, temperature_inc=0.0,
                      strategy=SamplingStrategy.BEAM_SEARCH,
                      beam_search=BeamSearchParams(beam_size=3))
    for p, secs, seed in ((greedy, 35, 0), (beam, 40, 1)):
        samples = (np.random.default_rng(seed).standard_normal(16000 * secs)
                   .astype(np.float32) * 0.1)
        ids = {}
        for dev in ("cuda", "cpu"):
            ctx = TF.WhisperContext(cfg, params, build_vocab(tokens, cfg.n_vocab),
                                    TF._synthetic_mel_filters(80), n_loaded=1,
                                    dtype=torch.float32, device=dev)
            before = TE.cross_attention_q8.launches
            res = TF.whisper_full(ctx, p, samples)
            ids[dev] = [t.id for s in res.segments for t in s.tokens]
            launched = TE.cross_attention_q8.launches - before
            assert (launched > 0 and launched % cfg.n_text_layer == 0) if dev == "cuda" \
                else launched == 0
        assert ids["cuda"] == ids["cpu"] and len(ids["cpu"]) >= 100


@pytest.mark.parametrize("M,K,N", [(1536, 1280, 5120), (1536, 5120, 1280), (200, 72, 136),
                                   (1000, 1000, 1000), (131, 70, 100), (1, 8, 8)])
def test_mm_bf16_kernel_matches_plain(cuda, M, K, N, monkeypatch):
    """T1 at the tensor-core probe's two products, at ragged M, N and K
    (not multiples of the 128 x 128 tile or the 64-deep step: TMA fills
    with zeros, the stores are masked), and at K and N the wrapper pads to
    a multiple of 8, against its plain version: every element within one bf16 ulp,
    plus what two f32 sums of the same K products can differ by in another
    order, and at most 1 % of the values differing, 0.1 % by more than one
    ulp (gemm.mm_bf16_within). One launch per call, never the plain
    version."""
    from open_whisper_kit_tpu_torch.ops import gemm as G
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    a = (torch.randn(M, K, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    b = (torch.randn(K, N, generator=g, device=cuda) * K ** -0.5).to(torch.bfloat16)
    ref = G.mm_bf16_plain(a, b)
    before = G.mm_bf16.launches
    with monkeypatch.context() as m:
        m.setattr(G, "mm_bf16_plain", None)
        got = G.mm_bf16(a, b)
    torch.cuda.synchronize()
    assert G.mm_bf16.launches == before + 1
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    r = G.mm_bf16_within(got, ref, a, b)
    assert r["ok"], r


@pytest.mark.parametrize("M,K,N,tile", [
    (1536, 1280, 5120, (128, 256)), (2000, 700, 2100, (128, 256)), (1300, 1000, 4000, (128, 256)),
    (1536, 5120, 1280, (128, 128)), (1000, 1000, 1000, (128, 128)), (131, 70, 100, (128, 128)),
    (300, 512, 520, (128, 128))])
def test_mm_bf16_each_tile_matches_plain(cuda, M, K, N, tile):
    """T1 at each output tile it is built for, reached through shapes
    where its plan picks that tile (128 x 256 only where its tile pairs
    fill the card): the probe's products, ragged M, N and K, and K and N
    the wrapper pads to a multiple of 8, within mm_bf16_within's limits;
    one launch per call."""
    from open_whisper_kit_tpu_torch.ops import gemm as G
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert G.mm_bf16_plan(M, -(-N // 8) * 8, sms).tile == tile
    g = torch.Generator(device=cuda).manual_seed(M * K + N)
    a = (torch.randn(M, K, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    b = (torch.randn(K, N, generator=g, device=cuda) * K ** -0.5).to(torch.bfloat16)
    before = G.mm_bf16.launches
    got = G.mm_bf16(a, b)
    torch.cuda.synchronize()
    assert G.mm_bf16.launches == before + 1 and got.shape == (M, N)
    r = G.mm_bf16_within(got, G.mm_bf16_plain(a, b), a, b)
    assert r["ok"], r


@pytest.mark.parametrize("M,K,N", [(1536, 1280, 5120), (1536, 5120, 1280), (200, 72, 136),
                                   (12288, 1280, 5120), (12288, 5120, 1280), (131, 1000, 260),
                                   (2000, 96, 4096)])
def test_mm_s8_kernel_matches_plain(cuda, M, K, N, monkeypatch):
    """T2 (K6's GEMM alone) at the probe's two products (x @ W1 at its plan's
    128 x 256 tile, h @ W2 at 128 x 128), the 8-window encoder products,
    ragged M, N and K (K = 72 and 1000 padded to 80 and 1008) against its
    plain version, bit for bit; an all-zero row and an all-zero weight
    column give zeros. One launch per call, never the plain version."""
    from open_whisper_kit_tpu_torch.ops import gemm as G
    from open_whisper_kit_tpu_torch.ops import encoder_int8 as E8
    from open_whisper_kit_tpu_torch.tools import bench_int8_mxu as P
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    x[1] = 0
    w = torch.randn(K, N, generator=g, device=cuda) * K ** -0.5
    w[:, 2] = 0
    aq, a_s = P.quant_rows(x)
    wq, ws = E8.quantize_w_cols(w)
    wq_t = wq.t().contiguous()
    ref = G.mm_s8_plain(aq, a_s, wq_t, ws)
    before = G.mm_s8.launches
    with monkeypatch.context() as m:
        m.setattr(G, "mm_s8_plain", None)
        got = G.mm_s8(aq, a_s, wq_t, ws)
    torch.cuda.synchronize()
    assert G.mm_s8.launches == before + 1
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    n_diff = int((got.float() != ref.float()).sum())
    assert n_diff == 0, f"{n_diff} of {got.numel()} values differ"
    assert not got[1].any() and not got[:, 2].any()


def test_mm_wrappers_reject_what_the_kernels_cannot_take(cuda):
    """T1 and T2 raise on a wrong dtype, a non-contiguous operand, an
    operand off the 16-byte grid and mismatched shapes, before launching."""
    from open_whisper_kit_tpu_torch.ops import gemm as G
    a = torch.zeros(256, 256, dtype=torch.bfloat16, device=cuda)
    before = (G.mm_bf16.launches, G.mm_s8.launches)
    with pytest.raises(ValueError, match="bfloat16"):
        G.mm_bf16(a.float(), a)
    with pytest.raises(ValueError, match="contiguous"):
        G.mm_bf16(a, a.t())
    with pytest.raises(ValueError, match="16-byte"):
        G.mm_bf16(a.flatten()[1:1 + 128 * 128].view(128, 128), a[:128])
    with pytest.raises(ValueError, match=r"got torch.bfloat16 \(128, 256\)"):
        G.mm_bf16(a, a[:128])
    q = torch.zeros(256, 256, dtype=torch.int8, device=cuda)
    s = torch.zeros(256, 1, device=cuda)
    with pytest.raises(ValueError, match="a_s"):
        G.mm_s8(q, s[:128], q, s.t().contiguous())
    with pytest.raises(ValueError, match="b_t"):
        G.mm_s8(q, s, q.float(), s.t().contiguous())
    assert (G.mm_bf16.launches, G.mm_s8.launches) == before
