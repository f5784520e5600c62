"""The launch plans of the port's redesigned Hopper kernels, on the CPU.

K3's rows route (ops/quant_matmul.py::qmm_rows_plan, csrc/qmm_rows.cuh),
K5 on the same rows body (ffn_int8_rows_plan, csrc/ffn_int8.cu), T1
(ops/gemm.py::mm_bf16_plan, csrc/mm_bf16.cu), K6 and T2 (gemm.w8a8_plan,
csrc/w8a8.cu) and K2's chain
(ops/decode_megakernel.py::mega_step_plan, csrc/mega_stream.cuh) size their
launches in Python: how many splits of K, which K rows each takes, how much
shared memory a block holds for x's rows and for the other splits' partial
sums, T1's tile, its clusters and how many rounds of tile pairs the busiest
one walks, K2's attention key chunks, and K8's (csrc/mega_batch.cu,
mega_batch_plan) GEMVs, time blocks and cross chunks, K4's rows body on
int4 planes (quant_matmul.qmm4_rows_plan) and K9's clusters of key chunks
(ops/experiments.py::cross_q8_plan, csrc/cross_q8.cu). The kernels
themselves run only on the card (tests/test_torch_cuda.py); these are the
numbers they are launched with, checked here at the shapes large-v3-turbo
gives them.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from open_whisper_kit_tpu_torch import Transcriber
from open_whisper_kit_tpu_torch.decode import device_speculative as DS
from open_whisper_kit_tpu_torch.decode import full as FULL
from open_whisper_kit_tpu_torch.decode import tokenizer as TOK
from open_whisper_kit_tpu_torch.decode.params import FullParams
from open_whisper_kit_tpu_torch.models.whisper import model as TM
from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
from open_whisper_kit_tpu_torch.ops import experiments as XQ
from open_whisper_kit_tpu_torch.ops import gemm as G
from open_whisper_kit_tpu_torch.ops import quant_matmul as Q

H100_SMS = 132
# (M, K, Np) of the rows route on the decode path of large-v3-turbo: o/cq/co
# and qkv at one row, qkv at five (beam search, speculative verify), the W8
# logits (51866 columns padded to 128)
MAIN_PATH_ROWS = [(1, 1280, 1280), (1, 1280, 3840), (5, 1280, 3840), (1, 1280, 51968)]


@pytest.mark.parametrize("M,K,Np", MAIN_PATH_ROWS)
def test_rows_plan_spreads_the_main_path_over_the_card(M, K, Np):
    """Every main-path shape launches ROWS_BLOCKS blocks or more, or as many
    as the largest cluster allows (the 1.8 MB planes are then in flight
    whole); the W8 logits' 406 column tiles need no split."""
    plan = Q.qmm_rows_plan(M, K, Np)
    assert plan.blocks >= min(Q.ROWS_BLOCKS, plan.tiles * Q.ROWS_MAX_SPLITS)
    assert 1 <= plan.splits <= Q.ROWS_MAX_SPLITS
    assert plan.tiles == Np // 128
    if plan.tiles >= Q.ROWS_BLOCKS:
        assert plan.splits == 1


def test_rows_plan_at_the_decode_shapes():
    """The splits the kernel runs at (csrc/qmm_rows.cuh's header)."""
    assert [Q.qmm_rows_plan(*s).splits for s in MAIN_PATH_ROWS] == [8, 4, 4, 1]
    assert [Q.qmm_rows_plan(*s).blocks for s in MAIN_PATH_ROWS] == [80, 120, 120, 406]


@pytest.mark.parametrize("M,K,Np", MAIN_PATH_ROWS + [
    (1, 1312, 1280), (3, 1312, 1280), (9, 2080, 640), (16, 5120, 1280), (2, 96, 128),
    (1, 32, 128), (16, 1280, 51968)])
def test_rows_plan_splits_fall_on_scale_blocks(M, K, Np):
    """The splits cover K in order, each a non-empty run of whole 32-row
    scale blocks, the longest at most one block longer than the shortest."""
    rows = Q.qmm_rows_plan(M, K, Np).split_rows()
    assert rows[0][0] == 0 and rows[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(start % 32 == 0 and stop % 32 == 0 and stop > start for start, stop in rows)
    sizes = [stop - start for start, stop in rows]
    assert max(sizes) - min(sizes) <= 32


def test_rows_plan_uneven_splits():
    """41 scale blocks over 8 splits: some take five blocks, some six."""
    plan = Q.qmm_rows_plan(1, 1312, 1280)
    assert plan.splits == 8
    assert sorted({stop - start for start, stop in plan.split_rows()}) == [160, 192]


@pytest.mark.parametrize("M", [1, 2, 5, 8, 9, 16])
@pytest.mark.parametrize("K,Np", [(1280, 1280), (1280, 3840), (1280, 51968), (5120, 1280)])
def test_rows_plan_shared_memory(M, K, Np):
    """x's rows of a split (8 rows up to M = 8, else 16) and the partial sums
    the first split gathers (M x 128 f32 from each other split) stay within
    the plan's caps, and what a block asks for (csrc/qmm_rows.cuh's
    smem_bytes: the 4-stage ring of 4.5 KB, barriers, x's rows padded by 16
    bytes each, the gathered sums) fits the H100's 227 KB."""
    plan = Q.qmm_rows_plan(M, K, Np)
    x_rows = 8 if M <= 8 else 16
    longest = max(stop - start for start, stop in plan.split_rows())
    assert plan.x_smem == x_rows * longest * 2 <= Q.ROWS_X_SMEM
    assert plan.gather_smem == (plan.splits - 1) * M * 128 * 4 <= Q.ROWS_GATHER
    ring = 4 * (32 * 128 + 128 * 4) + 16 * 4 + 16
    assert 1024 + ring + plan.x_smem + 16 * x_rows + plan.gather_smem <= 227 * 1024


def test_rows_plan_rejects_what_no_split_fits():
    """A K so long that x's rows of a split outgrow their cap at every
    split the combine can hold has no plan (the wrapper raises)."""
    with pytest.raises(ValueError, match="no rows-route plan"):
        Q.qmm_rows_plan(16, 32 * 640, 128)


@pytest.mark.parametrize("M", [1, 5, 16, 17, 1500])
def test_qmm_route_takes_the_rows_body_to_16_rows(M):
    assert Q.qmm_route(M) == ("rows" if M <= Q.QMM_ROWS_MAX else "tiles")


@pytest.mark.parametrize("M,K,N,tile,pairs,grid,rounds", [
    (1536, 1280, 5120, (128, 256), 120, 132, 2),   # the probe's x @ W1: 240 tiles
    (1536, 5120, 1280, (128, 128), 60, 120, 1),    # h @ W2: 128 x 256 would leave 30 pairs
])
def test_mm_bf16_plan_at_the_probe_products(M, K, N, tile, pairs, grid, rounds):
    """T1's tile, tile pairs (clusters of two blocks), grid and rounds at
    the tensor-core probe's two products on 132 SMs; both fill the card to
    120 of 132 SM-rounds."""
    plan = G.mm_bf16_plan(M, N, H100_SMS)
    assert (plan.tile, plan.pairs, plan.grid, plan.rounds) == (tile, pairs, grid, rounds)
    assert plan.tiles == -(-M // tile[0]) * -(-N // tile[1])
    assert plan.fill == pytest.approx(120 / 132)


@pytest.mark.parametrize("M,N,tile", [
    (1536, 5120, (128, 256)), (4096, 4096, (128, 256)), (2000, 2104, (128, 256)),
    (1300, 4000, (128, 256)), (12288, 1280, (128, 256)), (12288, 5120, (128, 256)),
    (1, 8, (128, 128)), (131, 104, (128, 128)), (200, 136, (128, 128)),
    (1000, 1000, (128, 128)), (1536, 1280, (128, 128)), (1500, 1280, (128, 128))])
def test_mm_bf16_plan_covers_every_tile(M, N, tile):
    """Each of T1's tiles is reached through shapes where the plan picks
    it, and whatever the shape, the clusters (an even grid, at most one
    block per SM) walk every pair of row tiles of every column tile: pairs
    x 2 covers the row tiles, rounds x clusters covers the pairs."""
    plan = G.mm_bf16_plan(M, N, H100_SMS)
    assert plan.tile == tile and tile in G.MM_BF16_TILES
    m_tiles, n_tiles = -(-M // tile[0]), -(-N // tile[1])
    assert plan.grid % 2 == 0 and 2 <= plan.grid <= H100_SMS
    assert plan.pairs * 2 >= m_tiles and plan.pairs == -(-m_tiles // 2) * n_tiles
    assert plan.rounds * plan.grid // 2 >= plan.pairs
    assert 0 < plan.fill <= 1


@pytest.mark.parametrize("n_pairs,tile", [(66, (128, 256)), (65, (128, 128))])
def test_mm_bf16_plan_widens_only_where_pairs_fill_the_card(n_pairs, tile):
    """Two row tiles by n_pairs column tiles of 128 x 256: the wide tile
    only where its pairs fill every one of the card's 66 clusters."""
    plan = G.mm_bf16_plan(256, 256 * n_pairs, H100_SMS)
    assert plan.tile == tile
    assert plan.grid == H100_SMS


# every model width the port loads (tiny/tiny.en 384 through large 1280)
PRESET_WIDTHS = sorted({cfg.n_text_state for cfg in TM.PRESETS.values()})
ROWS_M = [1, 2, 5, 8, 9, 16]


def rows_max_smem(stages: int, gather: int) -> int:
    """The most a rows-body block with a ring of `stages` may ask for
    (csrc/qmm_rows.cuh's Layout::max_smem, what the kernel opts in to):
    1024 bytes of alignment, the ring (a 4 KB value tile, 512 bytes of
    scales, two 8-byte barriers a stage), the gather barrier, ROWS_X_SMEM +
    256 of x's rows and `gather` bytes of gathered sums."""
    return 1024 + stages * (32 * 128 + 128 * 4 + 16) + 16 + Q.ROWS_X_SMEM + 256 + gather


@pytest.mark.parametrize("M", ROWS_M)
@pytest.mark.parametrize("S", PRESET_WIDTHS)
def test_ffn_int8_plan_fits_the_rows_body(S, M):
    """K5's two launches at every preset width (S -> 4S -> S, W1 padded to
    128 columns) and every row count of the rows body: splits of whole
    scale blocks, at most the portable cluster of 8, x's rows of a split
    within ROWS_X_SMEM, the gathered sums within FFN_GATHER, and what a
    block asks for within its kernel's opt-in (rows_max_smem) and the
    H100's 227 KB."""
    plan = Q.ffn_int8_rows_plan(M, S, 4 * S, S)
    for p, stages in ((plan.up, Q.FFN_UP_STAGES), (plan.down, Q.FFN_DOWN_STAGES)):
        assert 1 <= p.splits <= Q.ROWS_MAX_SPLITS and p.splits <= p.K // 32
        rows = p.split_rows()
        assert rows[0][0] == 0 and rows[-1][1] == p.K
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        assert all(start % 32 == 0 and stop > start for start, stop in rows)
        assert p.x_smem <= Q.ROWS_X_SMEM
        assert p.gather_smem <= Q.FFN_GATHER
        assert p.smem(stages) <= rows_max_smem(stages, Q.FFN_GATHER) <= 227 * 1024
    assert plan.smem == (plan.up.smem(Q.FFN_UP_STAGES), plan.down.smem(Q.FFN_DOWN_STAGES))
    assert (plan.up.Np, plan.down.K, plan.down.Np) == (4 * S, 4 * S, S)


@pytest.mark.parametrize("M", ROWS_M)
@pytest.mark.parametrize("S", PRESET_WIDTHS)
def test_ffn_int8_plan_does_not_depend_on_m(S, M):
    """K5's splits (and so the order of every f32 sum) are those of one row
    at every M the rows body takes: a verify row is bit-equal to the same
    row run alone."""
    one = Q.ffn_int8_rows_plan(1, S, 4 * S, S)
    plan = Q.ffn_int8_rows_plan(M, S, 4 * S, S)
    assert (plan.up.splits, plan.down.splits) == (one.up.splits, one.down.splits)
    assert plan.up.split_rows() == one.up.split_rows()
    assert plan.down.split_rows() == one.down.split_rows()


def test_ffn_int8_plan_at_whisper_large():
    """At S = 1280 (large-v3, turbo) the first half runs 40 column tiles x
    3 splits (13-14 stages each, all in its 14-stage ring), the second 10
    x 8 (20 stages each, all in its 20-stage ring: the whole of W1 is asked
    for before the dependent launch's wait); both fit one SM together."""
    plan = Q.ffn_int8_rows_plan(1, 1280, 5120, 1280)
    assert (plan.up.splits, plan.up.blocks, plan.down.splits, plan.down.blocks) == (3, 120, 8, 80)
    steps = [(b - a) // 32 for a, b in plan.up.split_rows()]
    assert max(steps) <= Q.FFN_UP_STAGES
    assert {(b - a) // 32 for a, b in plan.down.split_rows()} == {Q.FFN_DOWN_STAGES}
    assert sum(plan.smem) + 2 * 1024 <= 227 * 1024


@pytest.mark.parametrize("M", [1, 16, 17, 40])
def test_ffn_int8_route(M):
    """M <= 16 rows take the rows body, whose plan refuses any other M."""
    assert Q.ffn_int8_route(M) == ("rows" if M <= 16 else "tiles")
    if M <= 16:
        assert Q.ffn_int8_rows_plan(M, 1280, 5120, 1280).up.M == M
    else:
        with pytest.raises(ValueError, match="rows body"):
            Q.ffn_int8_rows_plan(M, 1280, 5120, 1280)


def test_rows_body_constants_are_the_kernels():
    """The planner's ring depths and gather cap are csrc's: a plan that
    passes here also launches."""
    csrc = Path(Q.__file__).parents[1] / "csrc"
    ffn = (csrc / "ffn_int8.cu").read_text()
    rows = (csrc / "qmm_rows.cuh").read_text()
    assert int(re.search(r"constexpr int kUpStages = (\d+);", ffn).group(1)) == Q.FFN_UP_STAGES
    assert int(re.search(r"constexpr int kDownStages = (\d+);", ffn).group(1)) == \
        Q.FFN_DOWN_STAGES
    assert "constexpr uint32_t kFfnGatherCap = 7 * 16 * kBN * 4;" in rows
    assert Q.FFN_GATHER == 7 * 16 * 128 * 4
    assert re.search(r"launch_rows<4, kGatherCap, StoreF32Rows, kPdlNone>",
                     (csrc / "qmm_rows.cu").read_text())


# K6's four encoder linears (K, N) at model width S, and the row counts of
# one 30 s window and a batched round of eight
def _encoder_linears(S):
    return {"qkv": (S, 3 * S), "o": (S, S), "mlp0": (S, 4 * S), "mlp1": (4 * S, S)}


@pytest.mark.parametrize("M", [1536, 12288])
@pytest.mark.parametrize("S", PRESET_WIDTHS)
def test_w8a8_plan_covers_every_tile(S, M):
    """K6's (and T2's) plan at every preset's encoder linears: a tile of
    TILES, the wide one exactly where its pairs fill the card's 66
    clusters, an even grid of at most one block per SM, rounds x clusters
    covering every pair, and the share of SM-rounds that compute a tile."""
    for K, N in _encoder_linears(S).values():
        plan = G.w8a8_plan(M, N, H100_SMS)
        assert plan.tile in G.TILES
        wide_pairs = -(-M // 128 // 2) * -(-N // 256)
        assert plan.tile == ((128, 256) if wide_pairs >= H100_SMS // 2 else (128, 128))
        m_tiles, n_tiles = -(-M // plan.tile[0]), -(-N // plan.tile[1])
        assert plan.pairs == -(-m_tiles // 2) * n_tiles
        assert plan.grid % 2 == 0 and 2 <= plan.grid <= H100_SMS
        assert plan.rounds * plan.grid // 2 >= plan.pairs
        assert 0 < plan.fill <= 1


@pytest.mark.parametrize("M,name,tile,grid,rounds", [
    (1536, "qkv", (128, 256), 132, 2), (1536, "o", (128, 128), 120, 1),
    (1536, "mlp0", (128, 256), 132, 2), (1536, "mlp1", (128, 128), 120, 1),
    (12288, "qkv", (128, 256), 132, 11), (12288, "o", (128, 256), 132, 4),
    (12288, "mlp0", (128, 256), 132, 15), (12288, "mlp1", (128, 256), 132, 4)])
def test_w8a8_plan_at_turbo(M, name, tile, grid, rounds):
    """The tiles and grids K6 runs at large-v3-turbo's encoder (w8a8.cu's
    header): one window's o and mlp1 (N = 1280: 30 wide pairs) take 128 x
    128, everything else 128 x 256; T2's probe products are one window's
    mlp0 and mlp1."""
    K, N = _encoder_linears(1280)[name]
    plan = G.w8a8_plan(M, N, H100_SMS)
    assert (plan.tile, plan.grid, plan.rounds) == (tile, grid, rounds)


def test_w8a8_plan_is_t1s_rule():
    """K6/T2 and T1 pick their tiles by the same rule from the same two
    tiles (their plans differ only in the kernel they are for)."""
    assert G.TILES == G.MM_BF16_TILES
    for M in (1, 200, 1536, 12288):
        for N in (8, 1280, 3840, 5120, 51866):
            assert G.w8a8_plan(M, N, H100_SMS) == G.mm_bf16_plan(M, N, H100_SMS)


# K2 (the whole decoder step) at large-v3-turbo and at the narrow S = 128
# config the card compares with the CPU token for token, in each mode
# (int4 needs S % 256 == 0); the kinds of the seven weight fields
TURBO_CFG = TM.WhisperConfig(51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128)
NARROW_CFG = TM.WhisperConfig(51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80)
K2_KINDS = {"none": (None,) * 7, "logits": (None,) * 6 + ("int8",), "all": ("int8",) * 7,
            "int4": ("int4",) * 7}
K2_CASES = [(name, cfg, mode) for name, cfg in (("turbo", TURBO_CFG), ("narrow", NARROW_CFG))
            for mode in K2_KINDS if not (mode == "int4" and cfg.n_text_state % 256)]
K2_IDS = [f"{name}-{mode}" for name, _, mode in K2_CASES]


def _k2_plan(cfg, mode, R, Tc=None):
    return MK.mega_step_plan(cfg, K2_KINDS[mode], Tc or cfg.n_text_ctx, rows=R)


def _key_chunks(plan, T, cross=False):
    """The keys [start, stop) each block of a head's cluster takes of T."""
    c, n = ((plan.cross_chunk, plan.cross_chunks) if cross
            else (plan.self_chunk, plan.self_chunks))
    return [(i * c, min((i + 1) * c, T)) for i in range(n)]


@pytest.mark.parametrize("R", [1, 5, 8])
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_step_plan_covers_every_tile_once(name, cfg, mode, R):
    """Every field's grid is its column tiles of 128 by its splits: the
    tiles cover the field's N (the vocabulary padded to 128) once, and each
    tile's splits cover K (int4: the packed rows) in order, once."""
    S = cfg.n_text_state
    Vp = -(-cfg.n_vocab // 128) * 128
    want = {"qkv_w": (S, 3 * S), "o_w": (S, S), "cq_w": (S, S), "co_w": (S, S),
            "mlp0_w": (S, 4 * S), "mlp1_w": (4 * S, S), "teT": (S, Vp)}
    plan = _k2_plan(cfg, mode, R)
    assert [f.name for f in plan.fields] == list(MK.WEIGHTS)
    for f in plan.fields:
        assert (f.K, f.N) == want[f.name] and f.kind == K2_KINDS[mode][MK.WEIGHTS.index(f.name)]
        assert f.tiles * 128 == f.N and f.blocks == f.tiles * f.splits
        rows = f.split_rows()
        assert len(rows) == f.splits and rows[0][0] == 0
        assert rows[-1][1] == (f.K // 2 if f.kind == "int4" else f.K)
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("R", [1, 5, 8])
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_step_plan_splits_fall_on_scale_blocks(name, cfg, mode, R):
    """Each split is a non-empty run of whole 32-row scale blocks (int4: 32
    packed rows, one block of each half), the longest at most one block
    longer than the shortest."""
    for f in _k2_plan(cfg, mode, R).fields:
        rows = f.split_rows()
        assert all(a % 32 == 0 and b % 32 == 0 and b > a for a, b in rows)
        sizes = [b - a for a, b in rows]
        assert max(sizes) - min(sizes) <= 32


@pytest.mark.parametrize("R", [1, 5, 8])
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_step_plan_is_the_same_for_every_row_count(name, cfg, mode, R):
    """The splits and the key chunks, what fixes every row's summation
    order, do not depend on R: a verify row sums as the one-row step at its
    position does. Only the gathered partial sums' shared memory grows."""
    one, plan = _k2_plan(cfg, mode, 1), _k2_plan(cfg, mode, R)
    assert plan.ints == one.ints
    assert [f.split_rows() for f in plan.fields] == [f.split_rows() for f in one.fields]
    assert _key_chunks(plan, cfg.n_text_ctx) == _key_chunks(one, cfg.n_text_ctx)
    assert _key_chunks(plan, cfg.n_audio_ctx, cross=True) == _key_chunks(
        one, cfg.n_audio_ctx, cross=True)
    for f, g in zip(plan.fields, one.fields):
        staged = ((R - 1) * (f.K + 8) * 2 if f.splits > 1
                  and f.name in ("qkv_w", "cq_w", "mlp0_w", "teT") else 0)
        assert f.smem(R) - g.smem(1) == (f.splits - 1) * (R - 1) * 128 * 4 + staged


@pytest.mark.parametrize("R", [1, 5, 8])
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_step_plan_clusters_and_shared_memory(name, cfg, mode, R):
    """Clusters (a tile's splits, a head's key chunks) of at most 8 blocks,
    key chunks of at most 256 keys, rings of 1-20 stages, none deeper than
    its split, and every block's shared memory, mlp1's (K = 4S) included,
    within MEGA_MAX_SMEM (what the kernels opt in to); a grid larger than
    the card at two blocks a multiprocessor (the logits) fits it whole at 8
    rows, within a multiprocessor's 227 KB."""
    plan = _k2_plan(cfg, mode, R)
    limit = MK.MEGA_MAX_SMEM
    for f in plan.fields:
        assert 1 <= f.splits <= MK.MEGA_MAX_CLUSTER and f.splits <= f.stages
        assert 1 <= f.depth <= min(f.split_stages, MK.MEGA_MAX_DEPTH)
        assert f.smem(R) <= limit
        per_sm = -(-f.blocks // 132)
        if per_sm > 2:
            assert f.smem(8) * per_sm <= MK.MEGA_SM_SMEM == 227 * 1024
    mlp1 = plan.fields[MK.WEIGHTS.index("mlp1_w")]
    assert mlp1.K == 4 * cfg.n_text_state and mlp1.smem(R) <= limit
    assert max(plan.self_chunks, plan.cross_chunks) <= 8
    assert max(plan.self_chunk, plan.cross_chunk) <= 256
    assert max(plan.attn_smem) <= limit
    assert plan.cross_chunk * plan.cross_chunks >= cfg.n_audio_ctx


@pytest.mark.parametrize("gamma", range(1, 8))
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_step_plan_key_chunk_depends_on_tp_only(name, cfg, mode, gamma):
    """The speculative loop's cache (n_text_ctx + gamma + 4 rows) is split
    into the greedy loop's chunks (n_text_ctx rows), plus one chunk for the
    rows past n_text_ctx, within the 8 a cluster holds."""
    Tc = cfg.n_text_ctx
    greedy = _k2_plan(cfg, mode, 1, Tc)
    spec = _k2_plan(cfg, mode, gamma + 1, Tc + gamma + 4)
    assert spec.self_chunk == greedy.self_chunk
    g_chunks, s_chunks = _key_chunks(greedy, Tc), _key_chunks(spec, Tc + gamma + 4)
    assert s_chunks[:len(g_chunks) - 1] == g_chunks[:-1]
    assert s_chunks[len(g_chunks) - 1][0] == g_chunks[-1][0]
    assert spec.self_chunks <= 8 and spec.ints[:14] == greedy.ints[:14]


def test_mega_step_plan_at_turbo():
    """The int8 launches at large-v3-turbo (tiles, splits, ring depth):
    qkv 30 x 4 x 10, mlp0 40 x 4 x 10, o/cq/co 10 x 8 x 5, mlp1 10 x 8 x 20
    (a ring holds the whole split), the W8 logits 406 x 1 x 6 (of 40
    stages: four blocks a multiprocessor); self-attention 7
    chunks of 64 keys at 448 cache rows (8 at the speculative loop's 459),
    cross 8 of 192."""
    plan = _k2_plan(TURBO_CFG, "all", 1)
    assert [(f.tiles, f.splits, f.depth) for f in plan.fields] == [
        (30, 4, 10), (10, 8, 5), (10, 8, 5), (10, 8, 5), (40, 4, 10), (10, 8, 20), (406, 1, 6)]
    assert (plan.self_chunk, plan.self_chunks, plan.cross_chunk, plan.cross_chunks) == (
        64, 7, 192, 8)
    assert _k2_plan(TURBO_CFG, "all", 8, 459).self_chunks == 8


def test_mega_step_plan_rejects_what_no_cluster_holds():
    """A cache far past n_text_ctx would need more than 8 key chunks: no
    plan (the wrapper raises rather than launching)."""
    with pytest.raises(ValueError, match="no plan"):
        _k2_plan(TURBO_CFG, "all", 1, 448 * 2)


def test_mega_step_smem_limit_is_the_kernels():
    """The planner's per-block limit is what csrc/mega_stream.cuh opts its
    kernels in to: a plan that passes here also launches."""
    src = (Path(MK.__file__).parents[1] / "csrc" / "mega_stream.cuh").read_text()
    kb = int(re.search(r"constexpr int kMaxSmem = (\d+) \* 1024;", src).group(1))
    assert kb * 1024 == MK.MEGA_MAX_SMEM


@pytest.mark.parametrize("gamma", [4, 7, 60, 61, 100])
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_speculative_steps_take_k2_while_the_cache_has_a_plan(name, cfg, mode, gamma):
    """The speculative loop's caches hold n_text_ctx + gamma + 4 rows; K2
    plans for at most mega_step_max_cache (512 at 448: 8 chunks of 64).
    The draft's one-row steps take K2 to gamma 60 and decode_impl past it;
    the verify pass takes K2 to gamma 7. Whatever gamma, each step has a
    route."""
    Tc = DS.cache_rows(cfg, gamma)
    fits = Tc <= MK.mega_step_max_cache(cfg)
    assert fits == (gamma <= 60)
    if fits:
        _k2_plan(cfg, mode, 1, Tc)
    else:
        with pytest.raises(ValueError, match="no plan"):
            _k2_plan(cfg, mode, 1, Tc)
    ctx = types.SimpleNamespace(
        cfg=cfg, mega_params=lambda p, draft=False: "target",
        draft=types.SimpleNamespace(cfg=cfg, mega_params=lambda p, draft=False: "draft"))
    assert FULL._speculative_mega(ctx, None, gamma) == (
        "draft" if fits else None, "target" if gamma + 1 <= 8 else None)


# K8 (the batched-stream step) at B = 2, 5 and 8 streams on the same cases
K8_STREAMS = (2, 5, 8)


@pytest.mark.parametrize("B", K8_STREAMS)
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_batch_plan_runs_k2s_gemvs_at_b_rows(name, cfg, mode, B):
    """K8's seven GEMV launches are K2's at R = B: the same fields, splits,
    ring depths and split rows, so each stream's row sums as a K2 row does."""
    plan = MK.mega_batch_plan(cfg, K2_KINDS[mode], cfg.n_text_ctx, streams=B)
    k2 = _k2_plan(cfg, mode, B)
    assert plan.rows == k2.rows == B
    assert plan.fields == k2.fields and plan.ints[:14] == k2.ints[:14]
    assert [f.split_rows() for f in plan.fields] == [f.split_rows() for f in k2.fields]


@pytest.mark.parametrize("B", K8_STREAMS)
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_batch_plan_blocks_clusters_and_shared_memory(name, cfg, mode, B):
    """The self-attention walks whole 128-row time blocks and the
    cross-attention whole 256-row chunks (the TPU kernel's BT and tac: its
    online softmax's running max moves at their edges), each (head, stream)
    pair's blocks one cluster; every cluster (those and the GEMVs' splits)
    within MEGA_MAX_CLUSTER and every block's shared memory within
    MEGA_MAX_SMEM, what the kernels opt in to."""
    Tc, Ta = cfg.n_text_ctx, cfg.n_audio_ctx
    plan = MK.mega_batch_plan(cfg, K2_KINDS[mode], Tc, streams=B)
    assert MK.BT == 128 and MK.TAC == 256 and plan.ints[14:] == (MK.BT, MK.TAC)
    for rows, n, T in ((MK.BT, plan.self_blocks, Tc), (MK.TAC, plan.cross_chunks, Ta)):
        blocks = [(c * rows, min((c + 1) * rows, T)) for c in range(n)]
        assert blocks[-1][1] == T and all(b - a == rows for a, b in blocks[:-1])
        assert 0 < blocks[-1][1] - blocks[-1][0] <= rows
        assert n <= MK.MEGA_MAX_CLUSTER
    assert all(1 <= f.splits <= MK.MEGA_MAX_CLUSTER for f in plan.fields)
    assert max(f.smem(B) for f in plan.fields) <= MK.MEGA_MAX_SMEM
    assert max(plan.attn_smem) <= MK.MEGA_MAX_SMEM


@pytest.mark.parametrize("Tc,Ta,fits", [(1024, 2048, True), (1025, 1500, False),
                                        (448, 2049, False), (1100, 2100, False)])
def test_mega_batch_plan_rejects_what_no_cluster_holds(Tc, Ta, fits):
    """A cluster of 8 holds 8 time blocks (1024 cache rows a stream) and 8
    cross chunks (2048 audio positions); past either there is no plan, and
    the error names the limit (the wrapper raises it on the card)."""
    kinds = K2_KINDS["all"]
    if fits:
        plan = MK.mega_batch_plan(TURBO_CFG, kinds, Tc, Ta, streams=8)
        assert (plan.self_blocks, plan.cross_chunks) == (8, 8)
    else:
        with pytest.raises(ValueError, match=r"1024\).*2048\)"):
            MK.mega_batch_plan(TURBO_CFG, kinds, Tc, Ta, streams=8)


@pytest.mark.parametrize("preset", sorted(TM.PRESETS))
def test_every_preset_lockstep_step_has_a_k8_plan(preset):
    """The lockstep loop steps K8 on a cache of n_text_ctx rows a stream
    over n_audio_ctx positions: every preset has a plan there at every B
    and in every mode the kernel takes (int4 needs S % 256 == 0)."""
    cfg = TM.PRESETS[preset]
    for mode, kinds in K2_KINDS.items():
        if mode == "int4" and cfg.n_text_state % 256:
            continue
        for B in range(2, 9):
            plan = MK.mega_batch_plan(cfg, kinds, cfg.n_text_ctx, cfg.n_audio_ctx, streams=B)
            assert max(plan.self_blocks, plan.cross_chunks) <= MK.MEGA_MAX_CLUSTER


class _Stop(Exception):
    pass


def test_lockstep_path_steps_k8_at_n_text_ctx(monkeypatch):
    """transcribe_batch with megakernel="int8" on a narrow bf16 model on the
    CPU: the first lockstep step calls K8 with n_text_ctx cache rows a
    stream and n_audio_ctx positions, where it has a plan (the call is
    stopped there)."""
    cfg = TM.WhisperConfig(51864, 1500, 128, 2, 2, 448, 128, 2, 2, 80)
    params = TM.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    vocab = TOK.build_vocab([b"<%d>" % i for i in range(50257)], cfg.n_vocab)
    ctx = FULL.WhisperContext(cfg, params, vocab, FULL._synthetic_mel_filters(80), n_loaded=1,
                              dtype=torch.bfloat16, device="cpu")
    seen = []

    def k8(cfg_, mp, x0, kv_k, kv_v, kv_head, xk, xv):
        B = x0.shape[0]
        seen.append((B, kv_k.shape[1] // B, xk.shape[-2]))
        MK.mega_batch_plan(cfg_, [MK._kind(getattr(mp, n)) for n in MK.WEIGHTS],
                           kv_k.shape[1] // B, xk.shape[-2], streams=B, Vp=mp.vp)
        raise _Stop
    monkeypatch.setattr(MK, "mega_decode_step_batch", k8)
    tr = Transcriber.__new__(Transcriber)
    tr.ctx = ctx
    files = [(np.random.default_rng(s).standard_normal(32000) * 0.1).astype(np.float32)
             for s in range(3)]
    with pytest.raises(_Stop):
        tr.transcribe_batch(files, FullParams(print_progress=False, megakernel="int8"))
    assert seen == [(3, cfg.n_text_ctx, cfg.n_audio_ctx)]


# K7 (the beam step) at B = 2..8 beams on the same cases
K7_BEAMS = tuple(range(2, 9))


@pytest.mark.parametrize("B", K7_BEAMS)
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_beam_plan_runs_k2s_gemvs_and_cross_chunks_at_b_rows(name, cfg, mode, B):
    """K7's seven GEMV launches are K2's at R = B (the same fields, splits,
    ring depths and split rows, so each beam's row sums as a K2 row does),
    and its cross-attention is K2's: the same key chunk over the shared
    cross-KV."""
    plan = MK.mega_beam_plan(cfg, K2_KINDS[mode], cfg.n_text_ctx, beams=B)
    k2 = _k2_plan(cfg, mode, B)
    assert plan.rows == k2.rows == B
    assert plan.fields == k2.fields and plan.ints[:14] == k2.ints[:14]
    assert [f.split_rows() for f in plan.fields] == [f.split_rows() for f in k2.fields]
    assert (plan.cross_chunk, plan.cross_chunks) == (k2.cross_chunk, k2.cross_chunks)
    assert plan.ints[15] == k2.ints[15]


@pytest.mark.parametrize("B", K7_BEAMS)
@pytest.mark.parametrize("name,cfg,mode", K2_CASES, ids=K2_IDS)
def test_mega_beam_plan_blocks_clusters_and_shared_memory(name, cfg, mode, B):
    """The lineage self-attention walks whole 128-row time blocks (the TPU
    kernel's BT: its online softmax's running max moves at their edges),
    each (head, beam) pair's blocks one cluster; every cluster (those, the
    cross chunks and the GEMVs' splits) within MEGA_MAX_CLUSTER and every
    block's shared memory within MEGA_MAX_SMEM."""
    Tc, Ta = cfg.n_text_ctx, cfg.n_audio_ctx
    plan = MK.mega_beam_plan(cfg, K2_KINDS[mode], Tc, beams=B)
    assert plan.ints[14] == MK.BT == 128
    assert plan.self_blocks == -(-Tc // MK.BT) <= MK.MEGA_MAX_CLUSTER
    assert plan.cross_chunks * plan.cross_chunk >= Ta > (plan.cross_chunks - 1) * plan.cross_chunk
    assert plan.cross_chunks <= MK.MEGA_MAX_CLUSTER and plan.cross_chunk <= MK.MEGA_MAX_CHUNK
    assert all(1 <= f.splits <= MK.MEGA_MAX_CLUSTER for f in plan.fields)
    assert max(f.smem(B) for f in plan.fields) <= MK.MEGA_MAX_SMEM
    assert max(plan.attn_smem) <= MK.MEGA_MAX_SMEM


@pytest.mark.parametrize("Tc,Ta,fits", [(1024, 2048, True), (1025, 1500, False),
                                        (448, 2049, False), (1100, 2100, False)])
def test_mega_beam_plan_rejects_what_no_cluster_holds(Tc, Ta, fits):
    """A cluster of 8 holds 8 time blocks (1024 cache rows a beam) and 8
    cross chunks of at most 256 positions (2048); past either there is no
    plan, and the error names the limit (the wrapper raises it on the
    card)."""
    kinds = K2_KINDS["all"]
    if fits:
        plan = MK.mega_beam_plan(TURBO_CFG, kinds, Tc, Ta, beams=5)
        assert (plan.self_blocks, plan.cross_chunks) == (8, 8)
    else:
        with pytest.raises(ValueError, match=r"1024\).*2048\)"):
            MK.mega_beam_plan(TURBO_CFG, kinds, Tc, Ta, beams=5)


@pytest.mark.parametrize("preset", sorted(TM.PRESETS))
def test_every_preset_beam_loop_has_a_k7_plan(preset):
    """The device beam loop steps K7 on a cache of n_text_ctx rows a beam
    over n_audio_ctx positions: every preset has a plan there at every B
    and in every mode the kernel takes (int4 needs S % 256 == 0)."""
    cfg = TM.PRESETS[preset]
    for mode, kinds in K2_KINDS.items():
        if mode == "int4" and cfg.n_text_state % 256:
            continue
        for B in K7_BEAMS:
            plan = MK.mega_beam_plan(cfg, kinds, cfg.n_text_ctx, cfg.n_audio_ctx, beams=B)
            assert max(plan.self_blocks, plan.cross_chunks) <= MK.MEGA_MAX_CLUSTER


def test_beam_path_steps_k7_at_n_text_ctx(monkeypatch):
    """Beam search (beam_size 3) with megakernel="int8" on a narrow bf16
    model on the CPU: the first beam step calls K7 with n_text_ctx cache
    rows a beam, n_audio_ctx positions and a (B, n_text_ctx) origin table,
    where it has a plan (the call is stopped there)."""
    from open_whisper_kit_tpu_torch.decode.params import BeamSearchParams, SamplingStrategy
    cfg = TM.WhisperConfig(51864, 1500, 128, 2, 2, 448, 128, 2, 2, 80)
    params = TM.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    vocab = TOK.build_vocab([b"<%d>" % i for i in range(50257)], cfg.n_vocab)
    ctx = FULL.WhisperContext(cfg, params, vocab, FULL._synthetic_mel_filters(80), n_loaded=1,
                              dtype=torch.bfloat16, device="cpu")
    seen = []

    def k7(cfg_, mp, x0, kv_k, kv_v, kv_head, xk, xv, origin=None):
        B = x0.shape[0]
        seen.append((B, kv_k.shape[1] // B, xk.shape[-2], tuple(origin.shape)))
        MK.mega_beam_plan(cfg_, [MK._kind(getattr(mp, n)) for n in MK.WEIGHTS],
                          kv_k.shape[1] // B, xk.shape[-2], beams=B, Vp=mp.vp)
        raise _Stop
    monkeypatch.setattr(MK, "mega_decode_step_beam", k7)
    tr = Transcriber.__new__(Transcriber)
    tr.ctx = ctx
    samples = (np.random.default_rng(0).standard_normal(32000) * 0.1).astype(np.float32)
    p = FullParams(print_progress=False, strategy=SamplingStrategy.BEAM_SEARCH,
                   beam_search=BeamSearchParams(beam_size=3), megakernel="int8")
    with pytest.raises(_Stop):
        tr.transcribe(samples, p)
    assert seen == [(3, cfg.n_text_ctx, cfg.n_audio_ctx, (3, cfg.n_text_ctx))]


# K1's f32 body (ops/attention.py::mha_f32_plan): (B, T, S, n_valid) of the
# narrow f32 models (S = 128, 2 heads; one window and a round of eight), a
# tiny-like width, large-v3-turbo's width, a ragged T and a few live keys
F32_SHAPES = [(1, 1536, 128, 1500), (8, 1536, 128, 1500), (2, 1500, 384, 1500),
              (1, 1536, 1280, 1500), (8, 1536, 1280, 1500), (1, 200, 128, 190),
              (1, 1536, 128, 1)]


@pytest.mark.parametrize("B,T,S,n_valid", F32_SHAPES)
def test_mha_f32_plan_clusters_chunks_and_shared_memory(B, T, S, n_valid):
    """The chunks cover the live keys in whole 64-key tiles with none empty,
    a cluster holds at most 8 of them (the portable size), the shared
    memory a block asks for lets F32_BLOCKS_PER_SM share a multiprocessor,
    and the grid reaches the card's 132 multiprocessors wherever the query
    tiles, heads and keys allow it (at most a power-of-two cluster a query
    tile)."""
    from open_whisper_kit_tpu_torch.ops import attention as A
    plan = A.mha_f32_plan(B, T, S, n_valid, H100_SMS)
    tiles = -(-n_valid // A.F32_KEYS)
    assert 1 <= plan.chunks <= A.F32_MAX_CLUSTER
    assert plan.chunk_keys % A.F32_KEYS == 0
    assert (plan.chunks - 1) * plan.chunk_keys < n_valid <= plan.chunks * plan.chunk_keys
    assert plan.pairs == B * -(-T // A.F32_QUERIES) * (S // 64)
    assert A.F32_BLOCKS_PER_SM * A.F32_SMEM <= 227 * 1024
    widest = max(c for c in (1, 2, 4, 8) if c <= tiles)
    assert plan.blocks >= min(H100_SMS, plan.pairs * widest)


def test_mha_f32_plan_fills_the_card_at_narrow_width():
    """At the narrow f32 models' encoder shape (one window, 2 heads, 1500
    live keys) the first f32 body launched 96 blocks; the plan splits the
    keys in 4 chunks of 384: 24 query tiles x 2 heads x 4 = 192 blocks, one
    wave at two a multiprocessor (8 chunks, 384 blocks, measured 10 %
    slower on the H100). At large-v3-turbo's width the 480 (query tile,
    head) pairs fill the card alone."""
    from open_whisper_kit_tpu_torch.ops import attention as A
    plan = A.mha_f32_plan(1, 1536, 128, 1500, H100_SMS)
    assert (plan.chunks, plan.chunk_keys, plan.blocks) == (4, 384, 192)
    assert plan.blocks >= H100_SMS
    assert A.mha_f32_plan(1, 1536, 1280, 1500, H100_SMS).chunks == 1


# K4 on the rows body: the W4 logits plane (51866 columns padded to 128) at
# the decode rows: one row, five beams, eight lockstep streams, sixteen
# verify rows
@pytest.mark.parametrize("M", [1, 5, 8, 16])
def test_qmm4_rows_plan_at_the_w4_logits(M):
    """K4's plan at the W4 logits: 406 column tiles of 128, one split (the
    tiles alone fill the card), the int4 stage (16 packed rows, 2 KB, and
    128 scales) on K3's 4-stage ring; what a block asks for fits the H100's
    227 KB, and four blocks share a multiprocessor."""
    Np = 51968
    plan = Q.qmm4_rows_plan(M, 1280, Np)
    assert (plan.M, plan.K, plan.Np, plan.bits) == (M, 1280, Np, 4)
    assert plan.tiles == 406 and plan.splits == 1 and plan.blocks == 406
    assert plan.split_rows() == [(0, 1280)]
    stage = 16 * 128 + 128 * 4 + 16
    x_rows = 8 if M <= 8 else 16
    smem = plan.smem(Q.ROWS_STAGES)
    assert smem == 1024 + Q.ROWS_STAGES * stage + 16 + plan.x_smem + 16 * x_rows
    assert 4 * smem <= 227 * 1024
    assert smem < Q.qmm_rows_plan(M, 1280, Np).smem(Q.ROWS_STAGES)


@pytest.mark.parametrize("M", [1, 2, 5, 8, 9, 16])
@pytest.mark.parametrize("K,Np", [(1280, 1280), (1280, 3840), (5120, 1280), (384, 51968)])
def test_qmm4_rows_plan_is_k3s_splits_on_the_int4_stage(M, K, Np):
    """K4 splits K as K3's rows route does at every shape (the same scale
    blocks a split) and asks for less shared memory: half a stage's value
    bytes, within 227 KB."""
    k3, k4 = Q.qmm_rows_plan(M, K, Np), Q.qmm4_rows_plan(M, K, Np)
    assert k4.splits == k3.splits and k4.split_rows() == k3.split_rows()
    assert k4.smem(Q.ROWS_STAGES) == k3.smem(Q.ROWS_STAGES) - Q.ROWS_STAGES * 16 * 128
    assert k4.smem(Q.ROWS_STAGES) <= 227 * 1024


@pytest.mark.parametrize("M", [0, 17, 40])
def test_qmm4_rows_plan_takes_the_decode_rows_only(M):
    """Past 16 rows K4 takes the TMA + wgmma tiles of qmm_wgmma.cuh with the
    int4 loader (qmm_route), and the rows plan refuses."""
    with pytest.raises(ValueError, match="rows body"):
        Q.qmm4_rows_plan(M, 1280, 51968)


def test_qmm4_rows_body_constants_are_the_kernels():
    """K4's entry runs the rows body at the planner's ring depth with the
    int4 stage."""
    csrc = Path(Q.__file__).parents[1] / "csrc"
    assert re.search(rf"launch_rows<{Q.ROWS_STAGES}, kGatherCap, StoreF32Rows, kPdlNone, 4>",
                     (csrc / "qmm4.cu").read_text())
    assert re.search(rf"launch_rows<{Q.ROWS_STAGES}, kGatherCap, StoreF32Rows, kPdlNone>",
                     (csrc / "qmm_rows.cu").read_text())


# the tiles body above 16 rows (csrc/qmm_wgmma.cuh): the row counts its
# callers give it (8 lockstep streams of 3-4 prompt tokens, kernel_times.py's
# 40, the host-stepped and DTW 64-row buckets, one window's 1 + 223 + 3
# prompt ingest, a whole text context), and its three planes at
# large-v3-turbo: K5's two halves and K4's W4 logits
TILES_M = [17, 24, 40, 64, 227, 448]


def _tiles_plans(M):
    ffn = Q.ffn_int8_tiles_plan(M, 1280, 5120, 1280)
    return {"ffn up": ffn.up, "ffn down": ffn.down,
            "qmm4 logits": Q.tiles_plan(M, 1280, 51968, bits=4)}


@pytest.mark.parametrize("M", TILES_M)
def test_tiles_plan_covers_every_tile_once(M):
    """Every (row tile, column tile, split) is one block of the grid, and
    the splits of a tile walk K's 64-row steps once each, in order, none
    empty; at most TILES_MAX_SPLITS (the portable cluster) and no more
    than the runs there are."""
    for name, plan in _tiles_plans(M).items():
        work = plan.block_work()
        assert len(work) == plan.blocks == plan.row_tiles * plan.col_tiles * plan.splits
        assert len({w[:3] for w in work}) == len(work), name
        assert plan.row_tiles == -(-M // 128) and plan.col_tiles == plan.Np // 128
        assert 1 <= plan.splits <= min(Q.TILES_MAX_SPLITS, plan.runs)
        for m in range(plan.row_tiles):
            for n in range(plan.col_tiles):
                rows = sorted((w[2], w[3], w[4]) for w in work if w[:2] == (m, n))
                assert [r[0] for r in rows] == list(range(plan.splits))
                assert rows[0][1] == 0 and rows[-1][2] == -(-plan.K // 64) * 64 >= plan.K
                assert all(a[2] == b[1] for a, b in zip(rows, rows[1:]))
                assert all(stop > start and start % 64 == 0 for _, start, stop in rows)


@pytest.mark.parametrize("M", TILES_M)
def test_ffn_int8_tiles_plan_splits_on_512_row_tiles(M):
    """K5's second half splits the hidden axis on the TPU kernel's 512-row
    tiles only (runs of 8 steps), so its splits add whole tiles in tile
    order; the first half splits K in 64-row steps."""
    plan = Q.ffn_int8_tiles_plan(M, 1280, 5120, 1280)
    assert plan.down.unit == 8 and plan.up.unit == 1
    assert plan.down.runs == 10
    for start, stop in plan.down.split_rows():
        assert start % 512 == 0 and stop % 512 == 0
    assert (plan.up.K, plan.up.Np, plan.down.K, plan.down.Np) == (1280, 5120, 5120, 1280)


@pytest.mark.parametrize("M", TILES_M)
def test_tiles_plan_walk_is_the_shortest(M):
    """The plan's splits give the shortest modelled walk (waves of the
    clusters the card holds, each as long as its longest split, plus the
    combine) of every admissible split count, the fewest splits among
    equals; with as many output tiles as multiprocessors it splits
    nothing."""
    for name, plan in _tiles_plans(M).items():
        if plan.tiles >= H100_SMS:
            assert plan.splits == 1 and "fill" in plan.reason
            continue
        others = [Q.TilesPlan(M, plan.K, plan.Np, s, plan.unit, plan.bits)
                  for s in range(1, min(Q.TILES_MAX_SPLITS, plan.runs) + 1)]
        assert all((plan.walk, plan.splits) <= (o.walk, o.splits) for o in others), name
        assert f"{plan.blocks} blocks" in plan.reason


def test_tiles_plan_at_a_windows_ingest():
    """One window's prompt ingest at large-v3-turbo (227 rows): the first
    half's 80 output tiles unsplit (one wave of 80 blocks: two splits would
    take two waves of the H100's 66 clusters of two), the second half's 20
    x 5 splits (100 blocks in one wave of the 22 clusters of five, two
    512-row tiles a split). Fewer than 132 blocks, and the plan says why:
    6 to 8 splits would still leave two tiles to a split and take a second
    wave (the card holds 17 clusters of six, 15 of seven or eight); 10
    splits (one tile each) pass the portable cluster of 8. K4's W4 logits
    fill the card unsplit."""
    plan = Q.ffn_int8_tiles_plan(227, 1280, 5120, 1280)
    assert (plan.up.splits, plan.up.blocks, plan.up.waves) == (1, 80, 1)
    assert Q.TilesPlan(227, 1280, 5120, 2).waves == 2
    assert (plan.down.splits, plan.down.blocks, plan.down.waves) == (5, 100, 1)
    assert plan.down.blocks < H100_SMS and "shortest walk" in plan.down.reason
    for splits in (6, 7, 8):
        more = Q.TilesPlan(227, 5120, 1280, splits, 8)
        assert more.waves == 2 and more.walk > plan.down.walk
    w4 = Q.tiles_plan(227, 1280, 51968, bits=4)
    assert (w4.splits, w4.blocks) == (1, 406 * 2)


@pytest.mark.parametrize("M", [17, 24, 40, 64])
def test_tiles_plan_at_one_row_tile(M):
    """Up to 128 rows (one row tile) K5's first half takes two splits (80
    blocks, the H100's 66 clusters of two hold them in one wave; three
    splits' 40 clusters of three pass the 39 it holds), its second half
    five (50 blocks, two 512-row tiles a split: 6-8 splits leave as many
    to their longest)."""
    plan = Q.ffn_int8_tiles_plan(M, 1280, 5120, 1280)
    assert (plan.up.splits, plan.up.blocks, plan.down.splits, plan.down.blocks) == (2, 80, 5, 50)
    assert Q.TilesPlan(M, 1280, 5120, 3).waves == 2
    assert {(b - a) // 512 for a, b in plan.down.split_rows()} == {2}
    assert all(Q.TilesPlan(M, 5120, 1280, s, 8).walk == plan.down.walk for s in (6, 7, 8))


def test_tiles_plan_counts_waves_in_the_cards_clusters():
    """The waves are the tiles over the clusters of that size the card holds
    (not the multiprocessors over the size): another card's counts give
    another plan."""
    h100 = Q.H100_TILES_CLUSTERS
    assert h100[0] == H100_SMS and all(a >= b for a, b in zip(h100, h100[1:]))
    assert Q.TilesPlan(40, 1280, 5120, 3).waves == 2          # 40 tiles, 39 clusters
    roomy = (132, 66, 44, 33, 26, 22, 18, 16)                  # 132 // size
    assert Q.TilesPlan(40, 1280, 5120, 3, clusters=roomy).waves == 1
    assert Q.tiles_plan(40, 1280, 5120, clusters=roomy).splits == 3
    assert Q.tiles_plan(40, 1280, 5120).splits == 2


@pytest.mark.parametrize("bits", [8, 4])
def test_tiles_smem_fits_the_h100(bits):
    """What a tiles block asks for (qmm_wgmma.cuh's Layout) fits the 227 KB
    a block can have, and the DSMEM combine's receive slots (a sender's
    share of 16 column chunks for each of 256 consumer threads, 16 bytes
    each) fit in the six x tiles it reuses, at every split count."""
    assert Q.tiles_smem(bits) <= 227 * 1024
    for splits in range(2, Q.TILES_MAX_SPLITS + 1):
        assert splits * 256 * -(-16 // splits) * 16 <= 6 * 128 * 64 * 2


def test_tiles_body_constants_are_the_kernels():
    """The planner's tile, steps, ring depths and cluster cap are csrc's,
    and K3's entry takes the body unsplit (its ingest build up to 64
    rows, the split-free build above)."""
    csrc = Path(Q.__file__).parents[1] / "csrc"
    body = (csrc / "qmm_wgmma.cuh").read_text()
    assert "constexpr int kBM = 128, kBN = 128, kBK = 64;" in body
    assert (Q.TILES_BM, Q.TILES_BK) == (128, 64)
    for ring, depth in (("kXStages", 6), ("kWStages", 6), ("kBStages", 3)):
        assert re.search(rf"constexpr int {ring} = {depth};", body)
    assert f"constexpr int kMaxSplits = {Q.TILES_MAX_SPLITS};" in body
    k3 = (csrc / "qmm.cu").read_text()
    for ingest in ("true", "false"):
        assert re.search(rf"launch_tiles<Int8Planes, StoreF32, kPdlNone, {ingest}>\(\s*"
                         r"x, qs, scales, ep, M, K, Np, 1, 1,", k3)
    assert not (csrc / "qmm_tile.cuh").exists()


@pytest.mark.parametrize("M", [0, 1, 16])
def test_tiles_plan_refuses_the_decode_rows(M):
    """The tiles plans take more than 16 rows; the rows body the rest."""
    with pytest.raises(ValueError, match="tiles body"):
        Q.tiles_plan(M, 1280, 51968, bits=4)
    with pytest.raises(ValueError, match="tiles body"):
        Q.ffn_int8_tiles_plan(M, 1280, 5120, 1280)


# K9's launches on the decode path: (B query rows, heads, live keys, shared
# batch-1 plane): greedy one row, beam 5 over one plane, eight lockstep
# streams, K9a's 1500 live keys of 1504-row slabs, at large-v3-turbo and
# the narrow models
K9_PLANS = [(B, H, n, shared) for H in (20, 2) for n in (1500, 1504)
            for B, shared in ((1, False), (5, True), (8, True), (8, False))]


@pytest.mark.parametrize("B,H,n_keys,shared", K9_PLANS)
def test_cross_q8_plan_clusters_the_live_keys(B, H, n_keys, shared):
    """At most 8 chunks (the portable cluster), each a multiple of 32 keys
    and at most 256, covering exactly the live keys in order with none
    empty; rows of a shared plane in one block (eight rows at most), a
    plane a row otherwise; what a block asks for fits the H100's 227 KB."""
    plan = XQ.cross_q8_plan(B, H, n_keys, shared)
    assert 1 <= plan.chunks <= XQ.K9_MAX_CLUSTER == 8
    assert plan.chunk % 32 == 0 and plan.chunk <= XQ.K9_MAX_CHUNK
    chunks = plan.key_chunks()
    assert len(chunks) == plan.chunks and chunks[0][0] == 0 and chunks[-1][1] == n_keys
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(stop > start for start, stop in chunks)
    assert (plan.rows, plan.groups) == ((B, 1) if shared and B > 1 else (1, B))
    assert plan.blocks == plan.chunks * H * plan.groups
    assert plan.smem <= 227 * 1024


def test_cross_q8_plan_at_turbo():
    """large-v3-turbo's 1500 audio positions: 8 chunks of 192 keys, the last
    156; 160 blocks at one row (at least the H100's 132 multiprocessors),
    160 for five beams over one plane (one block scores the five rows
    against each key it loads), 1280 for eight streams."""
    one = XQ.cross_q8_plan(1, 20, 1500, False)
    assert (one.chunks, one.chunk, one.key_chunks()[-1]) == (8, 192, (1344, 1500))
    assert one.blocks == 160 >= H100_SMS
    beams = XQ.cross_q8_plan(5, 20, 1500, True)
    assert (beams.rows, beams.groups, beams.blocks) == (5, 1, 160)
    assert XQ.cross_q8_plan(8, 20, 1500, False).blocks == 1280
    assert XQ.cross_q8_plan(1, 20, 1504, False).key_chunks()[-1] == (1344, 1504)


@pytest.mark.parametrize("n_keys,chunks,chunk,last", [
    (225, 8, 32, 1), (1350, 8, 192, 6), (100, 4, 32, 4), (33, 2, 32, 1), (32, 1, 32, 32),
    (1, 1, 32, 1), (2048, 8, 256, 256)])
def test_cross_q8_plan_short_last_chunks(n_keys, chunks, chunk, last):
    """Key counts whose last chunk holds fewer than 32 live keys, or one:
    the kernel reads only the live ones."""
    plan = XQ.cross_q8_plan(1, 20, n_keys, False)
    assert (plan.chunks, plan.chunk) == (chunks, chunk)
    start, stop = plan.key_chunks()[-1]
    assert stop - start == last


@pytest.mark.parametrize("B,rows,groups", [(2, 2, 1), (8, 8, 1), (9, 5, 2), (12, 6, 2),
                                           (17, 6, 3)])
def test_cross_q8_plan_row_groups_of_a_shared_plane(B, rows, groups):
    """More rows than a block takes over one shared plane: as few groups of
    at most 8 rows as hold them, evenly."""
    plan = XQ.cross_q8_plan(B, 20, 1500, True)
    assert (plan.rows, plan.groups) == (rows, groups)
    assert plan.rows <= XQ.K9_MAX_ROWS and (plan.groups - 1) * plan.rows < B


def test_cross_q8_plan_rejects_what_no_cluster_holds():
    XQ.cross_q8_plan(1, 20, 2048, False)
    with pytest.raises(ValueError, match="at most 2048"):
        XQ.cross_q8_plan(1, 20, 2049, False)


def test_cross_q8_plan_constants_are_the_kernels():
    """The planner's limits and shared-memory layout are csrc/cross_q8.cu's."""
    src = (Path(XQ.__file__).parents[1] / "csrc" / "cross_q8.cu").read_text()
    for name, value in (("kMaxChunk", XQ.K9_MAX_CHUNK), ("kMaxCluster", XQ.K9_MAX_CLUSTER),
                        ("kMaxRows", XQ.K9_MAX_ROWS), ("kThreads", 32 * XQ._K9_WARPS),
                        ("kQLd", XQ._K9_Q_LD)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name
