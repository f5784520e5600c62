"""The launch plans of the port's redesigned Hopper kernels, on the CPU.

K3's rows route (ops/quant_matmul.py::qmm_rows_plan, csrc/qmm_rows.cuh)
and T1 (ops/gemm.py::mm_bf16_plan, csrc/mm_bf16.cu) size their launches in
Python: how many splits of K, which K rows each takes, how much shared
memory a block holds for x's rows and for the other splits' partial sums,
T1's tile, its clusters and how many rounds of tile pairs the busiest one
walks. The kernels themselves run only on the card (tests/test_torch_cuda.py);
these are the numbers they are launched with, checked here at the shapes
large-v3-turbo gives them.
"""

import pytest

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
