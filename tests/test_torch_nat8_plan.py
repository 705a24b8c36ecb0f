"""The launch plan of the nat8 W8A16 kernel (csrc/nat8_gemm.cu):
`qmm.nat8_plan` picks the route and how far K is cut across blocks. A plain
function, so it is checked here on the CPU; the kernel itself is held to
its plain version, at every split, in tests/test_torch_cuda.py."""
import pytest
import torch

from ggml_imax_tpu_torch.ops import qmm

SMS = 132
MAX_SPLIT = 8           # the split blocks of a tile form one cluster
TILE_MAX_SPLIT = 5      # one tile block fills an SM: larger clusters wait
TILE_SUM_STEPS = 4      # a cluster's sum of its partial tiles, in K steps
# GPT-2 1558M (XL): fc_w (the one nat8 product on its kernel path), then
# attn_w, proj_w and out_w; GPT-2 117M: attn_w, proj_w, fc_w, out_w
GPT2_XL = [(1600, 6400), (1600, 4800), (1600, 1600), (6400, 1600)]
GPT2_117M = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
OTHER = [(1568, 200), (1568, 640), (3072, 6400), (96, 128), (20480, 256)]


def grid_blocks(route, m, n):
    """128 columns a block on the small-M route, 128 x 256 tiles above."""
    if route == "small":
        return -(-n // 128)
    return -(-n // 256) * -(-m // 128)


def k_units(route, k):
    """The pieces of K a split deals out: 32 rows (one per-32 group or two
    per-16 ones) on the small-M route, steps of 64 rows on the tile."""
    return k // 32 if route == "small" else -(-k // 64)


def divisors(units, most):
    return [s for s in range(1, min(units, most) + 1) if units % s == 0]


def tile_cost(blocks, units, s):
    """Waves of one block an SM, times a block's steps and its sum."""
    return -(-blocks * s // SMS) * (units // s + (TILE_SUM_STEPS if s > 1
                                                  else 0))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 128, 512, 600])
def test_route_is_small_up_to_m8(m):
    route, _ = qmm.nat8_plan(m, 1600, 6400)
    assert route == ("small" if m <= 8 else "tile")


@pytest.mark.parametrize("k,n", GPT2_XL + GPT2_117M + OTHER)
@pytest.mark.parametrize("m", [1, 5, 8, 9, 128, 512, 600])
def test_every_split_divides_k_and_fits_a_cluster(k, n, m):
    route, split = qmm.nat8_plan(m, k, n)
    units = k_units(route, k)
    assert 1 <= split <= MAX_SPLIT and units % split == 0
    if route == "tile":
        assert split <= TILE_MAX_SPLIT


@pytest.mark.parametrize("m", [2, 5, 8])
def test_gpt2_xl_small_m_takes_one_wave(m):
    """A prompt of at most 8 tokens (the Engine's bucket of 8) runs fc_w's
    50 column blocks in 2 K pieces: 100 blocks, one wave of one block an SM
    (5 pieces, 250 blocks, would take two)."""
    route, split = qmm.nat8_plan(m, 1600, 6400)
    assert (route, split) == ("small", 2)
    assert grid_blocks(route, m, 6400) * split <= SMS
    assert grid_blocks(route, m, 6400) * 5 > SMS


@pytest.mark.parametrize("k,n", GPT2_XL + GPT2_117M + OTHER)
@pytest.mark.parametrize("m", [1, 4, 8])
def test_small_split_is_the_most_that_fits_one_wave(k, n, m):
    route, split = qmm.nat8_plan(m, k, n)
    blocks, units = grid_blocks(route, m, n), k_units(route, k)
    assert route == "small"
    if blocks >= SMS:               # the column blocks fill the card alone
        assert split == 1
        return
    assert blocks * split <= SMS
    larger = [s for s in divisors(units, MAX_SPLIT) if s > split]
    assert all(blocks * s > SMS for s in larger)


@pytest.mark.parametrize("k,n", GPT2_XL + GPT2_117M + OTHER)
@pytest.mark.parametrize("m", [9, 100, 128, 512])
def test_tile_split_has_the_fewest_waves_times_steps(k, n, m):
    route, split = qmm.nat8_plan(m, k, n)
    blocks, units = grid_blocks(route, m, n), k_units(route, k)
    assert route == "tile"
    costs = {s: tile_cost(blocks, units, s)
             for s in divisors(units, TILE_MAX_SPLIT)}
    assert costs[split] == min(costs.values())
    assert all(costs[s] > costs[split] for s in costs if s < split)


def test_gpt2_plans():
    """What the kernel runs at GPT-2's shapes: XL's fc_w has 25 K steps and
    25 tiles at M 128 (one wave of 125 blocks in 5 pieces), 100 at M 512
    (one wave unsplit: 5 pieces would be 4 waves), and 50 column blocks at
    M 8 (2 pieces of 25 rows of 32); GPT-2 117M's fc_w at
    M 512 has 48 tiles of 12 steps (2 pieces: one wave of 96 blocks) and
    its out_w 12 tiles of 48 steps (4 pieces of 12, one wave)."""
    plan = qmm.nat8_plan
    assert plan(512, 1600, 6400) == ("tile", 1)
    assert plan(128, 1600, 6400) == ("tile", 5)
    assert plan(8, 1600, 6400) == ("small", 2)
    assert plan(512, 768, 3072) == ("tile", 2)
    assert plan(512, 3072, 768) == ("tile", 4)


def test_ragged_k_takes_odd_pieces():
    # K 1568: 49 pieces of 32 rows (1 or 7) on the small-M route, 25 steps
    # of 64 (the last half full) on the tile
    assert qmm.nat8_plan(5, 1568, 640) == ("small", 7)
    assert qmm.nat8_plan(100, 1568, 640) == ("tile", 5)


def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper takes the plain version, never plans a
    launch and counts none."""
    def no_plan(*a):
        raise AssertionError("planned a launch for a CPU tensor")
    monkeypatch.setattr(qmm, "nat8_plan", no_plan)
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (512, 200), dtype=torch.int8, generator=g)
    s = torch.rand((32, 200), generator=g) * 0.01
    b = torch.rand((32, 200), generator=g) * 0.01
    qt = QTensor("int8", q, s, b, 512, 200, GGMLType.Q8_0,
                 interleaved_bk=512, q4_layout=4)
    before = dict(qmm._build.LAUNCHES)
    for m in (2, 9):
        x = torch.randn(m, 512, generator=g)
        out = qmm.nat8_w8a16_gemm(x, qt)
        assert torch.equal(out, qmm.nat8_w8a16_gemm_plain(x, qt))
    assert qmm._build.LAUNCHES == before
