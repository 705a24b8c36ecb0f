"""The launch plan of the natpair W4A16 kernel (csrc/w4a16_gemm.cu):
`qmm.natpair_plan` picks the route and how far K is cut across blocks. A
plain function, so it is checked here on the CPU; the kernel itself is held
to its plain version, at every split, in tests/test_torch_cuda.py."""
import pytest
import torch

from ggml_imax_tpu_torch.ops import qmm

SMS = 132
MAX_SPLIT = 8           # the split blocks of a tile form one cluster
TILE_MAX_SPLIT = 5      # one tile block fills an SM: larger clusters wait
TILE_SUM_STEPS = 4      # a cluster's sum of its partial tiles, in K steps
# GPT-J-6B's products (chip_smoke phase 2): qkvf_w, of_w, the padded LM head
GPTJ = [(4096, 28672), (20480, 4096), (4096, 51200)]
OTHER = [(1024, 640), (20480, 256), (4096, 4096), (96, 128), (1056, 384)]


def grid_blocks(route, m, n):
    """128 columns a block on the small-M route, 128 x 256 tiles above."""
    if route == "small":
        return -(-n // 128)
    return -(-n // 256) * -(-m // 128)


def k_units(route, k):
    return k // 32 if route == "small" else -(-k // 64)


def divisors(units, most):
    return [s for s in range(1, min(units, most) + 1) if units % s == 0]


def tile_cost(blocks, units, s):
    """Waves of one block an SM, times a block's steps and its sum."""
    return -(-blocks * s // SMS) * (units // s + (TILE_SUM_STEPS if s > 1
                                                  else 0))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 128, 512, 600])
def test_route_is_small_up_to_m8(m):
    route, _ = qmm.natpair_plan(m, 20480, 4096)
    assert route == ("small" if m <= 8 else "tile")


@pytest.mark.parametrize("k,n", GPTJ)
@pytest.mark.parametrize("m", [1, 5, 8, 9, 128, 512, 600])
def test_every_split_divides_k_and_fits_a_cluster(k, n, m):
    route, split = qmm.natpair_plan(m, k, n)
    units = k_units(route, k)
    assert 1 <= split <= MAX_SPLIT and units % split == 0
    if route == "tile":
        assert split <= TILE_MAX_SPLIT


@pytest.mark.parametrize("k,n", GPTJ)
def test_gptj_small_m_fills_the_card(k, n):
    """At M 8 every GPT-J product runs at least a block per SM."""
    route, split = qmm.natpair_plan(8, k, n)
    assert route == "small" and grid_blocks(route, 8, n) * split >= SMS


@pytest.mark.parametrize("k,n", GPTJ + OTHER)
@pytest.mark.parametrize("m", [1, 4, 8])
def test_small_split_is_the_least_that_fills_the_card(k, n, m):
    route, split = qmm.natpair_plan(m, k, n)
    blocks, units = grid_blocks(route, m, n), k_units(route, k)
    assert route == "small"
    smaller = [s for s in range(1, split) if units % s == 0]
    assert all(blocks * s < SMS for s in smaller)
    if blocks * split < SMS:        # could not fill it: the most a cluster takes
        assert split == max(divisors(units, MAX_SPLIT))


@pytest.mark.parametrize("k,n", GPTJ + OTHER)
@pytest.mark.parametrize("m", [9, 100, 128, 512])
def test_tile_split_has_the_fewest_waves_times_steps(k, n, m):
    route, split = qmm.natpair_plan(m, k, n)
    blocks, units = grid_blocks(route, m, n), k_units(route, k)
    assert route == "tile"
    costs = {s: tile_cost(blocks, units, s)
             for s in divisors(units, TILE_MAX_SPLIT)}
    assert costs[split] == min(costs.values())
    assert all(costs[s] > costs[split] for s in costs if s < split)


def test_gptj_plans():
    """What the kernel runs at GPT-J-6B's shapes: of_w's 32 column blocks
    need 5 K pieces at M 8 (160 blocks); its 16 tiles 5 at M 128 (one wave
    of 80 blocks, 64 steps each) and its 64 tiles 2 at M 512 (one wave of
    128); qkvf_w's 448 tiles at M 512 take 2 (7 waves of 32 steps, not 4 of
    64); the rest run unsplit."""
    plan = qmm.natpair_plan
    assert plan(8, 20480, 4096) == ("small", 5)
    assert plan(128, 20480, 4096) == ("tile", 5)
    assert plan(512, 20480, 4096) == ("tile", 2)
    assert plan(512, 4096, 28672) == ("tile", 2)
    for m in (8, 128):
        assert plan(m, 4096, 28672)[1] == 1
    for m in (8, 128, 512):
        assert plan(m, 4096, 51200)[1] == 1


def test_long_k_narrow_n_takes_a_whole_cluster():
    # 2 column blocks, 640 quant blocks: 8 pieces, not 66
    assert qmm.natpair_plan(8, 20480, 256) == ("small", 8)
    # one tile of 320 steps: 5 pieces of 64
    assert qmm.natpair_plan(64, 20480, 256) == ("tile", 5)
    # 3 K steps of 64: too few to pay for a cluster's sum
    assert qmm.natpair_plan(64, 192, 128) == ("tile", 1)


def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper takes the plain version and never plans a
    launch."""
    def no_plan(*a):
        raise AssertionError("planned a launch for a CPU tensor")
    monkeypatch.setattr(qmm, "natpair_plan", no_plan)
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    g = torch.Generator().manual_seed(0)
    q = torch.randint(0, 256, (256, 128), dtype=torch.uint8, generator=g)
    s = torch.rand((16, 128), generator=g) * 0.01
    qt = QTensor("nib4", q, s, None, 512, 128, GGMLType.Q4_0, zero=8,
                 interleaved_bk=512, q4_layout=3)
    x = torch.randn(5, 512, generator=g)
    before = dict(qmm._build.LAUNCHES)
    out = qmm.w4a16_gemm(x, qt)
    assert torch.equal(out, qmm.w4a16_gemm_plain(x, qt))
    assert qmm._build.LAUNCHES == before
