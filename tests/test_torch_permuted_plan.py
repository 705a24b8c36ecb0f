"""The launch plan of the permuted-layout kernels (csrc/permuted_gemm.cu):
`qmm.permuted_plan` picks the route and how far K is cut across blocks. A
plain function, so it is checked here on the CPU; the kernels themselves
are held to their plain versions in tests/test_torch_cuda.py."""
import pytest
import torch

from ggml_imax_tpu_torch.ops import qmm

SMS = 132
MAX_SPLIT = 8           # the split blocks of a tile form one cluster
LAYOUTS = [("planes", 16), ("planes", 32), ("rowpair", 32), ("int8", 16),
           ("int8", 32)]
# chip_smoke phase 2: GPT-2 117M's attn_w and out_w, and the sizing shape
SHAPES = [(768, 2304, 256), (3072, 768, 512), (4096, 16384, 512)]


def grid_blocks(route, m, n):
    cols = -(-n // 64)
    return cols if route == "gemv" else cols * -(-m // 128)


def k_units(route, layout, k, bk, g):
    return qmm.permuted_units(layout, k, bk, g) if route == "gemv" \
        else -(-k // 64)


def most_pieces(units):
    return max(s for s in range(1, MAX_SPLIT + 1) if units % s == 0)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 7, 8, 9, 16, 64, 512, 600])
def test_route_is_gemv_up_to_m8(m):
    route, _ = qmm.permuted_plan("planes", m, 3072, 768, 512, 16)
    assert route == ("gemv" if m <= 8 else "tile")


@pytest.mark.parametrize("layout,g", LAYOUTS)
@pytest.mark.parametrize("k,n,bk", SHAPES)
@pytest.mark.parametrize("m", [1, 8, 512])
def test_phase2_shapes_fill_the_card(layout, g, k, n, bk, m):
    """At least a block per SM wherever K has the pieces for it (at most 8
    to a tile); each piece of K equal."""
    route, split = qmm.permuted_plan(layout, m, k, n, bk, g)
    blocks, units = grid_blocks(route, m, n), k_units(route, layout, k, bk, g)
    assert 1 <= split <= min(units, MAX_SPLIT) and units % split == 0
    assert blocks * split >= min(SMS, blocks * most_pieces(units))
    if blocks >= SMS:
        assert split == 1


@pytest.mark.parametrize("layout,g", LAYOUTS)
@pytest.mark.parametrize("m", [1, 4, 8, 9, 512])
def test_split_is_the_least_that_fills_the_card(layout, g, m):
    k, n, bk = 3072, 768, 512
    route, split = qmm.permuted_plan(layout, m, k, n, bk, g)
    blocks, units = grid_blocks(route, m, n), k_units(route, layout, k, bk, g)
    smaller = [s for s in range(1, split) if units % s == 0]
    assert all(blocks * s < SMS for s in smaller)


@pytest.mark.parametrize("m,n", [(1, 16384), (8, 8448), (512, 2304),
                                 (600, 4096)])
def test_no_split_where_the_grid_fills_the_card(m, n):
    for layout, g in LAYOUTS:
        assert qmm.permuted_plan(layout, m, 4096, n, 512, g)[1] == 1


def test_split_stops_at_a_cluster_of_8():
    # one column block and 512 quant blocks of K: 8 pieces, not 132
    assert qmm.permuted_plan("planes", 1, 16384, 64, 512, 16) == ("gemv", 8)
    # 96 K pieces, 2 column blocks: 66 would be needed, 8 is the most
    assert qmm.permuted_plan("int8", 1, 1536, 128, 512, 16) == ("gemv", 8)
    # 24 pieces (row-pair pairs): 8 divides them
    assert qmm.permuted_plan("rowpair", 1, 1536, 128, 512, 32) == ("gemv", 8)
    # GPT-2 117M's out_w: 12 column blocks, 96 quant blocks, 8 pieces
    assert qmm.permuted_plan("planes", 1, 3072, 768, 512, 16) == ("gemv", 8)


def test_short_k_takes_every_piece():
    # 2 column blocks and K of 4 quant blocks: every piece its own block
    route, split = qmm.permuted_plan("planes", 1, 128, 128, 128, 16)
    assert (route, split) == ("gemv", 4)
    # K 96 at the tile route: ceil(96 / 64) = 2 steps
    assert qmm.permuted_plan("int8", 64, 96, 64, 96, 16) == ("tile", 2)


@pytest.mark.parametrize("layout,bk,g,units", [
    ("planes", 512, 16, 96), ("planes", 96, 32, 96),
    ("rowpair", 512, 32, 48), ("rowpair", 256, 32, 48),
    ("rowpair", 96, 32, 96), ("rowpair", 32, 32, 96),
    ("int8", 512, 16, 192), ("int8", 512, 32, 96)])
def test_units_follow_the_stored_layout(layout, bk, g, units):
    """Row-pair pairs two quant blocks only when NB = bk / 32 is even."""
    assert qmm.permuted_units(layout, 3072, bk, g) == units


def test_cpu_wrappers_run_the_plain_versions(monkeypatch):
    """On a CPU tensor the wrappers take the plain version and never plan a
    launch."""
    def no_plan(*a):
        raise AssertionError("planned a launch for a CPU tensor")
    monkeypatch.setattr(qmm, "permuted_plan", no_plan)
    g = torch.Generator().manual_seed(0)
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    q = torch.randint(-127, 128, (512, 64), dtype=torch.int8, generator=g)
    s = torch.rand((32, 64), generator=g) * 0.01
    qt = QTensor("int8", q, s, None, 512, 64, GGMLType.Q8_0,
                 interleaved_bk=256, q4_layout=2)
    x = torch.randn(3, 512, generator=g)
    before = dict(qmm._build.LAUNCHES)
    out = qmm.int8_rows_w8a16(x, qt)
    assert torch.equal(out, qmm.int8_rows_w8a16_plain(x, qt))
    assert qmm._build.LAUNCHES == before
