"""The launch plan of the W4A8 GEMV (csrc/w4a8_gemv.cu): `qmm.w4a8_plan`
says how far K is cut across the blocks of a thread-block cluster. A plain
function, so it is checked here on the CPU; the kernel itself is held to
its plain version, at every split, in tests/test_torch_cuda.py."""
import pytest
import torch

from ggml_imax_tpu_torch.ops import qmm

SMS = 132
COLS = 128              # a block's columns
MAX_SPLIT = 8           # the split blocks of a column block form one cluster
# GPT-J-6B's decode GEMVs (chip_smoke phase 2): qkvf_w, of_w, the padded LM
# head
GPTJ = [(4096, 28672), (20480, 4096), (4096, 51200)]
OTHER = [(2048, 1280), (20480, 512), (20480, 256), (96, 128), (1056, 384),
         (32, 128), (1600, 6400)]


def pieces(k, split):
    """The quant blocks each rank takes: [y U / split, (y + 1) U / split)
    of U = K / 32, as the kernel's u0 and u1 say."""
    u = k // 32
    return [range(y * u // split, (y + 1) * u // split) for y in range(split)]


@pytest.mark.parametrize("k,n", GPTJ + OTHER)
def test_split_divides_k_and_fits_a_cluster(k, n):
    split = qmm.w4a8_plan(k, n)
    assert 1 <= split <= MAX_SPLIT and (k // 32) % split == 0


@pytest.mark.parametrize("k,n", GPTJ + OTHER)
def test_split_is_the_least_that_fills_the_card(k, n):
    split, blocks, units = qmm.w4a8_plan(k, n), n // COLS, k // 32
    smaller = [s for s in range(1, split) if units % s == 0]
    assert all(blocks * s < SMS for s in smaller)
    if blocks * split < SMS:        # could not fill it: the most a cluster takes
        assert split == max(s for s in range(1, MAX_SPLIT + 1)
                            if units % s == 0)


@pytest.mark.parametrize("n", [132 * COLS, 224 * COLS, 400 * COLS])
def test_column_blocks_that_fill_the_card_run_unsplit(n):
    assert qmm.w4a8_plan(20480, n) == 1


def test_gptj_plans():
    """of_w's 32 column blocks need 5 pieces (160 blocks); qkvf_w's 224 and
    the LM head's 400 column blocks fill the card unsplit."""
    assert qmm.w4a8_plan(20480, 4096) == 5
    assert qmm.w4a8_plan(4096, 28672) == 1
    assert qmm.w4a8_plan(4096, 51200) == 1


def test_long_k_narrow_n():
    # 4 column blocks, 640 quant blocks: 8 pieces, the most a cluster takes
    assert qmm.w4a8_plan(20480, 512) == 8
    # 3 and 33 quant blocks: 3 pieces of one, 3 of 11
    assert qmm.w4a8_plan(96, 128) == 3
    assert qmm.w4a8_plan(1056, 384) == 3


@pytest.mark.parametrize("k", [32, 96, 1056, 4096, 20480])
@pytest.mark.parametrize("n", [128, 4096, 51200])
def test_pieces_cover_k_once(k, n):
    split = qmm.w4a8_plan(k, n)
    got = [u for r in pieces(k, split) for u in r]
    assert got == list(range(k // 32))
    assert all(len(r) > 0 for r in pieces(k, split))


def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper takes the plain version, never plans a
    launch and counts none."""
    def no_plan(*a):
        raise AssertionError("planned a launch for a CPU tensor")
    monkeypatch.setattr(qmm, "w4a8_plan", no_plan)
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    g = torch.Generator().manual_seed(0)
    q = torch.randint(0, 256, (256, 128), dtype=torch.uint8, generator=g)
    s = torch.rand((16, 128), generator=g) * 0.01
    qt = QTensor("nib4", q, s, None, 512, 128, GGMLType.Q4_0, zero=8,
                 interleaved_bk=512, q4_layout=3)
    x8, dx = qmm.quantize_activations_q8(torch.randn(1, 512, generator=g))
    before = dict(qmm._build.LAUNCHES)
    out = qmm.w4a8_gemv(x8[:, 0], dx[:, 0], qt)
    assert torch.equal(out, qmm.w4a8_gemv_plain(x8[:, 0], dx[:, 0], qt))
    assert qmm._build.LAUNCHES == before


def test_a_bias_needs_its_block_sums():
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    q = torch.zeros((16, 128), dtype=torch.uint8)
    s = torch.ones((1, 128))
    qt = QTensor("nib4", q, s, s.clone(), 32, 128, GGMLType.Q4_1, zero=8,
                 interleaved_bk=32, q4_layout=3)
    with pytest.raises(ValueError, match="xs"):
        qmm.w4a8_gemv(torch.zeros(1, 32, dtype=torch.int8), torch.ones(1), qt)
