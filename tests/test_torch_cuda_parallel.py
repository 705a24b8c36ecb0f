"""Tensor parallelism on the card (marker ``cuda``; skips without an
NVIDIA GPU): two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
device) run forward_tp with the kernels at their local shapes, held to the
single-device forward on the card. Run on a machine with one card:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda -q
"""
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as R
from ggml_imax_tpu_torch import _build
from ggml_imax_tpu_torch.parallel import distributed as D

pytestmark = pytest.mark.cuda

# head_dim 256 (the decode kernel's route), one head a rank at tp 2, every
# local product N % 128 == 0 (the kernels' gate)
CFG = dict(n_vocab=1024, n_ctx=64, n_embd=512, n_head=2, n_layer=2, n_rot=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    try:
        _build._nvcc()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build the CUDA kernels: {e}")
    _build.lib()                     # built once here, loaded by the ranks


def test_gptj_tp_on_the_card_matches_single_device(card, tmp_path):
    prompt, feed = np.arange(3, 19), np.array([7, 99, 500])
    res = D.spawn(R.card_tp, 2, (CFG, prompt, feed), rendezvous_dir=tmp_path,
                  timeout=300, backend="gloo", device="cuda:0")
    ref = res[0][1]
    for got, _, launches, route in res:
        assert route == "host"
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)
        L = CFG["n_layer"]
        assert launches["w4a16_gemm"] == 2 * L + 1
        assert launches["flash_attention"] == L
        assert launches["w4a8_gemv"] == len(feed) * (2 * L + 1)
        assert launches["decode_attention"] == len(feed) * L
