"""1-D convolution (counterpart of ggml_imax_tpu/ops/conv.py `conv_1d`,
ggml_conv_1d): Whisper's two-layer conv frontend. The reference computes
it in f32 (lax.conv_general_dilated on f32 casts); no Pallas kernel
computes a convolution, so this is `F.conv1d`. The rest of that module
(conv_2d, the transposed convolutions, pooling, im2col) is not ported
yet."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _cudnn_without_tf32():
    """cuDNN may run an f32 convolution in TF32 (10-bit mantissas) while
    torch.backends.cudnn.allow_tf32 is True, its default. This sets the
    flag to False for the block only and puts the caller's value back
    after it, so the convolution is f32 as the reference's is and no
    global setting outlives the call."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def conv_1d(x, w, s0: int = 1, p0: int = 0, d0: int = 1):
    """x: (N, Cin, W), w: (Cout, Cin, K) -> (N, Cout, OW) f32."""
    with _cudnn_without_tf32():
        return F.conv1d(x.float(), w.float(), stride=s0, padding=p0,
                        dilation=d0)
