"""Port parity: the Whisper audio frontend (audio/wav.py, audio/mel.py)
and ops/conv.conv_1d against the JAX package's, on the host.

write_wav's bytes, read_wav and vad_simple equal; mel_filterbank bit-equal;
log_mel_spectrogram within atol 1e-4 of the JAX one (both f32 FFTs,
summed in other orders; values of ~1); conv_1d at (k 3, s 1, p 1) and
(k 3, s 2, p 1), Whisper's two convolutions, within 1e-5 of the largest
|output|.
"""
import numpy as np
import pytest
import torch

from ggml_imax_tpu.audio import mel as jmel
from ggml_imax_tpu.audio import wav as jwav
from ggml_imax_tpu.ops import conv as jconv
from ggml_imax_tpu_torch.audio import mel as tmel
from ggml_imax_tpu_torch.audio import wav as twav
from ggml_imax_tpu_torch.ops import conv as tconv


def _tone_signal(seconds=2.5):
    """Two tones and a chirp, deterministic."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 880 * t)
            + 0.1 * np.sin(2 * np.pi * (200 + 300 * t) * t)).astype(np.float32)


def test_constants_equal():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "N_MEL",
                 "CHUNK_LENGTH", "N_SAMPLES"):
        assert getattr(tmel, name) == getattr(jmel, name), name
    assert twav.SAMPLE_RATE == jwav.SAMPLE_RATE


@pytest.mark.parametrize("stereo", [False, True])
def test_wav_bytes_and_reads_equal(tmp_path, stereo):
    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal(16000) * 0.4).astype(np.float32)  # clips too
    a, b = tmp_path / "jax.wav", tmp_path / "port.wav"
    jwav.write_wav(a, pcm)
    twav.write_wav(b, pcm)
    assert a.read_bytes() == b.read_bytes()
    if stereo:                      # a 2-channel file, written by hand
        import wave
        inter = (np.clip(rng.standard_normal((8000, 2)) * 0.3, -1, 1)
                 * 32767).astype(np.int16)
        with wave.open(str(b), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(inter.tobytes())
    got, ref = twav.read_wav(b), jwav.read_wav(b)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_read_wav_refuses_other_rates(tmp_path):
    p = tmp_path / "t.wav"
    twav.write_wav(p, np.zeros(100, np.float32), rate=8000)
    with pytest.raises(ValueError, match="16000"):
        twav.read_wav(p)


@pytest.mark.parametrize("freq_thold", [0.0, 100.0])
@pytest.mark.parametrize("tail", [0, 8000, 32000])
def test_vad_simple_equal(freq_thold, tail):
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal(12000) * 0.2).astype(np.float32)
    sig = np.concatenate([pcm, rng.standard_normal(tail).astype(np.float32)
                          * 0.01])
    for last_ms in (500, 1000, 2000):
        got = twav.vad_simple(sig, last_ms=last_ms, freq_thold=freq_thold)
        assert got == jwav.vad_simple(sig, last_ms=last_ms,
                                      freq_thold=freq_thold)


@pytest.mark.parametrize("n_mel", [16, 80])
def test_mel_filterbank_bit_equal(n_mel):
    got = tmel.mel_filterbank(n_mel)
    ref = jmel.mel_filterbank(n_mel)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["tone", "noise", "short_tone_80",
                                  "unpadded"])
def test_log_mel_spectrogram_matches_jax(case):
    rng = np.random.default_rng(5)
    filters, pad = None, True
    if case == "noise":
        samples = (rng.standard_normal(40000) * 0.1).astype(np.float32)
        filters = jmel.mel_filterbank(16)
    elif case == "short_tone_80":
        samples = _tone_signal(0.7)
    elif case == "unpadded":
        samples, pad = _tone_signal(1.3), False
    else:
        samples = _tone_signal()
    ref = np.asarray(jmel.log_mel_spectrogram(samples, filters,
                                              pad_to_chunk=pad))
    got = tmel.log_mel_spectrogram(samples, filters, pad_to_chunk=pad,
                                   device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # a torch tensor takes the same path
    again = tmel.log_mel_spectrogram(torch.from_numpy(samples), filters,
                                     pad_to_chunk=pad, device="cpu")
    assert torch.equal(again, got)


def test_log_mel_clamps_to_the_max_over_the_padded_spectrogram():
    """The dynamic-range clamp reads the max over every frame, the zero
    tail's included: a loud clip's tail frames sit at max - 8."""
    got = tmel.log_mel_spectrogram(_tone_signal(), device="cpu").numpy()
    assert got.shape[1] == (2 * 200 + 40000 + tmel.N_SAMPLES - 400) // 160
    np.testing.assert_allclose(got[:, -1], (got.max() * 4 - 4 - 8 + 4) / 4,
                               atol=1e-6)


@pytest.mark.parametrize("stride,cin,cout,width", [(1, 16, 32, 64),
                                                   (2, 32, 32, 64),
                                                   (1, 80, 96, 37),
                                                   (2, 96, 96, 37)])
def test_conv_1d_matches_jax(stride, cin, cout, width):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, cin, width)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3)) * 0.1).astype(np.float32)
    ref = np.asarray(jconv.conv_1d(x, w, stride, 1))
    got = tconv.conv_1d(torch.from_numpy(x), torch.from_numpy(w), stride, 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # rtol 1e-5 of the output's scale: the two libraries sum the 3 Cin
    # products in other orders, so an element near 0 alone can differ by
    # more than 1e-5 of itself (seen: 1.3e-6 at an element of 3e-3)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


def test_conv_1d_leaves_the_tf32_flag_as_it_found_it():
    for flag in (True, False):
        torch.backends.cudnn.allow_tf32 = flag
        tconv.conv_1d(torch.ones(1, 2, 8), torch.ones(3, 2, 3), 1, 1)
        assert torch.backends.cudnn.allow_tf32 is flag
    torch.backends.cudnn.allow_tf32 = True


def test_mel_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmel.log_mel_spectrogram(_tone_signal(0.5))
