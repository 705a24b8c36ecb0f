"""Log-mel spectrogram, the Whisper audio frontend (counterpart of
ggml_imax_tpu/audio/mel.py).

Periodic Hann window, 400-point FFT, hop 160, power spectrum times the mel
filterbank, log10 clamped at 1e-10, the dynamic range clamped to the
spectrogram's max - 8 (the max over the whole padded spectrogram, its zero
tail included), then (x + 4) / 4. The audio gets a 200-sample reflection
on the left, 30 s of zeros and 200 zeros on the right, and the last frame
is dropped. Frames, an f32 `torch.fft.rfft` and the filterbank product
run on the samples' device.

`mel_filterbank` regenerates the Slaney-style bank that Whisper
checkpoints ship (librosa.filters.mel(sr=16000, n_fft=400, n_mels=80)), in
numpy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MEL = 80
CHUNK_LENGTH = 30                      # seconds
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH


def _hz_to_mel(f):
    # Slaney scale (librosa default, htk=False)
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_branch = min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, mels)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(n_mel: int = N_MEL, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """(n_mel, n_fft//2 + 1) Slaney-normalized triangular filter bank."""
    fmax = sr / 2.0
    fft_freqs = np.linspace(0, fmax, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(fmax), n_mel + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mel + 2] - hz_pts[:n_mel])
    return (weights * enorm[:, None]).astype(np.float32)


def log_mel_spectrogram(samples, filters: np.ndarray | None = None, *,
                        n_fft: int = N_FFT, hop: int = HOP_LENGTH,
                        pad_to_chunk: bool = True,
                        device=None) -> torch.Tensor:
    """samples: float32 mono 16 kHz (numpy or a tensor) -> (n_mel, T) f32
    normalized log-mel on `device` (the card unless "cpu"). With
    pad_to_chunk T covers the 30 s zero tail too; slice [:, :3000] for one
    30 s encoder window."""
    dev = resolve_device(device)
    if filters is None:
        filters = mel_filterbank(n_fft=n_fft)
    if not isinstance(samples, torch.Tensor):
        samples = torch.from_numpy(np.ascontiguousarray(samples, np.float32))
    x = samples.to(dev, torch.float32)
    fb = torch.as_tensor(np.asarray(filters, np.float32)).to(dev)
    half = n_fft // 2
    left = x[1:half + 1].flip(0)
    tail = torch.zeros((N_SAMPLES if pad_to_chunk else 0) + half,
                       dtype=torch.float32, device=dev)
    x = torch.cat([left, x, tail])
    n_frames = (x.shape[0] - n_fft) // hop       # the last frame dropped
    frames = x.unfold(0, n_fft, hop)[:n_frames]  # (T, n_fft)
    window = 0.5 * (1.0 - torch.cos(
        2.0 * math.pi * torch.arange(n_fft, dtype=torch.float32, device=dev)
        / n_fft))
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ fb.T                           # (T, n_mel)
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    logmel = torch.maximum(logmel, logmel.max() - 8.0)
    return ((logmel + 4.0) / 4.0).T.contiguous()
