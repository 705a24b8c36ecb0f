"""WAV audio I/O and a simple energy VAD (counterpart of
ggml_imax_tpu/audio/wav.py): 16-bit PCM (or 8-bit) mono/stereo at 16 kHz,
stereo averaged to mono. The standard library's `wave` and numpy only."""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16000  # WHISPER_SAMPLE_RATE


def read_wav(path: str | Path, expect_rate: int = SAMPLE_RATE) -> np.ndarray:
    """-> float32 mono samples in [-1, 1]."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        if rate != expect_rate:
            raise ValueError(f"{path}: need {expect_rate} Hz, got {rate}")
        width = w.getsampwidth()
        nch = w.getnchannels()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if nch > 1:
        data = data.reshape(-1, nch).mean(axis=1)
    return data


def write_wav(path: str | Path, samples: np.ndarray,
              rate: int = SAMPLE_RATE) -> None:
    pcm = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def vad_simple(pcm: np.ndarray, sample_rate: int = SAMPLE_RATE,
               last_ms: int = 1250, vad_thold: float = 0.6,
               freq_thold: float = 100.0) -> bool:
    """True if the last `last_ms` are quiet against the whole clip (speech
    has ended): mean |x| of the tail under vad_thold times that of the
    clip, after a one-pole high-pass at freq_thold Hz (0: none)."""
    pcm = np.asarray(pcm, np.float32).copy()
    n = len(pcm)
    n_last = min(n, sample_rate * last_ms // 1000)
    if n_last == n:
        return False
    if freq_thold > 0:
        rc = 1.0 / (2.0 * np.pi * freq_thold)
        dt = 1.0 / sample_rate
        alpha = dt / (rc + dt)
        y = np.empty_like(pcm)
        y[0] = pcm[0]
        for i in range(1, n):  # short clips only; a host-side utility
            y[i] = alpha * pcm[i] + (1 - alpha) * y[i - 1]
        pcm = y
    e_all = np.abs(pcm).mean()
    e_last = np.abs(pcm[-n_last:]).mean()
    return e_last < vad_thold * e_all
