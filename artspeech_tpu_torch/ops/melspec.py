"""Mel spectrogram as two float32 matmuls (counterpart of
artspeech_tpu/ops/melspec.py).

Equivalent of ``torchaudio.transforms.MelSpectrogram`` as configured by the
reference recognizer dataset (phoneme_recognition/datasets.py:84-92: sample
rate 16k, n_fft = win_length = 1024, hop 256, 80 mels, power 2, HTK mel
scale, no filterbank norm, center-padded reflect STFT) plus the log
compression ``dynamic_range_compression`` (datasets.py:47-48).

The STFT is computed as the JAX package computes it: the framed, windowed
signal times a real-DFT basis ``[cos; -sin]`` and the power spectrum times
the HTK filterbank, both in full float32 (TF32 is off, ``core/device.py``).
``torch.stft`` is not used: its FFT sums in another order.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    """HTK mel scale (torchaudio default mel_scale="htk")."""
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(
    n_mels: int,
    n_freqs: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> np.ndarray:
    """Triangular mel filterbank (n_freqs, n_mels), HTK scale, no norm."""
    f_max = f_max or sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def dft_basis(n_fft: int) -> np.ndarray:
    """Real-DFT basis stacked [cos; -sin]: (2 * (n_fft//2 + 1), n_fft)."""
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=0).astype(np.float32)


def frame_signal(audio: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """(..., S) -> (..., T, n_fft) frames with reflect center padding; the
    frames are copies of the signal's values (``Tensor.unfold``)."""
    if center:
        lead = audio.shape[:-1]
        audio = F.pad(audio.reshape(-1, 1, audio.shape[-1]), (n_fft // 2, n_fft // 2),
                      mode="reflect").reshape(*lead, -1)
    n = audio.shape[-1]
    if n < n_fft:
        return audio.new_zeros(audio.shape[:-1] + (0, n_fft))
    return audio.unfold(-1, n_fft, hop_length)


def melspectrogram(
    audio: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    win_length: Optional[int] = None,
    hop_length: int = 256,
    n_mels: int = 80,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
    power: float = 2.0,
) -> torch.Tensor:
    """Mel spectrogram of (..., S) float32 audio -> (..., n_mels, T).

    Matches torchaudio MelSpectrogram defaults (hann window, center reflect,
    HTK mel, norm None).
    """
    win_length = win_length or n_fft
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    dev = audio.device
    frames = frame_signal(audio, n_fft, hop_length) * torch.from_numpy(window).to(dev)
    basis = torch.from_numpy(dft_basis(n_fft)).to(dev)  # (2F, N)
    spec = frames @ basis.T  # (..., T, 2F)
    n_freqs = n_fft // 2 + 1
    real, imag = spec[..., :n_freqs], spec[..., n_freqs:]
    mag = real * real + imag * imag
    if power != 2.0:
        mag = torch.pow(torch.clamp(mag, min=1e-30), power / 2.0)
    fb = torch.from_numpy(mel_filterbank(n_mels, n_freqs, sample_rate, f_min, f_max)).to(dev)
    return (mag @ fb).transpose(-1, -2)  # (..., n_mels, T)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, min=clip_val) * C) — reference datasets.py:47-48."""
    return torch.log(torch.clamp(x, min=clip_val) * C)
