"""WAV reading and writing (host side; copy of artspeech_tpu/data/audio.py).

Replaces the torchaudio usage of reference video.py:17-18 with a stdlib
PCM reader (soundfile fallback if present).
"""

import wave
from typing import Tuple

import numpy as np


def read_wav(filepath: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (mono float32 samples in [-1, 1], sample_rate).

    Multi-channel audio is mean-averaged to mono (reference video.py:18).
    """
    try:
        with wave.open(filepath, "rb") as w:
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            framerate = w.getframerate()
            n_frames = w.getnframes()
            raw = w.readframes(n_frames)
        if sampwidth == 2:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif sampwidth == 4:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif sampwidth == 1:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"Unsupported sample width {sampwidth}")
        if n_channels > 1:
            data = data.reshape(-1, n_channels).mean(axis=1)
        return data, framerate
    except wave.Error:
        import soundfile as sf  # optional fallback for non-PCM formats

        data, framerate = sf.read(filepath, dtype="float32")
        if data.ndim > 1:
            data = data.mean(axis=1)
        return data, framerate


def write_wav(filepath: str, samples: np.ndarray, sample_rate: int):
    """Write mono float32 samples as PCM16."""
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(filepath, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
