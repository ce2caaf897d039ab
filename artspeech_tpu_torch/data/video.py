"""Audio/video alignment (reference video.py:9-75), numpy host-side (copy of
artspeech_tpu/data/video.py)."""

from typing import List

import numpy as np

from artspeech_tpu_torch.data.audio import read_wav


class Video:
    def __init__(
        self,
        frames_filepaths: List[str],
        audio_filepath: str,
        framerate: int = 50,
        max_diff: float = 0.0025,
    ):
        audio, self.sample_rate = read_wav(audio_filepath)
        self.num_samples = len(audio)
        audio_duration = self.num_samples / self.sample_rate

        self.framerate = framerate
        self.num_frames = len(frames_filepaths)
        video_duration = self.num_frames / self.framerate

        diff = abs(video_duration - audio_duration)
        if diff > max_diff:
            raise ValueError(
                f"Difference in duration of audio and video is too large ({diff})"
            )
        self.duration = video_duration
        self.audio = audio
        self.frames_filepaths = frames_filepaths

    def get_audio_interval(self, start: float, end: float):
        time = np.linspace(0.0, self.duration, self.num_samples)
        indices = np.where((time >= start) & (time < end))[0]
        return time[indices], self.audio[indices]

    def get_frames_interval(self, start: float, end: float):
        time = np.linspace(0.0, self.duration, self.num_frames)
        indices = np.where((time >= start) & (time < end))[0]
        if len(indices) == 0:
            return np.array([]), []
        frames = sorted(self.frames_filepaths[i] for i in indices)
        return time[indices], frames
