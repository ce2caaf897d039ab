"""Corpus collectors: align TextGrid phoneme annotations with MRI frames
(copy of artspeech_tpu/data/collectors.py).

Port of reference database_collector.py:19-297 semantics (SYNC_SHIFT frame
alignment, per-sentence phone/frame gathering, TextgridOnly synthesis of
frame counts from durations).
"""

import logging
import os
from glob import glob
from tempfile import NamedTemporaryFile
from typing import Dict, List, Optional

from artspeech_tpu_torch.core.config import (
    ARTSPEECH2_CONFIG,
    GOTTINGEN_CONFIG,
    TEXTGRID_ONLY_CONFIG,
    DatasetConfig,
)
from artspeech_tpu_torch.data.audio import write_wav
from artspeech_tpu_torch.data.textgrid import read_textgrid
from artspeech_tpu_torch.data.video import Video

logger = logging.getLogger(__name__)


class DatabaseCollector:
    sentence_tier = "SentenceTier"
    word_tier = "WordTier"
    phoneme_tier = "PhonTier"
    dataset_config: DatasetConfig = None

    def __init__(self, datadir: str, save_audio_dir: Optional[str] = None):
        self.datadir = datadir
        self.save_audio_dir = save_audio_dir

    @staticmethod
    def _has_all_articulators(sequence_dir, frame_ids, required_articulators):
        if required_articulators is None:
            return True
        return all(
            os.path.exists(
                os.path.join(
                    sequence_dir, "inference_contours", f"{frame_id}_{articulator}.npy"
                )
            )
            for frame_id in frame_ids
            for articulator in required_articulators
        )

    def get_sequence_dir(self, subject, sequence):
        return os.path.join(self.datadir, subject, sequence)

    def get_wav_filepath(self, subject, sequence):
        raise NotImplementedError

    def get_textgrid_filepath(self, subject, sequence):
        raise NotImplementedError

    def get_frame_ids(self, subject, sequence) -> List[str]:
        sequence_dir = self.get_sequence_dir(subject, sequence)
        filepaths = glob(os.path.join(sequence_dir, "inference_contours", "*.npy"))
        basenames = (os.path.basename(fp).split(".")[0] for fp in filepaths)
        return sorted({name.split("_")[0] for name in basenames})

    def _save_sentence_audio_interval(self, video: Video, sentence_interval):
        _, samples = video.get_audio_interval(
            sentence_interval.start_time, sentence_interval.end_time
        )
        with NamedTemporaryFile(
            dir=self.save_audio_dir, suffix=".wav", delete=False
        ) as f:
            filepath = f.name
        write_wav(filepath, samples, video.sample_rate)
        return filepath

    def collect_data(self, sequences, required_articulators=None) -> List[dict]:
        data = []
        for subject, sequence in sequences:
            sequence_dir = self.get_sequence_dir(subject, sequence)
            frame_ids = self.get_frame_ids(subject, sequence)
            if len(frame_ids) == 0:
                logger.warning("Skipping %s/%s - Empty frame sequence", subject, sequence)
                continue

            # Audio/video sync shift (reference database_collector.py:92-96).
            sync_shift = abs(self.dataset_config.SYNC_SHIFT)
            if self.dataset_config.SYNC_SHIFT >= 0:
                frame_ids = frame_ids[sync_shift:]
            else:
                frame_ids = [frame_ids[0]] * sync_shift + frame_ids

            textgrid_filepath = self.get_textgrid_filepath(subject, sequence)
            if not os.path.isfile(textgrid_filepath):
                logger.warning("Skipping %s/%s - Missing textgrid", subject, sequence)
                continue
            textgrid = read_textgrid(textgrid_filepath)
            phone_tier = textgrid.get_tier_by_name(self.phoneme_tier)
            sentence_tier = textgrid.get_tier_by_name(self.sentence_tier)

            wav_filepath = self.get_wav_filepath(subject, sequence)
            video = Video(
                frames_filepaths=frame_ids,
                audio_filepath=wav_filepath,
                framerate=self.dataset_config.FRAMERATE,
                max_diff=1.0,
            )

            for sentence_interval in sentence_tier.intervals:
                sentence_wav_filepath = wav_filepath
                if self.save_audio_dir is not None:
                    sentence_wav_filepath = self._save_sentence_audio_interval(
                        video, sentence_interval
                    )

                phone_intervals = sorted(
                    (
                        p
                        for p in phone_tier
                        if p.start_time >= sentence_interval.start_time
                        and p.end_time <= sentence_interval.end_time
                    ),
                    key=lambda interval: interval.start_time,
                )

                phonemes_with_time = []
                phonemes: List[str] = []
                sentence_frame_ids: List[str] = []
                for phone in phone_intervals:
                    _, phoneme_frame_ids = video.get_frames_interval(
                        phone.start_time, phone.end_time
                    )
                    sentence_frame_ids.extend(phoneme_frame_ids)
                    phonemes.extend([phone.text] * len(phoneme_frame_ids))
                    phonemes_with_time.append(
                        (
                            phone.text,
                            phone.start_time - sentence_interval.start_time,
                            phone.end_time - sentence_interval.start_time,
                        )
                    )

                if len(sentence_frame_ids) == 0:
                    continue

                start_str = "%.04f" % sentence_interval.start_time
                end_str = "%.04f" % sentence_interval.end_time
                data.append(
                    {
                        "subject": subject,
                        "sequence": sequence,
                        "sentence_name": f"{subject}_{sequence}-{start_str}_{end_str}",
                        "wav_filepath": sentence_wav_filepath,
                        "audio_duration": sentence_interval.end_time
                        - sentence_interval.start_time,
                        "audio_interval": (
                            sentence_interval.start_time,
                            sentence_interval.end_time,
                        ),
                        "textgrid_filepath": textgrid_filepath,
                        "n_frames": len(sentence_frame_ids),
                        "frame_ids": sentence_frame_ids,
                        "phonemes_with_time": phonemes_with_time,
                        "phonemes": phonemes,
                        "has_all": self._has_all_articulators(
                            sequence_dir, sentence_frame_ids, required_articulators
                        ),
                    }
                )
        return data


class ArtSpeechDatabase2Collector(DatabaseCollector):
    dataset_config = ARTSPEECH2_CONFIG

    def get_wav_filepath(self, subject, sequence):
        return os.path.join(
            self.get_sequence_dir(subject, sequence), f"{subject}_{sequence}.wav"
        )

    def get_textgrid_filepath(self, subject, sequence):
        return os.path.join(
            self.get_sequence_dir(subject, sequence),
            f"{subject}_{sequence}_adjusted.textgrid",
        )

    def get_frame_ids(self, subject, sequence):
        sequence_dir = self.get_sequence_dir(subject, sequence)
        filepaths = glob(os.path.join(sequence_dir, "NPY_MR", "*.npy"))
        return sorted(os.path.basename(fp).split(".")[0] for fp in filepaths)


class GottingenDatabaseCollector(DatabaseCollector):
    dataset_config = GOTTINGEN_CONFIG

    def get_wav_filepath(self, subject, sequence):
        return os.path.join(
            self.get_sequence_dir(subject, sequence), f"vol_{subject}_{sequence}.wav"
        )

    def get_textgrid_filepath(self, subject, sequence):
        return os.path.join(
            self.get_sequence_dir(subject, sequence),
            f"vol_{subject}_{sequence}.textgrid",
        )


class TextgridOnlyDatabaseCollector(DatabaseCollector):
    """Synthesizes frame counts from durations; no images required
    (reference database_collector.py:223-290)."""

    dataset_config = TEXTGRID_ONLY_CONFIG

    def get_textgrid_filepath(self, subject, sequence):
        return os.path.join(self.get_sequence_dir(subject, sequence), f"{sequence}.textgrid")

    def collect_data(self, sequences, **kwargs):
        data = []
        for subject, sequence in sequences:
            textgrid_filepath = self.get_textgrid_filepath(subject, sequence)
            if not os.path.isfile(textgrid_filepath):
                logger.warning("Skipping %s/%s - Missing textgrid", subject, sequence)
                continue
            textgrid = read_textgrid(textgrid_filepath)
            phone_tier = textgrid.get_tier_by_name(self.phoneme_tier)
            sentence_tier = textgrid.get_tier_by_name(self.sentence_tier)

            for sentence_interval in sentence_tier.intervals:
                phone_intervals = sorted(
                    (
                        p
                        for p in phone_tier
                        if p.start_time >= sentence_interval.start_time
                        and p.end_time <= sentence_interval.end_time
                    ),
                    key=lambda interval: interval.start_time,
                )
                phonemes_with_time = []
                phonemes: List[str] = []
                for phone in phone_intervals:
                    duration = phone.end_time - phone.start_time
                    num_frames = int(self.dataset_config.FRAMERATE * duration)
                    phonemes.extend([phone.text] * num_frames)
                    phonemes_with_time.append(
                        (
                            phone.text,
                            phone.start_time - sentence_interval.start_time,
                            phone.end_time - sentence_interval.start_time,
                        )
                    )

                start_str = "%.04f" % sentence_interval.start_time
                end_str = "%.04f" % sentence_interval.end_time
                data.append(
                    {
                        "subject": subject,
                        "sequence": sequence,
                        "sentence_name": f"{subject}_{sequence}-{start_str}_{end_str}",
                        "wav_filepath": None,
                        "audio_duration": sentence_interval.end_time
                        - sentence_interval.start_time,
                        "textgrid_filepath": textgrid_filepath,
                        "n_frames": 0,
                        "frame_ids": [],
                        "phonemes_with_time": phonemes_with_time,
                        "phonemes": phonemes,
                        "has_all": None,
                    }
                )
        return data


DATABASE_COLLECTORS: Dict[str, type] = {
    "artspeech2": ArtSpeechDatabase2Collector,
    "gottingen": GottingenDatabaseCollector,
    "textgrid_only": TextgridOnlyDatabaseCollector,
}
