"""Render MRI frame + contour overlay videos for a corpus (counterpart of
artspeech_tpu/cli/make_dataset_videos.py).

Equivalent of reference scripts/make_dataset_videos.py:27-142 (cv2 video +
optional ffmpeg audio mux). DICOM inputs require pydicom; plain .npy frame
dirs (NPY_MR/*.npy) work without it.

Host only: ``--device`` is not used. Raises without cv2.

Usage: python -m artspeech_tpu_torch.cli.make_dataset_videos --config cfg.yaml
Config keys: datadir, database_name, seq_dict, articulators, save_to,
mux_audio (default false; requires ffmpeg on PATH).
"""

import os
import subprocess

import numpy as np

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS
from artspeech_tpu_torch.data.collectors import DATABASE_COLLECTORS
from artspeech_tpu_torch.data.loaders import load_articulator_array
from artspeech_tpu_torch.synth.viz import uint16_to_uint8
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    try:
        import cv2
    except Exception as exc:
        raise RuntimeError("make_dataset_videos requires cv2") from exc

    datadir = cfg["datadir"]
    config = DATASET_CONFIG[cfg["database_name"]]
    articulators = sorted(cfg.get("articulators") or TUBE_ARTICULATORS)
    save_to = cfg["save_to"]
    os.makedirs(save_to, exist_ok=True)
    collector = DATABASE_COLLECTORS[cfg["database_name"]](datadir)

    written = []
    for subject, sequence in sequences_from_dict(datadir, cfg["seq_dict"]):
        seq_dir = os.path.join(datadir, subject, sequence)
        frame_ids = collector.get_frame_ids(subject, sequence)
        if not frame_ids:
            continue
        size = config.RES
        video_path = os.path.join(save_to, f"{subject}_{sequence}.avi")
        writer = cv2.VideoWriter(
            video_path,
            cv2.VideoWriter_fourcc(*"MJPG"),
            config.FRAMERATE,
            (size * 4, size * 4),
        )
        for frame_id in frame_ids:
            npy_path = os.path.join(seq_dir, "NPY_MR", f"{frame_id}.npy")
            if os.path.isfile(npy_path):
                img = uint16_to_uint8(np.load(npy_path))
            else:
                img = np.zeros((size, size), np.uint8)
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
            img = cv2.resize(img, (size * 4, size * 4))
            for articulator in articulators:
                fp = os.path.join(
                    seq_dir, "inference_contours", f"{frame_id}_{articulator}.npy"
                )
                if not os.path.isfile(fp):
                    continue
                contour = load_articulator_array(fp, norm_value=1.0)  # pixels
                pts = (contour * 4).astype(np.int32).reshape(-1, 1, 2)
                cv2.polylines(img, [pts], False, (0, 255, 255), 1)
            writer.write(img)
        writer.release()

        if cfg.get("mux_audio", False):
            wav = collector.get_wav_filepath(subject, sequence)
            if os.path.isfile(wav):
                out = video_path.replace(".avi", "_audio.avi")
                subprocess.run(
                    ["ffmpeg", "-y", "-i", video_path, "-i", wav, "-c:v", "copy", out],
                    check=False,
                    capture_output=True,
                )
        written.append(video_path)
    print(f"Wrote {len(written)} videos")
    return written


if __name__ == "__main__":
    run_experiment("Make dataset videos", main)
