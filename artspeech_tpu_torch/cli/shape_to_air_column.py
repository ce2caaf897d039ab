"""Precompute air columns for a corpus: contours -> tube walls -> npy
(counterpart of artspeech_tpu/cli/shape_to_air_column.py).

Equivalent of reference scripts/shape_to_air_column.py:40-89: the tube walls
of ``batch_size`` frames at a time come from one
``generate_vocal_tract_tube_batch`` call on ``--device`` (default cuda). The
last chunk of a sequence runs at its own size. Each frame gets
``air_column/{frame}.npy`` of shape (2, 2, 100): the internal wall, then the
external, each as (x row, y row).

Usage: python -m artspeech_tpu_torch.cli.shape_to_air_column --config cfg.yaml \
           [--device cpu]
Config keys: datadir, database_name, seq_dict (subject -> [sequences]),
articulators (default: the 11 tube articulators), batch_size.
"""

import os

import numpy as np
import torch

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.data.collectors import DATABASE_COLLECTORS
from artspeech_tpu_torch.data.loaders import load_articulator_array
from artspeech_tpu_torch.geometry.tube import generate_vocal_tract_tube_batch
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    datadir = cfg["datadir"]
    database_name = cfg["database_name"]
    config = DATASET_CONFIG[database_name]
    articulators = sorted(cfg.get("articulators") or TUBE_ARTICULATORS)
    batch_size = cfg.get("batch_size", 64)

    collector = DATABASE_COLLECTORS[database_name](datadir)
    sequences = sequences_from_dict(datadir, cfg["seq_dict"])

    n_written = 0
    for subject, sequence in sequences:
        seq_dir = os.path.join(datadir, subject, sequence)
        frame_ids = collector.get_frame_ids(subject, sequence)
        if not frame_ids:
            continue
        air_dir = os.path.join(seq_dir, "air_column")
        os.makedirs(air_dir, exist_ok=True)

        for start in range(0, len(frame_ids), batch_size):
            frames = []
            kept_ids = []
            for frame_id in frame_ids[start:start + batch_size]:
                try:
                    arts = [
                        load_articulator_array(
                            os.path.join(seq_dir, "inference_contours",
                                         f"{frame_id}_{articulator}.npy"),
                            norm_value=config.RES,
                        ).T  # (2, D)
                        for articulator in articulators
                    ]
                except FileNotFoundError:
                    continue
                frames.append(np.stack(arts))
                kept_ids.append(frame_id)
            if not frames:
                continue
            stack = torch.from_numpy(np.stack(frames)).to(device)  # (B, Nart, 2, D)
            with torch.no_grad():
                internal, external = generate_vocal_tract_tube_batch(stack, articulators)
            internal, external = internal.cpu().numpy(), external.cpu().numpy()
            for i, frame_id in enumerate(kept_ids):
                air = np.stack([internal[i].T, external[i].T])  # (2, 2, 100)
                np.save(os.path.join(air_dir, f"{frame_id}.npy"), air)
                n_written += 1
    print(f"Wrote {n_written} air columns")
    return n_written


if __name__ == "__main__":
    run_experiment("Shape to air column", main)
