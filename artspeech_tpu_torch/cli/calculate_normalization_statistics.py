"""Compute per-articulator contour mean/std over a corpus split (counterpart
of artspeech_tpu/cli/calculate_normalization_statistics.py).

Equivalent of reference scripts/calculate_normalization_statistics.py:16-83;
writes normalization_statistics/{articulator}_{mean,std}.npy consumed by the
principal-components datasets. Host work only (numpy): ``--device`` is
accepted and not used.

Usage: python -m artspeech_tpu_torch.cli.calculate_normalization_statistics \
           --config cfg.yaml
Config keys: datadir, database_name, seq_dict, articulators, clip_tails,
save_to (default {datadir}/normalization_statistics).
"""

import os

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.data.pc_datasets import compute_normalization_statistics
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    datadir = cfg["datadir"]
    save_to = cfg.get("save_to") or os.path.join(datadir, "normalization_statistics")
    stats = compute_normalization_statistics(
        datadir,
        cfg["database_name"],
        sequences_from_dict(datadir, cfg["seq_dict"]),
        sorted(cfg["articulators"]),
        clip_tails=cfg.get("clip_tails", True),
        save_to=save_to,
    )
    print(f"Wrote stats for {len(stats)} articulators -> {save_to}")
    return list(stats.keys())


if __name__ == "__main__":
    run_experiment("Calculate normalization statistics", main)
