"""Fit + test the phoneme-wise mean-contour lookup baseline (counterpart of
artspeech_tpu/cli/train_phoneme_wise_mean_contour.py).

Equivalent of reference train_phoneme_wise_mean_contour.py:29-138
("training" accumulates per-token contour statistics) and its test pass.
Config keys as in configs/mean_contour/train_mean_contour.yaml, plus the
JAX package's ``reference_sampling`` (the reference's seeded per-token row
subsample, ``sample_frac`` default 0.1, ``seed``), ``n_position_bins`` (the
positional table) and ``sample_frac`` (without ``reference_sampling``,
default 1.0). Writes ``mean_contour_table.npz``, ``test_outputs/0/...`` and
``test_results.json`` under ``--output_dir``.

Usage: python -m artspeech_tpu_torch.cli.train_phoneme_wise_mean_contour \
           --config config.yaml [--output_dir results] [--device cpu]
"""

import json
import os

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.datasets import ArtSpeechDataset
from artspeech_tpu_torch.eval.articulation import run_test
from artspeech_tpu_torch.models.mean_contour import (
    fit_mean_contour,
    fit_mean_contour_reference_sampling,
    make_mean_contour_forward,
)
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    articulators = sorted(cfg["articulators"])

    datasets = {
        split: ArtSpeechDataset(
            cfg["datadir"],
            database_name,
            sequences_from_dict(cfg["datadir"], cfg[key]),
            vocabulary,
            articulators,
            clip_tails=cfg.get("clip_tails", True),
        )
        for split, key in (("train", "train_seq_dict"), ("test", "test_seq_dict"))
    }

    if cfg.get("reference_sampling", False):
        if cfg.get("n_position_bins", 0):
            raise ValueError("reference_sampling does not support n_position_bins; "
                             "drop one of the two keys")
        table = fit_mean_contour_reference_sampling(
            datasets["train"], vocab_size=len(vocabulary), frac=cfg.get("sample_frac", 0.1),
            random_state=cfg.get("seed", 0))
    else:
        table = fit_mean_contour(
            datasets["train"], vocab_size=len(vocabulary), n_bins=cfg.get("n_position_bins", 0),
            sample_frac=cfg.get("sample_frac", 1.0), seed=cfg.get("seed", 0))
    os.makedirs(args.output_dir, exist_ok=True)
    table_path = os.path.join(args.output_dir, "mean_contour_table.npz")
    table.save(table_path)
    tracker.log_artifact(table_path)

    loader = BucketedLoader(datasets["test"], batch_size=cfg.get("batch_size", 8), shuffle=False)
    info = run_test(
        make_mean_contour_forward(table, device=device),
        loader,
        articulators,
        to_mm=mm_per_unit(DATASET_CONFIG[database_name]),
        outputs_dir=os.path.join(args.output_dir, "test_outputs", "0"),
        regularize_out=cfg.get("regularize_out", False),
        loss_agg="sentence",
        device=device,
    )
    with open(os.path.join(args.output_dir, "test_results.json"), "w") as f:
        json.dump(info, f, indent=2)
    tracker.log_dict(info, "test_results.json")
    print(json.dumps({"loss": info["loss"]}, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Train phoneme-wise mean contour baseline", main)
