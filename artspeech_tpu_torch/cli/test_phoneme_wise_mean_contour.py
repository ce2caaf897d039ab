"""Evaluate a fitted mean-contour table on a held-out split (counterpart of
artspeech_tpu/cli/test_phoneme_wise_mean_contour.py).

Equivalent of reference test_phoneme_wise_mean_contour.py:18-88. Config keys
as in configs/mean_contour/test_mean_contour.yaml: datadir, database_name,
test_seq_dict, table_filepath (the mean_contour_table.npz from training, by
either package), vocab_filepath, articulators; optional save_to, batch_size,
clip_tails, regularize_out.

Usage: python -m artspeech_tpu_torch.cli.test_phoneme_wise_mean_contour \
           --config cfg.yaml [--output_dir results] [--device cpu]
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
from artspeech_tpu_torch.models.mean_contour import MeanContourTable, make_mean_contour_forward
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    articulators = sorted(cfg["articulators"])

    table = MeanContourTable.load(cfg["table_filepath"])
    dataset = ArtSpeechDataset(
        cfg["datadir"],
        database_name,
        sequences_from_dict(cfg["datadir"], cfg["test_seq_dict"]),
        vocabulary,
        articulators,
        clip_tails=cfg.get("clip_tails", True),
    )
    loader = BucketedLoader(dataset, batch_size=cfg.get("batch_size", 8), shuffle=False)
    info = run_test(
        make_mean_contour_forward(table, device=device),
        loader,
        articulators,
        to_mm=mm_per_unit(DATASET_CONFIG[database_name]),
        outputs_dir=cfg.get("save_to", os.path.join(args.output_dir, "test_outputs", "0")),
        regularize_out=cfg.get("regularize_out", False),
        loss_agg="sentence",
        device=device,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "test_results.json"), "w") as f:
        json.dump(info, f, indent=2)
    tracker.log_dict(info, "test_results.json")
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Test phoneme-wise mean contour", main)
