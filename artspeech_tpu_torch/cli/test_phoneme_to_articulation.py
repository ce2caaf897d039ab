"""Evaluate a trained phoneme-to-articulation model on a held-out split
(counterpart of artspeech_tpu/cli/test_phoneme_to_articulation.py).

Equivalent of reference test_phoneme_to_articulation.py:23-123: load the
model's parameters (``state_dict_filepath``: ``<ckpts>/best/state``,
``<ckpts>/best`` or ``<ckpts>/best_model``), run the test harness, dump json
+ per-sentence contour/TV artifacts.

Usage: python -m artspeech_tpu_torch.cli.test_phoneme_to_articulation \
           --config config.yaml [--output_dir results] [--device cpu]
"""

import json
import os

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.datasets import ArtSpeechDataset
from artspeech_tpu_torch.eval.articulation import run_test
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.train.checkpoint import load_params
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    articulators = sorted(cfg["articulators"])

    model = ArtSpeech(vocab_size=len(vocabulary), n_articulators=len(articulators),
                      **model_kwargs_from_cfg(cfg), device=device)
    model.load_state_dict(load_params(cfg["state_dict_filepath"]))

    dataset = ArtSpeechDataset(
        cfg["datadir"],
        database_name,
        sequences_from_dict(cfg["datadir"], cfg["test_seq_dict"]),
        vocabulary,
        articulators,
        clip_tails=cfg.get("clip_tails", True),
    )
    loader = BucketedLoader(dataset, batch_size=cfg["batch_size"], shuffle=False)

    save_to = cfg.get("save_to", os.path.join(args.output_dir, "test_outputs", "0"))
    info = run_test(
        model,
        loader,
        articulators,
        to_mm=mm_per_unit(DATASET_CONFIG[database_name]),
        outputs_dir=save_to,
        regularize_out=cfg.get("regularize_out", False),
        device=device,
    )
    with open(os.path.join(args.output_dir, "test_results.json"), "w") as f:
        json.dump(info, f, indent=2)
    tracker.log_dict(info, "test_results.json")
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Test phoneme-to-articulation (BiGRU)", main)
