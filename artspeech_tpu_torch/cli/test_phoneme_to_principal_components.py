"""Evaluate a trained latent-RNN (phonemes -> principal components) model
(counterpart of artspeech_tpu/cli/test_phoneme_to_principal_components.py).

Equivalent of reference test_phoneme_to_principal_components.py:28-164.

Usage: python -m artspeech_tpu_torch.cli.test_phoneme_to_principal_components \
           --config cfg.yaml [--device cpu]
"""

import json
import os

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.cli.train_phoneme_to_principal_components import build_frozen_ae
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.pc_datasets import (
    PrincipalComponentsDataset,
    load_norm_stats,
    stack_norm_stats,
)
from artspeech_tpu_torch.eval.autoencoder import run_latent_rnn_test
from artspeech_tpu_torch.models.autoencoder import normalize_indices_dict
from artspeech_tpu_torch.models.latent_rnn import PrincipalComponentsArtSpeech
from artspeech_tpu_torch.train.checkpoint import load_params
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    to_mm = mm_per_unit(DATASET_CONFIG[database_name])
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    indices_dict = normalize_indices_dict(cfg["indices_dict"])
    articulators = sorted(indices_dict.keys())
    datadir = cfg["datadir"]

    norm_stats = load_norm_stats(datadir, articulators)
    denorm_mean, denorm_std = stack_norm_stats(norm_stats, articulators)
    _, decode_fn = build_frozen_ae(cfg, indices_dict, require_encoder=False, device=device)

    model = PrincipalComponentsArtSpeech(len(vocabulary), indices_dict,
                                         **model_kwargs_from_cfg(cfg), device=device)
    model.load_state_dict(load_params(cfg["state_dict_filepath"]))

    dataset = PrincipalComponentsDataset(
        datadir, database_name, sequences_from_dict(datadir, cfg["test_seq_dict"]), vocabulary,
        articulators, TV_to_phoneme_map=cfg.get("TV_to_phoneme_map"),
        clip_tails=cfg.get("clip_tails", True), norm_stats=norm_stats)
    loader = BucketedLoader(dataset, batch_size=cfg.get("batch_size", 8), shuffle=False)
    info = run_latent_rnn_test(
        model, decode_fn, loader, articulators, denorm_mean, denorm_std, to_mm,
        rescale_factor=cfg.get("rescale_factor", 1.0),
        outputs_dir=cfg.get("save_to", os.path.join(args.output_dir, "test_outputs", "0")),
        device=device)
    with open(os.path.join(args.output_dir, "test_results.json"), "w") as f:
        json.dump(info, f, indent=2)
    tracker.log_dict(info, "test_results.json")
    print(json.dumps({"p2cp_mm": info["p2cp_mm"]}, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Test phoneme-to-principal-components", main)
