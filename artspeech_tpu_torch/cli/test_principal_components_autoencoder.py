"""Evaluate a trained frame autoencoder: reconstruction errors, latent
covariance, nomograms, latent histograms (counterpart of
artspeech_tpu/cli/test_principal_components_autoencoder.py).

Equivalent of reference test_principal_components_autoencoder.py:32-321.
Nomogram plots need matplotlib; without it the CLI logs so and writes the
arrays alone.

Usage: python -m artspeech_tpu_torch.cli.test_principal_components_autoencoder \
           --config cfg.yaml [--device cpu]
"""

import json
import os

import numpy as np

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.data.pc_datasets import (
    AutoencoderDataset,
    load_norm_stats,
    stack_norm_stats,
)
from artspeech_tpu_torch.eval.autoencoder import nomograms, plot_nomograms, run_autoencoder_test
from artspeech_tpu_torch.models.autoencoder import (
    MultiArticulatorAutoencoder,
    latent_size_of,
    normalize_indices_dict,
)
from artspeech_tpu_torch.train.checkpoint import load_params
from artspeech_tpu_torch.train.pc_step import make_autoencoder_eval_step
from artspeech_tpu_torch.train.state import TrainState
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    to_mm = mm_per_unit(DATASET_CONFIG[database_name])
    indices_dict = normalize_indices_dict(cfg["indices_dict"])
    articulators = sorted(indices_dict.keys())
    datadir = cfg["datadir"]

    norm_stats = load_norm_stats(datadir, articulators)
    denorm_mean, denorm_std = stack_norm_stats(norm_stats, articulators)
    dataset = AutoencoderDataset(datadir, database_name,
                                 sequences_from_dict(datadir, cfg["test_seq_dict"]), articulators,
                                 clip_tails=cfg.get("clip_tails", True), norm_stats=norm_stats)

    model = MultiArticulatorAutoencoder(
        indices_dict, in_features=cfg.get("in_features", 100),
        hidden_features=cfg.get("hidden_features", 50),
        encoder_cls=cfg.get("encoder_cls", "AE"), decoder_cls=cfg.get("decoder_cls", "AE"),
        device=device)
    model.load_state_dict(load_params(cfg["checkpoint_dir"]))
    eval_step = make_autoencoder_eval_step(indices_dict, cfg.get("alpha", 0.1), denorm_mean,
                                           denorm_std, to_mm, device=device)
    outputs_dir = os.path.join(args.output_dir, "test_outputs")
    info = run_autoencoder_test(TrainState(model=model, optimizer=None), eval_step, dataset,
                                cfg.get("batch_size", 64), denorm_mean, denorm_std, to_mm,
                                articulators, outputs_dir=outputs_dir, device=device)

    noms = nomograms(model.decode, latent_size_of(indices_dict), denorm_mean, denorm_std,
                     device=device)
    np.savez(os.path.join(outputs_dir, "nomograms.npz"),
             **{f"component_{i}": v for i, v in noms.items()})
    plot_nomograms(noms, articulators, outputs_dir)

    # Latent histograms (reference :230-260): reuse dumped latents.
    latents = np.load(os.path.join(outputs_dir, "latents.npy"))
    hist = {f"component_{i}": np.histogram(latents[:, i], bins=20, range=(-1, 1))[0]
            for i in range(latents.shape[1])}
    np.savez(os.path.join(outputs_dir, "latent_histograms.npz"), **hist)

    tracker.log_dict(info, "test_results.json")
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Test principal-components autoencoder", main)
