"""Train the multi-articulator frame autoencoder (counterpart of
artspeech_tpu/cli/train_principal_components_autoencoder.py).

Equivalent of reference train_principal_components_autoencoder.py:67-356:
RegularizedLatentsMSELoss (weighted MSE + off-diagonal latent covariance),
AdamW, early stopping on the valid reconstruction p2cp_mm, encoder and
decoder params saved separately (downstream losses load them on their own),
then the test: per-articulator errors, latent covariance and nomograms.
Frame batches are padded with zero-weight rows to the batch size, rounded up
to a multiple of the world size: over torchrun's ranks each rank trains on
its rows of every batch (the whole batch's loss, parallel/mesh.py), rank 0
writes the checkpoints and runs the test.

Usage: python -m artspeech_tpu_torch.cli.train_principal_components_autoencoder \
           --config cfg.yaml [--output_dir results] [--device cpu]
Config keys: datadir, database_name, num_epochs, batch_size, patience,
learning_rate, weight_decay, alpha, indices_dict (articulator -> n components),
train/valid/test_seq_dict, articulators (or from indices_dict), clip_tails,
in_features, hidden_features, encoder_cls/decoder_cls (AE | PCA), seed.
"""

import json
import os

import numpy as np
import torch

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.data.batching import prefetch_to_device, round_up_to_multiple
from artspeech_tpu_torch.data.pc_datasets import (
    AutoencoderDataset,
    compute_normalization_statistics,
    load_norm_stats,
    stack_norm_stats,
)
from artspeech_tpu_torch.eval.autoencoder import nomograms, run_autoencoder_test
from artspeech_tpu_torch.models.autoencoder import (
    MultiArticulatorAutoencoder,
    latent_size_of,
    normalize_indices_dict,
)
from artspeech_tpu_torch.parallel.distributed import (
    barrier,
    distribute_state,
    is_initialized,
    is_main_process,
)
from artspeech_tpu_torch.parallel.mesh import batch_sharding, data_parallel_mesh, world
from artspeech_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, save_params
from artspeech_tpu_torch.train.pc_step import (
    make_autoencoder_eval_step,
    make_autoencoder_train_step,
)
from artspeech_tpu_torch.train.state import count_parameters, create_train_state
from artspeech_tpu_torch.utils.io import sequences_from_dict


def _epoch_means(results):
    """Frame-weighted means over (metrics, n_valid) pairs."""
    total = max(sum(n for _, n in results), 1.0)
    keys = results[0][0].keys() if results else ()
    return {k: float(sum(float(m[k]) * n for m, n in results)) / total for k in keys}


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    to_mm = mm_per_unit(DATASET_CONFIG[database_name])
    indices_dict = normalize_indices_dict(cfg["indices_dict"])
    articulators = sorted(cfg.get("articulators") or indices_dict.keys())
    clip_tails = cfg.get("clip_tails", True)
    datadir = cfg["datadir"]
    seed = cfg.get("seed", 0)

    batch_size = cfg["batch_size"]
    n_ranks, _ = world()
    mesh = None
    if is_initialized():
        mesh = data_parallel_mesh(round_up_to_multiple(batch_size, n_ranks), device=device)
    stats_dir = os.path.join(datadir, "normalization_statistics")
    if is_main_process() and not os.path.isdir(stats_dir):
        compute_normalization_statistics(
            datadir, database_name, sequences_from_dict(datadir, cfg["train_seq_dict"]),
            articulators, clip_tails=clip_tails, save_to=stats_dir)
    barrier(mesh)  # the other ranks read rank 0's statistics
    norm_stats = load_norm_stats(datadir, articulators)
    denorm_mean, denorm_std = stack_norm_stats(norm_stats, articulators)

    datasets = {
        split: AutoencoderDataset(datadir, database_name, sequences_from_dict(datadir, cfg[key]),
                                  articulators, clip_tails=clip_tails, norm_stats=norm_stats)
        for split, key in (("train", "train_seq_dict"), ("valid", "valid_seq_dict"),
                           ("test", "test_seq_dict"))
    }

    model = MultiArticulatorAutoencoder(
        indices_dict, in_features=cfg.get("in_features", 100),
        hidden_features=cfg.get("hidden_features", 50),
        encoder_cls=cfg.get("encoder_cls", "AE"), decoder_cls=cfg.get("decoder_cls", "AE"),
        generator=torch.Generator().manual_seed(seed), device=device)
    state = create_train_state(model, cfg["learning_rate"], cfg.get("weight_decay", 0.0))
    n_params = count_parameters(model)
    tracker.log_params({"num_network_params": n_params})
    print(f"MultiArticulatorAutoencoder -- {n_params} parameters")

    alpha = cfg.get("alpha", 0.1)
    if mesh is not None:
        distribute_state(state, mesh)
    sharding = batch_sharding(mesh) if mesh is not None else None
    common = (indices_dict, alpha, denorm_mean, denorm_std, to_mm)
    train_step = make_autoencoder_train_step(*common, device=device, mesh=mesh)
    eval_step = make_autoencoder_eval_step(*common, device=device, mesh=mesh)

    def frames(split, **kwargs):
        return prefetch_to_device(datasets[split].batches(batch_size, pad_to_multiple=n_ranks,
                                                          **kwargs),
                                  device=device, sharding=sharding)

    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    best_metric, since_best = float("inf"), 0
    for epoch in range(cfg["num_epochs"]):
        train = [(train_step(state, batch), meta["n_valid"])
                 for batch, meta in frames("train", shuffle=True, seed=seed + epoch)]
        valid = [(eval_step(state, batch)[0], meta["n_valid"])
                 for batch, meta in frames("valid", shuffle=False)]
        train_metrics, valid_metrics = _epoch_means(train), _epoch_means(valid)
        record = {**{f"train_{k}": v for k, v in train_metrics.items()},
                  **{f"valid_{k}": v for k, v in valid_metrics.items()}}
        tracker.log_metrics(record, step=epoch)
        print(f"epoch {epoch}: {record}")

        # Every rank takes the same decisions from the group's metrics;
        # rank 0 writes.
        if valid_metrics["p2cp_mm"] < best_metric:
            best_metric, since_best = valid_metrics["p2cp_mm"], 0
            if is_main_process():
                save_checkpoint(os.path.join(ckpt_dir, "best"), state)
                # encoder/decoder saved separately (reference :230-239)
                save_params(os.path.join(ckpt_dir, "best_encoder"), model.encoders)
                save_params(os.path.join(ckpt_dir, "best_decoder"), model.decoders)
        else:
            since_best += 1
        if is_main_process():
            save_checkpoint(os.path.join(ckpt_dir, "last"), state,
                            aux={"epoch": epoch, "best_metric": best_metric})
        barrier(mesh)
        if since_best > cfg.get("patience", 30):
            break
    if not is_main_process():
        return None

    state, _ = restore_checkpoint(os.path.join(ckpt_dir, "best"), state)
    outputs_dir = os.path.join(args.output_dir, "test_outputs")
    eval_step = make_autoencoder_eval_step(*common, device=device)
    info = run_autoencoder_test(state, eval_step, datasets["test"], batch_size, denorm_mean,
                                denorm_std, to_mm, articulators, outputs_dir=outputs_dir,
                                device=device)
    # Nomograms: per-component decoder sweeps (reference test CLI :32-321).
    noms = nomograms(model.decode, latent_size_of(indices_dict), denorm_mean, denorm_std,
                     device=device)
    np.savez(os.path.join(outputs_dir, "nomograms.npz"),
             **{f"component_{i}": v for i, v in noms.items()})
    tracker.log_dict(info, "test_results.json")
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Train multi-articulator autoencoder", main)
