"""Train the multi-channel transformer phoneme-to-articulation model
(counterpart of artspeech_tpu/cli/train_phoneme_to_articulation_transformer.py).

Equivalent of reference train_phoneme_to_articulation_transformer.py:49-454:
teacher forcing with right-shifted targets, AdamW + plateau LR, early
stopping on valid P2CP-mm, then the final AUTOREGRESSIVE test of ``best/``
with artifact dumps. Config keys as the JAX CLI's: the model-free trainer's
(datadir, database_name, num_epochs, batch_size, patience, learning_rate,
weight_decay, train/valid/test_seq_dict, vocab_filepath, articulators,
model_kwargs, clip_tails, seed), ``n_samples``, ``accum_steps`` (default:
``transformer_accum_steps`` of the batch size), ``generate_cache_dtype``
(default ``bfloat16``) and ``regularize_out``. Training runs the pair
attention on the fused training-attention kernels, the final test the KV-cached
decode on the flash decode-attention kernel and the metrics on the P2CP and
min-distance kernels. Data-parallel over torchrun's ranks as the
model-free trainer (cli/train_phoneme_to_articulation.py), the microbatches of
``accum_steps`` inside each rank; rank 0 writes, decodes and tests.

Usage: python -m artspeech_tpu_torch.cli.train_phoneme_to_articulation_transformer \
           --config cfg.yaml [--output_dir results] [--device cpu]
"""

import json
import os

import torch

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.cli.test_phoneme_to_articulation_transformer import cache_dtype_from_cfg
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.datasets import ArtSpeechDataset
from artspeech_tpu_torch.eval.articulation import run_test
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer, make_auto_generate
from artspeech_tpu_torch.parallel.distributed import is_main_process
from artspeech_tpu_torch.parallel.mesh import world
from artspeech_tpu_torch.train.checkpoint import restore_checkpoint
from artspeech_tpu_torch.train.loop import fit
from artspeech_tpu_torch.train.state import count_parameters, create_train_state
from artspeech_tpu_torch.train.step import (
    make_transformer_eval_step,
    make_transformer_train_step,
    transformer_accum_steps,
)
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    datadir = cfg["datadir"]
    database_name = cfg["database_name"]
    to_mm = mm_per_unit(DATASET_CONFIG[database_name])
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    articulators = sorted(cfg["articulators"])
    seed = cfg.get("seed", 0)
    n_samples = cfg.get("n_samples", 50)

    model = ArtSpeechTransformer(vocab_size=len(vocabulary), num_articulators=len(articulators),
                                 num_feat=2 * n_samples, **model_kwargs_from_cfg(cfg),
                                 generator=torch.Generator().manual_seed(seed), device=device)

    n_ranks, _ = world()
    loaders = {}
    for split, seq_key, shuffle in (
        ("train", "train_seq_dict", True),
        ("valid", "valid_seq_dict", False),
        ("test", "test_seq_dict", False),
    ):
        dataset = ArtSpeechDataset(datadir, database_name,
                                   sequences_from_dict(datadir, cfg[seq_key]), vocabulary,
                                   articulators, clip_tails=cfg.get("clip_tails", True))
        loaders[split] = BucketedLoader(dataset, batch_size=cfg["batch_size"], shuffle=shuffle,
                                        seed=seed, pad_to_multiple=n_ranks)

    state = create_train_state(model, cfg["learning_rate"], cfg.get("weight_decay", 0.0))
    n_params = count_parameters(state.model)
    tracker.log_params({"num_network_params": n_params})
    print(f"ArtSpeechTransformer -- {n_params} parameters")

    accum = cfg.get("accum_steps", transformer_accum_steps(loaders["train"].batch_size))
    print(f"transformer train step: accum_steps={accum} (batch {loaders['train'].batch_size})")
    result = fit(
        state,
        loaders["train"],
        loaders["valid"],
        None,
        None,
        train_step_factory=lambda mesh: make_transformer_train_step(
            to_mm, accum_steps=accum, device=device, mesh=mesh),
        eval_step_factory=lambda mesh: make_transformer_eval_step(
            to_mm, device=device, mesh=mesh),
        n_epochs=cfg["num_epochs"],
        checkpoints_dir=os.path.join(args.output_dir, "checkpoints"),
        monitor="p2cp_mm",
        patience=cfg.get("patience", 30),
        tracker=tracker,
        seed=seed,
        resume=args.checkpoint_filepath is not None,
        resume_from=args.checkpoint_filepath,
        device=device,
    )
    print(f"Best valid p2cp_mm: {result.best_metric:.4f} @ <= epoch {result.last_epoch}")
    if not is_main_process():
        return None

    # Final autoregressive test with the best model (reference :331-371).
    best_state, _ = restore_checkpoint(result.best_params_dir, result.state)
    best_state.model.eval()
    info = run_test(
        make_auto_generate(best_state.model, cache_dtype=cache_dtype_from_cfg(cfg), device=device),
        loaders["test"],
        articulators,
        to_mm=to_mm,
        outputs_dir=os.path.join(args.output_dir, "test_outputs", "0"),
        regularize_out=cfg.get("regularize_out", False),
        device=device,
    )
    with open(os.path.join(args.output_dir, "test_results.json"), "w") as f:
        json.dump(info, f, indent=2)
    tracker.log_dict(info, "test_results.json")
    print(json.dumps({"loss": info["loss"]}, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Train phoneme-to-articulation transformer", main)
