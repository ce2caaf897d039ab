"""Train the model-free BiGRU phoneme-to-articulation model (counterpart of
artspeech_tpu/cli/train_phoneme_to_articulation.py).

Equivalent of reference train_phoneme_to_articulation.py (main thesis
trainer): AdamW + plateau LR + early stopping on valid P2CP-mm, then a final
test pass with artifact dumps. YAML config keys mirror the reference
``main(**cfg)`` surface (datadir, database_name, num_epochs, batch_size,
patience, learning_rate, weight_decay, train/valid/test_seq_dict,
vocab_filepath, articulators, model_kwargs, clip_tails, seed).

Data-parallel over torchrun's ranks: the loaders pad the collated batch to a
multiple of the world size with zero-length dummy rows, ``fit`` resolves the
mesh, and the steps are built against it: the multi-rank steps over a
group, the one-device steps at world size 1, where there is no group. Rank 0
writes and runs the final test.

Usage: python -m artspeech_tpu_torch.cli.train_phoneme_to_articulation \
           --config config.yaml [--output_dir results] [--device cpu]
       python -m torch.distributed.run --nproc_per_node=N \
           -m artspeech_tpu_torch.cli.train_phoneme_to_articulation --config config.yaml
"""

import json
import os

import torch

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.datasets import ArtSpeechDataset
from artspeech_tpu_torch.eval.articulation import run_test
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.parallel.distributed import is_main_process
from artspeech_tpu_torch.parallel.mesh import world
from artspeech_tpu_torch.train.checkpoint import restore_checkpoint
from artspeech_tpu_torch.train.loop import fit
from artspeech_tpu_torch.train.state import count_parameters, create_train_state
from artspeech_tpu_torch.train.step import make_artspeech_eval_step, make_artspeech_train_step
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    datadir = cfg["datadir"]
    database_name = cfg["database_name"]
    to_mm = mm_per_unit(DATASET_CONFIG[database_name])
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    articulators = sorted(cfg["articulators"])
    clip_tails = cfg.get("clip_tails", True)
    seed = cfg.get("seed", 0)

    model = ArtSpeech(vocab_size=len(vocabulary), n_articulators=len(articulators),
                      **model_kwargs_from_cfg(cfg),
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
                                   articulators, clip_tails=clip_tails)
        loaders[split] = BucketedLoader(dataset, batch_size=cfg["batch_size"], shuffle=shuffle,
                                        seed=seed, pad_to_multiple=n_ranks)

    state = create_train_state(model, cfg["learning_rate"], cfg.get("weight_decay", 0.0))
    if cfg.get("state_dict_filepath"):
        state, _ = restore_checkpoint(cfg["state_dict_filepath"], state)

    n_params = count_parameters(state.model)
    tracker.log_params({"num_network_params": n_params})
    print(f"ArtSpeech -- {n_params} parameters")

    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    result = fit(
        state,
        loaders["train"],
        loaders["valid"],
        None,
        None,
        train_step_factory=lambda mesh: make_artspeech_train_step(
            to_mm, device=device, mesh=mesh),
        eval_step_factory=lambda mesh: make_artspeech_eval_step(
            to_mm, device=device, mesh=mesh),
        n_epochs=cfg["num_epochs"],
        checkpoints_dir=ckpt_dir,
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

    # Final test with the best model (reference :331-371).
    best_state, _ = restore_checkpoint(result.best_params_dir, result.state)
    info = run_test(
        best_state.model,
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
    run_experiment("Train phoneme-to-articulation (BiGRU)", main)
