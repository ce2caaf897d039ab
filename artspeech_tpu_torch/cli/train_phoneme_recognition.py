"""Train the DeepSpeech2 phoneme recognizer (counterpart of
artspeech_tpu/cli/train_phoneme_recognition.py).

Equivalent of reference train_phoneme_recognition.py:51-329: CTC or CE over
melspec / vocal_tract / air_column features, AdamW + CyclicLR, early stopping
on the valid edit distance, final test with substitution/confusion artifacts
under ``<output_dir>/test_outputs``. Checkpoints go to
``<output_dir>/checkpoints/{best,last}``.

Config keys mirror the reference: datadir, database_name, num_epochs,
batch_size, patience, learning_rate, weight_decay, feature, target, loss
(ctc|ce), train/valid/test_seq_dict, vocab_filepath, model_params,
voicing_filepath, use_voicing, logits_large_margins, class_weights_filepath,
pretrained / pretrained_filepath, compute_dtype, accum_steps (default 1),
seed.

Data-parallel over torchrun's ranks: the loaders pad the collated batch to a
multiple of the world size with rows of input length 0, each rank trains on
its rows of every batch (the whole batch's loss, train/recognition_step.py),
and the epoch loss is weighted by each batch's global count of real
sentences. Rank 0 runs the valid pass and the test and writes; the others
take its valid record.

Usage: python -m artspeech_tpu_torch.cli.train_phoneme_recognition \\
           --config cfg.yaml [--output_dir results] [--device cpu]
"""

import json
import os
import tempfile

import torch

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import prefetch_to_device
from artspeech_tpu_torch.data.recognition import (
    MELSPEC,
    TARGET_KEYS,
    PhonemeRecognitionDataset,
    RecognitionLoader,
)
from artspeech_tpu_torch.eval.recognition import run_recognition_test
from artspeech_tpu_torch.losses.recognition import load_class_weights
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2
from artspeech_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_object,
    distribute_state,
    is_initialized,
    is_main_process,
)
from artspeech_tpu_torch.parallel.mesh import batch_sharding, data_parallel_mesh, world
from artspeech_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from artspeech_tpu_torch.train.loop import folded_seed
from artspeech_tpu_torch.train.recognition_step import (
    cyclic_triangular_schedule,
    make_recognition_eval_step,
    make_recognition_train_step,
)
from artspeech_tpu_torch.train.state import count_parameters, create_train_state
from artspeech_tpu_torch.utils.io import sequences_from_dict


def load_voiced_tokens(cfg):
    if not cfg.get("voicing_filepath"):
        return None
    with open(cfg["voicing_filepath"]) as f:
        return json.load(f)


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    feature = cfg.get("feature", "melspec")
    criterion = cfg.get("loss", "ctc")
    target_key = TARGET_KEYS[cfg.get("target", "ctc")]
    use_voicing = cfg.get("use_voicing", False)
    voiced_tokens = load_voiced_tokens(cfg)
    seed = cfg.get("seed", 0)

    model_params = model_kwargs_from_cfg(cfg, key="model_params")
    gen = torch.Generator().manual_seed(seed)
    if cfg.get("pretrained", False):
        # LibriSpeech-pretrained init with a fresh classifier head
        # (reference train_phoneme_recognition.py:112-118).
        from artspeech_tpu_torch.utils.torch_import import load_librispeech_deepspeech2

        model = load_librispeech_deepspeech2(
            cfg["pretrained_filepath"],
            num_classes=len(vocabulary),
            num_features=model_params.get("num_features", 80),
            adapter_out_features=model_params.get("adapter_out_features"),
            dtype=model_params.get("dtype"),
            generator=gen,
            device=device,
        )
    else:
        model = DeepSpeech2(num_classes=len(vocabulary), **model_params, generator=gen,
                            device=device)

    class_weights = None
    if cfg.get("class_weights_filepath"):
        class_weights = load_class_weights(cfg["class_weights_filepath"], vocabulary)

    n_ranks, _ = world()
    loaders = {}
    tmp_dir = tempfile.mkdtemp() if feature == MELSPEC else None
    for split, key, shuffle in (
        ("train", "train_seq_dict", True),
        ("valid", "valid_seq_dict", False),
        ("test", "test_seq_dict", False),
    ):
        dataset = PhonemeRecognitionDataset(
            datadir=cfg["datadir"],
            database_name=cfg["database_name"],
            sequences=sequences_from_dict(cfg["datadir"], cfg[key]),
            vocabulary=vocabulary,
            features=[feature],
            voiced_tokens=voiced_tokens,
            tmp_dir=tmp_dir,
        )
        loaders[split] = RecognitionLoader(dataset, feature, batch_size=cfg["batch_size"],
                                           shuffle=shuffle, pad_to_multiple=n_ranks)

    # AdamW with the cyclic LR applied per optimizer step (reference :184-189).
    lr = cfg["learning_rate"]
    state = create_train_state(model, lr, cfg.get("weight_decay", 0.0))
    if args.checkpoint_filepath:
        state, _ = restore_checkpoint(args.checkpoint_filepath, state)
    mesh = None
    if is_initialized():
        mesh = data_parallel_mesh(loaders["train"].collate_batch_size, device=device)
        distribute_state(state, mesh)

    n_params = count_parameters(model)
    tracker.log_params({"num_network_params": n_params})
    print(f"DeepSpeech2 -- {n_params} parameters")

    # The JAX package's default microbatching (recognizer_accum_steps) was
    # measured on a TPU and does not carry over: the whole batch, unless the
    # config's accum_steps asks otherwise.
    accum = int(cfg.get("accum_steps", 1))
    common = dict(feature=feature, use_voicing=use_voicing, class_weights=class_weights,
                  device=device)
    train_step = make_recognition_train_step(
        criterion, target_key, logits_large_margins=cfg.get("logits_large_margins", 0.0),
        accum_steps=accum, schedule=cyclic_triangular_schedule(lr / 25, lr), mesh=mesh,
        **common)
    eval_step = make_recognition_eval_step(criterion, target_key, **common)

    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    best_dir = os.path.join(ckpt_dir, "best")
    best_metric, since_best = float("inf"), 0
    # Each data rank draws its own dropout and logit noise (rank 0 the
    # one-device run's).
    rank = mesh.data_index if mesh is not None else 0
    step_gen = torch.Generator(device=device).manual_seed(
        seed if rank == 0 else folded_seed(seed, rank))
    sharding = batch_sharding(mesh) if mesh is not None else None
    main = is_main_process()
    for epoch in range(cfg["num_epochs"]):
        loss_sum, weight_sum = 0.0, 0.0
        batches = loaders["train"] if sharding is None else prefetch_to_device(
            loaders["train"], sharding=sharding)
        for batch, meta in batches:
            metrics = train_step(state, batch, step_gen)
            w = float(meta.get("n_real", 1))  # sentence-weighted epoch mean
            loss_sum += w * float(metrics["loss"])
            weight_sum += w
        train_loss = loss_sum / weight_sum if weight_sum else float("nan")

        record = None
        if main:
            valid_info = run_recognition_test(state, eval_step, loaders["valid"], target_key,
                                              vocabulary)
            record = {
                "train_loss": train_loss,
                "train_manual_spmd": float(mesh is not None),
                "valid_loss": valid_info["loss"],
                "valid_edit_distance": valid_info["edit_distance"],
            }
        record = broadcast_object(record, mesh)
        tracker.log_metrics(record, step=epoch)
        print(f"epoch {epoch}: {record}")

        if record["valid_edit_distance"] < best_metric:
            best_metric, since_best = record["valid_edit_distance"], 0
            if main:
                save_checkpoint(best_dir, state,
                                aux={"epoch": epoch, "edit_distance": best_metric})
        else:
            since_best += 1
        if main:
            save_checkpoint(
                os.path.join(ckpt_dir, "last"),
                state,
                aux={"epoch": epoch, "best_metric": best_metric, "epochs_since_best": since_best},
            )
        barrier(mesh)
        if since_best > cfg.get("patience", 30):
            break
    if not main:
        return None

    state, _ = restore_checkpoint(best_dir, state)
    eval_step_f = make_recognition_eval_step(criterion, target_key, return_features=True,
                                             **common)
    info = run_recognition_test(
        state,
        eval_step_f,
        loaders["test"],
        target_key,
        vocabulary,
        outputs_dir=os.path.join(args.output_dir, "test_outputs"),
        collect_features=True,
    )
    tracker.log_dict(info, "test_results.json")
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Train DeepSpeech2 phoneme recognizer", main)
