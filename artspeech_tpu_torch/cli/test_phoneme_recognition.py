"""Evaluate a trained recognizer, on a recorded corpus or a SYNTHESIZED one
(counterpart of artspeech_tpu/cli/test_phoneme_recognition.py, on one device).

Equivalent of reference test_phoneme_recognition.py:46-169, including the
evaluation-by-synthesis loop: with ``synthetic: true`` and ``datadir`` at a
``generate_vocal_tract_shape`` output directory (its ``save_to``), every
sentence found there is scored with PER/WIL. Writes substitution and
confusion artifacts under ``<output_dir>/test_outputs``.
``state_dict_filepath`` names a checkpoint of the port's trainer
(``results/checkpoints/best/state``) or a model-only ``state_dict``. As in
the JAX package, a recorded corpus is read without a temporary directory for
sentence wavs, so ``feature: melspec`` is refused by the dataset.

Usage: python -m artspeech_tpu_torch.cli.test_phoneme_recognition \\
           --config cfg.yaml [--output_dir results] [--device cpu]
"""

import json
import os

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.cli.train_phoneme_recognition import load_voiced_tokens
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.recognition import (
    TARGET_KEYS,
    PhonemeRecognitionDataset,
    RecognitionLoader,
    SyntheticPhonemeRecognitionDataset,
)
from artspeech_tpu_torch.eval.recognition import run_recognition_test
from artspeech_tpu_torch.losses.recognition import load_class_weights
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2
from artspeech_tpu_torch.train.checkpoint import load_params
from artspeech_tpu_torch.train.state import TrainState
from artspeech_tpu_torch.train.recognition_step import make_recognition_eval_step
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    feature = cfg.get("feature", "vocal_tract")
    criterion = cfg.get("loss", "ctc")
    target_key = TARGET_KEYS[cfg.get("target", "ctc")]

    # As in JAX, the top-level compute_dtype is not read here: only model_params.
    model_params = model_kwargs_from_cfg({"model_params": cfg.get("model_params")}, "model_params")
    model = DeepSpeech2(num_classes=len(vocabulary), **model_params, device=device)
    model.load_state_dict(load_params(cfg["state_dict_filepath"]))
    datadir = cfg["datadir"]
    common = dict(datadir=datadir, vocabulary=vocabulary, features=[feature],
                  voiced_tokens=load_voiced_tokens(cfg))
    if cfg.get("synthetic", False):
        dataset = SyntheticPhonemeRecognitionDataset(
            sequences=SyntheticPhonemeRecognitionDataset.sequences_from_corpus(datadir),
            database_name=cfg.get("database_name", "artspeech"), **common)
    else:
        dataset = PhonemeRecognitionDataset(
            sequences=sequences_from_dict(datadir, cfg["test_seq_dict"]),
            database_name=cfg["database_name"], **common)
    loader = RecognitionLoader(dataset, feature, batch_size=cfg.get("batch_size", 4),
                               shuffle=False)

    class_weights = None
    if cfg.get("class_weights_filepath"):
        class_weights = load_class_weights(cfg["class_weights_filepath"], vocabulary)
    eval_step = make_recognition_eval_step(
        criterion,
        target_key,
        feature=feature,
        use_voicing=cfg.get("use_voicing", False),
        class_weights=class_weights,
        return_features=True,
        device=device,
    )
    info = run_recognition_test(
        TrainState(model=model, optimizer=None),
        eval_step,
        loader,
        target_key,
        vocabulary,
        outputs_dir=os.path.join(args.output_dir, "test_outputs"),
        use_beam=cfg.get("use_beam", False),
        collect_features=True,
    )
    tracker.log_dict(info, "test_results.json")
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Test DeepSpeech2 phoneme recognizer", main)
