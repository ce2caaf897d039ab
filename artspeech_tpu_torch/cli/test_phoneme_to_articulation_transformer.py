"""Evaluate a trained transformer autoregressively on a held-out split
(counterpart of artspeech_tpu/cli/test_phoneme_to_articulation_transformer.py).

Equivalent of reference test_phoneme_to_articulation_transformer.py:29-129:
load the model's parameters (``state_dict_filepath``: ``<ckpts>/best/state``,
``<ckpts>/best`` or ``<ckpts>/best_model``), generate every test sentence with
the KV-cached decode (its attends on the flash decode-attention kernel on the
card), run the test harness with tract variables, dump json + per-sentence
contour/TV artifacts.

Config keys as the JAX CLI's, and:
- ``generate_batch_size`` (default: ``max(batch_size, 64)`` on ``cuda``,
  ``batch_size`` on ``--device cpu``, as JAX splits it between accelerator and
  host); dummy rows of length 0 fill short batches and count nowhere;
- ``generate_cache_dtype`` (default ``bfloat16``; ``float32``, ``fp32`` and
  ``none`` select float32 caches).

Usage: python -m artspeech_tpu_torch.cli.test_phoneme_to_articulation_transformer \
           --config cfg.yaml [--output_dir results] [--device cpu]
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
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer, make_auto_generate
from artspeech_tpu_torch.train.checkpoint import load_params
from artspeech_tpu_torch.utils.io import sequences_from_dict


def generate_batch_size(cfg, device) -> int:
    gen_bs = cfg.get("generate_batch_size")
    if gen_bs is None:
        gen_bs = max(cfg["batch_size"], 64) if device.type == "cuda" else cfg["batch_size"]
    return gen_bs


def cache_dtype_from_cfg(cfg):
    """``generate_cache_dtype`` -> the decode's ``cache_dtype`` (None: float32)."""
    cache_dtype = cfg.get("generate_cache_dtype", "bfloat16")
    return None if str(cache_dtype).lower() in ("float32", "fp32", "none") else cache_dtype


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    articulators = sorted(cfg["articulators"])
    n_samples = cfg.get("n_samples", 50)

    model = ArtSpeechTransformer(vocab_size=len(vocabulary), num_articulators=len(articulators),
                                 num_feat=2 * n_samples, **model_kwargs_from_cfg(cfg),
                                 device=device)
    model.load_state_dict(load_params(cfg["state_dict_filepath"]))

    dataset = ArtSpeechDataset(
        cfg["datadir"],
        database_name,
        sequences_from_dict(cfg["datadir"], cfg["test_seq_dict"]),
        vocabulary,
        articulators,
        clip_tails=cfg.get("clip_tails", True),
    )
    loader = BucketedLoader(dataset, batch_size=generate_batch_size(cfg, device), shuffle=False)
    generate = make_auto_generate(model, cache_dtype=cache_dtype_from_cfg(cfg), device=device)

    info = run_test(
        generate,
        loader,
        articulators,
        to_mm=mm_per_unit(DATASET_CONFIG[database_name]),
        outputs_dir=cfg.get("save_to", os.path.join(args.output_dir, "test_outputs", "0")),
        regularize_out=cfg.get("regularize_out", False),
        device=device,
    )
    with open(os.path.join(args.output_dir, "test_results.json"), "w") as f:
        json.dump(info, f, indent=2)
    tracker.log_dict(info, "test_results.json")
    print(json.dumps(info, indent=2))
    return info


if __name__ == "__main__":
    run_experiment("Test phoneme-to-articulation transformer", main)
