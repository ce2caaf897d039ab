"""Generate a synthetic articulation corpus from TextGrid phoneme sequences
(counterpart of artspeech_tpu/cli/generate_vocal_tract_shape.py).

Equivalent of reference generate_vocal_tract_shape_v2.py:270-450: run the
synthesis pipeline and write inference_contours / air_column / xarticul /
target_sequence.txt per sentence — the corpus later consumed by the
phoneme-recognition evaluation. All three methods: ``encoder_decoder``,
``mean_contour`` (``state_dict_filepath``: the mean_contour_table.npz) and
``autoencoder`` (the latent RNN -> frozen decoder -> denorm, with
``aux_model_params`` and ``norm_stats_dir``). ``save_plots`` writes one
jpg a frame under each sentence's ``vocal_tract_shapes/`` and
``save_videos`` one ``<sentence>.avi`` (``synth/viz.py``), as in JAX; where
matplotlib (or, for videos, cv2) is missing, the CLI raises a
``RuntimeError`` naming it after the corpus is written, where JAX writes no
plots and says nothing.

Usage: python -m artspeech_tpu_torch.cli.generate_vocal_tract_shape \
           --config config.yaml [--device cpu]
"""

import os

import numpy as np
import torch

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.cli.train_phoneme_to_principal_components import build_frozen_ae
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import UPPER_INCISOR
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.pc_datasets import load_norm_stats, stack_norm_stats
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.autoencoder import normalize_indices_dict
from artspeech_tpu_torch.models.mean_contour import MeanContourTable, make_mean_contour_forward
from artspeech_tpu_torch.models.latent_rnn import (
    PrincipalComponentsArtSpeech,
    make_latent_rnn_synthesis_forward,
)
from artspeech_tpu_torch.synth.pipeline import SynthesisDataset, synthesize_corpus
from artspeech_tpu_torch.synth.viz import (
    make_vocal_tract_shape_video,
    missing_packages,
    save_vocal_tract_shapes,
)
from artspeech_tpu_torch.train.checkpoint import load_params
from artspeech_tpu_torch.utils.io import sequences_from_dict


def build_forward(cfg, vocabulary, articulators, device):
    method = cfg.get("method", "encoder_decoder")
    if method == "encoder_decoder":
        model = ArtSpeech(vocab_size=len(vocabulary), n_articulators=len(articulators),
                          **model_kwargs_from_cfg(cfg, "model_params"), device=device)
        model.load_state_dict(load_params(cfg["state_dict_filepath"]))
        return model
    if method == "mean_contour":
        return make_mean_contour_forward(MeanContourTable.load(cfg["state_dict_filepath"]),
                                         device=device)
    if method == "autoencoder":
        # Latent RNN -> frozen decoder -> denorm (reference v2:331-350).
        indices_dict = normalize_indices_dict(cfg["indices_dict"])
        arts = sorted(indices_dict.keys())
        norm_stats = load_norm_stats(cfg.get("norm_stats_dir") or cfg["datadir"], arts)
        denorm_mean, denorm_std = stack_norm_stats(norm_stats, arts)
        # aux_model_params carries the frozen AE's widths (reference
        # generate_vocal_tract_shape_autoencoder.yaml aux_model_params).
        ae_cfg = {**cfg, **(cfg.get("aux_model_params") or {})}
        _, decode_fn = build_frozen_ae(ae_cfg, indices_dict, require_encoder=False, device=device)
        rnn = PrincipalComponentsArtSpeech(len(vocabulary), indices_dict,
                                           **model_kwargs_from_cfg(cfg, "model_params"),
                                           device=device)
        rnn.load_state_dict(load_params(cfg["state_dict_filepath"]))
        return make_latent_rnn_synthesis_forward(
            rnn, decode_fn, torch.as_tensor(denorm_mean, device=device),
            torch.as_tensor(denorm_std, device=device),
            rescale_factor=cfg.get("rescale_factor", 1.0))
    raise ValueError(f"Unknown synthesis method: {method}")


def render(cfg, written, articulators, framerate):
    """Per-sentence plots and .avi videos of the written contours (reference
    generate_vocal_tract_shape.py:80-164 / _v2:404-417)."""
    full_arts = sorted(set(articulators) | {UPPER_INCISOR})
    for sentence_dir in written:
        with open(os.path.join(sentence_dir, "target_sequence.txt")) as f:
            phonemes = f.read().split()
        outputs = np.stack([  # (T, Nart, 2, D)
            np.stack([np.load(os.path.join(sentence_dir, "inference_contours",
                                           f"{t + 1:04d}_{a}.npy")) for a in full_arts])
            for t in range(len(phonemes))])
        if cfg.get("save_plots", False) and not save_vocal_tract_shapes(
                full_arts, outputs, phonemes, os.path.join(sentence_dir, "vocal_tract_shapes")):
            raise RuntimeError("save_plots needs matplotlib, which is not installed")
        if cfg.get("save_videos", False) and not make_vocal_tract_shape_video(
                full_arts, outputs, phonemes,
                os.path.join(sentence_dir, os.path.basename(sentence_dir) + ".avi"),
                framerate=framerate):
            raise RuntimeError(f"save_videos needs cv2 and matplotlib; not installed: "
                               f"{', '.join(missing_packages('cv2', 'matplotlib'))}")


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    database_name = cfg["database_name"]
    vocabulary = load_vocabulary(cfg["vocab_filepath"])
    articulators = sorted(cfg["articulators"])

    dataset = SynthesisDataset(
        cfg["datadir"],
        database_name,
        sequences_from_dict(cfg["datadir"], cfg["seq_dict"]),
        vocabulary,
        articulators,
    )
    forward = build_forward(cfg, vocabulary, articulators, device)
    written = synthesize_corpus(
        forward,
        dataset,
        cfg["save_to"],
        DATASET_CONFIG[database_name],
        regularize_outputs=cfg.get("regularize_outputs", True),
        batch_size=cfg.get("batch_size", 8),
        device=device,
    )
    if cfg.get("save_plots", False) or cfg.get("save_videos", False):
        render(cfg, written, articulators, DATASET_CONFIG[database_name].FRAMERATE)
    print(f"Synthesized {len(written)} sentences -> {cfg['save_to']}")
    return written


if __name__ == "__main__":
    run_experiment("Generate vocal tract shapes", main)
