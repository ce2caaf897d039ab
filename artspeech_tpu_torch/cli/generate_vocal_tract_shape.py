"""Generate a synthetic articulation corpus from TextGrid phoneme sequences
(counterpart of artspeech_tpu/cli/generate_vocal_tract_shape.py).

Equivalent of reference generate_vocal_tract_shape_v2.py:270-450: run the
synthesis pipeline and write inference_contours / air_column / xarticul /
target_sequence.txt per sentence — the corpus later consumed by the
phoneme-recognition evaluation. All three methods: ``encoder_decoder``,
``mean_contour`` (``state_dict_filepath``: the mean_contour_table.npz) and
``autoencoder`` (the latent RNN -> frozen decoder -> denorm, with
``aux_model_params`` and ``norm_stats_dir``). ``save_plots`` /
``save_videos`` (``synth/viz.py``, ROADMAP Queue 1, item 5) raise
``NotImplementedError``.

Usage: python -m artspeech_tpu_torch.cli.generate_vocal_tract_shape \
           --config config.yaml [--device cpu]
"""

import torch

from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg, run_experiment
from artspeech_tpu_torch.cli.train_phoneme_to_principal_components import build_frozen_ae
from artspeech_tpu_torch.core.config import DATASET_CONFIG
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


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    if cfg.get("save_plots", False) or cfg.get("save_videos", False):
        raise NotImplementedError("save_plots / save_videos need synth/viz.py, which is not "
                                  "ported to artspeech_tpu_torch yet (ROADMAP Queue 1, item 5)")
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
    print(f"Synthesized {len(written)} sentences -> {cfg['save_to']}")
    return written


if __name__ == "__main__":
    run_experiment("Generate vocal tract shapes", main)
