"""Fit classical per-articulator PCA and export PCAEncoder/PCADecoder params
(counterpart of artspeech_tpu/cli/train_articulatory_pca.py).

Equivalent of reference train_articulatory_PCA.py:38-202, with the sklearn
``IncrementalPCA.partial_fit`` loop replaced by one exact SVD per articulator
(ops/pca.py). The fitted {mean, eigenvectors, eigenvalues} are saved as the
state dicts of ``MultiEncoder``/``MultiDecoder`` with ``encoder_cls="PCA"``,
so downstream losses and wrappers load them exactly like trained AE params.
Host work only (numpy and LAPACK): ``--device`` is accepted and not used.

Usage: python -m artspeech_tpu_torch.cli.train_articulatory_pca --config cfg.yaml
"""

import json
import os

import numpy as np
import torch

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.data.pc_datasets import (
    AutoencoderDataset,
    compute_normalization_statistics,
    load_norm_stats,
)
from artspeech_tpu_torch.models.autoencoder import (
    MultiDecoder,
    MultiEncoder,
    normalize_indices_dict,
)
from artspeech_tpu_torch.ops.pca import explained_variance_ratio, fit_pca
from artspeech_tpu_torch.train.checkpoint import save_params
from artspeech_tpu_torch.utils.io import sequences_from_dict


def main(cfg, args, tracker):
    datadir = cfg["datadir"]
    database_name = cfg["database_name"]
    indices_dict = normalize_indices_dict(cfg["indices_dict"])
    articulators = sorted(indices_dict.keys())
    clip_tails = cfg.get("clip_tails", True)

    stats_dir = os.path.join(datadir, "normalization_statistics")
    if not os.path.isdir(stats_dir):
        compute_normalization_statistics(
            datadir, database_name, sequences_from_dict(datadir, cfg["train_seq_dict"]),
            articulators, clip_tails=clip_tails, save_to=stats_dir)
    norm_stats = load_norm_stats(datadir, articulators)

    dataset = AutoencoderDataset(
        datadir, database_name, sequences_from_dict(datadir, cfg["train_seq_dict"]),
        articulators, clip_tails=clip_tails, norm_stats=norm_stats)
    # All frames, per articulator: (N, 2*D).
    frames = np.stack([dataset[i]["inputs"] for i in range(len(dataset))])

    params, report = {}, {}
    for i, articulator in enumerate(articulators):
        x = frames[:, i, :]
        k = len(indices_dict[articulator])
        pca = fit_pca(x, k)
        evr = explained_variance_ratio(pca["eigenvalues"], float(x.var(axis=0).sum()))
        report[articulator] = {
            "num_components": k,
            "explained_variance_ratio": [float(v) for v in evr],
        }
        params[articulator] = {name: torch.from_numpy(v) for name, v in pca.items()}

    in_features = frames.shape[-1]
    encoder = MultiEncoder(indices_dict, in_features, encoder_cls="PCA", device="cpu")
    decoder = MultiDecoder(indices_dict, in_features, decoder_cls="PCA", device="cpu")
    for prefix, module in (("enc", encoder), ("dec", decoder)):
        module.load_state_dict({f"{prefix}_{a}.{name}": v for a, p in params.items()
                                for name, v in p.items()})
    out_dir = os.path.join(args.output_dir, "pca")
    save_params(os.path.join(out_dir, "encoder"), encoder)
    save_params(os.path.join(out_dir, "decoder"), decoder)
    with open(os.path.join(args.output_dir, "pca_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    tracker.log_dict(report, "pca_report.json")
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    run_experiment("Fit articulatory PCA", main)
