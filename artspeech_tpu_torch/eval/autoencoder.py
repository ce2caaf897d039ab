"""Evaluation harnesses for the autoencoder / principal-components method
(counterpart of artspeech_tpu/eval/autoencoder.py).

Equivalents of reference principal_components/evaluation.py:106-443
(``run_multiart_autoencoder_test``, ``run_phoneme_to_principal_components_test``)
and the nomogram analysis of test_principal_components_autoencoder.py:32-321.

The latent-RNN test is the articulation test harness (``eval/articulation.
run_test``: per-sentence metrics, upper-incisor injection, tract variables on
the min-distance kernel under ``torch.inference_mode``, contour and TV
artifacts) run on the synthesis forward (RNN -> frozen decoder -> denorm)
with denormalized targets. Plots need matplotlib; where it is missing the
harness says so on the log and writes the arrays alone.
"""

import json
import logging
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.data.batching import prefetch_to_device
from artspeech_tpu_torch.eval.articulation import run_test
from artspeech_tpu_torch.models.latent_rnn import make_latent_rnn_synthesis_forward
from artspeech_tpu_torch.ops.distances import mean_p2cp_channel_major

logger = logging.getLogger(__name__)


def run_autoencoder_test(state, eval_step, dataset, batch_size: int, denorm_mean, denorm_std,
                         to_mm: float, articulators: Sequence[str],
                         outputs_dir: Optional[str] = None, n_samples: int = 50,
                         device: DeviceLike = None) -> Dict:
    """Frame-AE test: per-articulator reconstruction p2cp_mm + latent
    covariance matrix (reference evaluation.py:106-280). ``eval_step`` from
    ``make_autoencoder_eval_step``; the per-articulator P2CP runs on the
    device (the P2CP kernel on CUDA)."""
    dev = resolve_device(device)
    arts = sorted(articulators)
    mean, std = (torch.as_tensor(v, device=dev) for v in (denorm_mean, denorm_std))
    losses, all_latents, per_art_p2cp = [], [], []
    for batch, meta in prefetch_to_device(dataset.batches(batch_size, shuffle=False), device=dev):
        metrics, (recon, latents) = eval_step(state, batch)
        n = meta["n_valid"]
        losses.append(float(metrics["loss"]))
        b = recon.shape[0]
        with torch.no_grad():
            r = recon.reshape(b, len(arts), 2, n_samples) * std + mean
            t = batch["inputs"].reshape(b, len(arts), 2, n_samples) * std + mean
            p2cp = mean_p2cp_channel_major(r, t)[:n]  # (n, Nart)
        per_art_p2cp.append(p2cp.cpu().numpy() * to_mm)
        all_latents.append(latents[:n].cpu().numpy())

    latents = np.concatenate(all_latents, axis=0)
    p2cp_mm = np.concatenate(per_art_p2cp, axis=0)
    info = {"loss": float(np.mean(losses)), "p2cp_mm": float(p2cp_mm.mean())}
    for i, art in enumerate(arts):
        info[art] = {"p2cp_mm": float(p2cp_mm[:, i].mean())}

    if outputs_dir is not None:
        os.makedirs(outputs_dir, exist_ok=True)
        cov = np.cov(latents.T)
        np.save(os.path.join(outputs_dir, "latent_covariance.npy"), cov)
        np.save(os.path.join(outputs_dir, "latents.npy"), latents)
        with open(os.path.join(outputs_dir, "test_results.json"), "w") as f:
            json.dump(info, f, indent=2)
        _plot_cov(cov, outputs_dir)
    return info


def nomograms(decode_fn: Callable, latent_size: int, denorm_mean, denorm_std,
              sweep=np.linspace(-1.0, 1.0, 9), device: DeviceLike = None) -> Dict[int, np.ndarray]:
    """Per-component decoder sweep: latent i in [-1, 1], others 0
    (reference test_principal_components_autoencoder.py nomogram analysis).

    Returns {component: (len(sweep), Nart, 2, D) denormalized contours} —
    computed in ONE batched decode over all (component, value) pairs.
    """
    dev = resolve_device(device)
    k = len(sweep)
    z = np.zeros((latent_size * k, latent_size), np.float32)
    for i in range(latent_size):
        z[i * k:(i + 1) * k, i] = sweep
    with torch.no_grad():
        shapes = decode_fn(torch.as_tensor(z, device=dev)).cpu().numpy()  # (L*k, Nart, 2*D)
    n_art = shapes.shape[1]
    shapes = shapes.reshape(latent_size, k, n_art, 2, shapes.shape[2] // 2)
    shapes = shapes * np.asarray(denorm_std) + np.asarray(denorm_mean)
    return {i: shapes[i] for i in range(latent_size)}


def _denormalized_targets(loader, denorm_mean, denorm_std):
    """The loader's batches with targets denormalized on the host."""
    for batch, meta in loader:
        yield {**batch, "targets": batch["targets"] * denorm_std + denorm_mean}, meta


def run_latent_rnn_test(model, decode_fn: Callable, loader, articulators: Sequence[str],
                        denorm_mean, denorm_std, to_mm: float, rescale_factor: float = 1.0,
                        outputs_dir: Optional[str] = None, n_samples: int = 50,
                        device: DeviceLike = None) -> Dict:
    """Latent-RNN test: decode, denorm, inject incisor, per-articulator
    metrics + TV/contour dumps (reference evaluation.py:283-443).

    ``model`` is a ``PrincipalComponentsArtSpeech`` on ``device``;
    ``decode_fn`` the frozen decoder; ``denorm_mean``/``denorm_std`` numpy
    (Nart, 2, D). Returns {articulator: {x_corr, y_corr, p2cp, p2cp_mm, med,
    med_mm}, p2cp_mm}.
    """
    dev = resolve_device(device)
    mean = np.asarray(denorm_mean, np.float32)
    std = np.asarray(denorm_std, np.float32)
    forward = make_latent_rnn_synthesis_forward(
        model, decode_fn, torch.as_tensor(mean, device=dev), torch.as_tensor(std, device=dev),
        n_samples=n_samples, rescale_factor=rescale_factor)
    info = run_test(forward, _denormalized_targets(loader, mean, std), articulators, to_mm,
                    outputs_dir=outputs_dir, device=dev)
    del info["loss"]  # the reference's latent-RNN test reports no contour loss
    info["p2cp_mm"] = float(np.mean([info[a]["p2cp"] for a in sorted(articulators)]) * to_mm)
    return info


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (logged) where
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed: plots are not written, arrays are")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_cov(cov: np.ndarray, outputs_dir: str):
    plt = _pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.abs(cov), cmap="magma")
    fig.colorbar(im)
    ax.set_title("|latent covariance|")
    fig.savefig(os.path.join(outputs_dir, "latent_covariance.png"), dpi=120)
    plt.close(fig)


def plot_nomograms(noms: Dict[int, np.ndarray], articulators: Sequence[str], outputs_dir: str):
    """Per-component contour sweep figures (reference
    test_principal_components_autoencoder.py nomogram plots)."""
    from artspeech_tpu_torch.core.constants import COLORS

    plt = _pyplot()
    if plt is None:
        return
    plots_dir = os.path.join(outputs_dir, "nomograms")
    os.makedirs(plots_dir, exist_ok=True)
    arts = sorted(articulators)
    for comp, sweep in noms.items():
        fig, ax = plt.subplots(figsize=(6, 6))
        k = sweep.shape[0]
        for s_idx in range(k):
            alpha = 0.25 + 0.75 * s_idx / max(k - 1, 1)
            for i, art in enumerate(arts):
                ax.plot(sweep[s_idx, i, 0], sweep[s_idx, i, 1], color=COLORS.get(art, "black"),
                        alpha=alpha, linewidth=1)
        ax.invert_yaxis()
        ax.axis("off")
        ax.set_title(f"component {comp}")
        fig.savefig(os.path.join(plots_dir, f"component_{comp}.jpg"), dpi=100)
        plt.close(fig)
