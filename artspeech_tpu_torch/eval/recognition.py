"""Evaluation harness for the phoneme recognizer (counterpart of
artspeech_tpu/eval/recognition.py).

Equivalent of reference phoneme_recognition/__init__.py:156-329 (``run_test``):
PER (edit distance) + WIL over decoded sequences, grouped confusion matrices
over phonetic classes, and the substitution matrix with insertion/deletion
margins. The greedy decode runs in the eval step on the device (the beam
search, when asked for, too); this module aggregates on the host and writes
npy/json artifacts (the t-SNE plot only where sklearn and matplotlib are
installed).
"""

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from artspeech_tpu_torch.core.constants import CLASSES_NAMES, PHONETIC_CLASSES
from artspeech_tpu_torch.eval.decoders import beam_ctc_decode_device
from artspeech_tpu_torch.eval.recognition_metrics import (
    align_transitions,
    substitution_matrix,
    word_error_rate,
    word_information_lost,
)


def token_class_map(vocabulary: Dict[str, int]) -> Dict[int, int]:
    """Token id -> phonetic class id (reference __init__.py:410-432)."""
    other = max(PHONETIC_CLASSES) + 1
    mapping = {}
    for token, idx in vocabulary.items():
        cls = other
        for class_id, tokens in PHONETIC_CLASSES.items():
            if token in tokens:
                cls = class_id
                break
        mapping[idx] = cls
    return mapping


def grouped_confusion_matrix(
    pred_ids: Sequence[Sequence[int]],
    target_ids: Sequence[Sequence[int]],
    vocabulary: Dict[str, int],
) -> np.ndarray:
    """Confusion matrix over the 8 phonetic classes from aligned
    (substitution + match) pairs."""
    n_cls = len(CLASSES_NAMES)
    cmap = token_class_map(vocabulary)
    cm = np.zeros((n_cls, n_cls))
    for pred, tgt in zip(pred_ids, target_ids):
        p = [str(x) for x in pred]
        t = [str(x) for x in tgt]
        _, _, subs, matches = align_transitions(p, t)
        for ti, pi in subs + matches:
            cm[cmap.get(int(t[ti]), n_cls - 1), cmap.get(int(p[pi]), n_cls - 1)] += 1
    return cm


def _numpy(value):
    return value.detach().float().cpu().numpy() if value.is_floating_point() \
        else value.detach().cpu().numpy()


def run_recognition_test(
    state,
    eval_step,
    loader,
    target_key: str,
    vocabulary: Dict[str, int],
    outputs_dir: Optional[str] = None,
    use_beam: bool = False,
    beam_width: int = 16,
    collect_features: bool = False,
) -> Dict:
    """Evaluate; return {loss, edit_distance (PER), word_info_lost} and write
    substitution/confusion artifacts."""
    losses = []
    pred_strs: List[str] = []
    tgt_strs: List[str] = []
    pred_ids: List[List[int]] = []
    tgt_ids: List[List[int]] = []
    features: List[np.ndarray] = []
    feature_labels: List[np.ndarray] = []

    for batch, meta in loader:
        out = eval_step(state, batch)
        lengths = np.asarray(batch["input_lengths"])
        valid = lengths > 0
        losses.append(float(out["loss"]))

        if use_beam:
            # Prefix beam search on the device (decoders.py): exact merge,
            # no per-frame candidate restriction.
            toks, tlens = beam_ctc_decode_device(
                out["log_probs"], torch.as_tensor(lengths, device=out["log_probs"].device),
                beam_width=beam_width)
        else:
            toks, tlens = out["decoded"], out["decoded_lengths"]
        toks, tlens = _numpy(toks), _numpy(tlens)
        dec_ids = [list(map(int, toks[i, : tlens[i]])) for i in np.nonzero(valid)[0]]

        targets = np.asarray(batch[target_key])
        tlengths = np.asarray(batch[f"{target_key}_lengths"])
        for j, i in enumerate(np.nonzero(valid)[0]):
            t = list(map(int, targets[i, : tlengths[i]]))
            pred_ids.append(dec_ids[j])
            tgt_ids.append(t)
            pred_strs.append(" ".join(map(str, dec_ids[j])))
            tgt_strs.append(" ".join(map(str, t)))

        if collect_features and "features" in out:
            # Frame-aligned labels: the CTC target is collapsed and has no
            # frame alignment (reference uses a separate frame-aligned
            # plot_target, __init__.py:156-246). Prefer the acoustic /
            # articulatory targets, which align 1:1 with input frames.
            label_src = None
            for key in ("acoustic_target", "articulatory_target"):
                if key in batch:
                    label_src = np.asarray(batch[key])
                    break
            if label_src is not None:
                feats = _numpy(out["features"])
                for i in np.nonzero(valid)[0]:
                    L = min(int(lengths[i]), label_src.shape[1])
                    features.append(feats[i, :L])
                    feature_labels.append(label_src[i, :L])

    info = {
        "loss": float(np.mean(losses)) if losses else float("nan"),
        "edit_distance": word_error_rate(pred_strs, tgt_strs),
        "word_info_lost": word_information_lost(pred_strs, tgt_strs),
    }

    if outputs_dir is not None:
        os.makedirs(outputs_dir, exist_ok=True)
        id_vocab = [str(i) for i in sorted(vocabulary.values())]
        sub = substitution_matrix(
            pred_strs, tgt_strs, id_vocab, insertions_and_deletions="both"
        )
        np.save(os.path.join(outputs_dir, "substitution_matrix.npy"), sub)
        cm = grouped_confusion_matrix(pred_ids, tgt_ids, vocabulary)
        np.save(os.path.join(outputs_dir, "grouped_confusion_matrix.npy"), cm)
        with open(os.path.join(outputs_dir, "test_results.json"), "w") as f:
            json.dump(info, f, indent=2)
        with open(os.path.join(outputs_dir, "predictions.json"), "w") as f:
            json.dump(
                [{"pred": p, "target": t} for p, t in zip(pred_strs, tgt_strs)],
                f,
                indent=2,
            )
        if collect_features and features:
            np.savez(
                os.path.join(outputs_dir, "features.npz"),
                features=np.concatenate(features, axis=0),
                labels=np.concatenate(feature_labels, axis=0),
            )
            _maybe_tsne_plot(features, feature_labels, vocabulary, outputs_dir)
    return info


def _maybe_tsne_plot(features, labels, vocabulary, outputs_dir, max_points=2000):
    """t-SNE feature plot colored by phonetic class (reference
    __init__.py:332-407); skipped if sklearn or matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn.manifold import TSNE
    except Exception:
        return
    feats = np.concatenate(features, axis=0)
    labs = np.concatenate(labels, axis=0)
    if len(feats) > max_points:
        idx = np.random.default_rng(0).choice(len(feats), max_points, replace=False)
        feats, labs = feats[idx], labs[idx]
    if len(feats) < 5:
        return
    perplexity = min(30.0, (len(feats) - 1) / 3.0)
    try:
        emb = TSNE(
            n_components=2, init="pca", random_state=0, perplexity=perplexity
        ).fit_transform(feats)
    except Exception:
        return
    cmap = token_class_map(vocabulary)
    classes = np.array([cmap.get(int(l), len(CLASSES_NAMES) - 1) for l in labs])
    fig, ax = plt.subplots(figsize=(8, 8))
    for cls_id, name in CLASSES_NAMES.items():
        sel = classes == cls_id
        if sel.any():
            ax.scatter(emb[sel, 0], emb[sel, 1], s=4, label=name)
    ax.legend(markerscale=3)
    fig.savefig(os.path.join(outputs_dir, "tsne_features.png"), dpi=120)
    plt.close(fig)
