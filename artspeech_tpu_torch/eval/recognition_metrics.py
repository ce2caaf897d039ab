"""Recognition metrics: PER (edit distance), WIL, accuracy/F1, and the
substitution-matrix machinery (copy of artspeech_tpu/eval/recognition_metrics.py).

Equivalents of reference phoneme_recognition/metrics.py:123-392. The
reference wraps torchmetrics ``word_error_rate`` / ``word_information_lost``
over token-id strings and drives the substitution analysis through a
Dijkstra shortest path over the edit matrix; here the DP alignment is
traced back directly (host-side numpy: reporting code, off the device).
"""

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def _tokens(s: Union[str, Sequence]) -> List[str]:
    return s.split() if isinstance(s, str) else [str(x) for x in s]


def edit_distance(pred: Sequence, target: Sequence) -> int:
    """Levenshtein distance between token sequences."""
    p, t = _tokens(pred), _tokens(target)
    dp = np.arange(len(t) + 1)
    for i in range(1, len(p) + 1):
        prev = dp.copy()
        dp[0] = i
        for j in range(1, len(t) + 1):
            dp[j] = (
                prev[j - 1]
                if p[i - 1] == t[j - 1]
                else 1 + min(prev[j], dp[j - 1], prev[j - 1])
            )
    return int(dp[-1])


def word_error_rate(preds, targets) -> float:
    """Corpus-level WER/PER: total edit distance / total target tokens
    (torchmetrics semantics used by reference metrics.py:123-136)."""
    if isinstance(preds, str):
        preds, targets = [preds], [targets]
    total_err = sum(edit_distance(p, t) for p, t in zip(preds, targets))
    total_len = sum(len(_tokens(t)) for t in targets)
    return total_err / max(total_len, 1)


def word_information_lost(preds, targets) -> float:
    """Corpus-level WIL = 1 - (C/N) * (C/P) with C total hits
    (torchmetrics semantics used by reference metrics.py:139-152)."""
    if isinstance(preds, str):
        preds, targets = [preds], [targets]
    total_hits = 0
    total_n = 0
    total_p = 0
    for pred, tgt in zip(preds, targets):
        p, t = _tokens(pred), _tokens(tgt)
        _, _, _, matches = align_transitions(p, t)
        total_hits += len(matches)
        total_n += len(t)
        total_p += len(p)
    if total_n == 0 or total_p == 0:
        return 1.0
    return 1.0 - (total_hits / total_n) * (total_hits / total_p)


def token_accuracy(preds: np.ndarray, targets: np.ndarray, mask=None) -> float:
    """Frame-level accuracy over valid positions."""
    preds, targets = np.asarray(preds), np.asarray(targets)
    if mask is None:
        mask = np.ones(targets.shape, bool)
    m = np.asarray(mask, bool)
    return float((preds[m] == targets[m]).mean()) if m.any() else 0.0


def align_transitions(
    pred: Sequence, target: Sequence
) -> Tuple[List[int], List[int], List[Tuple[int, int]], List[Tuple[int, int]]]:
    """Optimal-alignment transitions via DP traceback.

    Returns (deletions, insertions, substitutions, matches) where deletions
    hold target indices, insertions hold prediction indices and
    substitutions/matches are (target_idx, pred_idx) pairs — the same
    contract as reference metrics.py:273-321 (``compute_transitions``),
    computed by walking the edit-matrix backtrace instead of Dijkstra.
    """
    p, t = _tokens(pred), _tokens(target)
    np_, nt = len(p), len(t)
    dp = np.zeros((np_ + 1, nt + 1), np.int32)
    dp[:, 0] = np.arange(np_ + 1)
    dp[0, :] = np.arange(nt + 1)
    for i in range(1, np_ + 1):
        for j in range(1, nt + 1):
            cost = 0 if p[i - 1] == t[j - 1] else 1
            dp[i, j] = min(
                dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + cost
            )

    deletions: List[int] = []
    insertions: List[int] = []
    substitutions: List[Tuple[int, int]] = []
    matches: List[Tuple[int, int]] = []
    i, j = np_, nt
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
            0 if p[i - 1] == t[j - 1] else 1
        ):
            if p[i - 1] == t[j - 1]:
                matches.append((j - 1, i - 1))
            else:
                substitutions.append((j - 1, i - 1))
            i, j = i - 1, j - 1
        elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
            deletions.append(j - 1)
            j -= 1
        else:
            insertions.append(i - 1)
            i -= 1
    deletions.reverse()
    insertions.reverse()
    substitutions.reverse()
    matches.reverse()
    return deletions, insertions, substitutions, matches


def compute_transitions(preds, targets):
    """Batch version returning [(deletions, insertions, substitutions)]
    (reference metrics.py:294-321)."""
    if isinstance(preds, str):
        preds, targets = [preds], [targets]
    return [
        align_transitions(p, t)[:3] for p, t in zip(preds, targets)
    ]


def substitution_matrix(
    preds,
    targets,
    vocab: List[str],
    insertions_and_deletions: Optional[str] = None,
    normalize: Optional[str] = None,
) -> np.ndarray:
    """Substitution (confusion-like) matrix: rows = target tokens, cols =
    predicted tokens; optional extra row/col for insertions/deletions
    (reference metrics.py:324-392)."""
    if isinstance(preds, str):
        preds, targets = [preds], [targets]
    include_insertions = insertions_and_deletions in ("insertions", "both")
    include_deletions = insertions_and_deletions in ("deletions", "both")

    cm = np.zeros((len(vocab) + 1, len(vocab) + 1))
    index = {tok: i for i, tok in enumerate(vocab)}
    for pred, tgt in zip(preds, targets):
        p, t = _tokens(pred), _tokens(tgt)
        deletions, insertions, substitutions, matches = align_transitions(p, t)
        for tgt_i, pred_j in substitutions + matches:
            cm[index[t[tgt_i]], index[p[pred_j]]] += 1
        if include_deletions:
            for tgt_i in deletions:
                cm[index[t[tgt_i]], -1] += 1
        if include_insertions:
            for pred_j in insertions:
                cm[-1, index[p[pred_j]]] += 1

    with np.errstate(all="ignore"):
        if normalize == "true":
            cm = cm / cm.sum(axis=1, keepdims=True)
        elif normalize == "pred":
            cm = cm / cm.sum(axis=0, keepdims=True)
        elif normalize == "all":
            cm = cm / cm.sum()
        cm = np.nan_to_num(cm)
    return cm


def macro_f1(preds: np.ndarray, targets: np.ndarray, num_classes: int, mask=None) -> float:
    """Macro-averaged F1 over frame-level predictions (reference
    metrics.py:155-170 ``F1Score`` with torchmetrics MulticlassF1Score)."""
    preds, targets = np.asarray(preds).ravel(), np.asarray(targets).ravel()
    if mask is not None:
        m = np.asarray(mask, bool).ravel()
        preds, targets = preds[m], targets[m]
    f1s = []
    for c in range(num_classes):
        tp = np.sum((preds == c) & (targets == c))
        fp = np.sum((preds == c) & (targets != c))
        fn = np.sum((preds != c) & (targets == c))
        if tp + fp + fn == 0:
            continue
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1s.append(0.0 if precision + recall == 0 else 2 * precision * recall / (precision + recall))
    return float(np.mean(f1s)) if f1s else 0.0


def macro_auroc(probs: np.ndarray, targets: np.ndarray, num_classes: int, mask=None) -> float:
    """Macro one-vs-rest AUROC over frame-level class probabilities
    (reference metrics.py:185-197 ``AUROC``)."""
    probs = np.asarray(probs).reshape(-1, np.asarray(probs).shape[-1])
    targets = np.asarray(targets).ravel()
    if mask is not None:
        m = np.asarray(mask, bool).ravel()
        probs, targets = probs[m], targets[m]
    aucs = []
    for c in range(num_classes):
        pos = targets == c
        if not pos.any() or pos.all():
            continue
        score = probs[:, c]
        order = np.argsort(score)
        ranks = np.empty(len(score))
        ranks[order] = np.arange(1, len(score) + 1)
        n_pos, n_neg = pos.sum(), (~pos).sum()
        auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
        aucs.append(auc)
    return float(np.mean(aucs)) if aucs else 0.5
