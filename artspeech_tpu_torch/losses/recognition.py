"""Recognition losses: CTC and padded cross-entropy (counterpart of
artspeech_tpu/losses/recognition.py).

Equivalents of reference phoneme_recognition/metrics.py:87-121
(``CrossEntropyLoss`` with per-class weights over pad-masked frames) and the
CTC loss of train_phoneme_recognition.py:96-101.

The CTC loss is the function the JAX package computes with
``optax.ctc_loss``: the log-space alpha recursion over the blank-extended
labels, with impossible paths floored at ``log_epsilon = -1e5`` rather than
-inf. A target longer than its input therefore gives a finite loss of about
1e5 per sentence, which the JAX package's ``isfinite`` masking keeps; torch's
``CTCLoss(zero_infinity=True)`` gives it 0. The port follows the JAX
package. The recursion is plain torch, a loop over the frames; its gradients
come from autograd.
"""

import json
from typing import Optional

import torch

from artspeech_tpu_torch.utils.masks import make_padding_mask

#: optax.ctc_loss's stand-in for log(0).
LOG_EPSILON = -1e5


def _logaddexp_tail(phi: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
    """``phi[:, 1:]`` log-added with ``added``; ``phi[:, 0]`` as it is."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)


def ctc_per_sequence(log_probs, logit_paddings, labels, label_paddings, blank_id: int = 0):
    """``optax.ctc_loss``: (B,) negative log-likelihoods.

    Args:
        log_probs: (B, T, K) logits or log probabilities (normalised again).
        logit_paddings: (B, T), 1.0 on padded frames.
        labels: (B, N) label ids, right-padded.
        label_paddings: (B, N), 1.0 on padded labels.
    """
    b, _, _ = log_probs.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(log_probs, dim=-1)
    labellens = n - label_paddings.sum(dim=1).to(torch.int64)

    dtype = torch.promote_types(logprobs.dtype, torch.float32)  # optax's alphas: float32
    repeat = (labels[:, :-1] == labels[:, 1:]).to(dtype)
    repeat = torch.cat([repeat, repeat.new_zeros(b, 1)], dim=1)  # (B, N)

    phi_t = logprobs[:, :, blank_id].transpose(0, 1)[..., None]  # (T, B, 1)
    index = labels.to(torch.int64)[:, None, :].expand(-1, logprobs.shape[1], -1)
    emit_t = torch.gather(logprobs, 2, index).transpose(0, 1)  # (T, B, N)
    pads = logit_paddings.transpose(0, 1)[..., None] > 0  # (T, B, 1)

    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=dtype, device=logprobs.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, dtype=dtype, device=logprobs.device)
    to_phi_on_repeat = LOG_EPSILON * repeat
    to_phi_blank = LOG_EPSILON * (1.0 - repeat)
    for t in range(logprobs.shape[1]):
        phi_orig = phi
        # emit-to-phi epsilon transition, except if the next label repeats
        prev_phi = _logaddexp_tail(phi, emit + to_phi_on_repeat)
        # phi-to-emit transition and the self loop
        next_emit = torch.logaddexp(prev_phi[:, :-1] + emit_t[t], emit + emit_t[t])
        next_phi = prev_phi + phi_t[t]
        # emit-to-phi blank transition only when the next label repeats
        next_phi = _logaddexp_tail(next_phi, emit + phi_t[t] + to_phi_blank)
        emit = torch.where(pads[t], emit, next_emit)
        phi = torch.where(pads[t], phi_orig, next_phi)
    # the last epsilon transition
    phi_last = _logaddexp_tail(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


def _ctc_normalised(log_probs, targets, input_lengths, target_lengths, blank_id):
    """Per-sequence CTC loss over target length, zeroed where non-finite and
    on zero-length (padding) rows, and the valid-row weights."""
    t, n = log_probs.shape[1], targets.shape[1]
    dev = log_probs.device
    input_lengths = torch.as_tensor(input_lengths, device=dev)
    target_lengths = torch.as_tensor(target_lengths, device=dev)
    targets = torch.as_tensor(targets, device=dev)
    logit_paddings = 1.0 - make_padding_mask(input_lengths, t).to(log_probs.dtype)
    label_paddings = 1.0 - make_padding_mask(target_lengths, n).to(log_probs.dtype)
    per_seq = ctc_per_sequence(log_probs, logit_paddings, torch.clamp(targets, min=0),
                               label_paddings, blank_id=blank_id)
    per_seq = per_seq / torch.clamp(target_lengths.to(per_seq.dtype), min=1.0)
    valid = ctc_valid(target_lengths).to(per_seq.dtype)
    per_seq = torch.where(torch.isfinite(per_seq), per_seq, torch.zeros_like(per_seq)) * valid
    return per_seq, valid


def ctc_valid(target_lengths: torch.Tensor) -> torch.Tensor:
    """The rows that count in the CTC mean: those with a target."""
    return torch.as_tensor(target_lengths) > 0


def ctc_loss(log_probs, targets, input_lengths, target_lengths, blank_id: int = 0):
    """Mean CTC loss over the batch's real sentences.

    Args:
        log_probs: (B, T, K) log probabilities.
        targets: (B, N) label ids (padding value irrelevant, masked).
        input_lengths: (B,); target_lengths: (B,).
    Each sentence's loss is divided by its target length; non-finite losses
    are zeroed but counted, and rows with target length 0 (bucket padding)
    are left out of the mean.
    """
    per_seq, valid = _ctc_normalised(log_probs, targets, input_lengths, target_lengths, blank_id)
    return per_seq.sum() / torch.clamp(valid.sum(), min=1.0)


def ctc_loss_parts(log_probs, targets, input_lengths, target_lengths, blank_id: int = 0):
    """Numerator/denominator split of :func:`ctc_loss` — ``(sum of
    per-sequence normalized losses, valid-sequence count)``. Summing the
    parts over microbatches and dividing once reproduces the full-batch
    mean exactly (the denominator depends only on ``target_lengths``)."""
    per_seq, valid = _ctc_normalised(log_probs, targets, input_lengths, target_lengths, blank_id)
    return per_seq.sum(), valid.sum()


def load_class_weights(filepath: str, vocabulary) -> torch.Tensor:
    """Per-class CE weights from a {token: weight} JSON, aligned to the
    vocabulary's ids (BLANK at 0 and UNKNOWN at 1 in this repository's
    vocabularies). Tokens absent from the JSON (BLANK and UNKNOWN among them)
    weigh 1.0.

    Args:
        vocabulary: token -> id mapping (or an int class count for an
            all-ones vector).
    """
    with open(filepath) as f:
        class_weights = json.load(f)
    if isinstance(vocabulary, int):
        return torch.ones(vocabulary, dtype=torch.float32)
    weights = torch.ones(max(vocabulary.values()) + 1, dtype=torch.float32)
    for token, w in class_weights.items():
        if token in vocabulary:
            weights[vocabulary[token]] = float(w)
    return weights


def cross_entropy_weights(targets, input_lengths, t: int,
                          class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T) weight of each frame in the CE mean: its class weight on valid
    frames, 0 on padding. It depends on lengths and targets alone, so the
    accumulated train step takes the mean's denominator from it before any
    forward."""
    mask = make_padding_mask(torch.as_tensor(input_lengths), t).to(torch.float32)
    if class_weights is None:
        return mask
    tgt = torch.clamp(torch.as_tensor(targets), min=0)
    return class_weights.to(mask.device)[tgt] * mask


def cross_entropy_loss_parts(logits, targets, input_lengths, target_lengths=None,
                             class_weights: Optional[torch.Tensor] = None):
    """``(weighted NLL sum, weight sum)`` of the pad-masked frame-level CE,
    for exact microbatched accumulation."""
    dev = logits.device
    targets = torch.as_tensor(targets, device=dev)
    w = cross_entropy_weights(targets, torch.as_tensor(input_lengths, device=dev),
                              logits.shape[1], class_weights)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = torch.clamp(targets, min=0).to(torch.int64)
    nll = -torch.gather(logp, 2, tgt[..., None])[..., 0]  # (B, T)
    return (nll * w).sum(), w.sum()


def cross_entropy_loss(logits, targets, input_lengths, target_lengths=None,
                       class_weights: Optional[torch.Tensor] = None):
    """Pad-masked frame-level CE (frame-aligned targets, same T as inputs).

    Args:
        logits: (B, T, K) UNnormalized logits.
        targets: (B, T) int ids (padding masked via input_lengths).
    """
    num, den = cross_entropy_loss_parts(logits, targets, input_lengths,
                                        class_weights=class_weights)
    return num / torch.clamp(den, min=1.0)
