"""CTC decoders (counterpart of artspeech_tpu/eval/decoders.py).

- ``greedy_ctc_decode``: argmax -> collapse repeats -> drop blanks, batched
  on the device (reference decoders.py:9-42 ``TopKDecoder`` semantics);
  tokens are left-packed and padded with -1.
- ``beam_ctc_decode_device``: CTC prefix beam search batched on the device —
  a loop over time with (W, K) candidate tensors and an exact stay/extend
  merge (the reference uses the flashlight-backed
  ``torchaudio.models.decoder.ctc_decoder``, a CPU decoder).
- ``beam_ctc_decode``: host-side prefix beam search, the readable version
  the device decoder is held against.
"""

import math
from collections import defaultdict
from typing import List, Union

import numpy as np
import torch


def greedy_ctc_decode(emissions: torch.Tensor, lengths, blank_id: int = 0):
    """Batched greedy CTC decode.

    Args:
        emissions: (B, T, K) scores (logits or probabilities).
        lengths: (B,) valid lengths.
    Returns:
        (tokens, token_lengths): (B, T) int32 left-packed decoded ids padded
        with -1, and (B,) counts.
    """
    best = torch.argmax(emissions, dim=-1)  # (B, T)
    b, t = best.shape
    lengths = torch.as_tensor(lengths, device=best.device)
    valid = torch.arange(t, device=best.device)[None, :] < lengths[:, None]
    prev = torch.cat([torch.full_like(best[:, :1], -1), best[:, :-1]], dim=1)
    keep = (best != prev) & (best != blank_id) & valid  # (B, T)
    # Left-pack the kept tokens: position = cumsum of keep - 1; dropped
    # entries go to an extra column that is cut off.
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    scatter_pos = torch.where(keep, pos, torch.full_like(pos, t))
    out = torch.full((b, t + 1), -1, dtype=torch.int32, device=best.device)
    out.scatter_(1, scatter_pos, best.to(torch.int32))
    return out[:, :t], keep.sum(dim=1).to(torch.int32)


def decode_to_strings(tokens: np.ndarray, token_lengths: np.ndarray) -> List[str]:
    """Token-id arrays -> space-joined id strings (the reference compares
    PER over token-id 'sentences', metrics.py:57-84)."""
    return [
        " ".join(str(int(tok)) for tok in row[:length])
        for row, length in zip(np.asarray(tokens), np.asarray(token_lengths))
    ]


_NEG = -1.0e30  # -inf stand-in: survives additions without producing nan


def _top(scores: torch.Tensor, w: int) -> torch.Tensor:
    """Indices of the ``w`` largest scores along the last axis, in descending
    order, equal scores by lower index first (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :w]


def beam_ctc_decode_device(emissions: torch.Tensor, lengths, beam_width: int = 16,
                           blank_id: int = 0):
    """CTC prefix beam search batched on the device.

    Same semantics as :func:`beam_ctc_decode` with ``frame_candidates=None``
    (exact prefix-merging beam search over log-probabilities, no frame-level
    top-k restriction), as a loop over time with fixed shapes. The merge is
    exact because beams stay pairwise-distinct by construction, so the only
    possible collision at each step is an extend(w, k) candidate landing on
    an existing beam v with ``prefix_v == prefix_w + [k]`` — detected with a
    (W, W, T) masked prefix comparison and folded into v's stay score.

    Args:
        emissions: (B, T, K) LOG-probabilities.
        lengths: (B,) valid frame counts.
    Returns:
        (tokens, token_lengths): (B, T) int32 left-packed ids padded with
        -1, and (B,) counts — the convention of ``greedy_ctc_decode``.
    """
    logp_all = emissions.float()
    b, t, k = logp_all.shape
    w = beam_width
    dev = logp_all.device
    n_valid = torch.as_tensor(lengths, device=dev)
    pos = torch.arange(t, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    k_ids = torch.arange(k, device=dev)
    neg = torch.tensor(_NEG, device=dev)

    prefixes = torch.full((b, w, t), -1, dtype=torch.int64, device=dev)
    lens = torch.zeros(b, w, dtype=torch.int64, device=dev)
    p_b = torch.full((b, w), _NEG, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((b, w), _NEG, device=dev)

    for step in range(t):
        logp_t = logp_all[:, step]  # (B, K)
        p_tot = torch.logaddexp(p_b, p_nb)
        valid = p_tot > _NEG / 2
        last_at = torch.gather(prefixes, 2, torch.clamp(lens - 1, min=0)[..., None])[..., 0]
        last = torch.where(lens > 0, last_at, torch.full_like(last_at, -1))  # (B, W)
        last_c = torch.clamp(last, min=0)

        # stay candidates (prefix unchanged)
        stay_b = p_tot + logp_t[:, blank_id:blank_id + 1]
        stay_nb = torch.where(last >= 0, p_nb + torch.gather(logp_t, 1, last_c), neg)

        # extend candidates E[w, k]
        base = torch.where(k_ids[None, None, :] == last[..., None], p_b[..., None],
                           p_tot[..., None])
        ext = base + logp_t[:, None, :]
        ext[:, :, blank_id] = _NEG
        ext = torch.where(valid[..., None], ext, neg)

        # exact merge: extend(w, last_v) == stay(v) when
        # prefix_v == prefix_w + [last_v]
        len_ok = lens[:, :, None] == lens[:, None, :] + 1  # [v, w]
        pref_eq = torch.all(
            (prefixes[:, :, None, :] == prefixes[:, None, :, :])
            | (pos[None, None, None, :] >= lens[:, None, :, None]),
            dim=-1,
        )  # [v, w]: prefixes agree on the first len_w positions
        m = (len_ok & pref_eq & valid[:, :, None] & valid[:, None, :]
             & (last >= 0)[:, :, None])
        # ext_at_lastv[v, w] = ext[w, last_v]
        ext_at_lastv = torch.gather(ext.transpose(1, 2), 1,
                                    last_c[:, :, None].expand(-1, -1, w))
        contrib = torch.logsumexp(torch.where(m, ext_at_lastv, neg), dim=2)  # (B, V)
        stay_nb = torch.logaddexp(stay_nb, contrib)
        one_hot = (k_ids[None, None, :] == last_c[..., None]) & (last >= 0)[..., None]
        killed = torch.einsum("bvw,bvk->bwk", m.float(), one_hot.float()) > 0.5
        ext = torch.where(killed, neg, ext)

        scores = torch.cat([torch.logaddexp(stay_b, stay_nb), ext.reshape(b, -1)], dim=1)
        top = _top(scores, w)  # (B, W)
        is_stay = top < w
        parent = torch.where(is_stay, top, (top - w) // k)
        token = torch.where(is_stay, torch.full_like(top, -1), (top - w) % k)

        parent_lens = torch.gather(lens, 1, parent)
        new_prefixes = prefixes[rows, parent]
        new_lens = parent_lens + (~is_stay).to(torch.int64)
        insert = (pos[None, None, :] == parent_lens[..., None]) & (~is_stay)[..., None]
        new_prefixes = torch.where(insert, token[..., None], new_prefixes)
        new_p_b = torch.where(is_stay, torch.gather(stay_b, 1, parent), neg)
        new_p_nb = torch.where(is_stay, torch.gather(stay_nb, 1, parent),
                               torch.gather(ext.reshape(b, -1), 1, torch.clamp(top - w, min=0)))

        live = (step < n_valid)[:, None]  # (B, 1)
        prefixes = torch.where(live[..., None], new_prefixes, prefixes)
        lens = torch.where(live, new_lens, lens)
        p_b = torch.where(live, new_p_b, p_b)
        p_nb = torch.where(live, new_p_nb, p_nb)

    best = torch.argmax(torch.logaddexp(p_b, p_nb), dim=1)  # first of equal scores
    return (prefixes[torch.arange(b, device=dev), best].to(torch.int32),
            lens[torch.arange(b, device=dev), best].to(torch.int32))


def beam_ctc_decode(
    emissions: np.ndarray,
    lengths: np.ndarray,
    beam_width: int = 16,
    blank_id: int = 0,
    frame_candidates: Union[int, str, None] = "auto",
) -> List[List[int]]:
    """Host-side CTC prefix beam search over log-probabilities.

    Args:
        emissions: (B, T, K) log probabilities (np).
        frame_candidates: per-frame top-k candidate restriction (a speed
            heuristic matching flashlight-style decoders). ``"auto"`` keeps
            the historical ``max(beam_width, 4)``; ``None`` disables the
            restriction, making the search exact over the full vocabulary —
            the semantics ``beam_ctc_decode_device`` implements.
    Returns:
        best token sequence per batch element.
    """
    emissions = np.asarray(emissions)
    results = []
    for b in range(emissions.shape[0]):
        logp = emissions[b, : int(lengths[b])]
        results.append(
            _prefix_beam_search(logp, beam_width, blank_id, frame_candidates)
        )
    return results


def _prefix_beam_search(
    logp: np.ndarray,
    beam_width: int,
    blank_id: int,
    frame_candidates: Union[int, str, None] = "auto",
):
    T, K = logp.shape
    NEG = -math.inf
    if frame_candidates == "auto":
        frame_candidates = max(beam_width, 4)
    if frame_candidates is not None and frame_candidates < 1:
        # 0 / negative would silently select (nearly) the whole vocabulary
        # through the [-n:] slice idiom; demand an explicit None for exact.
        raise ValueError(f"frame_candidates must be >= 1 or None, got {frame_candidates}")
    # beams: prefix tuple -> (logp ending in blank, logp ending in non-blank)
    beams = {(): (0.0, NEG)}
    for t in range(T):
        new_beams = defaultdict(lambda: (NEG, NEG))
        if frame_candidates is None:
            top_k = list(range(K))
        else:
            # Restrict to top candidates at this frame for speed — but
            # ALWAYS include the blank, or live prefixes lose their "stay"
            # transition and probability mass is misallocated.
            top_k = list(np.argsort(logp[t])[-frame_candidates:])
            if blank_id not in top_k:
                top_k.append(blank_id)
        for prefix, (p_b, p_nb) in beams.items():
            p_tot = np.logaddexp(p_b, p_nb)
            for k in top_k:
                p_k = logp[t, k]
                if k == blank_id:
                    nb_b, nb_nb = new_beams[prefix]
                    new_beams[prefix] = (np.logaddexp(nb_b, p_tot + p_k), nb_nb)
                    continue
                new_prefix = prefix + (int(k),)
                nb_b, nb_nb = new_beams[new_prefix]
                if prefix and prefix[-1] == k:
                    # Repeating last token: only extend from blank-ending mass.
                    new_beams[new_prefix] = (nb_b, np.logaddexp(nb_nb, p_b + p_k))
                    sb_b, sb_nb = new_beams[prefix]
                    new_beams[prefix] = (sb_b, np.logaddexp(sb_nb, p_nb + p_k))
                else:
                    new_beams[new_prefix] = (nb_b, np.logaddexp(nb_nb, p_tot + p_k))
        beams = dict(
            sorted(
                new_beams.items(),
                key=lambda kv: -np.logaddexp(kv[1][0], kv[1][1]),
            )[:beam_width]
        )
    best = max(beams.items(), key=lambda kv: np.logaddexp(kv[1][0], kv[1][1]))
    return list(best[0])
