"""Everything a run makes from ``--seed``: child seeds, the weights and the
traffic's lengths, tokens and target contours.

Every seed gives the same set of sizes: the lengths of a pool are a fixed
multiset (each length of the traffic's range equally often), which the seed
only shuffles into batches, so the work of a pool does not move with the
seed. Weights and batches are drawn on the device with a
``torch.Generator`` there, in a few large calls.
"""

import math

import numpy as np
import torch

#: Child seeds of one run, by purpose.
WEIGHTS, DATA, DROPOUT, SAMPLE = range(4)


def child_seeds(seed: int) -> list:
    """Four independent seeds (below 2**63) derived from ``seed``, which may
    be any whole number."""
    state = np.random.SeedSequence(int(seed) % 2**64).generate_state(4, dtype=np.uint64)
    return [int(s) & (2**63 - 1) for s in state]


def draw_weights(spec: dict, seed: int, device) -> dict:
    """Parameters named in ``spec`` (name -> (shape, centre, half width)),
    each uniform on centre +- half width, from one draw on ``device``."""
    sizes = [math.prod(shape) for shape, _, _ in spec.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    weights, offset = {}, 0
    for (name, (shape, centre, half)), n in zip(spec.items(), sizes):
        weights[name] = flat[offset:offset + n].view(shape).mul(half).add_(centre)
        offset += n
    return weights


def load_weights(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the program's model, which must hold exactly
    these names and shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise ValueError(f"parameter names differ: program only {missing}, benchmark only {extra}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, "
                                 f"benchmark {tuple(weights[name].shape)}")
            p.copy_(weights[name])


def pool_lengths(traffic: dict, seed: int) -> np.ndarray:
    """(pool, batch) sentence lengths: every length of
    [length_min, length_max] equally often over the pool, shuffled."""
    lo, hi = traffic["length_min"], traffic["length_max"]
    n = traffic["pool"] * traffic["batch"]
    span = hi - lo + 1
    if n % span:
        raise ValueError(f"pool x batch = {n} is not a multiple of the {span} lengths")
    lengths = np.repeat(np.arange(lo, hi + 1), n // span)
    np.random.default_rng(seed).shuffle(lengths)
    return lengths.reshape(traffic["pool"], traffic["batch"]).astype(np.int64)


def smooth_contours(lengths: torch.Tensor, t: int, n_art: int, n_samples: int,
                    gen: torch.Generator) -> torch.Tensor:
    """(N, T, Nart, 2, D) target contours in [0, 1], zero past each length:
    per sentence and articulator an arc whose centre drifts slowly over the
    frames."""
    n, dev = lengths.shape[0], lengths.device

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    theta = torch.linspace(0.0, math.pi, n_samples, device=dev)
    frames = torch.arange(t, device=dev, dtype=torch.float32)[None, :, None, None]
    centre = u(0.3, 0.7, n, 1, n_art, 2)
    radius = u(0.05, 0.2, n, 1, n_art, 2)
    phase = u(0.0, 2 * math.pi, n, 1, n_art, 1)
    period = u(20.0, 60.0, n, 1, 1, 1)
    drift = 0.1 * torch.sin(2 * math.pi * frames / period + phase)  # (N, T, Nart, 1)
    x = centre[..., 0:1] + drift + radius[..., 0:1] * torch.cos(theta)
    y = centre[..., 1:2] - drift + radius[..., 1:2] * torch.sin(theta)
    valid = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()
    return torch.clamp(torch.stack([x, y], dim=3), 0.0, 1.0) * valid[:, :, None, None, None]


def tokens(lengths: torch.Tensor, t: int, vocab: int, gen: torch.Generator) -> torch.Tensor:
    """(N, T) int32 token ids uniform over the vocabulary, 0 past each length."""
    ids = torch.randint(0, vocab, (lengths.shape[0], t), generator=gen, device=lengths.device,
                        dtype=torch.int32)
    valid = torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]
    return torch.where(valid, ids, torch.zeros_like(ids))


def train_pool(traffic: dict, cfg: dict, seed: int, device) -> list:
    """The pool of distinct training batches, on ``device``: dicts of
    ``tokens`` (B, T) int32, ``targets`` (B, T, Nart, 2, D) and ``lengths`` (B,)."""
    lengths = torch.as_tensor(pool_lengths(traffic, seed), device=device)
    p, b = lengths.shape
    t = traffic["bucket"]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = lengths.reshape(-1)
    tok = tokens(flat, t, cfg["vocab_size"], gen).reshape(p, b, t)
    tgt = smooth_contours(flat, t, len(cfg["articulators"]), cfg["n_samples"], gen)
    tgt = tgt.reshape(p, b, *tgt.shape[1:])
    return [{"tokens": tok[i], "targets": tgt[i], "lengths": lengths[i]} for i in range(p)]
