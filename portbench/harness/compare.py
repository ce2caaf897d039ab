"""The numbers that decide ``correct``, each held to its limit.

Training cells compare the program's first steps with the plain
reference's (``train_gaps``); served cells compare each sampled answer
(``widest_gap``). Each number is a gap that a sound run keeps small.
"""

import math
import statistics

import torch


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def _gap(got: float, want: float, scale: float) -> float:
    """|got - want| / scale, infinite where it is not a number."""
    gap = abs(got - want) / max(scale, 1e-30)
    return gap if math.isfinite(gap) else math.inf


def train_gaps(program: dict, reference: dict, weights: dict) -> dict:
    """``program`` and ``reference``: {"losses": [...], "grads": {leaf: first
    gradient}, "params": {leaf: parameters after the steps}}; ``weights``
    the parameters both started from. Returns

    - ``loss_gap``: the widest relative gap of a step's loss;
      ``first_loss_gap`` that of the first step's alone;
    - ``grad_gap``: over the leaves, the widest gap between the program's
      and the reference's norm of the first gradient, over the reference's
      norm of that leaf or of the median leaf, whichever is larger;
      ``median_grad_gap`` the median leaf's of those gaps;
    - ``change_gap`` and ``median_change_gap``: the same of the parameters'
      change over the steps, over the leaves whose reference gradient is at
      least a thousandth of the median leaf's (a leaf the loss does not
      reach, such as a key's bias under softmax, moves under Adam by
      round-off alone).
    """
    same_steps = len(program["losses"]) == len(reference["losses"])
    loss = [_gap(p, r, abs(r)) for p, r in zip(program["losses"], reference["losses"])]
    g_ref, g_prog = _norms(reference["grads"]), _norms(program["grads"])
    g_med = statistics.median(g_ref.values())
    grad = [_gap(g_prog[k], g_ref[k], max(g_ref[k], g_med)) for k in g_ref]
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_ref = _norms({k: reference["params"][k] - weights[k] for k in moved})
    d_prog = _norms({k: program["params"][k] - weights[k] for k in moved})
    d_med = statistics.median(d_ref.values())
    change = [_gap(d_prog[k], d_ref[k], max(d_ref[k], d_med)) for k in moved]
    return {"loss_gap": max(loss) if same_steps else math.inf,
            "first_loss_gap": loss[0],
            "grad_gap": max(grad), "median_grad_gap": statistics.median(grad),
            "change_gap": max(change), "median_change_gap": statistics.median(change),
            "leaves_left_out": len(g_ref) - len(moved)}


def widest_gap(got: torch.Tensor, want: torch.Tensor, valid: torch.Tensor) -> float:
    """The widest absolute gap over the valid frames: ``got`` and ``want``
    (B, T, ...), ``valid`` (B, T) booleans. A non-finite value is an
    infinite gap."""
    diff = (got.float() - want.float()).abs()
    diff = torch.where(torch.isfinite(diff), diff, torch.full_like(diff, math.inf))
    diff = diff[valid]
    return float(diff.max()) if diff.numel() else 0.0


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limited number; a number without
    a limit in ``limits`` is not compared."""
    return {k: {"value": float(numbers.get(k, math.inf)), "limit": limits[k]} for k in limits}


def all_within(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
