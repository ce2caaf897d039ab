"""Vocal-tract variables (TVs) from articulator contours, fully batched
(counterpart of artspeech_tpu/geometry/tract_variables.py).

Every TV of every frame of every sentence is one min-distance problem over a
stack of contours (reference tract_variables.py:13-125 loops frames with
``torch.cdist`` and ``.item()``). The four TVs are one table of problems
(:func:`tv_table`, from ``ART_SLICES``): on CUDA one launch of the
min-distance kernel takes them all, reading each sub-contour in place from
the model's channel-major layout (..., 2, 50) and writing the values and
the places of constriction (ops/hopper_min_dist.py:min_distance_windows); on
the CPU its plain version cuts the windows, concatenates the palate and
gathers the places of constriction.
"""

from typing import Dict, Mapping, Optional

import torch

from artspeech_tpu_torch.core.constants import (
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    TONGUE,
    UPPER_INCISOR,
    UPPER_LIP,
)
from artspeech_tpu_torch.ops.hopper_min_dist import Window, min_distance_windows

#: Sub-contour index windows (reference tract_variables.py:13-20).
ART_SLICES = {
    "tongue-tip": (30, 45),
    "tongue-body": (10, 30),
    "upper-incisor": (25, 50),
    "hard-palate": (0, 25),
    "soft-palate": (35, 50),
    "velum": (0, 15),
}


#: Each TV's u window and v windows (the v windows read as one set, in
#: order): (articulator, ART_SLICES name, or None for the whole contour).
TV_WINDOWS = {
    "LA": ((LOWER_LIP, None), ((UPPER_LIP, None),)),
    "TTCD": ((TONGUE, "tongue-tip"), ((UPPER_INCISOR, "upper-incisor"),)),
    "TBCD": ((TONGUE, "tongue-body"), ((UPPER_INCISOR, "hard-palate"),
                                       (SOFT_PALATE_MIDLINE, "soft-palate"))),
    "VEL": ((SOFT_PALATE_MIDLINE, "velum"), ((PHARYNX, None),)),
}
#: The TVs in the reference's order; LP, TTCL, TBCL and GLO are None there
#: too (tract_variables.py:97-123, unimplemented).
TV_NAMES = ("LA", "LP", "TTCD", "TTCL", "TBCD", "TBCL", "VEL", "GLO")


def tv_table(points: Mapping[str, int]):
    """The TVs of TV_WINDOWS as a table of min-distance problems.

    Args:
        points: articulator name -> its contour's number of points, for the
            articulators at hand (a stack's in its Nart order).
    Returns:
        (sources, problems): the names of the contours the TVs read, in
        first use; and for each TV of TV_WINDOWS, in order, its (u window, v
        windows) as ``Window(source, start, count)`` over those sources.
    """
    sources = []

    def window(name, part):
        if name not in sources:
            sources.append(name)
        span = range(points[name])[slice(*ART_SLICES[part])] if part else range(points[name])
        return Window(sources.index(name), span.start, len(span))

    problems = [(window(*u), tuple(window(*w) for w in vs)) for u, vs in TV_WINDOWS.values()]
    return sources, problems


def _tract_variables(contours: Dict[str, torch.Tensor]) -> Dict[str, Optional[dict]]:
    """LA, TTCD, TBCD and VEL from channel-major (..., 2, N) contours."""
    names, problems = tv_table({name: c.shape[-1] for name, c in contours.items()})
    out = min_distance_windows([contours[name] for name in names], problems)
    tvs = dict.fromkeys(TV_NAMES)
    for name, tv in zip(TV_WINDOWS, out):
        tvs[name] = {"value": tv[..., 0], "poc_1": tv[..., 1:3], "poc_2": tv[..., 3:5]}
    return tvs


def compute_tract_variables(contours: Dict[str, torch.Tensor]) -> Dict[str, Optional[dict]]:
    """Compute LA, TTCD, TBCD and VEL for a (batch of) frame(s).

    Args:
        contours: articulator name -> (..., 50, 2) point-major tensors. Must
            contain the six articulators in REQUIRED_ARTICULATORS_FOR_TVS.
    Returns:
        TV name -> {"value": (...,), "poc_1": (..., 2), "poc_2": (..., 2)};
        LP/TTCL/TBCL/GLO map to None exactly as in the reference
        (tract_variables.py:97-123, unimplemented there too). On CUDA the
        values and points are f32 (a bf16 contour's points widened exactly).
    """
    return _tract_variables({name: c.transpose(-1, -2) for name, c in contours.items()})


def tract_variables_from_stack(stack, articulators):
    """Compute TVs from a stacked contour tensor.

    Args:
        stack: (..., Nart, 2, 50) model-output layout.
        articulators: names matching the Nart axis (sorted order).
    Returns:
        same structure as :func:`compute_tract_variables`.
    """
    return _tract_variables({name: stack[..., i, :, :] for i, name in enumerate(articulators)})
