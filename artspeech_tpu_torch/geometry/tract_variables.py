"""Vocal-tract variables (TVs) from articulator contours, fully batched
(counterpart of artspeech_tpu/geometry/tract_variables.py).

Every TV of every frame of every sentence is one min-distance call over a
stack of contours (reference tract_variables.py:13-125 loops frames with
``torch.cdist`` and ``.item()``). The sub-contours are cut from the model's
channel-major layout (..., 2, 50); on CUDA each TV is one launch of the
min-distance kernel (ops/hopper_min_dist.py), on the CPU its plain version
runs. The places of constriction are gathered with ``torch.gather``.
"""

from typing import Dict, Optional

import torch

from artspeech_tpu_torch.core.constants import (
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    TONGUE,
    UPPER_INCISOR,
    UPPER_LIP,
)
from artspeech_tpu_torch.ops.distances import min_distance_channel_major

#: Sub-contour index windows (reference tract_variables.py:13-20).
ART_SLICES = {
    "tongue-tip": (30, 45),
    "tongue-body": (10, 30),
    "upper-incisor": (25, 50),
    "hard-palate": (0, 25),
    "soft-palate": (35, 50),
    "velum": (0, 15),
}


def _points(contour, index):
    """The points ``index`` (...,) of a channel-major (..., 2, N) contour -> (..., 2)."""
    return torch.gather(contour, -1, index[..., None, None].expand(*index.shape, 2, 1))[..., 0]


def _min_pair(arr1, arr2):
    """Min distance between channel-major point sets (..., 2, N) and
    (..., 2, M) -> value (...,), poc_1 (..., 2), poc_2 (..., 2): the two
    places of constriction (batched reference tract_variables.py:23-35)."""
    value, i1, i2 = min_distance_channel_major(arr1, arr2)
    return value, _points(arr1, i1), _points(arr2, i2)


def _cut(contour, name):
    return contour[..., slice(*ART_SLICES[name])]


def _tract_variables(contours: Dict[str, torch.Tensor]) -> Dict[str, Optional[dict]]:
    """LA, TTCD, TBCD and VEL from channel-major (..., 2, 50) contours."""
    tongue = contours[TONGUE]
    uincisor = contours[UPPER_INCISOR]
    soft_palate = contours[SOFT_PALATE_MIDLINE]

    la = _min_pair(contours[LOWER_LIP], contours[UPPER_LIP])
    ttcd = _min_pair(_cut(tongue, "tongue-tip"), _cut(uincisor, "upper-incisor"))
    palate = torch.cat([_cut(uincisor, "hard-palate"), _cut(soft_palate, "soft-palate")], dim=-1)
    tbcd = _min_pair(_cut(tongue, "tongue-body"), palate)
    vel = _min_pair(_cut(soft_palate, "velum"), contours[PHARYNX])

    def record(tv):
        return {"value": tv[0], "poc_1": tv[1], "poc_2": tv[2]}

    return {
        "LA": record(la),
        "LP": None,
        "TTCD": record(ttcd),
        "TTCL": None,
        "TBCD": record(tbcd),
        "TBCL": None,
        "VEL": record(vel),
        "GLO": None,
    }


def compute_tract_variables(contours: Dict[str, torch.Tensor]) -> Dict[str, Optional[dict]]:
    """Compute LA, TTCD, TBCD and VEL for a (batch of) frame(s).

    Args:
        contours: articulator name -> (..., 50, 2) point-major tensors. Must
            contain the six articulators in REQUIRED_ARTICULATORS_FOR_TVS.
    Returns:
        TV name -> {"value": (...,), "poc_1": (..., 2), "poc_2": (..., 2)};
        LP/TTCL/TBCL/GLO map to None exactly as in the reference
        (tract_variables.py:97-123, unimplemented there too).
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
