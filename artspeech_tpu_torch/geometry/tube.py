"""Vocal-tract tube (air column) walls (counterpart of artspeech_tpu/geometry/tube.py).

The 11 tube articulator contours (each (50, 2), normalized coordinates) map to
an internal and an external wall of ``wall_points`` points each. The internal
chain runs vocal folds -> thyroid cartilage -> epiglottis -> tongue -> lower
incisor -> lower lip; the external one arytenoid cartilage -> pharynx -> soft
palate -> upper incisor -> upper lip. Each contour is flipped where needed so
the chain runs continuously from glottis to lips, the chain is concatenated
and resampled to even arc length. Frames are a leading batch axis: the flips
are ``torch.where`` selects, with no per-frame host loop.
"""

from typing import Dict, List, Sequence, Tuple

import torch

from artspeech_tpu_torch.core.constants import (
    ARYTENOID_CARTILAGE,
    EPIGLOTTIS,
    LOWER_INCISOR,
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    THYROID_CARTILAGE,
    TONGUE,
    UPPER_INCISOR,
    UPPER_LIP,
    VOCAL_FOLDS,
)
from artspeech_tpu_torch.ops.resample import arclength_resample

INTERNAL_WALL_ORDER: List[str] = [
    VOCAL_FOLDS,
    THYROID_CARTILAGE,
    EPIGLOTTIS,
    TONGUE,
    LOWER_INCISOR,
    LOWER_LIP,
]

EXTERNAL_WALL_ORDER: List[str] = [
    ARYTENOID_CARTILAGE,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    UPPER_INCISOR,
    UPPER_LIP,
]


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).sum(dim=-1)


def _chain(contours: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate contours (..., N, 2) into one polyline, flipping for continuity.

    The first contour is oriented so its far end is closest to the next one;
    each later contour continues from the running endpoint.
    """
    first = contours[0]
    if len(contours) > 1:
        nxt = contours[1]
        approach = torch.minimum(_dist(nxt[..., 0, :], first[..., -1, :]),
                                 _dist(nxt[..., -1, :], first[..., -1, :]))
        approach_flipped = torch.minimum(_dist(nxt[..., 0, :], first[..., 0, :]),
                                         _dist(nxt[..., -1, :], first[..., 0, :]))
        flip = (approach_flipped < approach)[..., None, None]
        first = torch.where(flip, torch.flip(first, dims=[-2]), first)

    pieces = [first]
    end = first[..., -1, :]
    for contour in contours[1:]:
        flip = (_dist(contour[..., -1, :], end) < _dist(contour[..., 0, :], end))[..., None, None]
        oriented = torch.where(flip, torch.flip(contour, dims=[-2]), contour)
        pieces.append(oriented)
        end = oriented[..., -1, :]
    return torch.cat(pieces, dim=-2)


def generate_vocal_tract_tube(
    articulators_dict: Dict[str, torch.Tensor],
    wall_points: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Internal and external walls, each (..., wall_points, 2), from
    articulator name -> (..., 50, 2) contours."""
    internal = _chain([articulators_dict[a] for a in INTERNAL_WALL_ORDER])
    external = _chain([articulators_dict[a] for a in EXTERNAL_WALL_ORDER])
    return (
        arclength_resample(internal, wall_points),
        arclength_resample(external, wall_points),
    )


def generate_vocal_tract_tube_batch(stack: torch.Tensor, articulators: Sequence[str],
                                    wall_points: int = 100):
    """Tube walls for a batch of frames.

    Args:
        stack: (..., Nart, 2, 50) contour stacks in model-output layout.
        articulators: names matching the Nart axis.
    Returns:
        (internal, external): each (..., wall_points, 2).
    """
    contours = {name: stack[..., i, :, :].transpose(-1, -2) for i, name in enumerate(articulators)}
    return generate_vocal_tract_tube(contours, wall_points)
