"""Tail clipping of articulator contours (host-side numpy; copy of
artspeech_tpu/data/tail_clipper.py).

Port of reference phoneme_to_articulation/tail_clipper.py:7-128 semantics:
removes anatomically meaningless contour tails using reference articulators,
then resamples back to 50 points with nearest-neighbour index resampling
(torch ``F.interpolate`` default mode). The reference's literal behavior is
preserved, including which clips resample and the upper-lip thresholds that
omit the /RES factor (tail_clipper.py:102,118).
"""

from typing import Dict

import numpy as np

from artspeech_tpu_torch.core.config import DatasetConfig
from artspeech_tpu_torch.core.constants import EPIGLOTTIS, LOWER_INCISOR, UPPER_INCISOR
from artspeech_tpu_torch.ops.resample import resample_nearest_np

TAIL_CLIP_REFERENCES = [LOWER_INCISOR, UPPER_INCISOR, EPIGLOTTIS]


class TailClipper:
    TAIL_CLIP_REFERENCES = TAIL_CLIP_REFERENCES

    def __init__(self, dataset_config: DatasetConfig):
        self.dataset_config = dataset_config

    def _resample(self, contour: np.ndarray, n: int = 50) -> np.ndarray:
        return resample_nearest_np(contour, n)

    @staticmethod
    def _keep(filtered: np.ndarray, original: np.ndarray) -> np.ndarray:
        """Guard against clips that would delete an entire contour half
        (possible on out-of-distribution contours; torch would crash in
        F.interpolate on an empty tensor)."""
        return filtered if len(filtered) > 0 else original

    def clip_tongue_tails(
        self, tongue, lower_incisor=None, epiglottis=None, **kwargs
    ) -> np.ndarray:
        """Reference tail_clipper.py:13-49."""
        cfg = self.dataset_config
        # Front tail vs lower incisor highest point.
        ref = lower_incisor[lower_incisor[:, 1].argmax()]
        first, second = tongue[:25], tongue[25:]
        second = self._keep(second[second[:, 1] < ref[1]], second)
        tongue = np.concatenate([first, second], axis=0)

        # Back tail vs epiglottis lowest point (+10 px in normalized units).
        ref = epiglottis[epiglottis[:, 1].argmin()]
        first, second = tongue[:25], tongue[25:]
        threshold = ref[1] + (10.0 / cfg.PIXEL_SPACING / cfg.RES)
        first = self._keep(first[first[:, 1] < threshold], first)
        tongue = np.concatenate([first, second], axis=0)
        return self._resample(tongue)

    def clip_lower_lip_tails(self, lower_lip, lower_incisor=None, **kwargs):
        """Reference tail_clipper.py:51-90."""
        cfg = self.dataset_config
        ref = lower_incisor[lower_incisor[:, 1].argmax()]
        first, second = lower_lip[:25], lower_lip[25:]
        threshold = ref[1] + (5.0 / cfg.PIXEL_SPACING / cfg.RES)
        second = self._keep(second[second[:, 1] < threshold], second)
        lip = self._resample(np.concatenate([first, second], axis=0))

        ref = lower_incisor[lower_incisor[:, 1].argmax()]
        first, second = lip[:25], lip[25:]
        first = self._keep(first[first[:, 1] < ref[1]], first)
        lip = self._resample(np.concatenate([first, second], axis=0))
        return lip

    def clip_upper_lip_tails(self, upper_lip, upper_incisor=None, **kwargs):
        """Reference tail_clipper.py:92-128 (thresholds intentionally match the
        reference, which divides by PIXEL_SPACING only)."""
        cfg = self.dataset_config
        ref = upper_incisor[-1]
        first, second = upper_lip[:25], upper_lip[25:]
        second = self._keep(second[second[:, 1] > ref[1] - (10.0 / cfg.PIXEL_SPACING)], second)
        lip = np.concatenate([first, second], axis=0)

        ref = upper_incisor[-1]
        first, second = lip[:25], lip[25:]
        first = self._keep(first[first[:, 1] > ref[1] - (5.0 / cfg.PIXEL_SPACING)], first)
        lip = self._resample(np.concatenate([first, second], axis=0))
        return lip

    def clip(
        self,
        articulator: str,
        contour: np.ndarray,
        references: Dict[str, np.ndarray],
    ) -> np.ndarray:
        """Dispatch by articulator name (reference
        phoneme_to_articulation/__init__.py:90-93); identity when the
        articulator has no clip method."""
        method = getattr(self, f"clip_{articulator.replace('-', '_')}_tails", None)
        if method is None:
            return contour
        kwargs = {name.replace("-", "_"): arr for name, arr in references.items()}
        return method(contour, **kwargs)
