"""Dataset configuration constants (copy of artspeech_tpu/core/config.py).

Reproduces reference settings.py:13-46 as frozen dataclasses, and
``mm_per_unit``.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class DatasetConfig:
    """Per-database acquisition constants.

    Attributes:
        RES: image resolution used to normalize contour coordinates to [0, 1].
        PIXEL_SPACING: millimetres per pixel; ``value * RES * PIXEL_SPACING``
            converts normalized distances into mm.
        FRAMERATE: MRI frames per second.
        SYNC_SHIFT: audio/video synchronisation shift in frames.
    """

    RES: int = 136
    PIXEL_SPACING: float = 1.6176470518112
    FRAMERATE: int = 50
    SYNC_SHIFT: int = 0


ARTSPEECH_CONFIG = DatasetConfig(SYNC_SHIFT=2)
ARTSPEECH2_CONFIG = DatasetConfig(SYNC_SHIFT=-20)
GOTTINGEN_CONFIG = DatasetConfig(PIXEL_SPACING=1.4117647409439, FRAMERATE=55)
TEXTGRID_ONLY_CONFIG = DatasetConfig()

DATASET_CONFIG = {
    "artspeech": ARTSPEECH_CONFIG,
    "artspeech2": ARTSPEECH2_CONFIG,
    "gottingen": GOTTINGEN_CONFIG,
    "textgrid_only": TEXTGRID_ONLY_CONFIG,
}


def mm_per_unit(config: DatasetConfig) -> float:
    """Conversion factor from normalized coordinate units to millimetres."""
    return config.RES * config.PIXEL_SPACING
