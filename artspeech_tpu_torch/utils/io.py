"""Host-side IO helpers (copy of artspeech_tpu/utils/io.py:npy_to_xarticul)."""

from typing import List

import numpy as np


def npy_to_xarticul(array: np.ndarray, filepath: str = None) -> List[str]:
    """Write an (N, 2) array of points in the Xarticul text format.

    An extra ``-1 -1`` line tags the end of file (reference helpers.py:27-45).
    """
    lines = [f"{x} {y}" for x, y in array]
    lines.append("-1 -1")
    if filepath is not None:
        with open(filepath, "w") as f:
            f.write("\n".join(lines))
    return lines
