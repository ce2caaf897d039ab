"""Host-side IO helpers (copy of artspeech_tpu/utils/io.py:
``npy_to_xarticul``, ``xarticul_to_npy``, ``sequences_from_dict``,
``make_indices_dict``, ``set_seeds`` and ``assert_expression``)."""

import os
from typing import Dict, List, Sequence, Tuple

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


def xarticul_to_npy(filepath: str) -> np.ndarray:
    """Read an Xarticul file back into an (N, 2) array (reference helpers.py:48-60)."""
    with open(filepath) as f:
        lines = [line.strip() for line in f.readlines()][:-1]
    return np.array([[float(value) for value in line.split()] for line in lines])


def sequences_from_dict(
    datadir: str, sequences_dict: Dict[str, Sequence[str]]
) -> List[Tuple[str, str]]:
    """Expand {subject: [sequences]} into (subject, sequence) pairs; an empty
    list selects every sequence directory (reference helpers.py:63-76)."""
    sequences = []
    for subject, seqs in sequences_dict.items():
        use_seqs = seqs
        if len(seqs) == 0:
            subject_dir = os.path.join(datadir, subject)
            use_seqs = sorted(
                s
                for s in os.listdir(subject_dir)
                if os.path.isdir(os.path.join(subject_dir, s))
            )
        sequences.extend((subject, seq) for seq in use_seqs)
    return sequences


def make_indices_dict(num_components: Dict[str, int]) -> Dict[str, List[int]]:
    """Convert per-articulator component counts into latent index slots
    (reference helpers.py:94-114).

    >>> make_indices_dict({'a': 3, 'b': 3, 'c': 2})
    {'a': [0, 1, 2], 'b': [3, 4, 5], 'c': [6, 7]}
    """
    indices_dict = {}
    start = 0
    for key, val in num_components.items():
        indices_dict[key] = list(range(start, start + val))
        start += val
    return indices_dict


def set_seeds(worker_id: int = 0, base_seed: int = 0):
    """Deterministic seeding for data-pipeline workers: numpy's global
    generator and ``random`` (reference helpers.py:8-11). torch's generators
    are the caller's: the port seeds each of its own explicitly."""
    import random

    seed = base_seed + worker_id
    np.random.seed(seed % (2**32))  # numpy accepts the full 0..2**32-1 range
    random.seed(seed)


def assert_expression(expression, exception=AssertionError, message: str = ""):
    """Raise ``exception(message)`` when the expression is falsy (reference
    helpers.py:14-24)."""
    if not expression:
        raise exception(message)
