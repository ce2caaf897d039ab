"""Vocabulary handling (copy of artspeech_tpu/core/vocab.py).

The reference builds the vocabulary as ``{BLANK: 0, UNKNOWN: 1}`` followed by
the tokens of a JSON list file (reference train_phoneme_to_articulation.py:151-156).
"""

import json
from typing import Dict, Iterable, List, Optional

from artspeech_tpu_torch.core.constants import BLANK, UNKNOWN


def build_vocabulary(
    tokens: Iterable[str],
    include_blank: bool = True,
    include_unknown: bool = True,
) -> Dict[str, int]:
    """Build token -> id mapping with optional special tokens first."""
    vocabulary: Dict[str, int] = {}
    if include_blank:
        vocabulary[BLANK] = len(vocabulary)
    if include_unknown:
        vocabulary[UNKNOWN] = len(vocabulary)
    for token in tokens:
        if token not in vocabulary:
            vocabulary[token] = len(vocabulary)
    return vocabulary


def load_vocabulary(
    filepath: str,
    include_blank: bool = True,
    include_unknown: bool = True,
) -> Dict[str, int]:
    """Load a vocabulary from a JSON list of tokens."""
    with open(filepath) as f:
        tokens: List[str] = json.load(f)
    return build_vocabulary(
        tokens, include_blank=include_blank, include_unknown=include_unknown
    )


def token_id(token: str, vocabulary: Dict[str, int]) -> int:
    """Token id with UNKNOWN fallback; raises a clear KeyError when the
    token is OOV and the vocabulary has no UNKNOWN entry (instead of letting
    a None id crash downstream array construction)."""
    if token in vocabulary:
        return vocabulary[token]
    if UNKNOWN in vocabulary:
        return vocabulary[UNKNOWN]
    raise KeyError(
        f"Token {token!r} is out of vocabulary and no {UNKNOWN!r} entry exists"
    )


def numericalize(
    tokens: Iterable[str],
    vocabulary: Dict[str, int],
    unknown_token: Optional[str] = UNKNOWN,
) -> List[int]:
    """Map tokens to ids, falling back to the unknown id (reference
    encoder_decoder/dataset.py:204-207)."""
    if unknown_token is not None and unknown_token in vocabulary:
        unk = vocabulary[unknown_token]
        return [vocabulary.get(token, unk) for token in tokens]
    return [vocabulary[token] for token in tokens]
