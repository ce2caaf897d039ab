"""Padding-mask utilities (counterpart of artspeech_tpu/utils/masks.py)."""

import torch


def make_padding_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask (B, max_length); True where t < length."""
    positions = torch.arange(max_length, device=lengths.device)[None, :]
    return positions < lengths[:, None]
