"""Latent sequence model: phonemes -> principal components (counterpart of
artspeech_tpu/models/latent_rnn.py).

Equivalents of reference principal_components/models/rnn.py:11-109
(``PrincipalComponentsPredictor``, ``PrincipalComponentsArtSpeech``) and
models/__init__.py:20-43 (``PrincipalComponentsArtSpeechWrapper``).

The recurrence is the port's masked BiGRU or BiLSTM (``rnn: GRU`` or
``LSTM``) on the hand-written kernels for CUDA tensors. The predictor's
LayerNorms take the variance as E[x^2] - E[x]^2, as flax's do
(``models/heads.layer_norm``). Construction draws the weights from a CPU
``torch.Generator`` (None: one seeded with 0) and moves them to ``device``
(``cuda`` unless the caller passes ``device="cpu"``), ending in ``.eval()``.
In training mode with ``rnn_dropout`` > 0, ``forward`` needs a
``torch.Generator`` on the model's device for the dropout masks.
"""

from typing import Dict, Optional

import torch
from torch import nn

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.models.autoencoder import latent_size_of, normalize_indices_dict
from artspeech_tpu_torch.models.heads import (
    default_generator,
    flax_dense,
    flax_embedding,
    layer_norm,
)
from artspeech_tpu_torch.ops.gru import BiGRU, BiLSTM
from artspeech_tpu_torch.utils.masks import make_padding_mask

RNNS = {"GRU": BiGRU, "LSTM": BiLSTM}


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6, ``scale`` and ``bias``)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias)


class PrincipalComponentsPredictor(nn.Module):
    """LN/Dense MLP head (reference rnn.py:11-33)."""

    def __init__(self, in_features: int, num_components: int, hidden_features: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        widths = (in_features, hidden_features, hidden_features // 2, num_components)
        for i in range(3):
            self.add_module(f"ln{i}", LayerNorm(widths[i]))
            self.add_module(f"dense{i}", flax_dense(widths[i], widths[i + 1], gen))

    def forward(self, x):
        h = torch.relu(self.dense0(self.ln0(x)))
        h = torch.relu(self.dense1(self.ln1(h)))
        return self.dense2(self.ln2(h))


class PrincipalComponentsArtSpeech(nn.Module):
    """Embedding -> 2-layer Bi{GRU,LSTM} -> Dense + ReLU -> predictor -> tanh
    -> (B, T, latent) (reference rnn.py:36-109)."""

    def __init__(self, vocab_size: int, indices_dict: Dict, embed_dim: int = 64,
                 hidden_size: int = 128, rnn_dropout: float = 0.0, rnn: str = "GRU", *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        if rnn.upper() not in RNNS:
            raise ValueError(f"rnn must be one of {sorted(RNNS)}, got {rnn!r}")
        dev = resolve_device(device)
        gen = default_generator(generator)
        latent = latent_size_of(normalize_indices_dict(indices_dict))
        self.embed = flax_embedding(vocab_size, embed_dim, gen)
        self.rnn = RNNS[rnn.upper()](embed_dim, hidden_size, num_layers=2, dropout=rnn_dropout,
                                     generator=gen)
        self.dense = flax_dense(2 * hidden_size, hidden_size, gen)
        self.predictor = PrincipalComponentsPredictor(hidden_size, latent, generator=gen)
        self.to(dev)
        self.eval()

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens (B, T) int ids (padded), lengths (B,) -> (B, T, latent) in
        (-1, 1). ``generator`` draws the dropout masks in training mode."""
        mask = make_padding_mask(lengths, tokens.shape[1])
        h = torch.relu(self.dense(self.rnn(self.embed(tokens), mask, generator)))
        return torch.tanh(self.predictor(h))


def make_latent_rnn_synthesis_forward(rnn_model, decode_fn, denorm_mean, denorm_std,
                                      n_samples: int = 50, rescale_factor: float = 1.0):
    """Synthesis wrapper: rnn -> frozen decoder -> reshape -> denorm
    (reference models/__init__.py:20-43).

    Args:
        rnn_model: a ``PrincipalComponentsArtSpeech`` (put in eval mode).
        decode_fn: (B, T, L) -> (B, T, Nart, 2*D), the frozen decoder.
        denorm_mean/denorm_std: (Nart, 2, D) per-articulator stats on the
            model's device, or None to return normalized shapes.
    Returns forward(tokens, lengths) -> (B, T, Nart, 2, D).
    """
    d = denorm_mean.shape[-1] if denorm_mean is not None else n_samples

    def forward(tokens, lengths):
        rnn_model.eval()
        shapes = decode_fn(rescale_factor * rnn_model(tokens, lengths))  # (B, T, Nart, 2*D)
        b, t, n_art, _ = shapes.shape
        shapes = shapes.reshape(b, t, n_art, 2, d)
        if denorm_mean is None:
            return shapes
        return shapes * denorm_std + denorm_mean

    return forward
