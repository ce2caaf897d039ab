"""ArtSpeech: the BiGRU phoneme-to-articulation model
(counterpart of artspeech_tpu/models/artspeech_rnn.py).

Embedding -> 2-layer masked BiGRU -> Linear + ReLU -> per-articulator heads ->
sigmoid, producing (B, T, Nart, 2, n_samples). Sequences are padded to
bucketed lengths with a boolean mask instead of pack_padded_sequence.

Construction takes a CPU ``torch.Generator`` for the random weights (None:
one seeded with 0), which are drawn on the CPU and then moved, so one seed
gives the same weights on every device, and a ``device``: ``cuda`` unless the
caller passes ``device="cpu"``, and a compute ``dtype`` (None: float32;
``torch.bfloat16`` for the bf16 configs, or ``torch.float16``): parameters
stay float32 and the forward computes in it where the flax modules cast (JAX
models/artspeech_rnn.py:27-78): the embedding's output, the GRU's input
product and recurrence, the Dense layers and the heads' LayerNorm outputs.
Construction ends in ``.eval()``; the trainer calls ``.train()``. In training mode with dropout > 0, ``forward``
needs a ``torch.Generator`` on the model's device for the dropout masks and
raises without one.
"""

from typing import Optional

import torch
from torch import nn

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.models.heads import (
    ContourDecoder,
    cast,
    default_generator,
    flax_dense,
    flax_embedding,
)
from artspeech_tpu_torch.ops.gru import BiGRU, apply_dropout
from artspeech_tpu_torch.utils.masks import make_padding_mask


class ArtSpeech(nn.Module):
    def __init__(self, vocab_size: int, n_articulators: int, embed_dim: int = 64,
                 hidden_size: int = 128, n_samples: int = 50, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        self.dtype = dtype
        self.embed = flax_embedding(vocab_size, embed_dim, gen)
        self.rnn = BiGRU(embed_dim, hidden_size, num_layers=2, dropout=dropout, generator=gen,
                         dtype=dtype)
        self.dense = flax_dense(2 * hidden_size, hidden_size, gen)
        self.decoder = ContourDecoder(hidden_size, n_articulators, n_samples, generator=gen,
                                      dtype=dtype)
        self.to(dev)
        self.eval()

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens (B, T) int ids (padded), lengths (B,) -> (B, T, Nart, 2, D).

        ``generator`` draws the dropout masks in training mode (flax's
        ``deterministic=False``); in eval mode it is not used.
        """
        dt = self.dtype
        mask = make_padding_mask(lengths, tokens.shape[1])
        rnn_out = self.rnn(cast(self.embed(tokens), dt), mask, generator)
        h = torch.relu(_dense(self.dense, rnn_out, dt))
        return self.decoder(h)


class SimpleArtSpeech(nn.Module):
    """RNN-free variant (reference encoder_decoder/models.py:53-96)."""

    def __init__(self, vocab_size: int, n_articulators: int, embed_dim: int = 64,
                 hidden_size: int = 128, n_samples: int = 50, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        self.dropout = dropout
        self.dtype = dtype
        self.embed = flax_embedding(vocab_size, embed_dim, gen)
        self.dense = flax_dense(embed_dim, hidden_size, gen)
        self.decoder = ContourDecoder(hidden_size, n_articulators, n_samples, generator=gen,
                                      dtype=dtype)
        self.to(dev)
        self.eval()

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del lengths
        embed = cast(self.embed(tokens), self.dtype)
        if self.training and self.dropout > 0.0:
            embed = apply_dropout(embed, self.dropout, generator)
        h = torch.relu(_dense(self.dense, embed, self.dtype))
        return self.decoder(h)


def _dense(linear: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    if dtype is None:
        return linear(x)
    return torch.nn.functional.linear(cast(x, dtype), cast(linear.weight, dtype),
                                      cast(linear.bias, dtype))
