"""Mask-aware GRU and LSTM layers (counterpart of artspeech_tpu/ops/gru.py).

Sequences stay padded at bucketed lengths and the recurrence is masked: the
hidden state (and the LSTM's cell state) freezes outside the valid region, so
outputs at padded steps repeat the last valid state (torch
``pack_padded_sequence`` would give zeros). The input projection of every
step is hoisted out of the time loop into one (T*B, E) x (E, G*H) product;
only the recurrence runs in the kernel (ops/hopper_gru.py, ops/hopper_lstm.py),
time-major.

GRU gate math follows torch semantics:
    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h
and the LSTM's follows torch's gate order i, f, g, o:
    c' = sigmoid(i) * tanh(g) + sigmoid(f) * c,  h' = sigmoid(o) * tanh(c')

Parameters keep the JAX orientation: ``wi (E, G*H)``, ``bi (G*H,)``,
``wh (H, G*H)``, ``bh (G*H,)`` with G = 3 (GRU) or 4 (LSTM). The JAX package
has two numerically identical bidirectional paths (direction-fused scan for
B <= 16, time-major twin scans above); the port has one. Every layer is
differentiable through ``hopper_gru.GRUSequenceFn`` or
``hopper_lstm.LSTMSequenceFn`` (the backward kernels on CUDA).

A layer's ``dtype`` (None: float32; ``torch.bfloat16`` or ``torch.float16``)
is flax's compute dtype (JAX ops/gru.py:74-79): the parameters stay float32
and are cast to it, with the input, for the input product and the recurrence,
which then runs in it (gate math in float32, the carry rounded to it after
every step, as the kernels do).

In training mode, dropout between stacked layers works as flax
``nn.Dropout``: keep with probability 1 - p, scale kept values by 1/(1 - p),
after every layer but the last. Its mask is drawn from a ``torch.Generator``
on the tensor's device that the caller passes; without one it raises.
"""

from typing import Optional

import torch
from torch import nn

from artspeech_tpu_torch.models.heads import cast
from artspeech_tpu_torch.ops.hopper_gru import bigru_sequence, gru_sequence
from artspeech_tpu_torch.ops.hopper_lstm import bilstm_sequence, lstm_sequence


def apply_dropout(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` with ``deterministic=False``, its keep mask
    drawn from ``generator`` (on x's device)."""
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator on the "
                         "tensor's device (pass generator=...)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def torch_rnn_init(param: torch.Tensor, hidden_size: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch nn.GRU initialization: U(-k, k) with k = 1/sqrt(hidden_size)."""
    bound = 1.0 / (hidden_size**0.5)
    with torch.no_grad():
        return param.uniform_(-bound, bound, generator=generator)


class _RNNLayer(nn.Module):
    """Single-direction masked recurrence, time-major: (T, B, E) -> (T, B, H).
    Subclasses name the gate count and the kernel's sequence function."""

    n_gates = 0
    sequence = None

    def __init__(self, in_features: int, hidden_size: int, reverse: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.reverse = reverse
        self.dtype = dtype
        gates = self.n_gates * hidden_size
        self.wi = nn.Parameter(torch.empty(in_features, gates))
        self.bi = nn.Parameter(torch.empty(gates))
        self.wh = nn.Parameter(torch.empty(hidden_size, gates))
        self.bh = nn.Parameter(torch.empty(gates))
        for p in (self.wi, self.bi, self.wh, self.bh):
            torch_rnn_init(p, hidden_size, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (T, B, E), mask (T, B), nonzero on valid steps -> (T, B, H)."""
        dt = self.dtype
        x_proj = cast(x, dt) @ cast(self.wi, dt) + cast(self.bi, dt)
        return self.sequence(x_proj, cast(self.wh, dt), cast(self.bh, dt), mask,
                             reverse=self.reverse)


class GRULayer(_RNNLayer):
    """Single-direction masked GRU (the JAX ``GRULayer(time_major=True)``)."""

    n_gates = 3
    sequence = staticmethod(gru_sequence)


class LSTMLayer(_RNNLayer):
    """Single-direction masked LSTM, gate order i, f, g, o (the JAX
    ``LSTMLayer(time_major=True)``)."""

    n_gates = 4
    sequence = staticmethod(lstm_sequence)


class _Bidirectional(nn.Module):
    """Stacked bidirectional recurrence: (B, T, E) -> (B, T, 2H).

    ``layers`` holds, in order, layer 0 forward, layer 0 backward, layer 1
    forward, ... (the JAX ``GRULayer_0..`` / ``LSTMLayer_0..`` order). Both
    directions of a layer share one input product and one kernel launch.
    """

    layer_cls = None
    bi_sequence = None

    def __init__(self, in_features: int, hidden_size: int, num_layers: int = 2,
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.dtype = dtype
        self.layers = nn.ModuleList()
        for layer in range(num_layers):
            width = in_features if layer == 0 else 2 * hidden_size
            for reverse in (False, True):
                self.layers.append(self.layer_cls(width, hidden_size, reverse, generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, E), mask (B, T) -> (B, T, 2H); ``generator`` draws the
        dropout masks in training mode."""
        dt = self.dtype
        out = x.transpose(0, 1)  # (T, B, E)
        mask_tm = mask.transpose(0, 1)
        for layer in range(self.num_layers):
            fwd, bwd = self.layers[2 * layer], self.layers[2 * layer + 1]
            x_proj = (cast(out, dt) @ cast(torch.cat([fwd.wi, bwd.wi], dim=1), dt)
                      + cast(torch.cat([fwd.bi, bwd.bi]), dt))
            out = self.bi_sequence(x_proj, cast(torch.stack([fwd.wh, bwd.wh]), dt),
                                   cast(torch.stack([fwd.bh, bwd.bh]), dt), mask_tm)
            if self.training and self.dropout > 0.0 and layer < self.num_layers - 1:
                out = apply_dropout(out, self.dropout, generator)
        return out.transpose(0, 1)


class BiGRU(_Bidirectional):
    """Stacked bidirectional masked GRU (the JAX ``BiGRU``)."""

    layer_cls = GRULayer
    bi_sequence = staticmethod(bigru_sequence)


class BiLSTM(_Bidirectional):
    """Stacked bidirectional masked LSTM (the JAX ``BiLSTM``, the latent
    RNN's ``rnn: LSTM``)."""

    layer_cls = LSTMLayer
    bi_sequence = staticmethod(bilstm_sequence)


class GRUStack(nn.Module):
    """Stacked unidirectional GRU: (B, T, E) -> (B, T, H)."""

    def __init__(self, in_features: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.ModuleList(
            GRULayer(in_features if layer == 0 else hidden_size, hidden_size,
                     generator=generator, dtype=dtype)
            for layer in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, E), mask (B, T) -> (B, T, H); ``generator`` as in BiGRU."""
        out = x.transpose(0, 1)
        mask_tm = mask.transpose(0, 1)
        for i, layer in enumerate(self.layers):
            out = layer(out, mask_tm)
            if self.training and self.dropout > 0.0 and i < len(self.layers) - 1:
                out = apply_dropout(out, self.dropout, generator)
        return out.transpose(0, 1)
