"""Per-articulator contour heads (counterpart of artspeech_tpu/models/heads.py).

All articulator heads run as batched products over a leading (Nart, ...)
parameter axis instead of a Python loop over heads. Each head is
LayerNorm -> Linear(256) -> ReLU -> LayerNorm -> Linear(256) -> ReLU ->
LayerNorm -> [x | y] Linear(2 x n_samples), with the x and y output layers
fused into one (256 -> 2*n_samples) product as in the JAX package.

Parameters keep the JAX (flax) layout and orientation: ``ln{i}_scale``,
``ln{i}_bias`` (Nart, F); ``dense{i}_kernel`` (Nart, in, out) and
``dense{i}_bias`` (Nart, out) for i = 0..3 (Dense_2 = x, Dense_3 = y).

A model's ``dtype`` (None: float32; ``torch.bfloat16`` or ``torch.float16``)
is flax's compute dtype: parameters stay float32, and each Dense casts its
input, kernel and bias to it, each LayerNorm takes its statistics in float32
and returns it, as flax's ``dtype=`` does (JAX models/heads.py:56-102).

On a mesh with a model axis (``parallel/distributed.distribute_state``) each
model rank keeps its Nart / model slice of these parameters and computes
those articulators only; the heads' input takes its gradient summed over the
model group, and the outputs are gathered along Nart
(``parallel/collectives.py``).
"""

import math
from typing import Optional

import torch
from torch import nn

from artspeech_tpu_torch.parallel.collectives import copy_to_model_axis, gather_model_axis
from artspeech_tpu_torch.parallel.mesh import keep_model_slice_

#: flax ``nn.LayerNorm`` epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6


def cast(x, dtype: Optional[torch.dtype]):
    """x in the compute dtype (unchanged when it is None: float32)."""
    return x if dtype is None else x.to(dtype)


def at_least_f32(x):
    """x promoted to at least float32 (bf16 and f16 up; float32 and float64 as they
    are), as flax promotes statistics and JAX's explicit float32 casts do."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def layer_norm(x, scale, bias, eps: float = LAYER_NORM_EPS, dtype: Optional[torch.dtype] = None):
    """flax LayerNorm over the last axis: Var = E[x^2] - E[x]^2, clipped at 0.

    ``scale``/``bias`` broadcast against ``x``. With a ``dtype`` (flax's
    ``LayerNorm(dtype=...)``) the statistics and the affine are float32 and
    the result is cast to it.
    """
    if dtype is not None:
        return layer_norm(at_least_f32(x), scale, bias, eps).to(dtype)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean) * mul + bias


def lecun_normal_(param: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(param, std=std, a=-2.0 * std, b=2.0 * std,
                                     generator=generator)


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The CPU generator a model draws its weights from: the caller's, or one
    seeded with 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def flax_embedding(vocab_size: int, embed_dim: int, generator) -> nn.Embedding:
    """flax ``nn.Embed`` default init: N(0, 1/embed_dim)."""
    embed = nn.Embedding(vocab_size, embed_dim)
    with torch.no_grad():
        embed.weight.normal_(0.0, math.sqrt(1.0 / embed_dim), generator=generator)
    return embed


def flax_dense(in_features: int, out_features: int, generator) -> nn.Linear:
    """flax ``nn.Dense`` default init (lecun normal kernel, zero bias)."""
    dense = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lecun_normal_(dense.weight, in_features, generator)
        dense.bias.zero_()
    return dense


class ContourDecoder(nn.Module):
    """(B, T, F) -> (B, T, Nart, 2, n_samples) contours in [0, 1]."""

    def __init__(self, in_features: int, n_articulators: int, n_samples: int = 50,
                 hidden: int = 256, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_articulators = n_articulators
        self.n_samples = n_samples
        self.dtype = dtype
        widths = [(in_features, hidden), (hidden, hidden), (hidden, n_samples),
                  (hidden, n_samples)]
        for i, width in enumerate((in_features, hidden, hidden)):
            self.register_parameter(f"ln{i}_scale", nn.Parameter(torch.ones(n_articulators, width)))
            self.register_parameter(f"ln{i}_bias", nn.Parameter(torch.zeros(n_articulators, width)))
        for i, (fan_in, fan_out) in enumerate(widths):
            kernel = nn.Parameter(torch.empty(n_articulators, fan_in, fan_out))
            lecun_normal_(kernel, fan_in, generator)
            self.register_parameter(f"dense{i}_kernel", kernel)
            self.register_parameter(f"dense{i}_bias", nn.Parameter(torch.zeros(n_articulators, fan_out)))
        self.model_axis = None  # (group, index, size) once sharded

    def model_axis_parameters(self):
        """(name, parameter) of every parameter ``shard_model_axis`` slices."""
        return list(self.named_parameters())

    def shard_model_axis(self, group, index: int, size: int, optimizer=None) -> None:
        """Keep this model rank's ``index``-th of ``size`` slices of every
        stacked parameter (and of the ``optimizer``'s moments of each), in
        place, and compute those articulators from now on."""
        keep_model_slice_(self.parameters(), index, size, optimizer)
        self.model_axis = (group, index, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, dt = x.shape[:-1], self.dtype
        group, index, size = self.model_axis or (None, 0, 1)
        x = copy_to_model_axis(x, group)
        h = x.reshape(1, -1, x.shape[-1])  # (1, M, F), shared by every head
        for i in range(2):
            h = layer_norm(h, getattr(self, f"ln{i}_scale")[:, None, :],
                           getattr(self, f"ln{i}_bias")[:, None, :], dtype=dt)  # (Nart, M, F)
            h = torch.baddbmm(cast(getattr(self, f"dense{i}_bias")[:, None, :], dt), h,
                              cast(getattr(self, f"dense{i}_kernel"), dt))
            h = torch.relu(h)
        h = layer_norm(h, self.ln2_scale[:, None, :], self.ln2_bias[:, None, :], dtype=dt)
        w = torch.cat([self.dense2_kernel, self.dense3_kernel], dim=-1)  # (Nart, 256, 2D)
        b = torch.cat([self.dense2_bias, self.dense3_bias], dim=-1)
        xy = torch.baddbmm(cast(b[:, None, :], dt), h, cast(w, dt))  # (Nart, M, 2D) = [x_pos | y_pos]
        xy = xy.reshape(w.shape[0], *lead, 2, self.n_samples)
        xy = gather_model_axis(xy, group, index, size)  # (Nart, ...)
        return torch.sigmoid(torch.movedim(xy, 0, len(lead)))
