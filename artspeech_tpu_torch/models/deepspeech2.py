"""DeepSpeech2 phoneme recognizer (counterpart of
artspeech_tpu/models/deepspeech2.py).

Equivalent of reference phoneme_recognition/deepspeech2.py:15-217: Conv2d stem
(+ additive voicing broadcast) -> N x pre-LN GELU residual CNN blocks ->
Linear -> N x LayerNorm/GELU GRU blocks -> feature extractor -> classifier,
with an optional Adapter MLP mapping the feature axis to ``adapter_out_features``
dims for LibriSpeech-pretrained compatibility.

Layout: the model takes (B, C, D, T) features (the reference layout) and runs
its conv stack on (B, C, T, D), so that every 3 x 3 SAME convolution is one
product over the unfolded input and the LayerNorms over the feature axis D,
the Adapter's among them, run over the last axis. The flatten before the big Linear
follows the JAX package's (B, T, D, C) order, index d * C + c.

Parameters keep the JAX (flax) layout: conv ``kernel`` (K, K, I, O) over
(T, D) and ``bias`` (O,); LayerNorm ``scale`` and ``bias`` (F,); ``nn.Linear``
for flax's Dense (``utils/convert.py`` transposes). The recurrent blocks run
the port's one-direction ``GRUStack`` (the GRU kernels for CUDA tensors).
LayerNorms are flax's (epsilon 1e-6, Var = E[x^2] - E[x]^2) and GELU is
exact.

A model's ``dtype`` (None: float32; ``torch.bfloat16`` or ``torch.float16``)
is flax's compute dtype: parameters stay float32; a convolution casts its
input and kernel to it, sums the products in float32, adds the float32 bias
and rounds the result to it, as JAX's ``ShiftedMatmulConv`` does; Dense layers
compute in it and LayerNorms take their statistics in float32.

Construction draws the weights from a CPU ``torch.Generator`` (None: one
seeded with 0) and moves them to ``device`` (``cuda`` unless the caller
passes ``device="cpu"``), ending in ``.eval()``. In training mode with
``dropout`` > 0, ``forward`` needs a ``torch.Generator`` on the model's
device for the dropout masks.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.models.heads import at_least_f32, cast, default_generator, flax_dense, \
    layer_norm, lecun_normal_
from artspeech_tpu_torch.ops.gru import GRUStack, apply_dropout
from artspeech_tpu_torch.utils.masks import make_padding_mask


def dense(linear: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in the compute dtype."""
    return F.linear(cast(x, dtype), cast(linear.weight, dtype), cast(linear.bias, dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, dtype=self.dtype)


class Conv(nn.Module):
    """K x K SAME convolution over (T, D) of (B, C, T, D), the JAX package's
    ``ShiftedMatmulConv``: ``kernel`` (K, K, I, O), ``bias`` (O,); inputs and
    kernel cast to the compute dtype, products summed in float32.

    Computed as JAX computes it, by direct sums: the K * K shifted copies of
    the input (``F.unfold``) times the kernel in one float32 product, whose
    backward is two more products. Padded frames make this necessary: the
    LayerNorms over D see rows there that are constant along D, whose
    gradients are 1/sqrt(eps) = 1000 times larger per LayerNorm, while the
    inputs they multiply are exact zeros. A direct sum adds those products
    as zeros; cuDNN's weight-gradient algorithm for the 2-channel stem does
    not, and on an H100 its gradient of the stem's kernel failed the
    card-against-float64 check of chip_smoke.py (PERF.md §6).
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("a SAME convolution needs an odd kernel")
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, kernel_size, in_channels, features))
        lecun_normal_(self.kernel, kernel_size * kernel_size * in_channels, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):  # (B, C, T, D)
        dt = self.dtype
        k, _, _, o = self.kernel.shape
        b, _, t, d = x.shape
        w = at_least_f32(cast(self.kernel, dt)).permute(3, 2, 0, 1).reshape(o, -1)  # (O, I*K*K)
        cols = F.unfold(at_least_f32(cast(x, dt)), k, padding=k // 2)  # (B, I*K*K, T*D)
        out = (w @ cols).view(b, o, t, d) + self.bias[:, None, None]
        return cast(out, dt)


class Adapter(nn.Module):
    """LN -> Dense -> LN -> Dense over the feature axis D (reference
    deepspeech2.py:73-87)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norm0 = LayerNorm(in_features, dtype)
        self.dense0 = flax_dense(in_features, out_features, generator)
        self.norm1 = LayerNorm(out_features, dtype)
        self.dense1 = flax_dense(out_features, out_features, generator)

    def forward(self, x):  # (B, C, T, D) -> (B, C, T, D')
        x = dense(self.dense0, self.norm0(x), self.dtype)
        return dense(self.dense1, self.norm1(x), self.dtype)


class ResidualCNN(nn.Module):
    """Pre-LN GELU double conv with residual (reference deepspeech2.py:15-47);
    the LayerNorms run over D with per-D scale and bias."""

    def __init__(self, channels: int, num_features: int, kernel_size: int = 3,
                 dropout: float = 0.1, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.norm0 = LayerNorm(num_features, dtype)
        self.conv0 = Conv(channels, channels, kernel_size, generator, dtype)
        self.norm1 = LayerNorm(num_features, dtype)
        self.conv1 = Conv(channels, channels, kernel_size, generator, dtype)

    def _drop(self, x, generator):
        if self.training and self.dropout > 0.0:
            return apply_dropout(x, self.dropout, generator)
        return x

    def forward(self, x, generator=None):
        out = self._drop(F.gelu(self.norm0(x)), generator)
        out = self.conv0(out)
        out = self._drop(F.gelu(self.norm1(out)), generator)
        return self.conv1(out) + x


class RecurrentBlock(nn.Module):
    """LN -> GELU -> GRU -> dropout (reference deepspeech2.py:50-70)."""

    def __init__(self, hidden_size: int, dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.norm = LayerNorm(hidden_size, dtype)
        self.gru = GRUStack(hidden_size, hidden_size, num_layers=1, generator=generator,
                            dtype=dtype)

    def forward(self, x, mask, generator=None):  # (B, T, H)
        out = self.gru(F.gelu(self.norm(x)), mask)
        if self.training and self.dropout > 0.0:
            out = apply_dropout(out, self.dropout, generator)
        return out


class DeepSpeech2(nn.Module):
    """Reference deepspeech2.py:90-195 for (B, C, D, T) inputs."""

    def __init__(self, in_channels: int = 2, num_residual_layers: int = 4,
                 num_rnn_layers: int = 2, rnn_hidden_size: int = 64, num_classes: int = 31,
                 num_features: int = 80, dropout: float = 0.1,
                 adapter_out_features: Optional[int] = None, conv_channels: int = 32,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        self.dtype = dtype
        self.dropout = dropout
        self.adapter = None
        if adapter_out_features is not None:
            self.adapter = Adapter(num_features, adapter_out_features, gen, dtype)
        d = adapter_out_features if adapter_out_features is not None else num_features
        self.conv = Conv(in_channels, conv_channels, 3, gen, dtype)
        self.residual = nn.ModuleList(
            ResidualCNN(conv_channels, d, dropout=dropout, generator=gen, dtype=dtype)
            for _ in range(num_residual_layers))
        self.dense = flax_dense(d * conv_channels, rnn_hidden_size, gen)
        self.recurrent = nn.ModuleList(
            RecurrentBlock(rnn_hidden_size, dropout, gen, dtype) for _ in range(num_rnn_layers))
        self.features = flax_dense(rnn_hidden_size, rnn_hidden_size, gen)
        self.classifier = flax_dense(rnn_hidden_size, num_classes, gen)
        self.to(dev)
        self.eval()

    def forward(self, x: torch.Tensor, voicing: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None, return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        """
        Args:
            x: (B, C, D, T) features (reference layout).
            voicing: optional (B, T) additive voicing signal.
            lengths: optional (B,) valid time lengths for the masked GRU.
            generator: draws the dropout masks in training mode.
        Returns:
            (B, T, num_classes) logits [, (B, T, H) features].
        """
        dt = self.dtype
        out = x.transpose(-1, -2)  # (B, C, T, D)
        if self.adapter is not None:
            out = self.adapter(out)
        out = self.conv(out)
        if voicing is not None:
            # Additive broadcast over (C, D) (reference deepspeech2.py:174-177).
            out = out + voicing[:, None, :, None]
        for block in self.residual:
            out = block(out, generator)

        b, c, t, d = out.shape
        out = out.permute(0, 2, 3, 1).reshape(b, t, d * c)  # index d * C + c
        out = dense(self.dense, out, dt)

        if lengths is None:
            mask = torch.ones(b, t, dtype=torch.bool, device=out.device)
        else:
            mask = make_padding_mask(torch.as_tensor(lengths, device=out.device), t)
        for block in self.recurrent:
            out = block(out, mask, generator)

        features = F.gelu(dense(self.features, out, dt))
        dropped = features
        if self.training and self.dropout > 0.0:
            dropped = apply_dropout(features, self.dropout, generator)
        logits = dense(self.classifier, dropped, dt)
        if return_features:
            return logits, features
        return logits


def to_recognizer_layout(shapes: torch.Tensor) -> torch.Tensor:
    """(B, T, Nart, 2, D) contours -> (B, 2, Nart * D, T), the vocal-tract
    feature layout (JAX train/step.py ``to_rec``)."""
    b, t, n_art, _, d = shapes.shape
    return shapes.permute(0, 3, 2, 4, 1).reshape(b, 2, n_art * d, t)


def frozen_recognizer_fn(model: DeepSpeech2) -> Callable:
    """Freeze ``model`` (eval mode, no parameter requires grad) and return
    ``recognizer_fn(shapes, voicing) -> (B, T, H)`` features: the model called
    with ``return_features=True`` and no ``lengths``, so its GRU runs over
    every frame, as the JAX package's frozen recognizer does
    (cli/train_phoneme_to_principal_components.py:105-125). Gradients pass
    through it to ``shapes`` only; an optimizer over another model never
    sees its parameters."""
    model.requires_grad_(False).eval()

    def recognizer_fn(shapes: torch.Tensor, voicing: Optional[torch.Tensor]) -> torch.Tensor:
        return model(shapes, voicing=voicing, return_features=True)[1]

    return recognizer_fn


def get_noise_logits(logits: torch.Tensor, factor: float,
                     generator: torch.Generator) -> torch.Tensor:
    """Large-margin logit noise (reference deepspeech2.py:148-151): normal
    noise drawn from ``generator`` (on the logits' device)."""
    noise = torch.randn(logits.shape, generator=generator, device=logits.device,
                        dtype=logits.dtype)
    return logits + factor * noise


def get_normalized_outputs(logits: torch.Tensor, use_log_prob: bool = False) -> torch.Tensor:
    """softmax / log_softmax over classes (reference deepspeech2.py:153-157)."""
    fn = torch.log_softmax if use_log_prob else torch.softmax
    return fn(logits, dim=-1)
