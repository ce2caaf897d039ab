"""Multi-articulator autoencoder and PCA encoder/decoder models (counterpart of
artspeech_tpu/models/autoencoder.py).

Equivalents of reference principal_components/models/autoencoder.py:10-253:
per-articulator MLP encoders/decoders writing into a shared latent vector via
``indices_dict`` slots with max-merge, plus linear PCA variants holding
eigenvalue/eigenvector parameters.

The max-merge takes ``torch.amax`` over a stack of per-articulator slot
vectors filled with -inf outside each articulator's slots: where two
articulators share a slot and tie, the gradient splits evenly between them,
as JAX's ``max`` splits it (``torch.max(dim)`` would give it all to one).

Parameters keep flax's names, one submodule per articulator
(``enc_{articulator}`` / ``dec_{articulator}``), with ``nn.Linear`` layers
``dense0..2`` in torch's (out, in) orientation; ``utils/convert.py`` carries
a JAX param tree over. Construction draws the weights from a CPU
``torch.Generator`` (None: one seeded with 0) with flax's default inits and
then moves them to ``device``: ``cuda`` unless the caller passes
``device="cpu"``. The PCA classes' ``whiten`` option, which no caller of the
JAX package sets, is not ported.
"""

from typing import Dict, List, Optional

import torch
from torch import nn

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.models.heads import default_generator, flax_dense
from artspeech_tpu_torch.utils.io import make_indices_dict


def normalize_indices_dict(indices_dict: Dict) -> Dict[str, List[int]]:
    """Accept {articulator: count} or {articulator: [indices]} (reference
    autoencoder.py:130-133)."""
    first = next(iter(indices_dict.values()))
    if isinstance(first, int):
        return make_indices_dict(indices_dict)
    return {k: list(v) for k, v in indices_dict.items()}


def latent_size_of(indices_dict: Dict[str, List[int]]) -> int:
    return 1 + max(i for v in indices_dict.values() for i in v)


class _MLP(nn.Module):
    """Three Dense layers with ReLU between them."""

    def __init__(self, widths, generator):
        super().__init__()
        for i in range(3):
            self.add_module(f"dense{i}", flax_dense(widths[i], widths[i + 1], generator))

    def forward(self, x):
        h = torch.relu(self.dense0(x))
        h = torch.relu(self.dense1(h))
        return self.dense2(h)


class Encoder(_MLP):
    """in -> hidden -> hidden//2 -> k MLP (reference autoencoder.py:82-96)."""

    def __init__(self, in_features: int, num_components: int, hidden_features: int = 50,
                 generator: Optional[torch.Generator] = None):
        super().__init__((in_features, hidden_features, hidden_features // 2, num_components),
                         default_generator(generator))


class Decoder(_MLP):
    """k -> hidden//2 -> hidden -> out MLP (reference autoencoder.py:99-111)."""

    def __init__(self, out_features: int, num_components: int, hidden_features: int = 50,
                 generator: Optional[torch.Generator] = None):
        super().__init__((num_components, hidden_features // 2, hidden_features, out_features),
                         default_generator(generator))


class _PCA(nn.Module):
    """eigenvalues (k,), eigenvectors (k, F), mean (F,); flax's inits
    (uniform [0, 1) and zeros)."""

    def __init__(self, features: int, num_components: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = default_generator(generator)
        self.eigenvalues = nn.Parameter(torch.rand(num_components, generator=gen))
        self.eigenvectors = nn.Parameter(torch.rand(num_components, features, generator=gen))
        self.mean = nn.Parameter(torch.zeros(features))


class PCAEncoder(_PCA):
    """Linear projection onto fitted eigenvectors (reference autoencoder.py:10-38)."""

    def forward(self, x):
        return (x - self.mean) @ self.eigenvectors.T


class PCADecoder(_PCA):
    """Linear unprojection (reference autoencoder.py:41-79)."""

    def forward(self, z):
        return z @ self.eigenvectors + self.mean


def _make_encoder(cls_name, in_features, num_components, hidden, generator):
    if cls_name == "AE":
        return Encoder(in_features, num_components, hidden, generator)
    if cls_name == "PCA":
        return PCAEncoder(in_features, num_components, generator)
    raise ValueError(f"Unknown encoder class {cls_name}")


def _make_decoder(cls_name, out_features, num_components, hidden, generator):
    if cls_name == "AE":
        return Decoder(out_features, num_components, hidden, generator)
    if cls_name == "PCA":
        return PCADecoder(out_features, num_components, generator)
    raise ValueError(f"Unknown decoder class {cls_name}")


class MultiEncoder(nn.Module):
    """Per-articulator encoders scattering into shared latent slots with
    max-merge (reference autoencoder.py:124-171).

    Input (..., Nart, in_features), articulators in sorted order -> latent
    (..., latent_size).
    """

    def __init__(self, indices_dict: Dict, in_features: int = 100, hidden_features: int = 50,
                 encoder_cls: str = "AE", *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        self.indices = normalize_indices_dict(indices_dict)
        self.latent_size = latent_size_of(self.indices)
        self.articulators = sorted(self.indices)
        for a in self.articulators:
            self.add_module(f"enc_{a}", _make_encoder(encoder_cls, in_features,
                                                      len(self.indices[a]), hidden_features, gen))
        self.to(dev)

    def forward(self, x):
        lead = x.shape[:-2]
        slots = []
        for i, a in enumerate(self.articulators):
            z = getattr(self, f"enc_{a}")(x[..., i, :])  # (..., k)
            slot = z.new_full(lead + (self.latent_size,), float("-inf"))
            slot[..., self.indices[a]] = z
            slots.append(slot)
        return torch.amax(torch.stack(slots, dim=-2), dim=-2)


class MultiDecoder(nn.Module):
    """Per-articulator decoders reading their latent slots (reference
    autoencoder.py:174-211).

    Input (..., latent_size) -> (..., Nart, out_features), articulators in
    sorted order (``in_features`` is the per-articulator output width, the
    reference's naming).
    """

    def __init__(self, indices_dict: Dict, in_features: int = 100, hidden_features: int = 50,
                 decoder_cls: str = "AE", *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        self.indices = normalize_indices_dict(indices_dict)
        self.articulators = sorted(self.indices)
        for a in self.articulators:
            self.add_module(f"dec_{a}", _make_decoder(decoder_cls, in_features,
                                                      len(self.indices[a]), hidden_features, gen))
        self.to(dev)

    def forward(self, z):
        return torch.stack([getattr(self, f"dec_{a}")(z[..., self.indices[a]])
                            for a in self.articulators], dim=-2)


class MultiArticulatorAutoencoder(nn.Module):
    """tanh(latents) + decode (reference autoencoder.py:214-253)."""

    def __init__(self, indices_dict: Dict, in_features: int = 100, hidden_features: int = 50,
                 encoder_cls: str = "AE", decoder_cls: str = "AE", *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        self.encoders = MultiEncoder(indices_dict, in_features, hidden_features, encoder_cls,
                                     generator=gen, device="cpu")
        self.decoders = MultiDecoder(indices_dict, in_features, hidden_features, decoder_cls,
                                     generator=gen, device="cpu")
        self.to(dev)
        self.eval()

    def forward(self, x):
        """(..., Nart, in_features) -> (recon, latents)."""
        latents = self.encode(x)
        return self.decode(latents), latents

    def encode(self, x):
        return torch.tanh(self.encoders(x))

    def decode(self, z):
        return self.decoders(z)
