"""Carry weights from the JAX package's param trees to the port's modules.

The input is a flax param tree as nested dicts of numpy arrays (``np.asarray``
of each leaf); the output is a ``state_dict`` the port's module accepts. GRU
and head weights keep the JAX orientation in the port, so the only transpose
is the one of ``nn.Linear``, here.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32))


def _gru_layers(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """``GRULayer_{i}/{wi,bi,wh,bh}`` -> ``{prefix}.layers.{i}.*``."""
    out = {}
    for i in range(len(tree)):
        layer = tree[f"GRULayer_{i}"]
        for name in ("wi", "bi", "wh", "bh"):
            out[f"{prefix}.layers.{i}.{name}"] = _t(layer[name])
    return out


def _linear(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """flax Dense ``kernel (in, out)`` -> nn.Linear ``weight (out, in)``."""
    return {f"{prefix}.weight": _t(tree["kernel"]).T.contiguous(),
            f"{prefix}.bias": _t(tree["bias"])}


def _contour_decoder(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    heads = tree["VmapArticulatorPredictor_0"]
    out = {}
    for i in range(3):
        out[f"{prefix}.ln{i}_scale"] = _t(heads[f"LayerNorm_{i}"]["scale"])
        out[f"{prefix}.ln{i}_bias"] = _t(heads[f"LayerNorm_{i}"]["bias"])
    for i in range(4):
        out[f"{prefix}.dense{i}_kernel"] = _t(heads[f"Dense_{i}"]["kernel"])
        out[f"{prefix}.dense{i}_bias"] = _t(heads[f"Dense_{i}"]["bias"])
    return out


def artspeech_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``ArtSpeech`` params -> the port's ``ArtSpeech.load_state_dict``."""
    return {
        "embed.weight": _t(params["Embed_0"]["embedding"]),
        **_gru_layers(params["BiGRU_0"], "rnn"),
        **_linear(params["Dense_0"], "dense"),
        **_contour_decoder(params["ContourDecoder_0"], "decoder"),
    }


def simple_artspeech_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SimpleArtSpeech`` params -> the port's ``SimpleArtSpeech``."""
    return {
        "embed.weight": _t(params["Embed_0"]["embedding"]),
        **_linear(params["Dense_0"], "dense"),
        **_contour_decoder(params["ContourDecoder_0"], "decoder"),
    }
