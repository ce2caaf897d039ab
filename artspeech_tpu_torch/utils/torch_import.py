"""Import the reference's PyTorch ArtSpeech and DeepSpeech2 weights into the
port's models (counterpart of artspeech_tpu/utils/torch_import.py).

``convert_artspeech_state_dict`` maps a reference ArtSpeech state dict
(encoder_decoder/models.py:99-145: embedding, 2-layer BiGRU, Linear head and
one ``ArticulatorPredictor`` per articulator) onto
``models/artspeech_rnn.ArtSpeech``: the GRU matrices transposed, the
``predictors.{i}`` ModuleList stacked onto the heads' leading (Nart, ...)
axis, the x and y output layers as ``dense2`` and ``dense3``.

The DeepSpeech2 half is the equivalent of reference deepspeech2.py:197-217
(``load_librispeech_model``): it maps a torch state dict with the reference
layout (adapter, cnn, residual_layers.N, linear, recurrent_layers.N,
feature_extractor, classifier) onto ``models/deepspeech2.DeepSpeech2``,
whose parameters keep the JAX package's layout:

- Conv2d: torch NCHW kernels (O, I, KD, KT) -> (KT, KD, I, O).
- GRU: torch (3H, X) weight matrices -> (X, 3H).
- The post-conv flatten: torch flattens (C, D) as c * D + d, the model as
  d * C + c, so the big Linear's input columns are permuted.
- Linear and LayerNorm weights map as they are.

State dicts are accepted as {name: np.ndarray}; ``load_torch_state_dict``
reads a ``.pt`` into that form.
"""

from typing import Dict, Optional

import numpy as np
import torch

from artspeech_tpu_torch.core.device import DeviceLike
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2
from artspeech_tpu_torch.utils.convert import artspeech_state_dict_from_flax


def load_torch_state_dict(filepath: str) -> Dict[str, np.ndarray]:
    state = torch.load(filepath, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32))


def _f32(array) -> np.ndarray:
    return np.asarray(array, dtype=np.float32)


def convert_artspeech_state_dict(sd: Dict[str, np.ndarray],
                                 num_layers: int = 2) -> Dict[str, torch.Tensor]:
    """The port's ``ArtSpeech`` state dict from a reference ArtSpeech one
    ({name: np.ndarray}, as ``load_torch_state_dict`` returns). Raises
    ``KeyError`` on a missing key."""
    gru = {}
    for layer in range(num_layers):
        for direction in ("", "_reverse"):
            gru[f"GRULayer_{len(gru)}"] = {
                "wi": _f32(sd[f"rnn.weight_ih_l{layer}{direction}"]).T,
                "bi": _f32(sd[f"rnn.bias_ih_l{layer}{direction}"]),
                "wh": _f32(sd[f"rnn.weight_hh_l{layer}{direction}"]).T,
                "bh": _f32(sd[f"rnn.bias_hh_l{layer}{direction}"]),
            }
    n_art = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("predictors."))

    def stacked(suffix, names):
        return {new: np.stack([_f32(sd[f"predictors.{i}.{suffix}.{old}"]).T
                               for i in range(n_art)])
                for old, new in zip(("weight", "bias"), names)}

    heads = {f"LayerNorm_{i}": stacked(f"linear.{k}", ("scale", "bias"))
             for i, k in enumerate((0, 3, 6))}
    for i, suffix in enumerate(("linear.1", "linear.4", "x_coords", "y_coords")):
        heads[f"Dense_{i}"] = stacked(suffix, ("kernel", "bias"))
    return artspeech_state_dict_from_flax({
        "Embed_0": {"embedding": _f32(sd["embedding.weight"])},
        "BiGRU_0": gru,
        "Dense_0": {"kernel": _f32(sd["linear.0.weight"]).T, "bias": _f32(sd["linear.0.bias"])},
        "ContourDecoder_0": {"VmapArticulatorPredictor_0": heads},
    })


def _same(sd, prefix, port, names=("weight", "bias"), as_=("weight", "bias")):
    return {f"{port}.{new}": _t(sd[f"{prefix}.{old}"]) for old, new in zip(names, as_)}


def _layernorm(sd, prefix, port):
    return _same(sd, prefix, port, as_=("scale", "bias"))


def _conv(sd, prefix, port):
    return {f"{port}.kernel": _t(sd[f"{prefix}.weight"].transpose(3, 2, 1, 0)),
            f"{port}.bias": _t(sd[f"{prefix}.bias"])}


def convert_deepspeech2_state_dict(
    sd: Dict[str, np.ndarray],
    num_residual_layers: int,
    num_rnn_layers: int,
    conv_channels: int = 32,
    skip_classifier: bool = False,
) -> Dict[str, torch.Tensor]:
    """The port's ``DeepSpeech2`` state dict from a reference torch one.

    Args:
        skip_classifier: drop the classifier head (reference swaps it for a
            fresh one when fine-tuning on a new vocabulary,
            train_phoneme_recognition.py:112-118).
    """
    out: Dict[str, torch.Tensor] = {}
    if "adapter.adapter.0.weight" in sd:
        out.update(_layernorm(sd, "adapter.adapter.0", "adapter.norm0"))
        out.update(_same(sd, "adapter.adapter.1", "adapter.dense0"))
        out.update(_layernorm(sd, "adapter.adapter.2", "adapter.norm1"))
        out.update(_same(sd, "adapter.adapter.3", "adapter.dense1"))
    out.update(_conv(sd, "cnn", "conv"))
    for i in range(num_residual_layers):
        ref, port = f"residual_layers.{i}", f"residual.{i}"
        out.update(_layernorm(sd, f"{ref}.layer_norm1", f"{port}.norm0"))
        out.update(_conv(sd, f"{ref}.cnn1", f"{port}.conv0"))
        out.update(_layernorm(sd, f"{ref}.layer_norm2", f"{port}.norm1"))
        out.update(_conv(sd, f"{ref}.cnn2", f"{port}.conv1"))

    # Big linear after the conv stack: permute input columns c*D+d -> d*C+c.
    w = sd["linear.weight"]  # (H, C*D), torch's flatten order
    d = w.shape[1] // conv_channels
    perm = np.asarray([c * d + dd for dd in range(d) for c in range(conv_channels)])
    out["dense.weight"] = _t(w[:, perm])
    out["dense.bias"] = _t(sd["linear.bias"])

    for i in range(num_rnn_layers):
        ref, port = f"recurrent_layers.{i}", f"recurrent.{i}"
        out.update(_layernorm(sd, f"{ref}.layer_norm", f"{port}.norm"))
        for name, key in (("wi", "weight_ih_l0"), ("wh", "weight_hh_l0")):
            out[f"{port}.gru.layers.0.{name}"] = _t(sd[f"{ref}.rnn.{key}"].T)
        for name, key in (("bi", "bias_ih_l0"), ("bh", "bias_hh_l0")):
            out[f"{port}.gru.layers.0.{name}"] = _t(sd[f"{ref}.rnn.{key}"])

    out.update(_same(sd, "feature_extractor.0", "features"))
    if not skip_classifier and "classifier.weight" in sd:
        out.update(_same(sd, "classifier", "classifier"))
    return out


def load_librispeech_deepspeech2(
    filepath: str,
    num_classes: int,
    num_features: int = 80,
    adapter_out_features: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> DeepSpeech2:
    """Reference ``DeepSpeech2.load_librispeech_model`` equivalent: the model
    with the LibriSpeech architecture (deepspeech2.py:197-211: 5 residual + 3
    GRU layers, hidden 128) and the torch weights imported, the classifier
    kept at its fresh initialisation when num_classes differs from the
    file's. Parameters the file lacks keep theirs too."""
    sd = load_torch_state_dict(filepath)
    model = DeepSpeech2(in_channels=2, num_residual_layers=5, num_rnn_layers=3,
                        rnn_hidden_size=128, num_classes=num_classes,
                        num_features=num_features, dropout=0.05,
                        adapter_out_features=adapter_out_features, dtype=dtype,
                        generator=generator, device=device)
    n_file = sd.get("classifier.weight", np.zeros((0,))).shape[0]
    imported = convert_deepspeech2_state_dict(sd, num_residual_layers=5, num_rnn_layers=3,
                                              skip_classifier=num_classes != n_file)
    unexpected = model.load_state_dict(imported, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"{filepath}: parameters the model has not: {unexpected}")
    return model
