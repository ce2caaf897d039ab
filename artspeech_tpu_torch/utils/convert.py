"""Carry weights from the JAX package's param trees to the port's modules.

The input is a flax param tree as nested dicts of numpy arrays (``np.asarray``
of each leaf); the output is a ``state_dict`` the port's module accepts. GRU,
LSTM, head, PCA and transformer weights keep the JAX orientation in the port,
so the only transpose is the one of ``nn.Linear``, here.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32))


def _gru_layers(tree: Mapping, prefix: str, layer: str = "GRULayer") -> Dict[str, torch.Tensor]:
    """``{layer}_{i}/{wi,bi,wh,bh}`` -> ``{prefix}.layers.{i}.*`` (``layer``
    GRULayer or LSTMLayer)."""
    out = {}
    for i in range(len(tree)):
        weights = tree[f"{layer}_{i}"]
        for name in ("wi", "bi", "wh", "bh"):
            out[f"{prefix}.layers.{i}.{name}"] = _t(weights[name])
    return out


def _linear(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """flax Dense ``kernel (in, out)`` -> nn.Linear ``weight (out, in)``."""
    return {f"{prefix}.weight": _t(tree["kernel"]).T.contiguous(),
            f"{prefix}.bias": _t(tree["bias"])}


def _contour_decoder(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return _contour_heads(tree["VmapArticulatorPredictor_0"], prefix)


def _contour_heads(heads: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """The stacked ``ArticulatorPredictor`` tree -> ``ContourDecoder``."""
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


def _params(tree: Mapping, prefix: str, names: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """``tree[flax]`` -> ``{prefix}.{port}`` for each ``port: flax`` of ``names``,
    kept in flax's orientation."""
    return {f"{prefix}.{port}": _t(tree[flax]) for port, flax in names.items()}


def _layer_norm(tree: Mapping, prefix: str, name: str) -> Dict[str, torch.Tensor]:
    return _params(tree, prefix, {f"{name}_scale": "scale", f"{name}_bias": "bias"})


def _dense(tree: Mapping, prefix: str, name: str) -> Dict[str, torch.Tensor]:
    return _params(tree, prefix, {f"{name}_kernel": "kernel", f"{name}_bias": "bias"})


def _attention(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """flax ``MultiHeadDotProductAttention`` -> ``MultiHeadParams``."""
    out = {}
    for name in ("query", "key", "value", "out"):
        out.update(_dense(tree[name], prefix, name))
    return out


def _channel_processing(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A (double) ``nn.vmap``-ed ``ChannelProcessingLayer`` -> the port's."""
    out = {**_layer_norm(tree["LayerNorm_0"], prefix, "ln"),
           **_attention(tree["MultiHeadDotProductAttention_0"], f"{prefix}.attn")}
    for i in range(3):
        out.update(_dense(tree[f"Dense_{i}"], prefix, f"dense{i}"))
    return out


def _count(params: Mapping, stem: str) -> int:
    return sum(1 for key in params if key.startswith(stem))


def transformer_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``ArtSpeechTransformer`` params -> the port's
    ``ArtSpeechTransformer.load_state_dict``. Every kernel keeps flax's
    orientation and stacked leading axes."""
    out = {"src_embedding.weight": _t(params["src_embedding"]["embedding"])}
    for i in range(_count(params, "encoder_layers_")):
        tree, prefix = params[f"encoder_layers_{i}"], f"encoder_layers.{i}"
        out.update(_attention(tree["MultiHeadDotProductAttention_0"], f"{prefix}.attn"))
        for j in range(2):
            out.update(_layer_norm(tree[f"LayerNorm_{j}"], prefix, f"ln{j}"))
            out.update(_dense(tree[f"Dense_{j}"], prefix, f"dense{j}"))
    for i in range(_count(params, "decoder_layers_")):
        tree, prefix = params[f"decoder_layers_{i}"], f"decoder_layers.{i}"
        inter = tree["VmapChannelInteractionsLayer_0"]
        out.update(_channel_processing(tree["VmapChannelProcessingLayer_0"], f"{prefix}.self_attn"))
        out.update(_channel_processing(inter["VmapChannelProcessingLayer_0"], f"{prefix}.inter.pairs"))
        out.update(_layer_norm(inter["LayerNorm_0"], f"{prefix}.inter", "ln"))
        out.update(_dense(inter["Dense_0"], f"{prefix}.inter", "dense"))
        out.update(_channel_processing(tree["VmapChannelProcessingLayer_1"], f"{prefix}.mem_attn"))
        out.update(_layer_norm(tree["LayerNorm_0"], prefix, "ln0"))
        out.update(_layer_norm(tree["LayerNorm_1"], prefix, "ln1"))
        out.update(_dense(tree["Dense_0"], prefix, "dense"))
    for name, kind in (("tgt_embed_ln", "scale"), ("head_ln", "scale"),
                       ("tgt_embed_dense", "kernel"), ("head_dense", "kernel")):
        out[f"{name}_{kind}"] = _t(params[name][kind])
        out[f"{name}_bias"] = _t(params[name]["bias"])
    out.update(_contour_heads(params["predictors"], "predictors"))
    return out


def latent_rnn_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``PrincipalComponentsArtSpeech`` params (its ``BiGRU_0`` or
    ``BiLSTM_0``) -> the port's ``PrincipalComponentsArtSpeech``."""
    if "BiGRU_0" in params:
        rnn = _gru_layers(params["BiGRU_0"], "rnn")
    else:
        rnn = _gru_layers(params["BiLSTM_0"], "rnn", layer="LSTMLayer")
    head = params["PrincipalComponentsPredictor_0"]
    out = {"embed.weight": _t(params["Embed_0"]["embedding"]), **rnn,
           **_linear(params["Dense_0"], "dense")}
    for i in range(3):
        out.update(_params(head[f"LayerNorm_{i}"], f"predictor.ln{i}",
                           {"scale": "scale", "bias": "bias"}))
        out.update(_linear(head[f"Dense_{i}"], f"predictor.dense{i}"))
    return out


def _articulator_net(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """An ``Encoder``/``Decoder`` (``Dense_0..2``) or a ``PCAEncoder``/
    ``PCADecoder`` (``eigenvalues``, ``eigenvectors``, ``mean``)."""
    if "Dense_0" in tree:
        out = {}
        for i in range(3):
            out.update(_linear(tree[f"Dense_{i}"], f"{prefix}.dense{i}"))
        return out
    return _params(tree, prefix, {name: name for name in ("eigenvalues", "eigenvectors", "mean")})


def autoencoder_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MultiArticulatorAutoencoder`` params (``encoders``/``decoders``),
    or a ``MultiEncoder``'s or ``MultiDecoder``'s alone (``enc_*``/``dec_*``,
    as the train CLI saves ``best_encoder`` and ``best_decoder``), AE or PCA
    -> the port's module of the same class."""
    out = {}
    for key, tree in params.items():
        if key in ("encoders", "decoders"):
            for name, net in tree.items():
                out.update(_articulator_net(net, f"{key}.{name}"))
        else:
            out.update(_articulator_net(tree, key))
    return out


def deepspeech2_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``DeepSpeech2`` params -> the port's ``DeepSpeech2``. Conv kernels
    keep flax's (K, K, I, O) and the Dense_0 rows their d * C + c order."""
    out = {}
    if "Adapter_0" in params:
        adapter = params["Adapter_0"]
        for i in range(2):
            out.update(_params(adapter[f"LayerNorm_{i}"], f"adapter.norm{i}",
                               {"scale": "scale", "bias": "bias"}))
            out.update(_linear(adapter[f"Dense_{i}"], f"adapter.dense{i}"))
    out.update(_params(params["Conv_0"], "conv", {"kernel": "kernel", "bias": "bias"}))
    for i in range(_count(params, "ResidualCNN_")):
        tree, prefix = params[f"ResidualCNN_{i}"], f"residual.{i}"
        for j in range(2):
            out.update(_params(tree[f"LayerNorm_{j}"], f"{prefix}.norm{j}",
                               {"scale": "scale", "bias": "bias"}))
            out.update(_params(tree[f"Conv_{j}"], f"{prefix}.conv{j}",
                               {"kernel": "kernel", "bias": "bias"}))
    out.update(_linear(params["Dense_0"], "dense"))
    for i in range(_count(params, "RecurrentBlock_")):
        tree, prefix = params[f"RecurrentBlock_{i}"], f"recurrent.{i}"
        out.update(_params(tree["LayerNorm_0"], f"{prefix}.norm", {"scale": "scale", "bias": "bias"}))
        out.update(_gru_layers(tree["GRUStack_0"], f"{prefix}.gru"))
    out.update(_linear(params["Dense_1"], "features"))
    out.update(_linear(params["Dense_2"], "classifier"))
    return out
