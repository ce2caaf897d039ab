"""Multi-channel transformer for phoneme-to-articulation, method D
(counterpart of artspeech_tpu/models/transformer.py): its training and
serving paths.

- ``ArtSpeechTransformer``: token encoder, multi-channel decoder (per-channel
  causal self attention, cross-channel interactions, cross attention to the
  encoder memory, feed-forward) and the per-articulator heads, with
  ``forward`` (teacher-forced, in eval or training mode), ``encode`` and
  ``generate`` (the buffer re-decode).
- In training mode the cross-channel pair attention goes through
  ``ops/hopper_train_attention.fused_causal_attend`` (the hand-written
  forward and backward kernels on the card); see
  ``ChannelInteractionsLayer``.
- ``make_fast_generate``: the KV-cached decode, whose every attend over the
  caches goes through ``ops/hopper_attention.flash_decode_attend`` (the
  hand-written kernel on the card).
- ``make_auto_generate``: the per-length choice between the two.

Every per-channel and per-channel-pair layer keeps its parameters stacked on
leading ``(C,)`` or ``(C, C-1)`` axes, in flax's layout (Dense kernels
``(in, out)``; attention ``query``/``key``/``value`` kernels ``(E, H, hd)``,
``out`` ``(H, hd, E)``), and runs as one batched product over them: there is
no Python loop over channels. The JAX package folds each LayerNorm's affine
into the next Dense kernel; the port applies it as it stands (the same
function up to float reassociation), except in the training-mode pair
attention, which folds it as JAX's ``FusedChannelInteractions`` does.

Construction takes a CPU ``torch.Generator`` for the random weights (None: one
seeded with 0; lecun-normal kernels, as flax initialises them), drawn on the
CPU and then moved, a ``device``: ``cuda`` unless the caller passes
``device="cpu"``, and a compute ``dtype`` (None: float32; ``torch.bfloat16``
for train_transformer_bf16.yaml, or ``torch.float16``). Parameters stay float32; the forward casts
where the JAX model casts (JAX transformer.py:201-290, :384-393, :590-764):
the embedding's output; every Dense, Q/K/V MLP and attention projection
(input, kernel and bias); the attention's scores, softmax and sum in the
compute dtype, as flax's ``MultiHeadDotProductAttention(dtype=...)`` runs
``lean_attention``; float32 statistics in every LayerNorm, whose output is in
the compute dtype where flax's ``LayerNorm(dtype=...)`` gives one. The
training-mode pair attention runs in float32 around
``fused_causal_attend`` and casts back, exactly as JAX (:461-467), so its
kernels take float32 only. The KV-cached decode computes in float32 whatever
the model's dtype (JAX casts the encoder memory up the same way) and keeps
its own cache dtype. In training mode (``.train()``) with dropout > 0,
``forward`` needs a ``torch.Generator`` on the model's device for the
dropout masks, as ``ArtSpeech.forward`` does; in eval mode the dropout is
inactive, as in JAX.

On a mesh with a model axis of m ranks that divides C
(``parallel/distributed.distribute_state``), every decoder layer keeps its
model rank's C/m channels of each (C, ...) and (C, C-1, ...) stack
(``shard_model_axis``) and computes those channels only, as XLA partitions
JAX's ``nn.vmap`` lifts by ``params_shardings``: the decoder's input is
sliced along C, the interactions' queries come from every channel (gathered
along C), and the head gathers the channels back before it mixes them. The
training pair attention then runs on the rank's (C/m)(C-1) pairs. Every
dropout mask over a channel axis is drawn whole from the step's generator
and sliced, so a model axis draws the masks of the one-device step. Decode
stays on one device.
"""

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.models.heads import (
    LAYER_NORM_EPS,
    ContourDecoder,
    at_least_f32,
    cast,
    layer_norm,
    lecun_normal_,
)
from artspeech_tpu_torch.ops import hopper_attention, hopper_train_attention
from artspeech_tpu_torch.ops.gru import apply_dropout
from artspeech_tpu_torch.parallel.collectives import (
    copy_to_model_axis,
    exchange_model_axis,
    gather_model_axis,
    slice_model_axis,
)
from artspeech_tpu_torch.parallel.mesh import keep_model_slice_, part_rows
from artspeech_tpu_torch.utils.masks import make_padding_mask


def sinusoidal_positions(max_len: int, dim: int) -> torch.Tensor:
    """(max_len, dim) sinusoidal table (reference models.py:9-34), float32."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table over the second-to-last axis (its dropout is
    applied by the caller)."""

    def __init__(self, dim: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer("table", sinusoidal_positions(max_len, dim), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.table[: x.shape[-2]].to(x.dtype)  # the caller's dtype, as JAX


def _drop(x, rate: float, generator: Optional[torch.Generator], axis=None):
    """flax ``nn.Dropout(rate)`` on x, one mask element per element of x;
    ``generator`` None means no dropout (eval mode, or rate 0). With a model
    ``axis`` (group, index, size), x is the rank's slice along dim 1 of a
    tensor ``size`` times as wide there: the mask is drawn whole and
    sliced."""
    if generator is None or rate == 0.0:
        return x
    if axis is None or rate >= 1.0:
        return apply_dropout(x, rate, generator)
    _, index, size = axis
    whole = (x.shape[0], x.shape[1] * size, *x.shape[2:])
    keep_prob = 1.0 - rate
    keep = torch.rand(whole, generator=generator, device=x.device)[:, part_rows(whole[1], index,
                                                                                 size)]
    return torch.where(keep < keep_prob, x / keep_prob, torch.zeros_like(x))


def _keep_mask(shape, rate: float, generator: Optional[torch.Generator], device, axis=None):
    """A pre-scaled keep mask (1 / (1 - rate) where kept, 0 elsewhere) of
    ``shape``, broadcast by the caller as flax broadcasts attention dropout;
    None without dropout. With a model ``axis``, the rank's slice of its
    leading (channel or pair-major) axis."""
    if generator is None or rate == 0.0:
        return None
    keep_prob = 1.0 - rate
    keep = (torch.rand(shape, generator=generator, device=device) < keep_prob).float() / keep_prob
    return keep if axis is None else keep[part_rows(shape[0], *axis[1:])]


def _norm_f32(x):
    """flax LayerNorm statistics without the affine, in at least float32:
    E[x^2] - E[x]^2, clamped at 0 (JAX transformer.py:84)."""
    x = at_least_f32(x)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + LAYER_NORM_EPS)


def _ln_norm(x, eps: float = LAYER_NORM_EPS):
    """The KV-cached decode's LayerNorm statistics: as :func:`_norm_f32` but
    without the clamp (JAX transformer.py:864)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + eps)


def lean_attention(query, key, value, mask=None, keep=None):
    """flax dot-product attention with the softmax normaliser folded into the
    output (JAX transformer.py:97).

    query (..., L, H, hd), key/value (..., S, H, hd), mask broadcastable to
    (..., H, L, S), True = keep -> (..., L, H, hd). Masked scores become
    ``finfo.min``, not -inf, so a fully masked row (a length-0 dummy) gets a
    uniform, finite softmax, as in JAX. ``keep``, a pre-scaled dropout keep
    mask broadcastable to (..., H, L, S), drops probabilities after the
    normaliser is taken, as flax's attention dropout does.
    """
    hd = query.shape[-1]
    s = torch.einsum("...qhd,...khd->...hqk", query / math.sqrt(hd), key)
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)  # (..., h, q, 1)
    if keep is not None:
        e = e * keep.to(e.dtype)
    o = torch.einsum("...hqk,...khd->...qhd", e, value)
    return o / z.transpose(-3, -2)  # z -> (..., q, h, 1)


def _others_index(c: int) -> np.ndarray:
    """(C, C-1): row i lists every channel but i, in order."""
    return np.asarray([[j for j in range(c) if j != i] for i in range(c)])


def _expand_others(proc, c: int, rows: slice = slice(None)):
    """(B, C, ...) -> (B, C, C-1, ...): row (i, j) is channel ``j`` skipping
    ``i`` (JAX transformer.py:154, its index gather); only the channels of
    ``rows``."""
    return proc[:, torch.as_tensor(_others_index(c)[rows], device=proc.device)]


# -- parameters ----------------------------------------------------------------

def _kernel(shape, fan_in, generator):
    p = nn.Parameter(torch.empty(shape))
    lecun_normal_(p, fan_in, generator)
    return p


def _zeros(shape):
    return nn.Parameter(torch.zeros(shape))


def _ones(shape):
    return nn.Parameter(torch.ones(shape))


class MultiHeadParams(nn.Module):
    """flax ``MultiHeadDotProductAttention``'s parameters, stacked on
    ``prefix``: ``{query,key,value}_kernel`` (*prefix, E, H, hd) and
    ``_bias`` (*prefix, H, hd), ``out_kernel`` (*prefix, H, hd, E) and
    ``out_bias`` (*prefix, E)."""

    def __init__(self, prefix: Sequence[int], e: int, h: int, generator):
        super().__init__()
        hd = e // h
        for name in ("query", "key", "value"):
            self.register_parameter(f"{name}_kernel", _kernel((*prefix, e, h, hd), e, generator))
            self.register_parameter(f"{name}_bias", _zeros((*prefix, h, hd)))
        self.out_kernel = _kernel((*prefix, h, hd, e), e, generator)
        self.out_bias = _zeros((*prefix, e))


def stacked_attention(p: MultiHeadParams, n: int, q_in, k_in, v_in, mask=None, keep=None,
                      dtype=None):
    """Multi-head attention with ``n`` stacked parameter sets, in the compute
    ``dtype`` (None: float32).

    q_in (B, n, L, E), k_in/v_in (B, n, S, E), mask and the pre-scaled
    dropout ``keep`` broadcastable to (B, n, H, L, S) -> (B, n, L, E).
    """
    e = q_in.shape[-1]
    h, hd = p.query_bias.shape[-2:]

    def project(x, name):
        w = getattr(p, f"{name}_kernel").reshape(n, e, h, hd)
        b = getattr(p, f"{name}_bias").reshape(n, 1, h, hd)
        return torch.einsum("bnle,nehd->bnlhd", cast(x, dtype), cast(w, dtype)) + cast(b, dtype)

    o = lean_attention(project(q_in, "query"), project(k_in, "key"), project(v_in, "value"),
                       mask, keep)
    return (torch.einsum("bnlhd,nhde->bnle", o, cast(p.out_kernel.reshape(n, h, hd, e), dtype))
            + cast(p.out_bias.reshape(n, 1, e), dtype))


class ChannelProcessingLayer(nn.Module):
    """LN -> Q/K/V MLPs -> MHA -> query residual (JAX transformer.py:178),
    ``prefix`` stacked parameter sets batched as one product. The same
    LayerNorm normalises src and tgt, as in the reference."""

    def __init__(self, prefix: Sequence[int], e: int, h: int, generator, dtype=None):
        super().__init__()
        self.n, self.e, self.dtype = int(np.prod(prefix)), e, dtype
        self.model_axis = None  # (group, index, size) once sharded
        self.ln_scale, self.ln_bias = _ones((*prefix, e)), _zeros((*prefix, e))
        for i in range(3):  # query, key, value MLPs (flax Dense_0/1/2)
            self.register_parameter(f"dense{i}_kernel", _kernel((*prefix, e, e), e, generator))
            self.register_parameter(f"dense{i}_bias", _zeros((*prefix, e)))
        self.attn = MultiHeadParams(prefix, e, h, generator)

    def model_axis_parameters(self):
        """(name, parameter) of every parameter ``shard_model_axis`` slices."""
        return list(self.named_parameters())

    def shard_model_axis(self, group, index: int, size: int, optimizer=None) -> None:
        """Keep this model rank's ``index``-th of ``size`` slices of every
        stacked parameter's leading axis (and of the ``optimizer``'s moments
        of each), in place, and compute those parameter sets from now on."""
        keep_model_slice_(self.parameters(), index, size, optimizer)
        self.n //= size
        self.model_axis = (group, index, size)

    def _mlp(self, i, x):
        dt = self.dtype
        w = getattr(self, f"dense{i}_kernel").reshape(self.n, self.e, self.e)
        b = getattr(self, f"dense{i}_bias").reshape(self.n, 1, self.e)
        return torch.relu(torch.einsum("bnle,nef->bnlf", cast(x, dt), cast(w, dt)) + cast(b, dt))

    def forward(self, src, tgt, mask=None, keep=None):
        """src (B, n or 1, S, E) keys/values source; tgt (B, n, L, E) queries
        source; mask broadcastable to (B, 1, L, S), True = keep; ``keep`` a
        pre-scaled attention-dropout mask (n, L, S), one a parameter set,
        broadcast over batch and heads -> (B, n, L, E)."""
        scale = self.ln_scale.reshape(self.n, 1, self.e)
        bias = self.ln_bias.reshape(self.n, 1, self.e)
        src_ln = _norm_f32(src) * scale + bias
        tgt_ln = src_ln if tgt is src else _norm_f32(tgt) * scale + bias
        query = self._mlp(0, tgt_ln)
        out = stacked_attention(self.attn, self.n, query, self._mlp(1, src_ln),
                                self._mlp(2, src_ln), None if mask is None else mask[:, None],
                                None if keep is None else keep[:, None], self.dtype)
        return query + out


class ChannelInteractionsLayer(nn.Module):
    """Each channel's frames serve as keys and values to the queries of every
    other channel; the C-1 results are concatenated, normalised and projected
    back (JAX transformer.py:238, vmapped over the channel in
    ``MultiChannelDecoderLayer``): parameters (C, C-1, ...) for the pairs,
    (C, ...) for the projection.

    In eval mode the pairs run as the stacked ``ChannelProcessingLayer`` with
    the full ``tgt_mask``. In training mode they run as JAX's
    ``FusedChannelInteractions`` (transformer.py:341-510; the same parameters,
    so the same weights): the LayerNorm affines folded into the Q/K/V MLP
    kernels, q/k/v projected pair-major to (C, C-1, B, H, L, hd) = (G, L, hd),
    and the attention through ``hopper_train_attention.fused_causal_attend``
    (on the card, the hand-written kernels), which never materialises the
    (B, C, C-1, H, L, L) scores, then the out projection and the query
    residual. That attend masks causally only: under a causal mask every key
    of a valid query is valid, and padded queries get no cotangent from the
    masked loss, so it differs from the eval path only at padded query
    positions, which the loss never reads (JAX transformer.py:373-377).
    """

    def __init__(self, c: int, e: int, h: int, generator, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.c, self.dropout, self.dtype = c, dropout, dtype
        self.pairs = ChannelProcessingLayer((c, c - 1), e, h, generator, dtype)
        self.ln_scale, self.ln_bias = _ones((c, (c - 1) * e)), _zeros((c, (c - 1) * e))
        self.dense_kernel = _kernel((c, (c - 1) * e, e), (c - 1) * e, generator)
        self.dense_bias = _zeros((c, e))
        self.model_axis = None  # (group, index, size) once sharded

    def model_axis_parameters(self):
        """(name, parameter) of every parameter ``shard_model_axis`` slices."""
        return list(self.named_parameters())

    def shard_model_axis(self, group, index: int, size: int, optimizer=None) -> None:
        """Keep this model rank's C / ``size`` channels of every stack, the
        pairs' included (and the ``optimizer``'s moments of each), and
        compute those channels from now on: ``forward`` then takes the
        rank's (B, C / size, L, E) and gathers the rest for the queries."""
        keep_model_slice_(self.parameters(recurse=False), index, size, optimizer)
        self.pairs.shard_model_axis(group, index, size, optimizer)
        self.model_axis = (group, index, size)

    def _others(self, proc):
        """The queries' source of the rank's channels: proc (B, C or C/m, L,
        E) -> (B, C or C/m, C-1, L, E), every channel but the row's own."""
        if self.model_axis is None:
            return _expand_others(proc, self.c)
        group, index, size = self.model_axis
        whole = exchange_model_axis(proc, group, index, size, dim=1)
        return _expand_others(whole, self.c, part_rows(self.c, index, size))

    def _fused_pairs(self, proc, generator):
        """The training-mode pairs (JAX transformer.py:395-496): proc (B, C, L,
        E) -> the dropped concat (B, C, L, (C-1) E); C the rank's channels on
        a model axis."""
        b, c, l, e = proc.shape
        p, a, dt, axis = self.pairs, self.pairs.attn, self.dtype, self.model_axis
        h, hd = a.query_bias.shape[-2:]
        rate = self.dropout
        # The reference drops these inputs twice (decoder and layer): one
        # drop at the composed rate is the same distribution (JAX :399-403).
        composed = 1.0 - (1.0 - rate) ** 2
        src_n = _norm_f32(_drop(proc, composed, generator, axis))  # (B, C, L, E)
        others_n = _norm_f32(_drop(self._others(proc), composed, generator, axis))

        def fold(i):
            w = getattr(p, f"dense{i}_kernel")  # (C, C-1, E, E)
            bias = torch.einsum("cje,cjef->cjf", p.ln_bias, w) + getattr(p, f"dense{i}_bias")
            return cast(p.ln_scale[..., None] * w, dt), cast(bias[:, :, None, None], dt)

        (qk, qb), (kk, kb), (vk, vb) = fold(0), fold(1), fold(2)
        others_n, src_n = cast(others_n, dt), cast(src_n, dt)
        # Queries from the other channels, keys and values from the
        # channel's own frames, pair-major: (C, C-1, B, L, E).
        q_mlp = torch.relu(torch.einsum("bcjle,cjef->cjblf", others_n, qk) + qb)
        k_mlp = torch.relu(torch.einsum("bcle,cjef->cjblf", src_n, kk) + kb)
        v_mlp = torch.relu(torch.einsum("bcle,cjef->cjblf", src_n, vk) + vb)

        def heads(x, name):  # -> (G, L, hd) in >= float32, G = (C, C-1, B, H) merged
            y = (torch.einsum("cjblf,cjfhd->cjbhld", x, cast(getattr(a, f"{name}_kernel"), dt))
                 + cast(getattr(a, f"{name}_bias")[:, :, None, :, None], dt))
            if name == "query":
                y = y * (1.0 / math.sqrt(hd))  # in the compute dtype, as JAX
            return at_least_f32(y.reshape(-1, l, hd)).contiguous()

        n_pairs, n_whole = c * (self.c - 1), self.c * (self.c - 1)
        keep = _keep_mask((n_whole, l, l), rate, generator, proc.device, axis)
        if keep is None:
            keep, n_pairs = torch.ones(1, l, l, device=proc.device), 1
        av = hopper_train_attention.fused_causal_attend(
            heads(q_mlp, "query"), heads(k_mlp, "key"), heads(v_mlp, "value"), keep, n_pairs)
        av = cast(av.reshape(c, self.c - 1, b, h, l, hd), dt)
        out_i = (torch.einsum("cjbhld,cjhde->cjble", av, cast(a.out_kernel, dt))
                 + cast(a.out_bias[:, :, None, None], dt))
        concat = (q_mlp + out_i).permute(2, 0, 3, 1, 4).reshape(b, c, l, (self.c - 1) * e)
        return _drop(concat, rate, generator, axis)

    def forward(self, proc, mask=None, generator: Optional[torch.Generator] = None):
        """proc (B, C, L, E) -> (B, C, L, E), C the rank's channels on a
        model axis; ``mask`` the eval path's (B or 1, 1, L, L) tgt_mask;
        ``generator`` the training dropout's."""
        b, c, l, e = proc.shape
        if self.training:
            concat = self._fused_pairs(proc, generator)
        else:
            others = self._others(proc)  # queries: (B, C, C-1, L, E)
            own = proc[:, :, None].expand_as(others)  # keys and values: the channel itself
            outs = self.pairs(own.reshape(b, -1, l, e), others.reshape(b, -1, l, e), mask)
            concat = outs.reshape(b, c, self.c - 1, l, e).permute(0, 1, 3, 2, 4).reshape(b, c, l, -1)
        dt = self.dtype
        h = _norm_f32(concat) * self.ln_scale[:, None] + self.ln_bias[:, None]
        return torch.relu(torch.einsum("bclx,cxe->bcle", cast(h, dt), cast(self.dense_kernel, dt))
                          + cast(self.dense_bias[:, None], dt))


class MultiChannelDecoderLayer(nn.Module):
    """Self attention per channel -> cross-channel interactions -> cross
    attention to the encoder memory -> LN -> feed-forward with pre-LN
    (JAX transformer.py:582)."""

    def __init__(self, c: int, e: int, h: int, generator, dropout: float = 0.0, dtype=None):
        super().__init__()
        self.c, self.dropout, self.dtype = c, dropout, dtype
        self.self_attn = ChannelProcessingLayer((c,), e, h, generator, dtype)
        self.inter = ChannelInteractionsLayer(c, e, h, generator, dropout, dtype)
        self.mem_attn = ChannelProcessingLayer((c,), e, h, generator, dtype)
        self.ln0_scale, self.ln0_bias = _ones(e), _zeros(e)
        self.ln1_scale, self.ln1_bias = _ones(e), _zeros(e)
        self.dense_kernel, self.dense_bias = _kernel((e, e), e, generator), _zeros(e)
        self.model_axis = None  # (group, index, size) once sharded

    def model_axis_parameters(self):
        """(name, parameter) of every parameter ``shard_model_axis`` slices:
        the channel stacks. The LayerNorms and the feed-forward, shared by
        every channel, stay whole."""
        return [(f"{name}.{n}", p) for name in ("self_attn", "inter", "mem_attn")
                for n, p in getattr(self, name).model_axis_parameters()]

    def shard_model_axis(self, group, index: int, size: int, optimizer=None) -> None:
        """Keep this model rank's C / ``size`` channels of every channel
        stack (and the ``optimizer``'s moments of each); ``forward`` then
        takes and returns the rank's (B, C / size, L, E)."""
        for name in ("self_attn", "inter", "mem_attn"):
            getattr(self, name).shard_model_axis(group, index, size, optimizer)
        self.model_axis = (group, index, size)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                generator: Optional[torch.Generator] = None):
        """tgt (B, C, L, E), memory (B, S, E), tgt_mask (B or 1, 1, L, L),
        memory_mask (B, 1, 1, S) -> (B, C, L, E), C the rank's channels on a
        model axis; ``generator`` draws the training dropout (None: none)."""
        rate, c, dev, axis = self.dropout, self.c, tgt.device, self.model_axis
        l, s = tgt.shape[2], memory.shape[1]
        tgt_d = _drop(tgt, rate, generator, axis)
        proc = self.self_attn(tgt_d, tgt_d, tgt_mask,
                              _keep_mask((c, l, l), rate, generator, dev, axis))
        inter = self.inter(proc, tgt_mask, generator)
        # One memory mask shared by every channel (JAX :657).
        mem_d, inter_d = _drop(memory, rate, generator), _drop(inter, rate, generator, axis)
        attended = self.mem_attn(mem_d[:, None], inter_d, memory_mask,
                                 _keep_mask((c, l, s), rate, generator, dev, axis))
        # Shared by every channel: on a model axis each rank's gradient of
        # these covers its channels only, so the copy sums it over the ranks.
        group = None if axis is None else axis[0]
        ln0_scale, ln0_bias, ln1_scale, ln1_bias, kernel, bias = (
            copy_to_model_axis(p, group) for p in (self.ln0_scale, self.ln0_bias, self.ln1_scale,
                                                   self.ln1_bias, self.dense_kernel,
                                                   self.dense_bias))
        dt = self.dtype
        attended = layer_norm(attended, ln0_scale, ln0_bias, dtype=dt)
        h = layer_norm(at_least_f32(_drop(attended, rate, generator, axis)), ln1_scale, ln1_bias)
        return attended + torch.relu(cast(h, dt) @ cast(kernel, dt) + cast(bias, dt))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer, ReLU feed-forward (JAX transformer.py:674)."""

    def __init__(self, e: int, h: int, ff_dim: int, generator, dropout: float = 0.0,
                 dtype=None):
        super().__init__()
        self.dropout, self.dtype = dropout, dtype
        self.attn = MultiHeadParams((), e, h, generator)
        self.ln0_scale, self.ln0_bias = _ones(e), _zeros(e)
        self.dense0_kernel, self.dense0_bias = _kernel((e, ff_dim), e, generator), _zeros(ff_dim)
        self.dense1_kernel, self.dense1_bias = _kernel((ff_dim, e), ff_dim, generator), _zeros(e)
        self.ln1_scale, self.ln1_bias = _ones(e), _zeros(e)

    def forward(self, x, mask=None, generator: Optional[torch.Generator] = None):
        """x (B, S, E), mask (B, 1, 1, S) keys kept -> (B, S, E); ``generator``
        draws the training dropout (None: none)."""
        rate, s, dt = self.dropout, x.shape[1], self.dtype
        xs = x[:, None]
        keep = _keep_mask((1, s, s), rate, generator, x.device)  # one (S, S) mask a layer
        attn = stacked_attention(self.attn, 1, xs, xs, xs, None if mask is None else mask[:, None],
                                 None if keep is None else keep[:, None], dt)
        x = layer_norm(x + _drop(attn[:, 0], rate, generator), self.ln0_scale, self.ln0_bias,
                       dtype=dt)
        ff = cast(x, dt) @ cast(self.dense0_kernel, dt) + cast(self.dense0_bias, dt)
        ff = _drop(torch.relu(ff), rate, generator)
        ff = ff @ cast(self.dense1_kernel, dt) + cast(self.dense1_bias, dt)
        return layer_norm(x + _drop(ff, rate, generator), self.ln1_scale, self.ln1_bias,
                          dtype=dt)


class ArtSpeechTransformer(nn.Module):
    """Token encoder + multi-channel decoder + per-articulator predictors
    (JAX transformer.py:701). Contours come out (B, L, C, 2, num_feat // 2)."""

    def __init__(self, vocab_size: int, num_articulators: int, embed_dim: int = 64,
                 num_heads: int = 4, num_layers: int = 4, num_feat: int = 100,
                 dropout: float = 0.0, encoder_ff_dim: int = 2048,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        c, e = num_articulators, embed_dim
        self.num_articulators, self.embed_dim, self.num_heads = c, e, num_heads
        self.num_layers, self.num_feat, self.dropout = num_layers, num_feat, dropout
        self.dtype = dtype
        self.src_embedding = nn.Embedding(vocab_size, e)
        with torch.no_grad():  # flax nn.Embed's default init: N(0, 1/embed_dim)
            self.src_embedding.weight.normal_(0.0, math.sqrt(1.0 / e), generator=gen)
        self.pos_encoding = PositionalEncoding(e)
        self.encoder_layers = nn.ModuleList(
            TransformerEncoderLayer(e, num_heads, encoder_ff_dim, gen, dropout, dtype)
            for _ in range(num_layers))
        self.decoder_layers = nn.ModuleList(
            MultiChannelDecoderLayer(c, e, num_heads, gen, dropout, dtype)
            for _ in range(num_layers))
        self.tgt_embed_ln_scale, self.tgt_embed_ln_bias = _ones(num_feat), _zeros(num_feat)
        self.tgt_embed_dense_kernel = _kernel((num_feat, e), num_feat, gen)
        self.tgt_embed_dense_bias = _zeros(e)
        self.head_ln_scale, self.head_ln_bias = _ones(c * e), _zeros(c * e)
        self.head_dense_kernel, self.head_dense_bias = _kernel((c * e, e), c * e, gen), _zeros(e)
        self.predictors = ContourDecoder(e, c, num_feat // 2, generator=gen, dtype=dtype)
        self.to(dev)
        self.eval()

    def _encode(self, src, src_mask, generator=None):
        embed = cast(self.src_embedding(src), self.dtype)
        h = _drop(self.pos_encoding(embed), self.dropout, generator)
        enc_mask = None if src_mask is None else src_mask[:, None, None, :]  # keys masked
        for layer in self.encoder_layers:
            h = layer(h, enc_mask, generator)
        return h

    @property
    def channel_axis(self):
        """(group, index, size) once the decoder's channels are split over a
        model axis (``shard_model_axis`` of its layers), else None."""
        return self.decoder_layers[0].model_axis if len(self.decoder_layers) else None

    def _decode(self, tgt, memory, tgt_mask, memory_mask, generator=None):
        """tgt (B, L, C, F) -> (B, L, C, 2, D) sigmoid contours."""
        b, l, c, _ = tgt.shape
        dt = self.dtype
        h = layer_norm(tgt, self.tgt_embed_ln_scale, self.tgt_embed_ln_bias, dtype=dt)
        h = torch.relu(h @ cast(self.tgt_embed_dense_kernel, dt) + cast(self.tgt_embed_dense_bias, dt))
        h = _drop(self.pos_encoding(h.permute(0, 2, 1, 3)), self.dropout, generator)  # (B, C, L, E)
        axis = self.channel_axis
        if axis is not None:  # the layers run on the rank's channels
            h = slice_model_axis(h, *axis, dim=1)
            memory = copy_to_model_axis(memory, axis[0])
        for layer in self.decoder_layers:
            h = layer(h, memory, tgt_mask, memory_mask, generator)
        if axis is not None:
            h = gather_model_axis(h, *axis, dim=1)
        h = h.permute(0, 2, 1, 3).reshape(b, l, c * self.embed_dim)
        h = layer_norm(h, self.head_ln_scale, self.head_ln_bias, dtype=dt)
        return self.predictors(torch.relu(h @ cast(self.head_dense_kernel, dt)
                                          + cast(self.head_dense_bias, dt)))

    def forward(self, src, tgt, src_lengths=None, tgt_lengths=None,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced forward: src (B, S) token ids, tgt (B, L, C, F)
        right-shifted targets -> (B, L, C, 2, D).

        In training mode, with dropout > 0, ``generator`` (a ``torch.Generator``
        on the model's device) draws every dropout mask of the JAX model's
        ``deterministic=False`` forward, with flax's semantics (keep with
        probability 1 - p, kept values scaled by 1 / (1 - p)):
        - the positional encodings' outputs, encoder and decoder (JAX :42-52,
          :768, :782);
        - the encoder's attention probabilities, one (S, S) mask a layer
          broadcast over batch and heads (``lean_attention`` :138-147 under
          :686-692), and its residual and feed-forward drops (:693-698);
        - the decoder's ``drop(tgt)`` (:613); its self- and memory-attention
          probabilities, one mask a channel, broadcast over batch and heads
          (split rngs, :605-612, :649-656);
        - in the cross-channel interactions, the inputs at the composed rate
          1 - (1 - p)^2 (:399-403), one attention keep mask a (c, j) pair,
          (C (C-1), L, L), broadcast over batch and heads (:449-458), and the
          concat drop (:496);
        - ``drop(memory)``, one (B, S, E) mask shared by every channel
          (:657), ``drop(inter)`` (:658) and the pre-feed-forward drop (:669).
        torch draws other bits than JAX from any seed: the masks agree with
        JAX's in distribution, not bit for bit. In eval mode nothing drops
        and the generator is not needed.
        """
        gen = None
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("ArtSpeechTransformer: dropout in training mode needs a "
                                 "torch.Generator on the model's device (pass generator=...)")
            gen = generator
        l = tgt.shape[1]
        src_mask = None if src_lengths is None else make_padding_mask(src_lengths, src.shape[1])
        memory = self._encode(src, src_mask, gen)
        memory_mask = None if src_mask is None else src_mask[:, None, None, :]
        tgt_mask = torch.tril(torch.ones(l, l, dtype=torch.bool, device=tgt.device))[None, None]
        if tgt_lengths is not None:
            tgt_mask = tgt_mask & make_padding_mask(tgt_lengths, l)[:, None, None, :]
        return self._decode(tgt, memory, tgt_mask, memory_mask, gen)

    def encode(self, src, src_lengths=None):
        """The encoder memory (B, S, E) and its mask (B, 1, 1, S) (None
        without lengths), without dropout."""
        src_mask = None if src_lengths is None else make_padding_mask(src_lengths, src.shape[1])
        memory = self._encode(src, src_mask)
        return memory, None if src_mask is None else src_mask[:, None, None, :]

    @torch.inference_mode()
    def generate(self, src, src_lengths=None):
        """Autoregressive generation from a zero start frame by re-decoding
        the whole buffer each step (JAX transformer.py:833) -> (B, S, C, 2, D),
        under ``torch.inference_mode``."""
        b, s = src.shape
        c, f = self.num_articulators, self.num_feat
        memory, memory_mask = self.encode(src, src_lengths)
        causal = torch.tril(torch.ones(s + 1, s + 1, dtype=torch.bool, device=src.device))[None, None]
        buf = torch.zeros(b, s + 1, c, f, device=memory.device)
        for t in range(s):
            out = self._decode(buf, memory, causal, memory_mask)
            buf[:, t + 1] = out[:, t].reshape(b, c, f)
        return buf[:, 1:].reshape(b, s, c, 2, f // 2)


# -- the KV-cached decode ------------------------------------------------------

def _cache_dtype(cache_dtype: Optional[str]) -> torch.dtype:
    """None (float32), "float32", "bfloat16" or "float16" -> the torch dtype."""
    dtype = torch.float32 if cache_dtype is None else getattr(torch, str(cache_dtype), None)
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"cache_dtype must be float32, bfloat16 or float16, got {cache_dtype}")
    return dtype


def make_fast_generate(model: ArtSpeechTransformer, cache_dtype: Optional[str] = None,
                       device: DeviceLike = None):
    """KV-cached autoregressive generation (JAX transformer.py:871).

    The memory-side K/V of every layer's cross attention are projected once,
    before the time loop. Each layer keeps its self and cross-channel K/V
    caches as (S, hd, G) tensors, G being every batch, channel (pair) and head
    dimension merged, in ``cache_dtype`` (float32, bfloat16 or float16; a row is
    rounded to nearest even on writing, as JAX's ``astype``); they are
    allocated once per call and written in place, a row a step. The loop over
    time is a Python loop with a host int ``t``: at every step and layer both
    attends call ``hopper_attention.flash_decode_attend(..., n_rows=t + 1)``
    — on the card the kernel, always, at every G. Score and softmax math is
    float32 whatever the cache dtype. The rest of the step (the projections,
    the cross attention to the memory, the feed-forward and the heads) is
    plain torch, as JAX left it to XLA.

    The TPU version's ``n_chunks`` (static-shape prefix scans) and
    ``attend_impl`` (its dispatch between an XLA and a Pallas attend) are not
    ported: reading exactly the ``t + 1`` live rows makes both moot, and in
    JAX the rows past ``t`` contribute exact zeros.

    ``model`` must be on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``). Returns ``fast_generate(src, src_lengths=None)`` ->
    (B, S, C, 2, D), which runs under ``torch.inference_mode``.
    """
    dev = resolve_device(device)
    dtype = _cache_dtype(cache_dtype)
    if model.channel_axis is not None:
        raise ValueError("the decode runs on one device: load the whole checkpoint into an "
                         "unsharded model")
    c, e, f = model.num_articulators, model.embed_dim, model.num_feat
    n_heads = model.num_heads
    hd = e // n_heads
    scale = 1.0 / math.sqrt(hd)
    layers = list(model.decoder_layers)
    others = torch.as_tensor(_others_index(c), device=dev)
    attend = hopper_attention.flash_decode_attend

    def ln(x, s, b):
        return _ln_norm(x) * s + b

    def self_side(p, x):
        """Per-channel LN -> Q/K/V MLPs -> MHA projections on one frame:
        x (B, C, E) -> q_mlp (B, C, E), q/k/v (B, C, H, hd)."""
        x_ln = ln(x, p.ln_scale, p.ln_bias)
        mlp = [torch.relu(torch.einsum("bce,cef->bcf", x_ln, getattr(p, f"dense{i}_kernel"))
                          + getattr(p, f"dense{i}_bias")) for i in range(3)]
        proj = [torch.einsum("bcf,cfhd->bchd", m, getattr(p.attn, f"{name}_kernel"))
                + getattr(p.attn, f"{name}_bias") for m, name in zip(mlp, ("query", "key", "value"))]
        return mlp[0], proj

    def pair_side(p, proc):
        """The cross-channel pairs on one frame: queries from the other
        channels, keys/values from the channel's own: proc (B, C, E) ->
        q_mlp (B, C, C-1, E), q/k/v (B, C, C-1, H, hd)."""
        proc_norm = _ln_norm(proc)
        own = proc_norm[:, :, None] * p.ln_scale + p.ln_bias
        other = proc_norm[:, others] * p.ln_scale + p.ln_bias
        mlp = [torch.relu(torch.einsum("bcje,cjef->bcjf", x, getattr(p, f"dense{i}_kernel"))
                          + getattr(p, f"dense{i}_bias")) for i, x in ((0, other), (1, own), (2, own))]
        proj = [torch.einsum("bcjf,cjfhd->bcjhd", m, getattr(p.attn, f"{name}_kernel"))
                + getattr(p.attn, f"{name}_bias") for m, name in zip(mlp, ("query", "key", "value"))]
        return mlp[0], proj

    def cached_attend(cache_k, cache_v, q, k_new, v_new, t):
        """Write row t of both caches, attend over rows [0, t] -> (G, hd)."""
        g = cache_k.shape[2]
        cache_k[t].copy_(k_new.reshape(g, hd).T)
        cache_v[t].copy_(v_new.reshape(g, hd).T)
        qg = (q * scale).reshape(g, hd).T.contiguous()
        return attend(cache_k, cache_v, qg, t + 1).T

    def predict_frame(hh):
        """The per-articulator heads on one frame (B, E) -> (B, C, F)."""
        pp = model.predictors
        h = ln(hh[:, None], pp.ln0_scale, pp.ln0_bias)  # (B, C, E)
        for i in (1, 2):
            h = torch.relu(torch.einsum("bce,ceg->bcg", h, getattr(pp, f"dense{i - 1}_kernel"))
                           + getattr(pp, f"dense{i - 1}_bias"))
            h = ln(h, getattr(pp, f"ln{i}_scale"), getattr(pp, f"ln{i}_bias"))
        x_pos = torch.einsum("bck,ckd->bcd", h, pp.dense2_kernel) + pp.dense2_bias
        y_pos = torch.einsum("bck,ckd->bcd", h, pp.dense3_kernel) + pp.dense3_bias
        return torch.sigmoid(torch.stack([x_pos, y_pos], dim=-2)).reshape(h.shape[0], c, f)

    @torch.inference_mode()
    def fast_generate(src, src_lengths=None):
        src = torch.as_tensor(src, device=dev)
        src_lengths = None if src_lengths is None else torch.as_tensor(src_lengths, device=dev)
        b, s = src.shape
        memory, memory_mask = model.encode(src, src_lengths)
        memory = memory.float()  # a bf16-compute model's memory, cast up as JAX does
        neg = torch.finfo(memory.dtype).min
        mem_bias = (torch.zeros(b, 1, 1, s, device=dev) if memory_mask is None
                    else torch.where(memory_mask, 0.0, neg))

        # Hoisted: the memory's K/V through every layer's per-channel cross
        # attention (LN -> K/V MLP -> MHA K/V projection), (B, C, S, H, hd).
        mem_norm = _ln_norm(memory)
        mem_kv = []
        for layer in layers:
            p = layer.mem_attn
            src_ln = mem_norm[:, None] * p.ln_scale[None, :, None] + p.ln_bias[None, :, None]
            kv = []
            for i, name in ((1, "key"), (2, "value")):
                mlp = torch.relu(torch.einsum("bcse,cef->bcsf", src_ln, getattr(p, f"dense{i}_kernel"))
                                 + getattr(p, f"dense{i}_bias")[None, :, None])
                kv.append(torch.einsum("bcsf,cfhd->bcshd", mlp, getattr(p.attn, f"{name}_kernel"))
                          + getattr(p.attn, f"{name}_bias")[None, :, None])
            mem_kv.append(kv)
        pos_table = sinusoidal_positions(s, e).to(dev)

        # Rows past t are never read (the attend takes n_rows = t + 1), so
        # the caches need no zeroing.
        g_self, g_pair = b * c * n_heads, b * c * (c - 1) * n_heads
        caches = [[torch.empty((s, hd, g), dtype=dtype, device=dev)
                   for g in (g_self, g_self, g_pair, g_pair)] for _ in layers]
        prev = torch.zeros(b, c, f, device=dev)
        frames = []
        for t in range(s):
            h = ln(prev, model.tgt_embed_ln_scale, model.tgt_embed_ln_bias)
            h = torch.relu(h @ model.tgt_embed_dense_kernel + model.tgt_embed_dense_bias) + pos_table[t]
            for layer, (k_self, v_self, k_pair, v_pair), (mem_k, mem_v) in zip(layers, caches, mem_kv):
                # 1. per-channel causal self attention
                p = layer.self_attn
                q_mlp, (q, k_new, v_new) = self_side(p, h)
                av = cached_attend(k_self, v_self, q, k_new, v_new, t).reshape(b, c, n_heads, hd)
                proc = q_mlp + torch.einsum("bchd,chde->bce", av, p.attn.out_kernel) + p.attn.out_bias
                # 2. cross-channel interactions
                ip = layer.inter
                pp = ip.pairs
                q_mlp_i, (q_i, k_i, v_i) = pair_side(pp, proc)
                av_i = cached_attend(k_pair, v_pair, q_i, k_i, v_i, t).reshape(b, c, c - 1, n_heads, hd)
                outs = q_mlp_i + torch.einsum("bcjhd,cjhde->bcje", av_i, pp.attn.out_kernel) \
                    + pp.attn.out_bias
                concat = ln(outs.reshape(b, c, (c - 1) * e), ip.ln_scale, ip.ln_bias)
                inter = torch.relu(torch.einsum("bcx,cxe->bce", concat, ip.dense_kernel) + ip.dense_bias)
                # 3. cross attention to the encoder memory (hoisted K/V)
                mp = layer.mem_attn
                inter_ln = ln(inter, mp.ln_scale, mp.ln_bias)
                q_mlp_m = torch.relu(torch.einsum("bce,cef->bcf", inter_ln, mp.dense0_kernel)
                                     + mp.dense0_bias)
                q_m = torch.einsum("bcf,cfhd->bchd", q_mlp_m, mp.attn.query_kernel) + mp.attn.query_bias
                logits_m = torch.einsum("bchd,bcshd->bchs", q_m * scale, mem_k) + mem_bias
                av_m = torch.einsum("bchs,bcshd->bchd", torch.softmax(logits_m, dim=-1), mem_v)
                attended = q_mlp_m + torch.einsum("bchd,chde->bce", av_m, mp.attn.out_kernel) \
                    + mp.attn.out_bias
                # 4. LN, then the feed-forward with pre-LN
                attended = ln(attended, layer.ln0_scale, layer.ln0_bias)
                h_ff = ln(attended, layer.ln1_scale, layer.ln1_bias)
                h = attended + torch.relu(h_ff @ layer.dense_kernel + layer.dense_bias)
            flat = ln(h.reshape(b, c * e), model.head_ln_scale, model.head_ln_bias)
            prev = predict_frame(torch.relu(flat @ model.head_dense_kernel + model.head_dense_bias))
            frames.append(prev)
        return torch.stack(frames, dim=1).reshape(b, s, c, 2, f // 2)

    return fast_generate


#: Source lengths at which the buffer re-decode beats the cached decode with
#: float32 caches: none on the H100 (LO > HI; see make_auto_generate).
BUFFER_WINS_LO = 1
BUFFER_WINS_HI = 0


def make_auto_generate(model: ArtSpeechTransformer, cache_dtype: Optional[str] = None,
                       device: DeviceLike = None):
    """Per-length choice between the KV-cached decode and the buffer
    re-decode (JAX transformer.py:1195): the buffer is taken for float32
    caches at source lengths in ``[BUFFER_WINS_LO, BUFFER_WINS_HI]``, the
    cached decode everywhere else and always with 16-bit caches.

    The JAX band (64-112) was measured on a TPU v5e and does not carry over.
    The port's band comes from chip_smoke.py's ``[decode]`` sweep, the cached
    float32 decode against the buffer re-decode at B=12 on an NVIDIA H100
    80GB HBM3 (700 W): the cached decode won at every length (ms, cached vs
    buffer: T=32 590 vs 802, T=64 1131 vs 1606, T=96 1666 vs 2654, T=112
    2443 vs 2866, T=128 1743 vs 2568), so the band is empty.

    Returns ``auto_generate(src, src_lengths=None)`` -> (B, S, C, 2, D).
    """
    fast = make_fast_generate(model, cache_dtype, device)
    buffer_band = _cache_dtype(cache_dtype) == torch.float32
    dev = resolve_device(device)

    def auto_generate(src, src_lengths=None):
        if buffer_band and BUFFER_WINS_LO <= src.shape[1] <= BUFFER_WINS_HI:
            lengths = None if src_lengths is None else torch.as_tensor(src_lengths, device=dev)
            return model.generate(torch.as_tensor(src, device=dev), lengths)
        return fast(src, src_lengths)

    return auto_generate
