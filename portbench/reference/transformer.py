"""Plain reference of the multi-channel transformer (configuration
``multichannel_transformer``) in training mode, and its train step
(teacher forcing on the right-shifted targets, masked-Euclidean loss, AdamW).

Written from the model's description, one channel and one channel pair at a
time with plain products, every attention materialised:

- encoder: token embedding + sinusoidal positions, dropout; per layer
  multi-head self attention over the valid source tokens (its probabilities
  dropped by one (S, S) mask a layer), residual dropout, post-LN, ReLU
  feed-forward with dropout inside and after, post-LN;
- decoder: LN -> Dense -> ReLU of each channel's right-shifted target
  frame, positions, dropout; per layer and channel: causal self attention
  (LN -> Q/K/V ReLU MLPs -> attention, one dropout mask a channel, plus the
  query), the cross-channel interactions (for each ordered pair (c, j),
  queries from channel j and keys and values from channel c, each input
  dropped at the composed rate 1 - (1 - p)^2 and normalised, causal
  attention with one dropout mask a pair; the C - 1 results concatenated,
  dropped, LN, Dense, ReLU), attention to the dropped encoder memory (one
  mask a channel), LN, and a pre-LN feed-forward with dropout;
- head: the channels concatenated, LN, Dense, ReLU, the per-articulator
  contour heads.

Dropout masks are drawn in the program's order and shapes from the seed the
benchmark gives both. Departures from the program's order of computation:
the program batches channels and pairs into single products, folds the
pairs' LayerNorm affine into the Q/K/V kernels, and runs the pair attention
in its fused kernels without materialising the scores (the causal mask
alone: padded query rows differ, and the loss never reads them); here
nothing is folded or fused, and the pair attention also masks padded keys
(every key of a valid query is valid under the causal mask, so valid rows
agree).
"""

import math

import torch

from portbench.reference.common import (
    MaskStream,
    contour_heads,
    contour_heads_spec,
    dropped,
    layer_norm,
    train_steps,
    uniform_bound,
    valid_mask,
)


def _mha_spec(prefix, lead, e, h):
    hd = e // h
    spec = {}
    for name in ("query", "key", "value"):
        spec[f"{prefix}{name}_kernel"] = ((*lead, e, h, hd), 0.0, uniform_bound(e))
        spec[f"{prefix}{name}_bias"] = ((*lead, h, hd), 0.0, 0.05)
    spec[f"{prefix}out_kernel"] = ((*lead, h, hd, e), 0.0, uniform_bound(e))
    spec[f"{prefix}out_bias"] = ((*lead, e), 0.0, 0.05)
    return spec


def _ln_spec(prefix, shape):
    return {f"{prefix}_scale": (shape, 1.0, 0.1), f"{prefix}_bias": (shape, 0.0, 0.05)}


def _dense_spec(prefix, lead, fan_in, fan_out):
    return {f"{prefix}_kernel": ((*lead, fan_in, fan_out), 0.0, uniform_bound(fan_in)),
            f"{prefix}_bias": ((*lead, fan_out), 0.0, 0.05)}


def _processing_spec(prefix, lead, e, h):
    spec = {f"{prefix}ln_scale": ((*lead, e), 1.0, 0.1), f"{prefix}ln_bias": ((*lead, e), 0.0, 0.05)}
    for i in range(3):
        spec.update(_dense_spec(f"{prefix}dense{i}", lead, e, e))
    spec.update(_mha_spec(f"{prefix}attn.", lead, e, h))
    return spec


def param_spec(cfg):
    """name -> (shape, centre, half width) of every parameter."""
    e, h, ff, f = cfg["embed_dim"], cfg["num_heads"], cfg["encoder_ff_dim"], cfg["num_feat"]
    c, v = len(cfg["articulators"]), cfg["vocab_size"]
    spec = {"src_embedding.weight": ((v, e), 0.0, uniform_bound(e))}
    for i in range(cfg["num_layers"]):
        p = f"encoder_layers.{i}."
        spec.update(_mha_spec(p + "attn.", (), e, h))
        spec.update(_ln_spec(p + "ln0", (e,)))
        spec.update(_dense_spec(p + "dense0", (), e, ff))
        spec.update(_dense_spec(p + "dense1", (), ff, e))
        spec.update(_ln_spec(p + "ln1", (e,)))
    for i in range(cfg["num_layers"]):
        p = f"decoder_layers.{i}."
        spec.update(_processing_spec(p + "self_attn.", (c,), e, h))
        spec.update(_processing_spec(p + "inter.pairs.", (c, c - 1), e, h))
        spec.update(_ln_spec(p + "inter.ln", (c, (c - 1) * e)))
        spec.update(_dense_spec(p + "inter.dense", (c,), (c - 1) * e, e))
        spec.update(_processing_spec(p + "mem_attn.", (c,), e, h))
        spec.update(_ln_spec(p + "ln0", (e,)))
        spec.update(_ln_spec(p + "ln1", (e,)))
        spec.update(_dense_spec(p + "dense", (), e, e))
    spec.update(_ln_spec("tgt_embed_ln", (f,)))
    spec.update(_dense_spec("tgt_embed_dense", (), f, e))
    spec.update(_ln_spec("head_ln", (c * e,)))
    spec.update(_dense_spec("head_dense", (), c * e, e))
    spec.update(contour_heads_spec("predictors.", c, e, f // 2))
    return spec


def positions(n: int, dim: int, device):
    """(n, dim) sinusoidal table: sin on even, cos on odd dimensions."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    freq = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / dim))
    table = torch.zeros(n, dim, device=device)
    table[:, 0::2] = torch.sin(pos * freq)
    table[:, 1::2] = torch.cos(pos * freq)
    return table


def normalised(x):
    """LayerNorm statistics without the affine."""
    ones = torch.ones(x.shape[-1], device=x.device)
    return layer_norm(x, ones, torch.zeros_like(ones))


def attention(w, p, q_in, k_in, v_in, mask, keep):
    """Multi-head attention with the parameters under prefix ``p`` (its
    leading index already taken): q_in (B, L, E), k_in/v_in (B, S, E), mask
    broadcastable to (B, H, L, S) (True = attend), ``keep`` a boolean
    dropout mask broadcastable to it, or None -> (B, L, E). Probabilities
    are dropped after the softmax's normaliser is taken."""
    wq, bq = w(p + "query_kernel"), w(p + "query_bias")
    h, hd = bq.shape
    b, l, e = q_in.shape
    q = (q_in @ wq.reshape(e, h * hd) + bq.reshape(-1)).reshape(b, l, h, hd).transpose(1, 2)
    k = (k_in @ w(p + "key_kernel").reshape(e, h * hd)
         + w(p + "key_bias").reshape(-1)).reshape(b, -1, h, hd).transpose(1, 2)
    v = (v_in @ w(p + "value_kernel").reshape(e, h * hd)
         + w(p + "value_bias").reshape(-1)).reshape(b, -1, h, hd).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    s = s.masked_fill(~mask, float("-inf"))
    prob = torch.softmax(s, dim=-1)
    if keep is not None:
        prob = dropped(prob, keep.mask, keep.rate)
    o = (prob @ v).transpose(1, 2).reshape(b, l, h * hd)
    return o @ w(p + "out_kernel").reshape(h * hd, e) + w(p + "out_bias")


class _Keep:
    """A boolean keep mask that carries its rate."""

    def __init__(self, mask, rate):
        self.mask, self.rate = mask, rate

    def __getitem__(self, index):
        return _Keep(self.mask[index], self.rate)


def _keep(masks, shape, rate):
    return _Keep(masks.keep(shape, rate), rate)


def forward(cfg, weights, src, tgt, src_lengths, tgt_lengths, masks: MaskStream):
    """Teacher-forced training forward: src (B, S) tokens, tgt (B, L, C, F)
    right-shifted targets -> (B, L, C, 2, F / 2) contours."""
    rate, n_layers = cfg["dropout"], cfg["num_layers"]
    b, s_len = src.shape
    _, l, c, f = tgt.shape
    e = cfg["embed_dim"]
    dev = src.device

    def w(name):
        return weights[name]

    def drop(x, r=rate):
        return dropped(x, masks.keep(x.shape, r), r)

    # Encoder.
    key_valid = valid_mask(src_lengths, s_len)[:, None, None, :]  # (B, 1, 1, S)
    x = drop(w("src_embedding.weight")[src] + positions(s_len, e, dev))
    for i in range(n_layers):
        p = f"encoder_layers.{i}."
        keep = _keep(masks, (1, s_len, s_len), rate)
        keep.mask = keep.mask[:, None]  # (1, 1, S, S): one mask a layer
        a = attention(lambda n: w(p + "attn." + n), "", x, x, x, key_valid, keep)
        x = layer_norm(x + drop(a), w(p + "ln0_scale"), w(p + "ln0_bias"))
        hid = drop(torch.relu(x @ w(p + "dense0_kernel") + w(p + "dense0_bias")))
        x = layer_norm(x + drop(hid @ w(p + "dense1_kernel") + w(p + "dense1_bias")),
                       w(p + "ln1_scale"), w(p + "ln1_bias"))
    memory = x

    # Decoder.
    causal = torch.tril(torch.ones(l, l, dtype=torch.bool, device=dev))
    tgt_valid = valid_mask(tgt_lengths, l)
    self_mask = causal[None, None] & tgt_valid[:, None, None, :]  # (B, 1, L, L)
    h = layer_norm(tgt, w("tgt_embed_ln_scale"), w("tgt_embed_ln_bias"))
    h = torch.relu(h @ w("tgt_embed_dense_kernel") + w("tgt_embed_dense_bias"))
    h = drop(h.permute(0, 2, 1, 3) + positions(l, e, dev))  # (B, C, L, E)
    composed = 1.0 - (1.0 - rate) ** 2
    for i in range(n_layers):
        p = f"decoder_layers.{i}."

        def processing(q, idx, src_x, tgt_x, mask, keep):
            def pw(n):
                return w(q + n)[idx]
            src_ln = normalised(src_x) * pw("ln_scale") + pw("ln_bias")
            tgt_ln = normalised(tgt_x) * pw("ln_scale") + pw("ln_bias")
            query = torch.relu(tgt_ln @ pw("dense0_kernel") + pw("dense0_bias"))
            key = torch.relu(src_ln @ pw("dense1_kernel") + pw("dense1_bias"))
            value = torch.relu(src_ln @ pw("dense2_kernel") + pw("dense2_bias"))
            return query + attention(lambda n: w(q + "attn." + n)[idx], "", query, key, value,
                                     mask, keep)

        tgt_d = drop(h)
        keep_self = _keep(masks, (c, l, l), rate)
        proc = torch.stack([processing(p + "self_attn.", ch, tgt_d[:, ch], tgt_d[:, ch], self_mask,
                                       keep_self[ch][None, None]) for ch in range(c)], dim=1)

        # Cross-channel interactions.
        own = normalised(drop(proc, composed))  # (B, C, L, E)
        others_idx = [[j for j in range(c) if j != ch] for ch in range(c)]
        others = normalised(drop(proc[:, torch.as_tensor(others_idx, device=dev)], composed))
        keep_pairs = _keep(masks, (c * (c - 1), l, l), rate)
        pieces = []
        for ch in range(c):
            row = []
            for j in range(c - 1):
                pw = p + "inter.pairs."

                def pair(n, ch=ch, j=j):
                    return w(pw + n)[ch, j]
                src_ln = own[:, ch] * pair("ln_scale") + pair("ln_bias")
                tgt_ln = others[:, ch, j] * pair("ln_scale") + pair("ln_bias")
                query = torch.relu(tgt_ln @ pair("dense0_kernel") + pair("dense0_bias"))
                key = torch.relu(src_ln @ pair("dense1_kernel") + pair("dense1_bias"))
                value = torch.relu(src_ln @ pair("dense2_kernel") + pair("dense2_bias"))
                row.append(query + attention(lambda n, ch=ch, j=j: w(pw + "attn." + n)[ch, j], "",
                                             query, key, value, self_mask,
                                             keep_pairs[ch * (c - 1) + j][None, None]))
            pieces.append(torch.cat(row, dim=-1))  # (B, L, (C-1) E)
        concat = drop(torch.stack(pieces, dim=1))  # (B, C, L, (C-1) E)
        inter = torch.stack([torch.relu(
            layer_norm(concat[:, ch], w(p + "inter.ln_scale")[ch], w(p + "inter.ln_bias")[ch])
            @ w(p + "inter.dense_kernel")[ch] + w(p + "inter.dense_bias")[ch]) for ch in range(c)],
            dim=1)

        mem_d = drop(memory)
        inter_d = drop(inter)
        keep_mem = _keep(masks, (c, l, s_len), rate)
        attended = torch.stack([processing(p + "mem_attn.", ch, mem_d, inter_d[:, ch], key_valid,
                                           keep_mem[ch][None, None]) for ch in range(c)], dim=1)
        attended = layer_norm(attended, w(p + "ln0_scale"), w(p + "ln0_bias"))
        ffn = layer_norm(drop(attended), w(p + "ln1_scale"), w(p + "ln1_bias"))
        h = attended + torch.relu(ffn @ w(p + "dense_kernel") + w(p + "dense_bias"))

    # Head.
    h = h.permute(0, 2, 1, 3).reshape(b, l, c * e)
    h = layer_norm(h, w("head_ln_scale"), w("head_ln_bias"))
    h = torch.relu(h @ w("head_dense_kernel") + w("head_dense_bias"))
    return contour_heads(weights, "predictors.", h)


def shifted_targets(targets):
    """(B, T, C, 2, D) -> (B, T, C, 2 D): each frame's input is the previous
    frame's target, x samples then y samples; the first frame's is zero."""
    b, t, c, two, d = targets.shape
    flat = targets.reshape(b, t, c, two * d)
    return torch.cat([torch.zeros_like(flat[:, :1]), flat[:, :-1]], dim=1)


def reference_train_steps(cfg, weights, batches, dropout_seed: int, n_steps: int):
    """The program's first ``n_steps`` train steps, worked out again: returns
    (losses, first gradients, parameters after the steps)."""
    device = batches[0]["tokens"].device
    masks = MaskStream(dropout_seed, device)

    def step_forward(params, batch):
        lengths = batch["lengths"]
        return forward(cfg, params, batch["tokens"].long(), shifted_targets(batch["targets"]),
                       lengths, lengths, masks)

    return train_steps(step_forward, weights, batches, cfg, n_steps)


def forward_flops(cfg, lengths) -> float:
    """Model FLOPs (2 per multiply-add, products only) of the training
    forward over sentences of ``lengths`` (as many source tokens as target
    frames), counting each attention over the keys a valid query may see:
    every valid source token in the encoder and the cross attention, the
    causal prefix in the decoder's self and pair attention."""
    e, h, ff, f = cfg["embed_dim"], cfg["num_heads"], cfg["encoder_ff_dim"], cfg["num_feat"]
    c, n_layers, hid = len(cfg["articulators"]), cfg["num_layers"], cfg["head_hidden"]
    processing = 3 * e * e + 3 * e * e + e * e  # Q/K/V MLPs, projections, out
    enc = 4 * e * e + 2 * e * ff
    dec = c * processing + c * (c - 1) * processing + c * (c - 1) * e * e + c * processing + c * e * e
    head = f * e * c + c * e * e + c * (e * hid + hid * hid + 2 * hid * (f // 2))
    total = 0.0
    for n in lengths:
        n = int(n)
        causal_keys = n * (n + 1) // 2
        attend = n_layers * (n * n + c * causal_keys + c * (c - 1) * causal_keys + c * n * n)
        total += 2.0 * (n * (n_layers * (enc + dec) + head) + 2 * e * attend)
    return total
