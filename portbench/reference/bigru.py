"""Plain reference of the thesis ArtSpeech model (configuration
``artspeech_bigru``): embedding -> 2-layer masked BiGRU (dropout between the
layers in training) -> Dense + ReLU -> per-articulator contour heads ->
sigmoid, and its train step (masked-Euclidean loss, AdamW).

Written from the model's description, not from the program: the GRU is a
Python loop over time per direction (torch gate semantics, the carry frozen
on padded steps, so padded outputs repeat the last valid state and the
reverse direction reads zeros until its first valid step), every product a
plain ``@``. Departures from the program's order of computation:

- the program hoists both directions' input products into one product and
  runs the recurrence in one kernel launch a layer; here each direction
  runs on its own, batch-major;
- the heads run one articulator at a time, where the program batches them;
- LayerNorm divides by sqrt(var + eps) where the program multiplies by its
  rsqrt.

Parameter names and shapes are the program's (``param_spec``), so one set of
weights drawn by the benchmark feeds both.
"""

import torch

from portbench.reference.common import (
    MaskStream,
    contour_heads,
    contour_heads_spec,
    dropped,
    train_steps,
    uniform_bound,
    valid_mask,
)


def param_spec(cfg):
    """name -> (shape, centre, half width) of every parameter."""
    e, h, v = cfg["embed_dim"], cfg["hidden_size"], cfg["vocab_size"]
    n_art, d = len(cfg["articulators"]), cfg["n_samples"]
    gru = 1.0 / h ** 0.5  # torch's GRU init: U(-1/sqrt(H), 1/sqrt(H))
    spec = {"embed.weight": ((v, e), 0.0, uniform_bound(e))}
    for layer in range(cfg["num_layers"]):
        width = e if layer == 0 else 2 * h
        for direction in range(2):
            i = 2 * layer + direction
            spec[f"rnn.layers.{i}.wi"] = ((width, 3 * h), 0.0, gru)
            spec[f"rnn.layers.{i}.bi"] = ((3 * h,), 0.0, gru)
            spec[f"rnn.layers.{i}.wh"] = ((h, 3 * h), 0.0, gru)
            spec[f"rnn.layers.{i}.bh"] = ((3 * h,), 0.0, gru)
    spec["dense.weight"] = ((cfg["dense"], 2 * h), 0.0, uniform_bound(2 * h))
    spec["dense.bias"] = ((cfg["dense"],), 0.0, 0.05)
    spec.update(contour_heads_spec("decoder.", n_art, cfg["dense"], d, cfg["head_hidden"]))
    return spec


def gru_direction(x, wi, bi, wh, bh, mask, reverse: bool):
    """One direction of a masked GRU layer: x (B, T, E), mask (B, T) -> (B, T, H)."""
    b, t, _ = x.shape
    hidden = wh.shape[0]
    xg_all = x @ wi + bi
    h = x.new_zeros(b, hidden)
    ys = [None] * t
    for s in range(t):
        i = t - 1 - s if reverse else s
        xg, hg = xg_all[:, i], h @ wh + bh
        r = torch.sigmoid(xg[:, :hidden] + hg[:, :hidden])
        z = torch.sigmoid(xg[:, hidden:2 * hidden] + hg[:, hidden:2 * hidden])
        n = torch.tanh(xg[:, 2 * hidden:] + r * hg[:, 2 * hidden:])
        h = torch.where(mask[:, i, None], (1.0 - z) * n + z * h, h)
        ys[i] = h
    return torch.stack(ys, dim=1)


def forward(cfg, w, tokens, lengths, masks: MaskStream = None):
    """tokens (B, T), lengths (B,) -> (B, T, Nart, 2, D). With ``masks`` (a
    training step) the dropout between the GRU layers is drawn from it, as
    the program draws it: one (T, B, 2H) keep mask a step, time-major."""
    b, t = tokens.shape
    mask = valid_mask(lengths, t)
    x = w["embed.weight"][tokens]
    rate = cfg["dropout"]
    for layer in range(cfg["num_layers"]):
        outs = []
        for direction in range(2):
            p = f"rnn.layers.{2 * layer + direction}."
            outs.append(gru_direction(x, w[p + "wi"], w[p + "bi"], w[p + "wh"], w[p + "bh"], mask,
                                      reverse=direction == 1))
        x = torch.cat(outs, dim=-1)
        if masks is not None and rate > 0.0 and layer < cfg["num_layers"] - 1:
            keep = masks.keep((t, b, x.shape[-1]), rate).transpose(0, 1)
            x = dropped(x, keep, rate)
    h = torch.relu(x @ w["dense.weight"].T + w["dense.bias"])
    return contour_heads(w, "decoder.", h)


def reference_train_steps(cfg, weights, batches, dropout_seed: int, n_steps: int):
    """The program's first ``n_steps`` train steps, worked out again: returns
    (losses, first gradients, parameters after the steps)."""
    device = batches[0]["tokens"].device
    masks = MaskStream(dropout_seed, device)

    def step_forward(params, batch):
        return forward(cfg, params, batch["tokens"].long(), batch["lengths"], masks)

    return train_steps(step_forward, weights, batches, cfg, n_steps)


def forward_flops(cfg, lengths) -> float:
    """Model FLOPs (2 per multiply-add, products only) of the forward over
    the valid frames of sentences of ``lengths``: every product of the model
    is per frame, so the count is a per-frame constant times the frames."""
    e, h, dense = cfg["embed_dim"], cfg["hidden_size"], cfg["dense"]
    hid, d, n_art = cfg["head_hidden"], cfg["n_samples"], len(cfg["articulators"])
    per_frame = 0
    for layer in range(cfg["num_layers"]):
        width = e if layer == 0 else 2 * h
        per_frame += 2 * (2 * width * 3 * h + 2 * h * 3 * h)  # both directions
    per_frame += 2 * 2 * h * dense
    per_frame += n_art * 2 * (dense * hid + hid * hid + 2 * hid * d)
    return float(per_frame) * float(sum(int(n) for n in lengths))
