"""Plain pieces the references share: precision, dropout draws, the
per-articulator contour heads, the masked-Euclidean loss and AdamW.

Every reference here is plain PyTorch. It imports neither ``jax``, the JAX
package nor anything of the PyTorch port, and it takes nothing the program
made: the benchmark hands it the same weights and inputs it hands the
program, and it derives again what the program derived from them (dropout
masks from the same seed, in the same order and shapes).
"""

import contextlib
import math

import torch

#: flax ``nn.LayerNorm`` epsilon.
LAYER_NORM_EPS = 1e-6


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in full float32 (``tf32=False``, the configurations'
    precision) or in TF32 (the control), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class MaskStream:
    """Dropout keep masks drawn from a ``torch.Generator`` seeded as the
    benchmark seeds the program's: ``torch.rand(shape) < 1 - rate``, one draw a
    call, so the same calls in the same order give the program's masks."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def keep(self, shape, rate: float) -> torch.Tensor:
        """A boolean keep mask of ``shape``."""
        return torch.rand(shape, generator=self.generator, device=self.device) < 1.0 - rate


def dropped(x, keep, rate: float):
    """Inverted dropout with a drawn keep mask."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def layer_norm(x, scale, bias):
    """LayerNorm over the last axis with flax's statistics (E[x^2] - E[x]^2,
    clipped at 0) and epsilon."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) / torch.sqrt(var + LAYER_NORM_EPS) * scale + bias


def contour_heads(w, prefix: str, h):
    """The per-articulator heads, one articulator at a time: LN -> Dense(256)
    -> ReLU -> LN -> Dense(256) -> ReLU -> LN -> x and y Dense(n_samples) ->
    sigmoid. h (..., F) -> (..., Nart, 2, n_samples)."""
    n_art = w[f"{prefix}ln0_scale"].shape[0]
    outs = []
    for a in range(n_art):
        z = h
        for i in range(2):
            z = layer_norm(z, w[f"{prefix}ln{i}_scale"][a], w[f"{prefix}ln{i}_bias"][a])
            z = torch.relu(z @ w[f"{prefix}dense{i}_kernel"][a] + w[f"{prefix}dense{i}_bias"][a])
        z = layer_norm(z, w[f"{prefix}ln2_scale"][a], w[f"{prefix}ln2_bias"][a])
        x = z @ w[f"{prefix}dense2_kernel"][a] + w[f"{prefix}dense2_bias"][a]
        y = z @ w[f"{prefix}dense3_kernel"][a] + w[f"{prefix}dense3_bias"][a]
        outs.append(torch.stack([x, y], dim=-2))
    return torch.sigmoid(torch.stack(outs, dim=-3))


def contour_heads_spec(prefix: str, n_art: int, in_features: int, n_samples: int,
                       hidden: int = 256):
    """Parameter names and shapes of :func:`contour_heads`, with the range
    the benchmark draws each from: (shape, centre, half width)."""
    spec = {}
    for i, width in enumerate((in_features, hidden, hidden)):
        spec[f"{prefix}ln{i}_scale"] = ((n_art, width), 1.0, 0.1)
        spec[f"{prefix}ln{i}_bias"] = ((n_art, width), 0.0, 0.05)
    for i, (fan_in, fan_out) in enumerate([(in_features, hidden), (hidden, hidden),
                                           (hidden, n_samples), (hidden, n_samples)]):
        spec[f"{prefix}dense{i}_kernel"] = ((n_art, fan_in, fan_out), 0.0, uniform_bound(fan_in))
        spec[f"{prefix}dense{i}_bias"] = ((n_art, fan_out), 0.0, 0.05)
    return spec


def uniform_bound(fan_in: int) -> float:
    """Half width of a uniform draw with variance 1 / fan_in (lecun scale)."""
    return math.sqrt(3.0 / fan_in)


def valid_mask(lengths, t: int):
    """(B, T) True on valid frames."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def masked_euclidean_loss(outputs, targets, lengths):
    """Mean over valid frames, articulators and sample points of the point
    distance between (B, T, Nart, 2, D) contours."""
    dist = torch.sqrt(torch.clamp(((outputs - targets) ** 2).sum(dim=-2), min=0.0))
    mask = valid_mask(lengths, outputs.shape[1])
    n = torch.clamp(mask.sum().to(dist.dtype), min=1.0) * outputs.shape[-3] * outputs.shape[-1]
    return (dist * mask[:, :, None, None]).sum() / n


class AdamW:
    """Adam with decoupled weight decay, written out: p <- p (1 - lr wd) -
    lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: dict, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            p.mul_(1.0 - self.lr * self.wd)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def train_steps(forward, weights: dict, batches, opt_cfg: dict, n_steps: int):
    """``n_steps`` steps of the masked-Euclidean loss and AdamW from
    ``weights`` (copied, not changed), batch i on step i. ``forward(params,
    batch)`` runs the model with the step's dropout. Returns (losses, the
    first step's gradients, the parameters after the last step)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = AdamW(params, opt_cfg["learning_rate"], opt_cfg["weight_decay"],
                tuple(opt_cfg["betas"]), opt_cfg["eps"])
    losses, first = [], None
    for i in range(n_steps):
        batch = batches[i]
        loss = masked_euclidean_loss(forward(params, batch), batch["targets"], batch["lengths"])
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}
