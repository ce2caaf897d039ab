"""The thesis ArtSpeech BiGRU: how the program's model, train state, train
step and synthesis step are built from ``artspeech_bigru.json``, its plain
reference, and the least time of its kernels' calls at a cell's shapes."""

import torch

from portbench.harness.roofline import gru_bound_ms, gru_bwd_bound_ms
from portbench.reference import bigru as reference  # noqa: F401  (the harness reads it)


def build_model(cfg, device):
    """The program's ``ArtSpeech`` (its own weights are replaced by the
    benchmark's)."""
    from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
    return ArtSpeech(cfg["vocab_size"], len(cfg["articulators"]), embed_dim=cfg["embed_dim"],
                     hidden_size=cfg["hidden_size"], n_samples=cfg["n_samples"],
                     dropout=cfg["dropout"], generator=torch.Generator().manual_seed(0),
                     device=device)


def train_state(cfg, model):
    from artspeech_tpu_torch.train.state import create_train_state
    return create_train_state(model, cfg["learning_rate"], cfg["weight_decay"])


def train_step(cfg, device):
    """The program's train step as its trainer builds it (no P2CP in the
    step; ``to_mm`` only scales that metric)."""
    from artspeech_tpu_torch.train.step import make_artspeech_train_step
    return make_artspeech_train_step(1.0, device=device)


def synthesis_step(cfg, forward, device):
    """The program's synthesis step over ``forward`` (the model in eval mode)."""
    from artspeech_tpu_torch.synth.pipeline import make_synthesis_step
    return make_synthesis_step(forward, cfg["articulators"], device=device)[0]


def area_function():
    """The program's area function of tube walls on a semipolar grid."""
    from artspeech_tpu_torch.geometry.area_function import tube_area_function
    return lambda internal, external, grid: tube_area_function(internal, external,
                                                               semipolar_grid=grid)


def kernel_bounds(cfg, traffic):
    """Least ms of one call of each kernel at the cell's shapes: one
    bidirectional GRU layer (both directions a launch), f32."""
    t, b, h = traffic["bucket"], traffic["batch"], cfg["hidden_size"]
    return {"gru_fwd": gru_bound_ms(t, b, h, 2, 4)[0], "gru_bwd": gru_bwd_bound_ms(t, b, h, 2, 4)[0]}
