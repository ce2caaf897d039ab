"""The multi-channel transformer: how the program's model, train state and
train step are built from ``multichannel_transformer.json``, its plain
reference, and the least time of its kernels' calls at a cell's shapes."""

import torch

from portbench.harness.roofline import train_attention_bound_ms
from portbench.reference import transformer as reference  # noqa: F401  (the harness reads it)


def build_model(cfg, device):
    """The program's ``ArtSpeechTransformer`` (its own weights are replaced
    by the benchmark's)."""
    from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer
    return ArtSpeechTransformer(cfg["vocab_size"], len(cfg["articulators"]),
                                embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
                                num_layers=cfg["num_layers"], num_feat=cfg["num_feat"],
                                dropout=cfg["dropout"], encoder_ff_dim=cfg["encoder_ff_dim"],
                                generator=torch.Generator().manual_seed(0), device=device)


def train_state(cfg, model):
    from artspeech_tpu_torch.train.state import create_train_state
    return create_train_state(model, cfg["learning_rate"], cfg["weight_decay"])


def train_step(cfg, device):
    """The program's teacher-forced train step as its trainer builds it."""
    from artspeech_tpu_torch.train.step import make_transformer_train_step
    return make_transformer_train_step(1.0, accum_steps=cfg["accum_steps"], device=device)


def kernel_bounds(cfg, traffic):
    """Least ms of one call of each training-attention kernel at the cell's
    shapes: every (channel pair, sentence, head) group, the causal
    triangle, one dropout keep mask a pair, f32."""
    c, h = len(cfg["articulators"]), cfg["num_heads"]
    g = traffic["batch"] * c * (c - 1) * h
    l, pairs, hd = traffic["bucket"], c * (c - 1), cfg["embed_dim"] // h
    return {"train_attention_fwd": train_attention_bound_ms(g, l, pairs, False, hd)[0],
            "train_attention_bwd": train_attention_bound_ms(g, l, pairs, True, hd)[0]}
