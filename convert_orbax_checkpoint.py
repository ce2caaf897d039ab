"""Convert a JAX (orbax) checkpoint of artspeech_tpu into the PyTorch port's.

A train-state directory, as artspeech_tpu/train/checkpoint.py:save_checkpoint
writes it (``<src>/state`` and ``<src>/aux.json``), becomes
``<dst>/state.pt`` and ``<dst>/aux.json``, which
artspeech_tpu_torch/train/checkpoint.py:restore_checkpoint resumes from
(parameters, AdamW moments, step, learning rate). A model-only artifact
(``save_params``' ``best_model``) becomes a bare ``state_dict`` at ``<dst>``,
which the port's ``load_params`` reads.

Reading orbax needs jax and orbax, so this runs where the JAX package runs;
the conversion itself is the port's (``state_from_flax_trees``).

Usage: python convert_orbax_checkpoint.py --family artspeech SRC DST
Families: artspeech, transformer, latent_rnn, autoencoder, deepspeech2.
"""

import argparse
import json
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import torch

from artspeech_tpu_torch.train.checkpoint import FLAX_CONVERTERS, save_flax_trees


def read_orbax(path: str):
    """An orbax PyTree checkpoint as nested dicts and lists of numpy arrays."""
    tree = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))
    return jax.tree_util.tree_map(np.asarray, tree)


def convert(src: str, dst: str, family: str) -> str:
    """Convert ``src`` into ``dst``; returns what was written."""
    if os.path.isdir(os.path.join(src, "state")):
        tree = read_orbax(os.path.join(src, "state"))
        aux = None
        if os.path.isfile(os.path.join(src, "aux.json")):
            with open(os.path.join(src, "aux.json")) as f:
                aux = json.load(f)
        save_flax_trees(dst, tree["params"], tree.get("opt_state"), tree["step"], family, aux)
        return os.path.join(dst, "state.pt")
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(FLAX_CONVERTERS[family](read_orbax(src)), dst)
    return dst


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", required=True, choices=sorted(FLAX_CONVERTERS))
    parser.add_argument("src", help="orbax checkpoint directory (with state/) or model-only artifact")
    parser.add_argument("dst", help="the port's checkpoint directory, or its model-only file")
    args = parser.parse_args()
    print(f"wrote {convert(args.src, args.dst, args.family)}")


if __name__ == "__main__":
    main()
