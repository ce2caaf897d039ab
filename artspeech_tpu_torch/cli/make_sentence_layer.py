"""Rebuild Short/Long sentence tiers in corpus TextGrids (counterpart of
artspeech_tpu/cli/make_sentence_layer.py).

Equivalent of reference scripts/make_sentence_layer.py (paths via config
instead of hardcoded cluster dirs). Host only: ``--device`` is accepted and
not used.

Usage: python -m artspeech_tpu_torch.cli.make_sentence_layer --config cfg.yaml
Config keys: glob (TextGrid path pattern), save_suffix (appended to each
directory name, default "_Adjusted"), save_to (one output directory instead).
"""

import os
from glob import glob

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.data.sentence_layer import make_sentence_layers
from artspeech_tpu_torch.data.textgrid import read_textgrid, write_textgrid


def main(cfg, args, tracker):
    filepaths = sorted(glob(cfg["glob"]))
    suffix = cfg.get("save_suffix", "_Adjusted")
    written = []
    for filepath in filepaths:
        grid = read_textgrid(filepath)
        new_grid = make_sentence_layers(grid)
        parent = os.path.dirname(filepath)
        out_dir = parent + suffix if not cfg.get("save_to") else cfg["save_to"]
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, os.path.basename(filepath))
        write_textgrid(new_grid, out_path)
        written.append(out_path)
    print(f"Adjusted {len(written)} TextGrids")
    return written


if __name__ == "__main__":
    run_experiment("Make sentence layer", main)
