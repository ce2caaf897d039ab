"""Plot predicted-vs-true contours from dumped test outputs (counterpart of
artspeech_tpu/cli/plot_phoneme_to_articulation_outputs.py).

Equivalent of reference scripts/plot_phoneme_to_articulation_outputs.py:38-80.
phonemes.csv is read with ``csv``, typed as pandas reads it
(eval/report.py:read_csv_table). Host only: ``--device`` is not used.
Raises without matplotlib.

Usage: python -m artspeech_tpu_torch.cli.plot_phoneme_to_articulation_outputs \
           --config cfg.yaml
Config keys: results_dir (holding test_outputs/0/*), articulators.
"""

import os
from glob import glob

import numpy as np

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.constants import COLORS
from artspeech_tpu_torch.eval.report import read_csv_table


def main(cfg, args, tracker):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as exc:
        raise RuntimeError("plotting requires matplotlib") from exc

    articulators = sorted(cfg["articulators"])
    base = os.path.join(cfg["results_dir"], "test_outputs", "0")
    n_plots = 0
    for sentence_dir in sorted(glob(os.path.join(base, "*"))):
        if not os.path.isdir(sentence_dir):
            continue
        phon_path = os.path.join(sentence_dir, "phonemes.csv")
        if not os.path.isfile(phon_path):
            continue
        phonemes = read_csv_table(phon_path)
        plots_dir = os.path.join(sentence_dir, "contour_plots")
        os.makedirs(plots_dir, exist_ok=True)
        contours_dir = os.path.join(sentence_dir, "contours")
        for row in phonemes.rows:
            frame = str(row["frame"])
            frame_str = "%04d" % int(frame) if frame.isdigit() else frame
            fig, ax = plt.subplots(figsize=(6, 6))
            ok = False
            for articulator in articulators:
                p = os.path.join(contours_dir, f"{frame_str}_{articulator}.npy")
                t = os.path.join(contours_dir, f"{frame_str}_{articulator}_true.npy")
                if not os.path.isfile(p):
                    continue
                ok = True
                pred = np.load(p)
                ax.plot(pred[0], pred[1], color=COLORS.get(articulator, "black"))
                if os.path.isfile(t):
                    true = np.load(t)
                    ax.plot(
                        true[0], true[1], "--",
                        color=COLORS.get(articulator, "black"), alpha=0.5,
                    )
            if not ok:
                plt.close(fig)
                continue
            ax.text(0.05, 0.95, str(row["phoneme"]), transform=ax.transAxes, fontsize=16)
            ax.set_xlim(0, 1)
            ax.set_ylim(1, 0)
            ax.axis("off")
            fig.savefig(os.path.join(plots_dir, f"{frame_str}.jpg"), dpi=100)
            plt.close(fig)
            n_plots += 1
    print(f"Wrote {n_plots} contour plots")
    return n_plots


if __name__ == "__main__":
    run_experiment("Plot phoneme-to-articulation outputs", main)
