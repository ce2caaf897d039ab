"""Build the post-hoc TV/error report over a results directory (counterpart
of artspeech_tpu/cli/report_phoneme_to_articulation.py).

Equivalent of reference report_phoneme_to_articulation.py. Config keys:
database_name, results_dir, articulators, make_plots (default true; skipped,
with one line saying so, where matplotlib is missing). The per-sentence P2CP
runs on ``--device`` (default cuda: the P2CP kernel, one launch a sentence).

Usage: python -m artspeech_tpu_torch.cli.report_phoneme_to_articulation \
           --config cfg.yaml [--device cpu]
"""

from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.device import resolve_device
from artspeech_tpu_torch.eval.report import build_report


def main(cfg, args, tracker):
    device = resolve_device(args.device)
    report = build_report(
        cfg["results_dir"],
        sorted(cfg["articulators"]),
        DATASET_CONFIG[cfg["database_name"]],
        make_plots=cfg.get("make_plots", True),
        device=device,
    )
    if report["plots_skipped"]:
        print("TV plots skipped: matplotlib is not installed")
    if not report["errors_agg"].empty:
        print(report["errors_agg"])
    if not report["tv_corr"].empty:
        print(report["tv_corr"])
    return report


if __name__ == "__main__":
    run_experiment("Report phoneme-to-articulation", main)
