"""Post-hoc error/TV report over dumped test artifacts (counterpart of
artspeech_tpu/eval/report.py).

Equivalent of reference report_phoneme_to_articulation.py:27-296: aggregates
per-sentence tract_variables.csv into a TV report with per-sentence
pred/target Pearson correlations, recomputes per-frame P2CP / Euclidean
errors from the dumped contour npys (a regression check on the artifacts),
and renders TV-vs-frame plots with phoneme bands.

Written with ``csv`` and numpy in place of pandas, with the JAX package's
files, columns, row order and statistics: a CSV column reads as int or float
where every value of it parses as one (pandas' inference, so frame ``0001``
reads as 1), rows sort stably by (sentence, frame), a ``std`` has ddof = 1,
and a statistic with nothing to reduce is NaN (written empty). The P2CP of a
sentence's frames is one ``mean_p2cp_channel_major`` call on the device: on
CUDA one launch of the P2CP kernel a sentence.
"""

import csv
import math
import os
import re
import warnings
from dataclasses import dataclass, field
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from artspeech_tpu_torch.core.config import DatasetConfig, mm_per_unit
from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.ops.distances import euclidean_distance, mean_p2cp_channel_major
from artspeech_tpu_torch.synth.viz import pyplot

TV_COLORS = {"LA": "tab:blue", "TTCD": "tab:orange", "TBCD": "tab:green", "VEL": "tab:red"}
ERROR_METRICS = ("p2cp", "p2cp_mm", "euclidean", "euclidean_mm")
STATS = ("mean", "std", "min", "max")
_INT = re.compile(r"^[+-]?\d+$")


@dataclass
class Table:
    """Rows of a CSV: ``columns`` in order, each row a dict keyed by them.
    A column given as a tuple is a two-level header (pandas' MultiIndex
    columns), written as two header rows."""

    columns: list = field(default_factory=list)
    rows: List[dict] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.rows

    def column(self, name) -> list:
        return [row.get(name, math.nan) for row in self.rows]

    def to_csv(self, path: str) -> None:
        """``DataFrame.to_csv(path, index=False)``: floats as ``repr``, NaN empty."""
        levels = len(self.columns[0]) if self.columns and isinstance(self.columns[0], tuple) else 0
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            if levels:
                for level in range(levels):
                    writer.writerow([c[level] for c in self.columns])
            else:
                writer.writerow(self.columns)
            for row in self.rows:
                writer.writerow([_format(row.get(c, math.nan)) for c in self.columns])

    def __str__(self) -> str:
        names = [" ".join(c).strip() if isinstance(c, tuple) else str(c) for c in self.columns]
        lines = ["  ".join(names)]
        lines += ["  ".join(_format(row.get(c, math.nan)) or "NaN" for c in self.columns)
                  for row in self.rows]
        return "\n".join(lines)


def _format(value) -> str:
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def _parse(values: List[str]) -> list:
    """One CSV column typed as pandas reads it: int where every value is an
    integer, else float where every non-empty value parses as one (empty is
    NaN), else the strings."""
    present = [v for v in values if v != ""]
    if present and len(present) == len(values) and all(_INT.match(v) for v in values):
        return [int(v) for v in values]
    try:
        return [float(v) if v != "" else math.nan for v in values]
    except ValueError:
        return values


def read_csv_table(path: str) -> Table:
    """A one-header CSV as a :class:`Table`, its columns typed by :func:`_parse`."""
    with open(path, newline="") as f:
        lines = list(csv.reader(f))
    columns, body = lines[0], lines[1:]
    typed = [_parse([line[i] if i < len(line) else "" for line in body])
             for i in range(len(columns))]
    return Table(columns, [dict(zip(columns, values)) for values in zip(*typed)]
                 if body else [])


def aggregate_tract_variables(sentences_dirs: Sequence[str]) -> Table:
    """Every sentence's tract_variables.csv, concatenated and sorted stably by
    (sentence, frame)."""
    tables = [read_csv_table(os.path.join(d, "tract_variables.csv")) for d in sentences_dirs
              if os.path.isfile(os.path.join(d, "tract_variables.csv"))]
    if not tables:
        return Table()
    columns = list(dict.fromkeys(c for t in tables for c in t.columns))
    rows = [row for t in tables for row in t.rows]
    rows.sort(key=lambda row: (row["sentence"], row["frame"]))
    return Table(columns, rows)


def _frame_name(frame) -> str:
    return "%04d" % int(frame) if str(frame).isdigit() else str(frame)


def sentence_error_frame(sentence_dir: str, articulators: Sequence[str], to_mm: float,
                         device: DeviceLike = None) -> List[dict]:
    """Recompute per-(frame, articulator) P2CP/Euclidean from dumped npys:
    all frames of the sentence in one call on ``device``."""
    phonemes = read_csv_table(os.path.join(sentence_dir, "phonemes.csv"))
    sentence_name = os.path.basename(sentence_dir)
    contours_dir = os.path.join(sentence_dir, "contours")
    preds, trues, rows = [], [], []
    for row in phonemes.rows:
        frame_str = _frame_name(row["frame"])
        frame_preds, frame_trues = [], []
        for articulator in articulators:
            p = os.path.join(contours_dir, f"{frame_str}_{articulator}.npy")
            t = os.path.join(contours_dir, f"{frame_str}_{articulator}_true.npy")
            if not (os.path.isfile(p) and os.path.isfile(t)):
                break
            frame_preds.append(np.load(p))
            frame_trues.append(np.load(t))
        else:
            preds.append(np.stack(frame_preds))
            trues.append(np.stack(frame_trues))
            rows.append(row)
    if not preds:
        return []

    dev = resolve_device(device)
    with torch.no_grad():
        pred = torch.from_numpy(np.stack(preds)).to(dev)  # (T, Nart, 2, D)
        true = torch.from_numpy(np.stack(trues)).to(dev)
        p2cp = mean_p2cp_channel_major(pred, true).cpu().numpy()  # (T, Nart)
        eucl = euclidean_distance(pred, true).mean(dim=-1).cpu().numpy()  # (T, Nart)

    records = []
    for t, row in enumerate(rows):
        for i, articulator in enumerate(articulators):
            records.append({
                "sentence_name": sentence_name,
                "frame": row["frame"],
                "phoneme": row["phoneme"],
                "articulator": articulator,
                "p2cp": float(p2cp[t, i]),
                "p2cp_mm": float(p2cp[t, i]) * to_mm,
                "euclidean": float(eucl[t, i]),
                "euclidean_mm": float(eucl[t, i]) * to_mm,
            })
    return records


def _stats(values) -> Dict[str, float]:
    """pandas' mean / std (ddof 1) / min / max of a column, NaN skipped."""
    arr = np.asarray(values, dtype=np.float64)
    arr = arr[~np.isnan(arr)]
    if arr.size == 0:
        return dict.fromkeys(STATS, math.nan)
    return {"mean": float(arr.mean()),
            "std": float(arr.std(ddof=1)) if arr.size > 1 else math.nan,
            "min": float(arr.min()), "max": float(arr.max())}


def _groups(rows: List[dict], key: str) -> Dict[object, List[dict]]:
    """``groupby(key)``: the rows of each key, keys sorted, NaN keys dropped."""
    groups: Dict[object, List[dict]] = {}
    for row in rows:
        value = row[key]
        if isinstance(value, float) and math.isnan(value):
            continue
        groups.setdefault(value, []).append(row)
    return dict(sorted(groups.items()))


def _pearson(a, b) -> float:
    """``Series.corr``: Pearson over the pairs where both are present."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    valid = ~(np.isnan(a) | np.isnan(b))
    if not valid.any():
        return math.nan
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.corrcoef(a[valid], b[valid])[0, 1])


def error_aggregate(errors: Table) -> Table:
    """Per articulator: mean, std, min and max of each error metric."""
    columns = [("articulator", "")] + [(m, s) for m in ERROR_METRICS for s in STATS]
    rows = []
    for articulator, group in _groups(errors.rows, "articulator").items():
        row = {("articulator", ""): articulator}
        for metric in ERROR_METRICS:
            stats = _stats([r[metric] for r in group])
            row.update({(metric, s): stats[s] for s in STATS})
        rows.append(row)
    return Table(columns, rows)


def tv_correlation_report(tvs: Table) -> Table:
    """Per-TV pred/target Pearson correlation stats over sentences
    (reference report:258-285); a sentence with one frame or a constant
    target has no correlation."""
    rows = []
    for tv in TV_COLORS:
        pred, target = f"{tv}_pred", f"{tv}_target"
        if pred not in tvs.columns or target not in tvs.columns:
            continue
        corrs = []
        for group in _groups(tvs.rows, "sentence").values():
            targets = [r[target] for r in group]
            if len(group) > 1 and _stats(targets)["std"] > 0:
                corrs.append(_pearson(targets, [r[pred] for r in group]))
        rows.append({"TV": tv, **_stats(corrs)})
    return Table(["TV", *STATS], rows)


def plot_tvs_for_sentence(tvs: Table, sentence_name: str, plots_dir: str,
                          suffix: Optional[str] = None, which: str = "both",
                          TVs: Optional[Sequence[str]] = None) -> bool:
    """TV-vs-frame plot with alternating phoneme bands (reference :27-125).
    Returns False, and draws nothing, without matplotlib."""
    plt = pyplot()
    if plt is None:
        return False
    TVs = list(TVs or TV_COLORS.keys())
    os.makedirs(plots_dir, exist_ok=True)

    fig, ax = plt.subplots(figsize=(25, 7))
    y_max = max(float(np.nanmax(tvs.column(f"{tv}_{w}")))
                for tv in TV_COLORS for w in ("pred", "target") if f"{tv}_{w}" in tvs.columns)
    frames = tvs.column("frame")
    for tv in TVs:
        if which in ("pred", "both"):
            ax.plot(frames, tvs.column(f"{tv}_pred"), color=TV_COLORS[tv], label=f"{tv} pred")
        if which in ("target", "both"):
            ax.plot(frames, tvs.column(f"{tv}_target"),
                    linestyle="--" if which == "both" else "-", color=TV_COLORS[tv],
                    label=f"{tv} target")
    # alternating phoneme bands
    phonemes = tvs.column("phoneme")
    start = 0
    band = 0
    for i in range(1, len(frames) + 1):
        if i == len(frames) or phonemes[i] != phonemes[start]:
            color = "lightgray" if band % 2 == 0 else "white"
            ax.axvspan(frames[start], frames[i - 1], alpha=0.3, color=color)
            ax.text(frames[start], y_max + 2 + 3 * (band % 4), str(phonemes[start]), fontsize=12)
            start = i
            band += 1
    ax.set_ylim(-2, y_max + 18)
    ax.set_xlabel("Frame Number", fontsize=18)
    ax.set_ylabel("TV value (mm)", fontsize=18)
    ax.grid(True, "major")
    fig.tight_layout()
    name = f"TVs_{sentence_name}" + (f"_{suffix}" if suffix else "")
    fig.savefig(os.path.join(plots_dir, f"{name}.jpg"))
    plt.close(fig)
    return True


def build_report(results_dir: str, articulators: Sequence[str], dataset_config: DatasetConfig,
                 make_plots: bool = True, device: DeviceLike = None) -> Dict[str, object]:
    """Full report over {results_dir}/test_outputs/0/* (reference main).

    Writes ``tract_variables.csv`` (TVs in mm with ``*_abs_error``),
    ``error_report_full.csv``, ``error_report_agg.csv`` and
    ``TV_corr_report.csv`` into ``results_dir``, and with ``make_plots`` one
    TV plot a sentence. Returns the four tables and ``plots_skipped``: True
    where plots were asked for and matplotlib is missing. ``device``: where
    the P2CP runs, ``cuda`` unless the caller passes ``device="cpu"``.
    """
    dev = resolve_device(device)
    sentences_dirs = sorted(d for d in glob(os.path.join(results_dir, "test_outputs", "0", "*"))
                            if os.path.isdir(d))
    to_mm = mm_per_unit(dataset_config)

    tvs = aggregate_tract_variables(sentences_dirs)
    if not tvs.empty:
        for tv in TV_COLORS:
            pred, target = f"{tv}_pred", f"{tv}_target"
            if pred in tvs.columns:
                for row in tvs.rows:
                    row[pred] *= to_mm
                    row[target] *= to_mm
                    row[f"{tv}_abs_error"] = abs(row[target] - row[pred])
                tvs.columns.append(f"{tv}_abs_error")
        tvs.to_csv(os.path.join(results_dir, "tract_variables.csv"))

    plots_skipped = make_plots and not tvs.empty and pyplot() is None
    records = []
    for sentence_dir in sentences_dirs:
        records.extend(sentence_error_frame(sentence_dir, articulators, to_mm, dev))
        if make_plots and not plots_skipped and not tvs.empty:
            name = os.path.basename(sentence_dir)
            sentence = Table(tvs.columns, [r for r in tvs.rows if r["sentence"] == name])
            if not sentence.empty:
                plot_tvs_for_sentence(sentence, name, os.path.join(sentence_dir, "plots"))

    errors = Table(list(dict.fromkeys(k for r in records for k in r)), records)
    errors_agg = Table()
    if not errors.empty:
        errors.to_csv(os.path.join(results_dir, "error_report_full.csv"))
        errors_agg = error_aggregate(errors)
        errors_agg.to_csv(os.path.join(results_dir, "error_report_agg.csv"))

    tv_corr = tv_correlation_report(tvs) if not tvs.empty else Table()
    if not tv_corr.empty:
        tv_corr.to_csv(os.path.join(results_dir, "TV_corr_report.csv"))

    return {"tract_variables": tvs, "errors": errors, "errors_agg": errors_agg,
            "tv_corr": tv_corr, "plots_skipped": plots_skipped}
