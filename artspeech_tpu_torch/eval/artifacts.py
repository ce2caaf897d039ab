"""Host-side artifact writers for evaluation outputs (counterpart of
artspeech_tpu/eval/artifacts.py).

Reproduces the on-disk schema of reference
phoneme_to_articulation/__init__.py:121-297 (``save_outputs`` and
``tract_variables``): per-sentence directories holding
``contours/{frame}_{articulator}.npy`` (+ ``_true``), ``phonemes.csv`` and
``tract_variables.csv``. The numerics (tract variables of predictions and
targets, optional B-spline regularization) are computed batched on the device
by the caller; these writers only lay numpy results out on disk. The CSVs are
written with the standard ``csv`` module, with the columns, their order and
the number formatting of the JAX package's pandas files: a header, then one
row per frame.
"""

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

TV_NAMES = ("LA", "TTCD", "TBCD", "VEL")


def _write_csv(path: str, records: List[dict]) -> None:
    """``pandas.DataFrame(records).to_csv(path, index=False)``: the columns
    are the records' keys in order of first appearance."""
    columns = list(dict.fromkeys(key for record in records for key in record))
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns, lineterminator="\n")
        writer.writeheader()
        writer.writerows(records)


def save_contours(
    sentence_id: str,
    frame_ids: Sequence[str],
    outputs: np.ndarray,
    targets: Optional[np.ndarray],
    phonemes: Sequence[str],
    articulators: Sequence[str],
    save_to: str,
):
    """Write per-frame contour npys + phonemes.csv for ONE sentence.

    Args:
        outputs/targets: (T, Nart, 2, D) already length-trimmed (and already
            B-spline regularized on device if requested).
    """
    sentence_dir = os.path.join(save_to, sentence_id)
    contours_dir = os.path.join(sentence_dir, "contours")
    os.makedirs(contours_dir, exist_ok=True)

    phoneme_data = []
    arts = sorted(articulators)
    for t, frame in enumerate(frame_ids):
        phoneme = phonemes[t] if t < len(phonemes) else ""
        phoneme_data.append({"sentence": sentence_id, "frame": frame, "phoneme": phoneme})
        for i_art, art in enumerate(arts):
            np.save(os.path.join(contours_dir, f"{frame}_{art}.npy"), outputs[t, i_art])
            if targets is not None:
                np.save(os.path.join(contours_dir, f"{frame}_{art}_true.npy"), targets[t, i_art])
    _write_csv(os.path.join(sentence_dir, "phonemes.csv"), phoneme_data)


def tvs_to_records(
    sentence_id: str,
    frame_ids: Sequence[str],
    phonemes: Sequence[str],
    pred_tvs: Dict[str, Optional[dict]],
    target_tvs: Optional[Dict[str, Optional[dict]]],
    t_offset: int = 0,
) -> List[dict]:
    """Flatten TV dicts of numpy arrays (shaped (T,) / (T, 2)) into
    per-frame CSV records matching reference __init__.py:247-290."""
    records = []
    for t, frame in enumerate(frame_ids):
        tt = t + t_offset
        item = {
            "sentence": sentence_id,
            "frame": frame,
            "phoneme": phonemes[t] if t < len(phonemes) else "",
        }
        for kind, tvs in (("target", target_tvs), ("pred", pred_tvs)):
            if tvs is None:
                continue
            for tv in TV_NAMES:
                d = tvs.get(tv)
                if d is None:
                    continue
                item[f"{tv}_{kind}"] = float(d["value"][tt])
                item[f"{tv}_{kind}_poc_1_x"] = float(d["poc_1"][tt][0])
                item[f"{tv}_{kind}_poc_1_y"] = float(d["poc_1"][tt][1])
                item[f"{tv}_{kind}_poc_2_x"] = float(d["poc_2"][tt][0])
                item[f"{tv}_{kind}_poc_2_y"] = float(d["poc_2"][tt][1])
        records.append(item)
    return records


def save_tract_variables_csv(sentence_id: str, records: List[dict], save_to: str):
    sentence_dir = os.path.join(save_to, sentence_id)
    os.makedirs(sentence_dir, exist_ok=True)
    _write_csv(os.path.join(sentence_dir, "tract_variables.csv"), records)
