"""Convert DICOM cine files into per-frame NPY_MR/*.npy arrays (counterpart
of artspeech_tpu/cli/dcm_to_npy.py).

Equivalent of reference scripts/dcm_to_npy.py:8-27. Requires pydicom
(optional dependency — absent in some environments; the CLI fails with a
clear message rather than at import time).

Host only: ``--device`` is not used.

Usage: python -m artspeech_tpu_torch.cli.dcm_to_npy --config cfg.yaml
Config keys: glob (pattern over .dcm files), save_dirname (default NPY_MR).
"""

import os
from glob import glob

import numpy as np

from artspeech_tpu_torch.cli.common import run_experiment


def main(cfg, args, tracker):
    try:
        import pydicom
    except ImportError as exc:
        raise RuntimeError(
            "dcm_to_npy requires pydicom (not installed in this environment)"
        ) from exc

    save_dirname = cfg.get("save_dirname", "NPY_MR")
    n_frames = 0
    for dcm_path in sorted(glob(cfg["glob"])):
        ds = pydicom.dcmread(dcm_path)
        pixels = ds.pixel_array  # (T, H, W) or (H, W)
        if pixels.ndim == 2:
            pixels = pixels[None]
        out_dir = os.path.join(os.path.dirname(dcm_path), save_dirname)
        os.makedirs(out_dir, exist_ok=True)
        for t in range(pixels.shape[0]):
            np.save(os.path.join(out_dir, f"{t + 1:04d}.npy"), pixels[t])
            n_frames += 1
    print(f"Wrote {n_frames} frames")
    return n_frames


if __name__ == "__main__":
    run_experiment("DICOM to npy", main)
