"""Maeda semipolar grid construction (a frozen copy of
artspeech_tpu_torch/geometry/grid.py: the benchmark builds the grid itself and
hands the same one to the program and to the plain reference).

Equivalent of reference area_function.py:12-110, vectorized with numpy (the
grid is a static precompute — it depends only on scalar geometry parameters,
so it is built once on the host and shipped to the device as a constant).
"""

import numpy as np


def rotate(points: np.ndarray, ang_rad: float) -> np.ndarray:
    """Rotate (..., 2) points by an angle (reference area_function.py:12-28).

    Matches the reference rotation matrix [[cos, sin], [-sin, cos]].
    """
    rot = np.array(
        [
            [np.cos(ang_rad), np.sin(ang_rad)],
            [-np.sin(ang_rad), np.cos(ang_rad)],
        ]
    )
    return points @ rot.T


def build_semipolar_grid(
    center,
    theta_rad: float,
    omega_rad: float,
    linear_step: float,
    polar_step_rad: float,
    grid_res: int = 50,
    mouth_extent: float = 0.5,
    width: float = 0.4,
    larynx_extent: float = 0.5,
) -> np.ndarray:
    """Build the semipolar analysis grid.

    Three sections ordered from larynx to mouth (reference
    area_function.py:31-110): a linear larynx grid rotated by omega, a polar
    arc between, and a linear mouth grid rotated by theta. Each grid line is
    a straight segment sampled at ``grid_res`` points from the internal side
    to the external side.

    Returns:
        (n_lines, grid_res, 2) array of grid-line point samples.
    """
    center = np.asarray(center, dtype=np.float64)

    # Mouth cavity grid: lines along -x, internal at y=0, external at y=-width.
    xs = np.arange(0.0, -mouth_extent, -linear_step)
    mouth_int = rotate(np.stack([xs, np.zeros_like(xs)], axis=1), theta_rad) + center
    mouth_ext = (
        rotate(np.stack([xs, -width * np.ones_like(xs)], axis=1), theta_rad) + center
    )

    # Larynx cavity grid: lines along +y, internal at x=0, external at x=width.
    ys = np.arange(0.0, larynx_extent, linear_step)
    larynx_int = rotate(np.stack([np.zeros_like(ys), ys], axis=1), omega_rad) + center
    larynx_ext = (
        rotate(np.stack([width * np.ones_like(ys), ys], axis=1), omega_rad) + center
    )

    # Polar arc between the two linear sections.
    angles = np.arange(theta_rad - polar_step_rad, -(np.pi / 2) + omega_rad, -polar_step_rad)
    p = np.array([0.0, -width])
    polar_ext = np.stack([rotate(p, ang) + center for ang in angles]) if len(angles) else np.zeros((0, 2))
    polar_int = np.zeros_like(polar_ext) + center

    lines = []
    for p_int, p_ext in reversed(list(zip(larynx_int, larynx_ext))):
        lines.append((p_int, p_ext))
    for p_int, p_ext in reversed(list(zip(polar_int, polar_ext))):
        lines.append((p_int, p_ext))
    for p_int, p_ext in zip(mouth_int, mouth_ext):
        lines.append((p_int, p_ext))

    grid = np.zeros((len(lines), grid_res, 2))
    for i, (p_int, p_ext) in enumerate(lines):
        grid[i, :, 0] = np.linspace(p_int[0], p_ext[0], grid_res)
        grid[i, :, 1] = np.linspace(p_int[1], p_ext[1], grid_res)
    return grid


#: The grid of the synthesis cells: bench.py's semipolar grid parameters.
SYNTHESIS_GRID_PARAMS = dict(
    center=(0.5, 0.5),
    theta_rad=float(np.deg2rad(30.0)),
    omega_rad=float(np.deg2rad(-30.0)),
    linear_step=0.05,
    polar_step_rad=float(np.deg2rad(5.0)),
)


def synthesis_grid() -> np.ndarray:
    """(L, 50, 2) float32 grid the synthesis cells intersect the walls with."""
    return build_semipolar_grid(**SYNTHESIS_GRID_PARAMS).astype(np.float32)
