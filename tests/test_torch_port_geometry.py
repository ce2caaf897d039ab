"""The port's synthesis geometry against the JAX package's.

B-spline smoothing, arc-length resampling, tube walls and the semipolar-grid
area function, on numpy-made contours shaped like model outputs, plus the
degenerate all-identical contour. Tolerance 1e-5 absolute in float32: the two
sides take sums in another order, and ``linspace`` may differ by ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.core import config as jax_config
from artspeech_tpu.core import constants as jax_constants
from artspeech_tpu.core.constants import TUBE_ARTICULATORS
from artspeech_tpu.geometry.area_function import intersect_semipolar_grid as jax_intersect
from artspeech_tpu.geometry.area_function import tube_area_function as jax_tube_area
from artspeech_tpu.geometry.grid import build_semipolar_grid as jax_build_grid
from artspeech_tpu.geometry.tube import generate_vocal_tract_tube_batch as jax_tube
from artspeech_tpu.ops import bspline as jax_bspline
from artspeech_tpu.ops import resample as jax_resample
from artspeech_tpu.synth.reference_contour import CANONICAL_UPPER_INCISOR as JAX_INCISOR
from artspeech_tpu_torch.core import config as port_config
from artspeech_tpu_torch.core import constants as port_constants
from artspeech_tpu_torch.geometry.area_function import intersect_semipolar_grid as port_intersect
from artspeech_tpu_torch.geometry.area_function import tube_area_function as port_tube_area
from artspeech_tpu_torch.geometry import grid as port_grid
from artspeech_tpu_torch.geometry.tube import generate_vocal_tract_tube_batch as port_tube
from artspeech_tpu_torch.ops import bspline as port_bspline
from artspeech_tpu_torch.ops import resample as port_resample
from artspeech_tpu_torch.synth.reference_contour import CANONICAL_UPPER_INCISOR as PORT_INCISOR

TOL = 1e-5
BENCH_GRID = dict(center=(0.5, 0.5), theta_rad=np.deg2rad(30.0), omega_rad=np.deg2rad(-30.0),
                  linear_step=0.05, polar_step_rad=np.deg2rad(5.0))


def _stacks(frames=10, seed=0):
    """(F, 11, 2, 50) smooth random-walk contours in [0, 1]; frame 0 has
    all-identical points (the degenerate case)."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.3, 0.7, (frames, 11, 2, 1))
    steps = rng.normal(0.0, 0.01, (frames, 11, 2, 50))
    stack = np.clip(start + np.cumsum(steps, axis=-1), 0.0, 1.0).astype(np.float32)
    stack[0] = 0.5
    return stack


def _jax_walls(stack):
    walls = jax.jit(lambda s: jax_tube(s, TUBE_ARTICULATORS))(stack)
    return tuple(np.array(w) for w in walls)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=tol)


def test_copied_modules_are_identical():
    public = lambda m: {k: v for k, v in vars(m).items() if k.isupper()}  # noqa: E731
    assert public(port_constants) == public(jax_constants)
    assert port_config.DATASET_CONFIG == {k: port_config.DatasetConfig(**vars(v))
                                          for k, v in jax_config.DATASET_CONFIG.items()}
    np.testing.assert_array_equal(PORT_INCISOR, JAX_INCISOR)
    points = np.random.default_rng(0).standard_normal((37, 2)).astype(np.float32)
    for n_out in (1, 50, 80):
        np.testing.assert_array_equal(port_resample.resample_nearest_np(points, n_out),
                                      jax_resample.resample_nearest_np(points, n_out))
        np.testing.assert_array_equal(port_resample.resample_linear_np(points, n_out),
                                      jax_resample.resample_linear_np(points, n_out))
    for params in (port_grid.DEFAULT_GRID_PARAMS, BENCH_GRID):
        np.testing.assert_array_equal(port_grid.build_semipolar_grid(**params),
                                      jax_build_grid(**params))
    np.testing.assert_array_equal(port_bspline.bspline_projection(50, 12, 3),
                                  jax_bspline.bspline_projection(50, 12, 3))


def test_regularize_bsplines_matches_jax():
    contours = np.swapaxes(_stacks(), -1, -2)  # (F, 11, 50, 2)
    ref = jax_bspline.regularize_bsplines(jnp.asarray(contours))
    got = port_bspline.regularize_bsplines(torch.from_numpy(contours))
    _close(got, ref)


def test_arclength_resample_matches_jax_and_handles_duplicates():
    polylines = np.swapaxes(_stacks()[:, 3], -1, -2)  # (F, 50, 2)
    polylines[1, 10:20] = polylines[1, 10]  # zero-width segments
    ref = jax.jit(jax.vmap(lambda p: jax_resample.arclength_resample(p, 100)))(polylines)
    got = port_resample.arclength_resample(torch.from_numpy(polylines), 100)
    assert got.shape == (polylines.shape[0], 100, 2)
    _close(got, ref)
    # All-identical points: every output is that point.
    np.testing.assert_array_equal(got[0].numpy(), np.full((100, 2), 0.5, np.float32))


def test_interp1d_clamps_like_jax():
    x = np.array([0.0, 0.5, 0.5, 1.0, 2.0], np.float32)
    y = np.array([[1.0, 2.0, 5.0, 0.0, 4.0], [0.0, 1.0, 2.0, 3.0, 4.0]], np.float32)
    x_new = np.array([-1.0, 0.0, 0.25, 0.5, 0.75, 1.0, 2.0, 3.0], np.float32)
    ref = jax_resample.interp1d(jnp.asarray(x_new), jnp.asarray(x), jnp.asarray(y))
    got = port_resample.interp1d(torch.from_numpy(x_new), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tube_walls_match_jax():
    stack = _stacks()
    ref_i, ref_e = _jax_walls(stack)
    got_i, got_e = port_tube(torch.from_numpy(stack), TUBE_ARTICULATORS)
    assert got_i.shape == (stack.shape[0], 100, 2)
    _close(got_i, ref_i)
    _close(got_e, ref_e)


@pytest.mark.parametrize("grid_params", [None, "default", "bench"])
def test_tube_area_function_matches_jax(grid_params):
    stack = _stacks(frames=16, seed=3)
    internal, external = _jax_walls(stack)
    grid = None
    if grid_params is not None:
        params = port_grid.DEFAULT_GRID_PARAMS if grid_params == "default" else BENCH_GRID
        grid = port_grid.build_semipolar_grid(**params).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda i, e: jax_tube_area(
        i, e, semipolar_grid=None if grid is None else jnp.asarray(grid))))(internal, external)
    got = port_tube_area(torch.from_numpy(internal), torch.from_numpy(external),
                         semipolar_grid=grid)
    assert got.shape == (stack.shape[0], 2, 200)
    assert torch.isfinite(got).all()
    _close(got, ref)


def test_intersect_semipolar_grid_matches_jax_branches():
    stack = _stacks(frames=16, seed=4)
    internal, external = _jax_walls(stack)
    grid = port_grid.build_semipolar_grid(**BENCH_GRID).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda i, e: jax_intersect(i, e, jnp.asarray(grid))))(
        internal, external)
    got = port_intersect(torch.from_numpy(internal), torch.from_numpy(external),
                         torch.from_numpy(grid))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    valid = got[2].numpy()
    assert valid.any() and not valid.all()  # both valid and skipped lines occur
