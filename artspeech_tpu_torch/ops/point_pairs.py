"""The lane grid of ``csrc/point_pairs.cuh``, for the launch rules of the
P2CP and min-distance kernels (``ops/hopper_p2cp.py``,
``ops/hopper_min_dist.py``).

A group of ``LANES_U x LANES_V`` lanes takes a row, ``ROWS_A_WARP`` rows a
warp. With a tile (KU, KV, N, M), lane (a, b) of a group holds u points
``i0 + a + LANES_U * k`` (k < KU) of each u tile ``i0`` and v points
``j0 + b + LANES_V * l`` (l < KV) of each v chunk ``j0``; points past N or M
read the last real point and are masked out. A kernel compiles its tiles
with the shape (N, M) where the model's paths call it at one (every count
and offset then a constant), and one with N = M = 0 for any other shape.
"""

from typing import Sequence, Tuple

LANES_U = LANES_V = 4
GROUP = LANES_U * LANES_V
ROWS_A_WARP = 32 // GROUP
WARPS = 4  # warps a CTA where shared memory allows (the kernels' __launch_bounds__)
MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use

#: (KU, KV, N, M): u points a lane a tile, v points a lane a chunk, and the
#: shape compiled in (0, 0: any shape).
Tile = Tuple[int, int, int, int]


def padded(k: int, lanes: int) -> int:
    """Entries of a per-lane array of ``k`` once padded for the reduce-scatter
    over ``lanes`` lanes (``point_pairs::padded``): a power of two, at least
    ``lanes``."""
    p = lanes
    while p < k:
        p *= 2
    return p


def blocks_of(n: int, m: int, tile: Tile) -> Tuple[int, int]:
    """(u tiles, v chunks) that a row's N x M pairs take with ``tile``."""
    ku, kv = tile[:2]
    return -(-n // (LANES_U * ku)), -(-m // (LANES_V * kv))


def pick_tile(tiles: Sequence[Tile], n: int, m: int) -> Tile:
    """The tile of ``tiles`` compiled with the shape (N, M), where there is
    one, else the one for any shape."""
    return next(t for t in tiles if t[2:] in ((n, m), (0, 0)))


def warps_for(row_bytes: int) -> int:
    """Warps a CTA when each of a warp's ROWS_A_WARP rows stages
    ``row_bytes``: WARPS, fewer where shared memory is short, 0 where one
    warp does not fit."""
    return min(WARPS, MAX_SMEM // (ROWS_A_WARP * row_bytes))
