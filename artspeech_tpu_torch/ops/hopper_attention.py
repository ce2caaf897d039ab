"""Flash decode-attention over merged-lane KV caches: the Hopper kernel's
wrapper and its plain version.

Counterpart of artspeech_tpu/ops/pallas_attention.py:flash_decode_attend (the
Pallas ``_flash_kernel``), which serves the transformer's KV-cached decode
(models/transformer.py:make_fast_generate). The kernel is
``csrc/flash_decode.cu``.

- A CPU tensor takes the plain version, :func:`flash_decode_attend_reference`.
- A CUDA tensor takes the kernel, or the call raises. Nothing falls back.

On every device the call raises for what the kernel does not take: caches
other than float32, bfloat16 or float16, K and V of different dtypes, a query other
than float32, tensors that are not contiguous, a head dim above
``MAX_HEAD_DIM``, ``n_rows`` outside ``[1, S]``. The TPU wrapper's tile rules
(``supported``, ``S_CHUNK``, ``_G_BLOCKS``) and its dispatch threshold
(``HBM_STREAM_BYTES``) are not ported: the kernel takes any G and any
``n_rows``, and the decode calls it at every step. The launch comes from
:func:`flash_decode_launch_geometry`, from the shape and the card alone.

Inference only, like the TPU kernel. ``launches`` counts kernel launches.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from artspeech_tpu_torch.ops import _build

#: Kernel launches so far (the plain version does not count).
launches = 0

#: Largest head dim the kernels take (csrc/flash_decode.cu: registers up to
#: ``REGISTER_MAX_HD``, the wide instance's shared memory above).
MAX_HEAD_DIM = 256
#: Largest head dim of the register instance (q and the accumulator in registers).
REGISTER_MAX_HD = 64
#: Head dims up to which a thread may take two lanes (flash_decode.cu's pair instance).
PAIR_MAX_HD = 16
#: Lanes a warp takes a row with one lane a thread.
LANES = 32
#: Warps a CTA of the register instance at most (flash_decode.cu's MAX_WARPS).
MAX_WARPS = 8
#: CTAs a cluster at most: the portable cluster size (dsmem.cuh's MAX_CLUSTER).
MAX_CLUSTER = 8
#: Warps a block of the wide instance at most (flash_decode.cu's WIDE_SPLITS).
WIDE_WARPS = 4
#: Bytes of shared memory one Hopper block may use.
MAX_SMEM = 232448
#: Streaming multiprocessors of an H100 SXM.
H100_SMS = 132

#: The cache dtypes the kernel takes, by its dtype code.
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_entry = None
_sm_counts = {}


class FlashGeometry(NamedTuple):
    """How the kernel launches at one shape (:func:`flash_decode_launch_geometry`).

    The kernel is passed ``lanes``, ``cluster``, ``warps`` and ``smem_bytes``
    and lays out the grid from them; the other fields describe that launch
    for the tests and for ``chip_smoke.py``'s prints.
    """

    wide: bool          #: the wide instance (hd > REGISTER_MAX_HD), else the register one
    lanes: int          #: lanes a thread: 1, or 2 loaded as one 8-byte (f32) or 4-byte (bf16) word
    lane_block: int     #: lanes a cluster owns: LANES * lanes
    blocks: int         #: lane blocks, ceil(G / lane_block)
    cluster: int        #: CTAs a cluster; they split the lane block's rows
    warps: int          #: warps a CTA; they split the CTA's share of the rows
    threads: int        #: threads a CTA
    ctas: int           #: blocks * cluster
    splits: int         #: row ranges a lane block: cluster * warps
    rows_per_warp: int  #: the most rows a warp takes, ceil(n_rows / splits)
    smem_bytes: int     #: dynamic shared memory a CTA


def register_smem_bytes(hd, warps, lanes):
    """Shared memory of the register instance: the warps' partials and the
    CTA's, each (hd + 2, LANES * lanes) floats (flash_decode.cu:smem_bytes)."""
    return 4 * (warps + 1) * (hd + 2) * LANES * lanes


def flash_decode_launch_geometry(g, n_rows, hd, elem_bytes, sm_count=H100_SMS, aligned=True):
    """The launch of csrc/flash_decode.cu for ``g`` lanes, ``n_rows`` rows and
    head dim ``hd`` with caches of ``elem_bytes`` (4 or 2), from the shape and
    the card alone; the kernel derives nothing else.

    The register instance (hd <= 64): a cluster of C CTAs owns a block of
    32 * lanes lanes and splits its rows, each CTA's W warps splitting its
    share further (split ``s = rank * W + warp`` takes rows ``[s * n_rows //
    (C W), (s + 1) * n_rows // (C W))``: ``n_rows // (C W)`` or one more). The
    rule aims at 2 * ``sm_count`` CTAs and 4 * ``sm_count`` warps where the
    rows allow:

    - lanes a thread: 2 where hd <= 16, G is even, the tensors are ``aligned``
      to a pair and the 64-lane blocks, in clusters of up to min(8, n_rows),
      still reach the CTAs aimed at; else 1;
    - C = the largest power of two <= min(8, n_rows, ceil(2 * sm_count /
      blocks)) (a cluster of 7 ran slower than one of 4 with twice the warps);
    - W = min(8, n_rows // C, ceil(4 * sm_count / (blocks * C))), at least
      1: no warp is left without rows, and no more row splits than fill the
      card (each split costs a partial to combine; on the H100 the decode's
      calls ran fastest at 4-5 warps an SM, PERF.md).

    The wide instance (hd > 64): blocks of 32 lanes, clusters of 1, min(4,
    n_rows) warps taking rows ``warp, warp + W, ...``, q and the partials in
    shared memory.
    """
    if hd > REGISTER_MAX_HD:
        warps = min(n_rows, WIDE_WARPS)
        blocks = -(-g // LANES)
        return FlashGeometry(True, 1, LANES, blocks, 1, warps, LANES * warps, blocks, warps,
                             -(-n_rows // warps), 4 * LANES * (warps * (hd + 2) + hd))
    target_ctas, target_warps = 2 * sm_count, 4 * sm_count
    pairs = (hd <= PAIR_MAX_HD and g % 2 == 0 and aligned
             and -(-g // (2 * LANES)) * min(MAX_CLUSTER, n_rows) >= target_ctas)
    lanes = 2 if pairs else 1
    lane_block = LANES * lanes
    blocks = -(-g // lane_block)
    cluster = 1 << (max(1, min(MAX_CLUSTER, n_rows, -(-target_ctas // blocks))).bit_length() - 1)
    warps = max(1, min(MAX_WARPS, n_rows // cluster, -(-target_warps // (blocks * cluster))))
    splits = cluster * warps
    return FlashGeometry(False, lanes, lane_block, blocks, cluster, warps, LANES * warps,
                         blocks * cluster, splits, -(-n_rows // splits),
                         register_smem_bytes(hd, warps, lanes))


@functools.lru_cache(maxsize=4096)
def _geometry(g, n_rows, hd, elem_bytes, sm_count, aligned):
    return flash_decode_launch_geometry(g, n_rows, hd, elem_bytes, sm_count, aligned)


def _flash_entry():
    """The library's ``flash_decode`` entry point, bound once."""
    global _entry
    if _entry is None:
        entry = _build.load("flash_decode").flash_decode
        entry.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        _entry = entry
    return _entry


def _sm_count(device):
    count = _sm_counts.get(device.index)
    if count is None:
        count = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return count


def flash_decode_attend_reference(cache_k, cache_v, qg, n_rows: int):
    """Plain PyTorch attend: the XLA attend of the JAX decode
    (transformer.py:1043-1047) over rows ``[0, n_rows)``: scores, softmax over
    time and the PV sum, all in float32.

    Args:
        cache_k, cache_v: (S, hd, G) caches; qg: (hd, G) pre-scaled query.
    Returns:
        (hd, G) float32.
    """
    k = cache_k[:n_rows].float()
    v = cache_v[:n_rows].float()
    logits = torch.sum(k * qg[None], dim=1)  # (n_rows, G)
    attn = torch.softmax(logits, dim=0)
    return torch.sum(v * attn[:, None, :], dim=0)


def _check(cache_k, cache_v, qg, n_rows):
    if cache_k.dtype not in _CACHE_DTYPES or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"flash_decode: caches must both be float32, bfloat16 or float16, got "
                        f"{cache_k.dtype} and {cache_v.dtype}")
    if qg.dtype != torch.float32:
        raise TypeError(f"flash_decode: the query must be float32, got {qg.dtype}")
    if cache_k.dim() != 3 or cache_v.shape != cache_k.shape or qg.shape != cache_k.shape[1:]:
        raise ValueError(f"flash_decode shapes: caches (S, hd, G) and query (hd, G), got "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)}, {tuple(qg.shape)}")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous() and qg.is_contiguous()):
        raise ValueError("flash_decode: caches and query must be contiguous")
    s, hd, _ = cache_k.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: head dim {hd} above the kernel's {MAX_HEAD_DIM}")
    if not 1 <= n_rows <= s:
        raise ValueError(f"flash_decode: n_rows={n_rows} outside [1, {s}]")


def _launch(cache_k, cache_v, qg, n_rows):
    global launches
    dev = cache_k.device
    _, hd, g = cache_k.shape
    elem = cache_k.element_size()
    ptrs = (cache_k.data_ptr(), cache_v.data_ptr(), qg.data_ptr())
    geo = _geometry(g, n_rows, hd, elem, _sm_count(dev), all(p % 8 == 0 for p in ptrs))
    out = torch.empty((hd, g), dtype=torch.float32, device=dev)
    err = _flash_entry()(*ptrs, out.data_ptr(), hd, g, n_rows, _CACHE_DTYPES[cache_k.dtype],
                         geo.lanes, geo.cluster, geo.warps, geo.smem_bytes,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def flash_decode_attend(cache_k, cache_v, qg, n_rows: int):
    """One decode step of attention over the first ``n_rows`` rows of
    merged-lane caches.

    Args:
        cache_k, cache_v: (S, hd, G) caches, float32, bfloat16 or float16, contiguous.
        qg: (hd, G) float32 pre-scaled query, contiguous.
        n_rows: rows to attend over (``t + 1`` at decode step ``t``), a host
            int in ``[1, S]``.
    Returns:
        (hd, G) float32. A CPU tensor takes
        :func:`flash_decode_attend_reference`; a CUDA tensor takes the
        kernel, or the call raises.
    """
    _check(cache_k, cache_v, qg, n_rows)
    dev = cache_k.device
    if dev.type == "cpu" and cache_v.device.type == "cpu" and qg.device.type == "cpu":
        return flash_decode_attend_reference(cache_k, cache_v, qg, n_rows)
    if dev.type != "cuda" or cache_v.device != dev or qg.device != dev:
        raise ValueError(f"flash_decode kernel needs CUDA tensors on one device, got "
                         f"{cache_k.device}, {cache_v.device}, {qg.device}")
    return _launch(cache_k, cache_v, qg, n_rows)
