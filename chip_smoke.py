"""Drive the PyTorch/CUDA port's synthesis path on one NVIDIA GPU and check it.

Usage, from the root of the repository, on a machine with one H100:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles the GRU forward kernel from ops/csrc/gru_fwd.cu;
  3. kernel  — holds the kernel against its plain PyTorch version on the card,
               both directions, ragged lengths, f32 and bf16;
  4. main    — the full-width ArtSpeech (vocab 64, hidden 128) synthesis path:
               synthesize_corpus over 32 seeded sentences into a temporary
               directory, then the bench.py shape (B=16, T=128, 11
               articulators) through make_synthesis_step and
               tube_area_function on the semipolar grid; checks the files,
               finiteness, the kernel launch count, and agreement with the
               same path run on the CPU on a small input;
  5. timing  — CUDA-event times of the kernel, its plain version and cuDNN's
               nn.GRU (a yardstick the port never calls), the bound, and
               synthesis frames/s.
Then one JSON line of kernel numbers and, last, the device line. Any failure
raises and exits non-zero; without CUDA nothing is printed as a result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import RECOGNITION_ARTICULATORS, TUBE_ARTICULATORS
from artspeech_tpu_torch.geometry.area_function import tube_area_function
from artspeech_tpu_torch.geometry.grid import build_semipolar_grid
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.ops import _build, hopper_gru
from artspeech_tpu_torch.synth.pipeline import make_synthesis_step, synthesize_corpus

VOCAB, HIDDEN = 64, 128
BENCH_B, BENCH_T = 16, 128
KERNEL_SHAPES = [(128, 16, 128), (128, 256, 128)]  # (T, B, H)
F32_TOL = 1e-5
# bf16: both sides round the carry to bf16 every step; one flip of the last
# bit (2^-8 at |h| < 1) can propagate, so allow two steps of it.
BF16_TOL = 2.0**-7
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s without tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = "artspeech_tpu/ops/pallas_gru.py:80 (_gru_fwd_kernel, pallas_call at :212)"


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def phase(tag, /, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, iters):
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_inputs(t, b, h, n_dir, dtype, seed):
    """Seeded x_proj (T, B, D*3H), w_h (D, H, 3H), b_h (D, 3H), ragged mask (T, B)."""
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(t, b, n_dir * 3 * h, generator=g) * 0.5
    wh = torch.randn(n_dir, h, 3 * h, generator=g) * 0.1
    bh = torch.randn(n_dir, 3 * h, generator=g) * 0.1
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = torch.arange(t)[:, None] < lengths[None, :]
    return [v.to(dtype).cuda() for v in (xp, wh, bh)] + [mask.cuda()]


def bigru_reference(xp, wh, bh, mask):
    gates = wh.shape[-1]
    return torch.cat([
        hopper_gru.gru_sequence_reference(xp[..., :gates], wh[0], bh[0], mask, False),
        hopper_gru.gru_sequence_reference(xp[..., gates:], wh[1], bh[1], mask, True),
    ], dim=-1)


def kernel_vs_plain():
    worst = 0.0
    for t, b, h in KERNEL_SHAPES:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xp, wh, bh, mask = gru_inputs(t, b, h, 2, dtype, seed=t + b)
            got = hopper_gru.bigru_sequence(xp, wh, bh, mask)
            torch.cuda.synchronize()
            err = (got.float() - bigru_reference(xp, wh, bh, mask).float()).abs().max().item()
            errs = {"bidirectional": err}
            gates = 3 * h
            for d, reverse in ((0, False), (1, True)):
                x_d = xp[..., d * gates:(d + 1) * gates].contiguous()
                one = hopper_gru.gru_sequence(x_d, wh[d], bh[d], mask, reverse)
                ref = hopper_gru.gru_sequence_reference(x_d, wh[d], bh[d], mask, reverse)
                errs["reverse" if reverse else "forward"] = (one.float() - ref.float()).abs().max().item()
            torch.cuda.synchronize()
            phase("kernel", T=t, B=b, H=h, dtype=str(dtype).split(".")[-1], tol=tol,
                  **{f"max_abs_err_{k}": v for k, v in errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()),
                  f"gru kernel disagrees with its plain version at {(t, b, h)} {dtype}: {errs}")
            if dtype == torch.float32 and (t, b) == (BENCH_T, BENCH_B):
                worst = max(worst, *errs.values())
    return worst


class Sentences:
    """Seeded in-memory sentences with the SynthesisDataset interface."""

    def __init__(self, n, articulators, seed):
        rng = np.random.default_rng(seed)
        self.articulators = sorted(articulators)
        self.data = []
        for i, n_tok in enumerate(rng.integers(20, 129, n)):
            tokens = rng.integers(0, VOCAB, n_tok).astype(np.int32)
            self.data.append({"sentence_name": f"S{i:03d}", "subject": "subject1",
                              "phonemes": [f"p{t}" for t in tokens], "tokens": tokens})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        item = self.data[index]
        return {**item, "length": len(item["tokens"])}


def bench_grid():
    """bench.py's semipolar grid."""
    return build_semipolar_grid(center=(0.5, 0.5), theta_rad=np.deg2rad(30.0),
                                omega_rad=np.deg2rad(-30.0), linear_step=0.05,
                                polar_step_rad=np.deg2rad(5.0)).astype(np.float32)


def bench_step(device):
    """make_synthesis_step + tube_area_function at the bench.py shape."""
    model = ArtSpeech(VOCAB, len(TUBE_ARTICULATORS), generator=torch.Generator().manual_seed(1),
                      device=device)
    step, arts = make_synthesis_step(model, TUBE_ARTICULATORS, device=device)
    grid = torch.as_tensor(bench_grid(), device=device)

    def run(tokens, lengths):
        out = step(tokens, lengths)
        with torch.inference_mode():
            area = tube_area_function(out["internal_wall"], out["external_wall"],
                                      semipolar_grid=grid)
        return out, area

    return run


def main_path(tmp):
    """Returns the launches it made and the bench-shape outputs."""
    model = ArtSpeech(VOCAB, len(RECOGNITION_ARTICULATORS), generator=torch.Generator().manual_seed(0))
    dataset = Sentences(32, RECOGNITION_ARTICULATORS, seed=0)
    bench = bench_step(None)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (BENCH_B, BENCH_T)).astype(np.int32)
    lengths = np.full(BENCH_B, BENCH_T, np.int32)
    torch.cuda.synchronize()

    hopper_gru.launches = 0
    t0 = time.perf_counter()
    written = synthesize_corpus(model, dataset, tmp, DATASET_CONFIG["artspeech2"], batch_size=8)
    out, area = bench(tokens, lengths)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = hopper_gru.launches

    n_batches = -(-len(dataset) // 8)
    expected = 2 * (n_batches + 1)  # one launch per BiGRU layer (both directions)
    phase("main", sentences=len(written), batches=n_batches, seconds=f"{seconds:.3f}",
          gru_launches=launches, expected=expected)
    check(launches == expected, f"GRU kernel launched {launches} times, expected {expected}")

    # The corpus: every file of every frame, finite.
    n_frames = sum(len(it["tokens"]) for it in dataset.data)
    n_npy = n_txt = 0
    for d in written:
        for sub, ext in (("inference_contours", ".npy"), ("air_column", ".npy"), ("xarticul", ".txt")):
            for name in os.listdir(os.path.join(d, sub)):
                path = os.path.join(d, sub, name)
                if ext == ".npy":
                    check(np.isfinite(np.load(path)).all(), f"non-finite values in {path}")
                    n_npy += 1
                else:
                    check(np.isfinite(np.loadtxt(path)).all(), f"non-finite values in {path}")
                    n_txt += 1
    check(n_npy == n_frames * (len(TUBE_ARTICULATORS) + 1), f"{n_npy} npy files for {n_frames} frames")
    check(n_txt == n_frames, f"{n_txt} xarticul files for {n_frames} frames")
    phase("main", corpus_frames=n_frames, npy_files=n_npy, xarticul_files=n_txt, finite=True)

    frames = BENCH_B * BENCH_T
    check(tuple(out["contours"].shape) == (BENCH_B, BENCH_T, 11, 2, 50), "contours shape")
    check(tuple(out["internal_wall"].shape) == (BENCH_B, BENCH_T, 100, 2), "wall shape")
    check(tuple(area.shape) == (BENCH_B, BENCH_T, 2, 200), "area function shape")
    for key, value in (*out.items(), ("area", area)):
        check(bool(torch.isfinite(value).all()), f"non-finite {key}")
    phase("main", bench_frames=frames, area_shape=tuple(area.shape), finite=True)
    return launches


def against_cpu():
    """The bench-shape path on the card against the same path on the CPU
    (plain GRU) on a small input; same seeded weights on both. The area
    function is compared on the same (the card's) walls: which wall crossings
    pair up is discrete, so walls a few ulps apart may pick another pair."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, VOCAB, (2, 32)).astype(np.int32)
    lengths = np.array([32, 17], np.int32)
    gpu_out, gpu_area = bench_step(None)(tokens, lengths)
    cpu_out, _ = bench_step("cpu")(tokens, lengths)
    errs = {k: (gpu_out[k].cpu() - cpu_out[k]).abs().max().item() for k in cpu_out}
    cpu_area = tube_area_function(gpu_out["internal_wall"].cpu(), gpu_out["external_wall"].cpu(),
                                  semipolar_grid=torch.as_tensor(bench_grid()))
    errs["area"] = (gpu_area.cpu() - cpu_area).abs().max().item()
    phase("main", against_cpu_tol=1e-4, **{f"max_abs_err_{k}": f"{v:.3g}" for k, v in errs.items()})
    check(all(v <= 1e-4 for v in errs.values()), f"card and CPU disagree: {errs}")


def gru_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the work: bytes moved once over HBM, FLOPs of the
    recurrent product over the f32 (non-tensor-core) peak; the larger."""
    gates = 3 * h
    bytes_moved = elem_bytes * (t * b * n_dir * gates + n_dir * h * gates + n_dir * gates
                                + t * b * n_dir * h) + 4 * t * b
    flops = n_dir * t * b * (2 * h * gates + 12 * h)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_breakdown(run, tokens, lengths, step_ms, steps=3):
    """Where a bench-shape synthesis step's time goes on the card: kernel
    launches and device-busy ms per step from a torch.profiler trace, the
    device's idle share against the untraced step time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run(tokens, lengths)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        phase("profile", device_trace="no device time recorded")
        return
    launches = sum(n for _, _, n in kernels)
    phase("profile", kernel_launches_per_step=f"{launches:.0f}",
          device_busy_ms_per_step=f"{busy_ms:.6g}", step_ms=f"{step_ms:.6g}",
          device_idle_share=f"{max(0.0, 1.0 - busy_ms / step_ms):.4f}")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:6]:
        phase("profile", kernel=name[:60].replace(" ", "_"), ms_per_step=f"{ms:.6g}",
              calls_per_step=f"{n:.0f}", share_of_busy=f"{ms / busy_ms:.3f}")


def timings(launches, max_err):
    results = {}
    for t, b, h in KERNEL_SHAPES:
        xp, wh, bh, mask = gru_inputs(t, b, h, 2, torch.float32, seed=1)
        kernel_ms = cuda_ms(lambda: hopper_gru.bigru_sequence(xp, wh, bh, mask), 20)
        plain_ms = cuda_ms(lambda: bigru_reference(xp, wh, bh, mask), 3)
        cudnn = torch.nn.GRU(h, h, bidirectional=True).cuda()
        x = torch.randn(t, b, h, device="cuda")
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: cudnn(x), 20)
        bound_ms, bound_by = gru_bound_ms(t, b, h, 2, 4)
        results[(t, b)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=library_ms)
        phase("timing", kernel="gru_fwd", T=t, B=b, H=h, directions=2, dtype="float32",
              **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in results[(t, b)].items()})

    run = bench_step(None)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, VOCAB, (BENCH_B, BENCH_T)).astype(np.int32)
    lengths = np.full(BENCH_B, BENCH_T, np.int32)
    run(tokens, lengths)
    torch.cuda.synchronize()
    iters, t0 = 10, time.perf_counter()
    for _ in range(iters):
        run(tokens, lengths)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    phase("timing", synthesis_step_ms=f"{step_s * 1e3:.6g}",
          synthesis_frames_per_s=f"{BENCH_B * BENCH_T / step_s:.6g}",
          shape=f"B={BENCH_B},T={BENCH_T},arts=11,with_area_function")
    device_breakdown(run, tokens, lengths, step_s * 1e3)

    main = results[(BENCH_T, BENCH_B)]
    return {"kernels": [{
        "name": "gru_fwd", "route": "cuda",
        "source": "artspeech_tpu_torch/ops/csrc/gru_fwd.cu",
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": f"T={BENCH_T},B={BENCH_B},H={HIDDEN},directions=2,float32",
    }]}


def main():
    check(torch.cuda.is_available(), "chip_smoke.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    fresh = not os.path.exists(_build.library_path("gru_fwd"))
    _build.build("gru_fwd")
    phase("build", kernel="gru_fwd", seconds=f"{time.perf_counter() - t0:.2f}", compiled=fresh)

    max_err = kernel_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(tmp)
    against_cpu()
    line = timings(launches, max_err)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
