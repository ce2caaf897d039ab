"""Drive the PyTorch/CUDA port's synthesis and training paths on one NVIDIA GPU
and check them.

Usage, from the root of the repository, on a machine with one H100:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  — requires CUDA; prints the card's name and power limit;
  2. build   — compiles the three kernels, ops/csrc/{gru_fwd,gru_bwd,p2cp}.cu,
               one nvcc each, all started together;
  3. kernel  — holds each kernel against its plain PyTorch version on the
               card: the GRU forward and backward at (T, B, H) = (128, 16,
               128) and (128, 256, 128), both directions in one launch and
               each alone, ragged lengths, f32 and bf16 (the backward also
               against torch.autograd through the plain forward); P2CP at
               R = 12*128*10 and R = 1001 rows;
  4. main    — the full-width ArtSpeech (vocab 64, hidden 128) synthesis path:
               synthesize_corpus over 32 seeded sentences into a temporary
               directory, then the bench.py shape (B=16, T=128, 11
               articulators) through make_synthesis_step and
               tube_area_function on the semipolar grid; checks the files,
               finiteness, the kernel launch count, and agreement with the
               same path run on the CPU on a small input;
  5. train   — the thesis trainer (configs/model_free/train_model_free.yaml:
               batch 12, dropout 0.1, AdamW lr 1e-4 wd 1e-5, 10 articulators)
               at full width: ``fit`` for 2 epochs over a seeded in-memory
               corpus (48 train, 12 valid sentences), its checkpoints, a
               resume, the launch counts of all three kernels, 20 steps on one
               batch at lr 1e-3 (the loss must fall), and one train step on
               the card against the same step on the CPU (see
               train_against_cpu for how the updated parameters compare);
  6. timing  — CUDA-event times of each kernel, its plain version and a
               PyTorch library call that computes the same function (a
               yardstick the port never calls), the bound, synthesis frames/s
               and train frames/s at B=12 and B=256 with the device's idle
               share and top kernels from torch.profiler.
Then one JSON line of kernel numbers and, last, the device line. Any failure
raises and exits non-zero; without CUDA nothing is printed as a result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.constants import RECOGNITION_ARTICULATORS, TUBE_ARTICULATORS
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.geometry.area_function import tube_area_function
from artspeech_tpu_torch.geometry.grid import build_semipolar_grid
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.ops import _build, hopper_gru, hopper_p2cp
from artspeech_tpu_torch.synth.pipeline import make_synthesis_step, synthesize_corpus
from artspeech_tpu_torch.train import loop, state
from artspeech_tpu_torch.train.checkpoint import restore_checkpoint
from artspeech_tpu_torch.train.step import make_artspeech_eval_step, make_artspeech_train_step

VOCAB, HIDDEN = 64, 128
BENCH_B, BENCH_T = 16, 128
KERNEL_SHAPES = [(128, 16, 128), (128, 256, 128)]  # (T, B, H)
F32_TOL = 1e-5
# bf16: both sides round the carry to bf16 every step; one flip of the last
# bit (2^-8 at |h| < 1) can propagate, so allow two steps of it.
BF16_TOL = 2.0**-7
# GRU backward, relative to max(|ref|, 1): f32 sums T*B terms of dW in
# another order; bf16 stores dx_proj in bf16 (2^-8 relative) and a one-ulp
# flip of the rounded dhg at one step moves the f32 carry and later
# roundings, so allow four ulps of the largest value.
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 2.0**-6
P2CP_TOL = 1e-5
P2CP_ROWS = 12 * 128 * 10  # the thesis valid batch: B * T * Nart contour pairs
TRAIN = dict(batch=12, lr=1e-4, wd=1e-5, dropout=0.1, n_train=48, n_valid=12, epochs=2)
TO_MM = mm_per_unit(DATASET_CONFIG["artspeech2"])
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s without tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = {
    "gru_fwd": "artspeech_tpu/ops/pallas_gru.py:80 (_gru_fwd_kernel, pallas_call at :212)",
    "gru_bwd": "artspeech_tpu/ops/pallas_gru.py:117 (_gru_bwd_kernel, pallas_call at :251)",
    "p2cp": "artspeech_tpu/ops/pallas_kernels.py:31 (_p2cp_kernel, pallas_call at :76)",
}


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def phase(tag, /, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def fmt(values):
    return {k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in values.items()}


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


def rel_err(got, ref):
    """max |got - ref| / max(max |ref|, 1)."""
    scale = max(ref.float().abs().max().item(), 1.0)
    return ((got.float() - ref.float()).abs().max() / scale).item()


def build_all():
    names = ("gru_fwd", "gru_bwd", "p2cp")
    fresh = {n: not os.path.exists(_build.library_path(n)) for n in names}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for name, future in [(n, pool.submit(_build.build, n)) for n in names]:
            future.result()
            phase("build", kernel=name, compiled=fresh[name])
    phase("build", kernels=len(names), seconds=f"{time.perf_counter() - t0:.2f}")


# -- kernels against their plain versions -------------------------------------

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
    return hopper_gru.gru_forward_reference(xp, wh, bh, mask, 0b10)


def bigru_backward_reference(xp, wh, bh, mask, ys, g):
    return hopper_gru.gru_backward_reference(xp, wh, bh, mask, ys, g, 0b10)


def gru_fwd_vs_plain():
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
            phase("kernel", kernel="gru_fwd", T=t, B=b, H=h, dtype=str(dtype).split(".")[-1],
                  tol=tol, **{f"max_abs_err_{k}": v for k, v in errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()),
                  f"gru kernel disagrees with its plain version at {(t, b, h)} {dtype}: {errs}")
            if dtype == torch.float32 and (t, b) == (BENCH_T, BENCH_B):
                worst = max(worst, *errs.values())
    return worst


def gru_bwd_vs_plain():
    """The backward kernel against its plain version (dx_proj, dW_h, db_h,
    relative to max(|ref|, 1)), both directions in one launch and each alone,
    and in f32 against torch.autograd through the plain forward. Returns the
    largest f32 absolute error max |got - ref| over dx_proj, dW_h and db_h
    against the plain version, and the largest f32 relative one."""
    worst_abs, worst_rel = 0.0, 0.0
    for t, b, h in KERNEL_SHAPES:
        gates = 3 * h
        for dtype, tol in ((torch.float32, BWD_F32_TOL), (torch.bfloat16, BWD_BF16_TOL)):
            xp, wh, bh, mask = gru_inputs(t, b, h, 2, dtype, seed=2 * t + b)
            gy = torch.randn(t, b, 2 * h, generator=torch.Generator().manual_seed(b),
                             device="cpu").to(dtype).cuda()
            ys = bigru_reference(xp, wh, bh, mask)
            got = hopper_gru.gru_backward(xp, wh, bh, mask, ys, gy, 0b10)
            ref = bigru_backward_reference(xp, wh, bh, mask, ys, gy)
            pairs = {f"bidirectional_{n}": (a, r) for n, a, r in zip(("dx", "dW", "db"), got, ref)}
            for d, reverse in ((0, False), (1, True)):
                x_d = xp[..., d * gates:(d + 1) * gates].contiguous()
                ys_d = ys[..., d * h:(d + 1) * h].contiguous()
                g_d = gy[..., d * h:(d + 1) * h].contiguous()
                one = hopper_gru.gru_backward(x_d, wh[d:d + 1], bh[d:d + 1], mask, ys_d, g_d,
                                              int(reverse))
                ref_d = hopper_gru.gru_sequence_backward_reference(x_d, wh[d], bh[d], mask, ys_d,
                                                                   g_d, reverse)
                for n, a, r in zip(("dx", "dW", "db"), (one[0], one[1][0], one[2][0]), ref_d):
                    pairs[f"{'reverse' if reverse else 'forward'}_{n}"] = (a, r)
            errs = {k: rel_err(a, r) for k, (a, r) in pairs.items()}
            abs_errs = {k: (a.float() - r.float()).abs().max().item() for k, (a, r) in pairs.items()}
            if dtype == torch.float32:
                params = [v.clone().requires_grad_() for v in (xp, wh, bh)]
                with torch.enable_grad():
                    auto = torch.autograd.grad(bigru_reference(*params, mask), params, gy)
                for n, a, r in zip(("dx", "dW", "db"), got, auto):
                    errs[f"autograd_{n}"] = rel_err(a, r)
            torch.cuda.synchronize()
            phase("kernel", kernel="gru_bwd", T=t, B=b, H=h, dtype=str(dtype).split(".")[-1],
                  tol=tol, **{f"rel_err_{k}": f"{v:.3g}" for k, v in errs.items()},
                  **{f"max_abs_err_{k}": f"{v:.3g}" for k, v in abs_errs.items()})
            check(all(np.isfinite(v) and v <= tol for v in errs.values()),
                  f"gru_bwd kernel disagrees with its plain version at {(t, b, h)} {dtype}: {errs}")
            if dtype == torch.float32:
                worst_abs = max(worst_abs, *abs_errs.values())
                worst_rel = max(worst_rel, *errs.values())
    return worst_abs, worst_rel


def p2cp_inputs(rows, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(rows, 2, 50, generator=g)
    v = (u + 0.05 * torch.randn(rows, 2, 50, generator=g)).clamp(0.0, 1.0)
    return u.cuda(), v.cuda()


def p2cp_vs_plain():
    worst = 0.0
    for rows in (P2CP_ROWS, 1001):
        u, v = p2cp_inputs(rows, seed=rows)
        got = hopper_p2cp.mean_p2cp_channel_major(u, v)
        err = (got - hopper_p2cp.mean_p2cp_channel_major_reference(u, v)).abs().max().item()
        torch.cuda.synchronize()
        phase("kernel", kernel="p2cp", rows=rows, N=50, M=50, dtype="float32", tol=P2CP_TOL,
              max_abs_err=err)
        check(np.isfinite(err) and err <= P2CP_TOL,
              f"p2cp kernel disagrees with its plain version at R={rows}: {err}")
        worst = max(worst, err)
    return worst


# -- the synthesis path ----------------------------------------------------------

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
    """Returns the launches it made."""
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


# -- the training path -----------------------------------------------------------

def smooth_contours(length, rng, n_art=len(RECOGNITION_ARTICULATORS)):
    """(length, n_art, 2, 50) smooth contours in [0, 1]: per articulator an
    arc of 50 points whose centre drifts slowly over the frames."""
    theta = np.linspace(0.0, np.pi, 50)
    frames = np.arange(length)[:, None, None]
    centre = rng.uniform(0.3, 0.7, (1, n_art, 2))
    radius = rng.uniform(0.05, 0.2, (1, n_art, 2))
    phase_ = rng.uniform(0.0, 2 * np.pi, (1, n_art, 1))
    drift = 0.1 * np.sin(2 * np.pi * frames / rng.uniform(20, 60) + phase_)
    x = centre[..., 0:1] + drift + radius[..., 0:1] * np.cos(theta)
    y = centre[..., 1:2] - drift + radius[..., 1:2] * np.sin(theta)
    return np.clip(np.stack([x, y], axis=2), 0.0, 1.0).astype(np.float32)


class Corpus:
    """Seeded in-memory sentences of 20-128 frames with the ArtSpeechDataset
    item interface and smooth target contours."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.data = []
        for i, length in enumerate(rng.integers(20, 129, n)):
            tokens = rng.integers(0, VOCAB, length).astype(np.int32)
            self.data.append({
                "sentence_name": f"S{i:03d}", "tokens": tokens,
                "targets": smooth_contours(length, rng), "phonemes": [f"p{t}" for t in tokens],
                "references": np.zeros((length, 1, 2, 50), np.float32),
                "critical_masks": np.zeros((0, length), np.int32),
                "frame_ids": [f"{f:04d}" for f in range(length)],
                "voicing": np.zeros(length, np.float32), "length": int(length)})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index]


def thesis_state(device, seed=0, dropout=TRAIN["dropout"], lr=TRAIN["lr"]):
    model = ArtSpeech(VOCAB, len(RECOGNITION_ARTICULATORS), dropout=dropout,
                      generator=torch.Generator().manual_seed(seed), device=device)
    return state.create_train_state(model, lr, TRAIN["wd"])


def parameters(st):
    return {k: v.detach().clone() for k, v in st.model.state_dict().items()}


def train_path(tmp):
    """fit for 2 epochs at thesis width, its checkpoints and a resume; the
    launch counts of all three kernels. Returns those counts."""
    train_loader = BucketedLoader(Corpus(TRAIN["n_train"], seed=1), TRAIN["batch"], seed=0)
    valid_loader = BucketedLoader(Corpus(TRAIN["n_valid"], seed=2), TRAIN["batch"], shuffle=False)
    train_step = make_artspeech_train_step(TO_MM)
    eval_step = make_artspeech_eval_step(TO_MM)
    steps = {"train": 0, "eval": 0}

    def counted_train(st, batch, generator):
        steps["train"] += 1
        return train_step(st, batch, generator)

    def counted_eval(st, batch):
        steps["eval"] += 1
        return eval_step(st, batch)

    st = thesis_state(None)
    torch.cuda.synchronize()
    hopper_gru.launches = hopper_gru.bwd_launches = hopper_p2cp.launches = 0
    t0 = time.perf_counter()
    result = loop.fit(st, train_loader, valid_loader, counted_train, counted_eval,
                      TRAIN["epochs"], tmp, patience=30)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"gru_fwd": hopper_gru.launches, "gru_bwd": hopper_gru.bwd_launches,
              "p2cp": hopper_p2cp.launches}
    expected = {"gru_fwd": 2 * (steps["train"] + steps["eval"]), "gru_bwd": 2 * steps["train"],
                "p2cp": steps["eval"]}
    phase("train", epochs=len(result.history), train_steps=steps["train"],
          eval_steps=steps["eval"], seconds=f"{seconds:.3f}",
          **{f"{k}_launches": v for k, v in counts.items()},
          **{f"{k}_expected": v for k, v in expected.items()})
    check(counts == expected, f"kernel launches {counts}, expected {expected}")
    for record in result.history:
        phase("train", **fmt({k: v for k, v in record.items()}))
        check(all(np.isfinite(v) for k, v in record.items() if k != "best"),
              f"non-finite metric in {record}")
    check(len(result.history) == TRAIN["epochs"], "fit stopped early")
    for sub in ("best/state.pt", "best/aux.json", "last/state.pt", "last/aux.json", "best_model"):
        check(os.path.isfile(os.path.join(tmp, sub)), f"fit wrote no {sub}")

    final = parameters(result.state)
    restored, _ = restore_checkpoint(os.path.join(tmp, "last"), thesis_state(None, seed=7))
    same = all(torch.equal(v, final[k]) for k, v in parameters(restored).items())
    resumed = loop.fit(thesis_state(None, seed=7), train_loader, valid_loader, train_step,
                       eval_step, TRAIN["epochs"] + 1, tmp, resume=True)
    phase("train", restored_from_last_equal=same,
          resumed_epochs=[r["epoch"] for r in resumed.history], resumed_step=resumed.state.step)
    check(same, "restoring last/ does not give fit's final parameters")
    check([r["epoch"] for r in resumed.history] == [TRAIN["epochs"]], "resume did not continue")
    check(resumed.state.step == result.state.step + steps["train"] // TRAIN["epochs"],
          "resumed step count")
    return counts


def fixed_batch(b, t, seed, device, ragged=True):
    """One seeded (B, T) batch; ragged lengths in [T/2, T] (the first T), or
    every frame valid."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(t // 2, t + 1, b) if ragged else np.full(b, t)
    lengths[0] = t
    mask = np.arange(t)[None, :] < lengths[:, None]
    batch = {"tokens": np.where(mask, rng.integers(0, VOCAB, (b, t)), 0).astype(np.int32),
             "targets": np.stack([smooth_contours(t, rng) for _ in range(b)])
             * mask[:, :, None, None, None],
             "lengths": lengths.astype(np.int32)}
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_falls():
    st = thesis_state(None, lr=1e-3)
    batch = fixed_batch(TRAIN["batch"], 128, seed=3, device="cuda", ragged=False)
    step = make_artspeech_train_step(TO_MM)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = [step(st, batch, gen)["loss"].item() for _ in range(20)]
    phase("train", fixed_batch_lr=1e-3, loss_first=f"{losses[0]:.6g}",
          loss_last=f"{losses[-1]:.6g}", ratio=f"{losses[-1] / losses[0]:.4f}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"loss did not fall: {losses}")


def train_against_cpu():
    """One train step, dropout 0, same weights and batch (B=2, T=32, ragged),
    on the card and on the CPU. Within 1e-4 relative (max |diff| / max |cpu
    value|, per tensor): the metrics, every gradient, AdamW's two moments
    after the step (exp_avg = 0.1 g, exp_avg_sq = 0.001 g^2) on every
    component, and every parameter after the step where |g| >= 100 * eps.

    AdamW's first update of a component is lr * g / (|g| + eps), eps = 1e-8,
    so where |g| is near eps (dead ReLU units give exact zeros and rounding
    noise) a 1e-9 difference in g moves the update by up to lr: the
    parameters are compared where |g| >= 100 * eps, the moments (which carry
    no eps) everywhere, and the unmasked parameter figure is printed."""
    batch = fixed_batch(2, 32, seed=4, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        st = thesis_state(device, dropout=0.0)
        metrics = make_artspeech_train_step(TO_MM, with_p2cp=True, device=device)(
            st, {k: v.to(device) for k, v in batch.items()})
        named = list(st.model.named_parameters())
        out[device] = ({k: v.cpu() for k, v in metrics.items()},
                       {n: p.grad.cpu() for n, p in named},
                       {n: p.detach().cpu() for n, p in named},
                       {(n, m): st.optimizer.state[p][m].cpu()
                        for n, p in named for m in ("exp_avg", "exp_avg_sq")})

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    eps = 1e-8
    cpu_grads, cpu_params, cpu_moments = out["cpu"][1], out["cpu"][2], out["cpu"][3]
    errs = {f"metric_{k}": rel(out["cuda"][0][k], v) for k, v in out["cpu"][0].items()}
    errs["grads_max"] = max(rel(out["cuda"][1][n], g) for n, g in cpu_grads.items())
    for m in ("exp_avg", "exp_avg_sq"):
        errs[f"{m}_max"] = max(rel(out["cuda"][3][key], v)
                               for key, v in cpu_moments.items() if key[1] == m)
    stable_err, near_eps_count = 0.0, 0
    for n, p in cpu_params.items():
        diff = (out["cuda"][2][n] - p).abs()
        stable = cpu_grads[n].abs() >= 100 * eps
        stable_err = max(stable_err, (diff[stable].max() / p.abs().max()).item()
                         if stable.any() else 0.0)
        near_eps_count += int((~stable).sum())
    errs["params_max_where_g_ge_100eps"] = stable_err
    all_params = max(rel(out["cuda"][2][n], p) for n, p in cpu_params.items())
    phase("train", against_cpu_tol=1e-4, **{f"rel_err_{k}": f"{v:.3g}" for k, v in errs.items()},
          rel_err_params_max_all=f"{all_params:.3g}", components_g_below_100eps=near_eps_count)
    check(all(v <= 1e-4 for v in errs.values()), f"card and CPU train steps disagree: {errs}")


# -- timing --------------------------------------------------------------------

def gru_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the forward's work: bytes moved once over HBM, FLOPs of
    the recurrent product over the f32 (non-tensor-core) peak; the larger."""
    gates = 3 * h
    bytes_moved = elem_bytes * (t * b * n_dir * gates + n_dir * h * gates + n_dir * gates
                                + t * b * n_dir * h) + 4 * t * b
    flops = n_dir * t * b * (2 * h * gates + 12 * h)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gru_bwd_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the backward's work: x_proj, ys, g, mask, W_h, b_h read
    and dx_proj written once, dW_h and db_h written once in f32; three
    (B, H) x (H, 3H)-sized products a step and direction (recompute, dh, dW)
    plus ~32 elementwise operations per hidden unit, over the f32 peak."""
    gates = 3 * h
    bytes_moved = (elem_bytes * (2 * t * b * n_dir * gates + 2 * t * b * n_dir * h
                                 + n_dir * h * gates + n_dir * gates)
                   + 4 * t * b + 4 * n_dir * (h * gates + gates))
    flops = n_dir * t * b * (3 * 2 * h * gates + 32 * h)
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def p2cp_bound_ms(rows, n, m):
    """u and v read and the means written once; per pair and direction two
    subtractions, a multiply, an FMA (2) and a min: six operations."""
    bytes_moved = 4 * rows * 2 * (n + m) + 4 * rows
    ops = 2 * rows * n * m * 6
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_breakdown(run_once, step_ms, tag, steps=3):
    """Where a step's time goes on the card: kernel launches and device-busy
    ms per step from a torch.profiler trace, the device's idle share against
    the untraced step time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_once()
        torch.cuda.synchronize()
    # User annotations (Optimizer.step#AdamW.step) span kernels already counted.
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        phase("profile", step=tag, device_trace="no device time recorded")
        return
    launches = sum(n for _, _, n in kernels)
    phase("profile", step=tag, kernel_launches_per_step=f"{launches:.0f}",
          device_busy_ms_per_step=f"{busy_ms:.6g}", step_ms=f"{step_ms:.6g}",
          device_idle_share=f"{max(0.0, 1.0 - busy_ms / step_ms):.4f}")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:6]:
        phase("profile", step=tag, kernel=name[:60].replace(" ", "_"), ms_per_step=f"{ms:.6g}",
              calls_per_step=f"{n:.0f}", share_of_busy=f"{ms / busy_ms:.3f}")


def host_ms(fn, iters):
    """Mean host-clock ms per call of work that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def time_gru_fwd():
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
              **fmt(results[(t, b)]))
    return results


def time_gru_bwd():
    """The backward kernel, its plain version, and cuDNN nn.GRU's backward
    (forward+backward minus forward; it also computes the input projection's
    gradients) as the yardstick."""
    results = {}
    for t, b, h in KERNEL_SHAPES:
        xp, wh, bh, mask = gru_inputs(t, b, h, 2, torch.float32, seed=3)
        gy = torch.randn(t, b, 2 * h, device="cuda")
        ys = hopper_gru.bigru_sequence(xp, wh, bh, mask)
        kernel_ms = cuda_ms(lambda: hopper_gru.gru_backward(xp, wh, bh, mask, ys, gy, 0b10), 20)
        plain_ms = cuda_ms(lambda: bigru_backward_reference(xp, wh, bh, mask, ys, gy), 3)
        cudnn = torch.nn.GRU(h, h, bidirectional=True).cuda()
        x = torch.randn(t, b, h, device="cuda", requires_grad=True)
        fwd_ms = cuda_ms(lambda: cudnn(x), 20)
        both_ms = cuda_ms(lambda: cudnn(x)[0].backward(gy), 20)
        bound_ms, bound_by = gru_bwd_bound_ms(t, b, h, 2, 4)
        results[(t, b)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=both_ms - fwd_ms)
        phase("timing", kernel="gru_bwd", T=t, B=b, H=h, directions=2, dtype="float32",
              cudnn_fwd_bwd_ms=f"{both_ms:.6g}", cudnn_fwd_ms=f"{fwd_ms:.6g}",
              **fmt(results[(t, b)]))
    return results[(BENCH_T, BENCH_B)]


def time_p2cp():
    u, v = p2cp_inputs(P2CP_ROWS, seed=9)
    kernel_ms = cuda_ms(lambda: hopper_p2cp.mean_p2cp_channel_major(u, v), 50)
    plain_ms = cuda_ms(lambda: hopper_p2cp.mean_p2cp_channel_major_reference(u, v), 10)
    up, vp = u.transpose(-1, -2), v.transpose(-1, -2)

    def library():
        d = torch.cdist(up, vp, compute_mode="donot_use_mm_for_euclid_dist")
        return (d.amin(dim=-1).mean(dim=-1) + d.amin(dim=-2).mean(dim=-1)) / 2.0

    lib_err = (library() - hopper_p2cp.mean_p2cp_channel_major(u, v)).abs().max().item()
    library_ms = cuda_ms(library, 10)
    bound_ms, bound_by = p2cp_bound_ms(P2CP_ROWS, 50, 50)
    result = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=library_ms)
    phase("timing", kernel="p2cp", rows=P2CP_ROWS, N=50, M=50, dtype="float32",
          library_max_abs_diff=f"{lib_err:.3g}", **fmt(result))
    return result


def time_synthesis():
    run = bench_step(None)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, VOCAB, (BENCH_B, BENCH_T)).astype(np.int32)
    lengths = np.full(BENCH_B, BENCH_T, np.int32)
    step_ms = host_ms(lambda: run(tokens, lengths), 10)
    phase("timing", synthesis_step_ms=f"{step_ms:.6g}",
          synthesis_frames_per_s=f"{BENCH_B * BENCH_T / step_ms * 1e3:.6g}",
          shape=f"B={BENCH_B},T={BENCH_T},arts=11,with_area_function")
    device_breakdown(lambda: run(tokens, lengths), step_ms, "synthesis")


def time_training():
    """The thesis train step (dropout 0.1, AdamW) at T=128, every frame valid."""
    for b in (TRAIN["batch"], 256):
        st = thesis_state(None)
        batch = fixed_batch(b, 128, seed=5, device="cuda", ragged=False)
        step = make_artspeech_train_step(TO_MM)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step_ms = host_ms(lambda: step(st, batch, gen), 10)
        frames = int(batch["lengths"].sum())
        phase("timing", train_step_ms=f"{step_ms:.6g}",
              train_frames_per_s=f"{frames / step_ms * 1e3:.6g}",
              shape=f"B={b},T=128,arts=10,dropout=0.1,adamw")
        device_breakdown(lambda: step(st, batch, gen), step_ms, f"train_B{b}")


def kernel_entry(name, launches, by_path, max_err, numbers, shape, **extra):
    return {"name": name, "route": "cuda", "source": f"artspeech_tpu_torch/ops/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max_err, "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"], "shape": shape, **extra}


def main():
    check(torch.cuda.is_available(), "chip_smoke.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    build_all()
    errs = {"gru_fwd": gru_fwd_vs_plain(), "p2cp": p2cp_vs_plain()}
    errs["gru_bwd"], bwd_rel_err = gru_bwd_vs_plain()
    with tempfile.TemporaryDirectory() as tmp:
        synthesis_launches = main_path(tmp)
    against_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = train_path(tmp)
    loss_falls()
    train_against_cpu()

    fwd = time_gru_fwd()[(BENCH_T, BENCH_B)]
    bwd = time_gru_bwd()
    p2cp = time_p2cp()
    time_synthesis()
    time_training()

    gru_shape = f"T={BENCH_T},B={BENCH_B},H={HIDDEN},directions=2,float32"
    line = {"kernels": [
        kernel_entry("gru_fwd", synthesis_launches + train_launches["gru_fwd"],
                     {"synthesis": synthesis_launches, "train": train_launches["gru_fwd"]},
                     errs["gru_fwd"], fwd, gru_shape),
        kernel_entry("gru_bwd", train_launches["gru_bwd"], {"train": train_launches["gru_bwd"]},
                     errs["gru_bwd"], bwd, gru_shape, rel_err=bwd_rel_err),
        kernel_entry("p2cp", train_launches["p2cp"], {"train": train_launches["p2cp"]},
                     errs["p2cp"], p2cp, f"R={P2CP_ROWS},N=50,M=50,float32"),
    ]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
