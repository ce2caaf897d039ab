"""The plain references agree with the program's CPU route (its plain
versions of every kernel) at tiny sizes, on weights and inputs the
benchmark draws: the thesis model's forward and train steps, the
transformer's train step, and the synthesis geometry."""

import statistics

import pytest
import torch

from portbench.harness import compare, inputs, manifest
from portbench.harness.cell import Cell
from portbench.reference import bigru, geometry
from portbench.reference.grid import synthesis_grid

M = manifest.load_manifest()
TINY_TRAIN = {"batch": 4, "bucket": 16, "length_min": 9, "length_max": 16, "pool": 4,
              "warmup_steps": 1, "trace_start": 1, "trace_steps": 2}
TINY_SYNTH = {"batch": 4, "bucket": 16, "length_min": 9, "length_max": 16, "pool": 2,
              "warmup_requests": 1, "sample": 2, "trace_start": 1, "trace_requests": 2}


def cell(workload, traffic, seed=2**31 + 11, cfg=None):
    w = manifest.workload(M, workload)
    tr = dict(manifest.load_traffic(w["traffic"]))
    tr.update(traffic)
    config = manifest.load_config(manifest.config_entry(M, w["config"]))
    config.update(cfg or {})
    return Cell(workload, w["config"], config, tr, {}, seed, 0.2,
                False, torch.device("cpu"))


def test_bigru_forward_matches_the_program():
    c = cell("artspeech_synthesis_b64", TINY_SYNTH)
    weights = inputs.draw_weights(bigru.param_spec(c.cfg), 3, "cpu")
    model = c.model.build_model(c.cfg, "cpu")
    inputs.load_weights(model, weights)
    lengths = torch.tensor([16, 9, 12])
    tokens = inputs.tokens(lengths, 16, c.cfg["vocab_size"], torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(tokens.long(), lengths)
        want = bigru.forward(c.cfg, weights, tokens.long(), lengths)
    valid = torch.arange(16)[None] < lengths[:, None]
    assert compare.widest_gap(got, want, valid) < 1e-5


def test_bigru_train_steps_match_the_program():
    c = cell("artspeech_train_b256", TINY_TRAIN)
    drv = manifest.driver_module("train")
    s = drv.setup(c)
    program = drv.first_steps(s)
    reference = drv.reference_steps(c, s.weights, s.pool[:3], s.dropout_seed)
    gaps = compare.train_gaps(program, reference, s.weights)
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-5 and gaps["change_gap"] < 1e-5


def test_transformer_train_step_matches_the_program():
    """float32: the first loss to rounding; the first gradients within 1e-2
    by the worst leaf (two orders of summation of this model's float32
    backward part by up to ~6e-3 here; in float64 they agree, next test)."""
    c = cell("transformer_train_b128", {**TINY_TRAIN, "batch": 2, "pool": 4, "length_min": 13})
    drv = manifest.driver_module("train")
    s = drv.setup(c)
    program = drv.first_steps(s, 1)
    reference = drv.reference_steps(c, s.weights, s.pool[:1], s.dropout_seed)
    gaps = compare.train_gaps(program, reference, s.weights)
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-2


def test_transformer_gradients_agree_in_float64(monkeypatch):
    from artspeech_tpu_torch.ops import hopper_train_attention as hta
    from artspeech_tpu_torch.train.state import create_train_state
    monkeypatch.setattr(hta, "fused_causal_attend",
                        lambda q, k, v, keep, n: hta.fused_causal_attend_reference(q, k, v, keep, n))
    c = cell("transformer_train_b128", {**TINY_TRAIN, "batch": 2, "pool": 4, "length_min": 13})
    drv = manifest.driver_module("train")
    s = drv.setup(c)
    s.model.double()
    s.state = create_train_state(s.model, 1e-4, 1e-5)
    for b in s.pool:
        b["targets"] = b["targets"].double()
    program = drv.first_steps(s, 1)
    weights = {k: v.double() for k, v in s.weights.items()}
    reference = drv.reference_steps(c, weights, s.pool[:1], s.dropout_seed)
    g_ref = {k: float(v.norm()) for k, v in reference["grads"].items()}
    g_med = statistics.median(g_ref.values())
    worst = max(abs(float(program["grads"][k].norm()) - g_ref[k]) / max(g_ref[k], g_med)
                for k in g_ref)
    assert worst < 1e-5


def test_geometry_copy_is_the_programs():
    from artspeech_tpu_torch.geometry.area_function import tube_area_function
    from artspeech_tpu_torch.geometry.tube import generate_vocal_tract_tube_batch
    from artspeech_tpu_torch.ops.bspline import regularize_bsplines
    cfg = manifest.load_config(manifest.config_entry(M, "artspeech_bigru"))
    x = torch.rand(2, 5, 10, 2, 50, generator=torch.Generator().manual_seed(5))
    smooth = geometry.smoothed(x)
    assert torch.equal(smooth, regularize_bsplines(x.transpose(-1, -2)).transpose(-1, -2))
    stack, arts = geometry.with_incisor(smooth, cfg["articulators"])
    walls = geometry.generate_vocal_tract_tube_batch(stack, arts)
    for a, b in zip(walls, generate_vocal_tract_tube_batch(stack, arts)):
        assert torch.equal(a, b)
    grid = torch.as_tensor(synthesis_grid())
    assert torch.equal(geometry.tube_area_function(*walls, grid),
                       tube_area_function(*walls, semipolar_grid=grid))


def test_synthesis_answers_match_the_reference():
    c = cell("artspeech_synthesis_b64", TINY_SYNTH)
    out = manifest.driver_module("synthesis").run(c)
    assert out.numbers["output_gap"] < 1e-5 and out.attempted >= 1
