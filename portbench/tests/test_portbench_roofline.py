"""The copied bound arithmetic gives chip_smoke.py's values at the shapes
of PERF.md's kernel table (values as chip_smoke.py's functions computed
them, hard-coded here)."""

import pytest

from portbench.harness import roofline

CHIP_SMOKE = [
    ("gru_bound_ms", (128, 12, 128, 2, 4), (0.004577738507462687, "operations")),
    ("gru_bwd_bound_ms", (128, 12, 128, 2, 4), (0.013709739940298508, "operations")),
    ("gru_bound_ms", (128, 16, 128, 2, 4), (0.006103651343283582, "operations")),
    ("gru_bwd_bound_ms", (128, 16, 128, 2, 4), (0.018279653253731345, "operations")),
    ("gru_bound_ms", (128, 256, 128, 2, 4), (0.09765842149253731, "operations")),
    ("gru_bwd_bound_ms", (128, 256, 128, 2, 4), (0.2924744520597015, "operations")),
    ("train_attention_bound_ms", (4320, 128, 90, False, 16), (0.044676967164179106, "bytes")),
    ("train_attention_bound_ms", (4320, 128, 90, True, 16), (0.08517234626865672, "operations")),
    ("train_attention_bound_ms", (23040, 128, 90, False, 16), (0.23064759402985074, "bytes")),
    ("train_attention_bound_ms", (23040, 128, 90, True, 16), (0.45425251343283585, "operations")),
    ("train_attention_bound_ms", (720, 576, 90, False, 16), (0.11428940417910448, "operations")),
    ("train_attention_bound_ms", (720, 576, 90, True, 16), (0.2857235104477612, "operations")),
    ("train_attention_bound_ms", (720, 1024, 90, False, 16), (0.36093707462686564, "operations")),
    ("train_attention_bound_ms", (720, 1024, 90, True, 16), (0.9023426865671642, "operations")),
    ("train_attention_bound_ms", (4320, 128, 90, False, 64), (0.1714451104477612, "bytes")),
    ("train_attention_bound_ms", (4320, 128, 90, True, 128), (0.6813787701492537, "operations")),
]


@pytest.mark.parametrize("name,args,want", CHIP_SMOKE)
def test_bounds_match_chip_smoke(name, args, want):
    got = getattr(roofline, name)(*args)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)


def test_cell_bounds_are_the_kernel_calls_at_the_cells_shapes():
    from portbench.harness import manifest
    m = manifest.load_manifest()
    cfg = manifest.load_config(manifest.config_entry(m, "artspeech_bigru"))
    bounds = manifest.config_module("artspeech_bigru").kernel_bounds(
        cfg, manifest.load_traffic("train_b256_bucket128"))
    assert bounds == {"gru_fwd": CHIP_SMOKE[4][2][0], "gru_bwd": CHIP_SMOKE[5][2][0]}
    cfg = manifest.load_config(manifest.config_entry(m, "multichannel_transformer"))
    bounds = manifest.config_module("multichannel_transformer").kernel_bounds(
        cfg, manifest.load_traffic("train_b128_bucket128"))
    groups = 128 * 10 * 9 * 4  # sentences x channel pairs x heads
    assert bounds == {"train_attention_fwd": roofline.train_attention_bound_ms(
                          groups, 128, 90, False, 16)[0],
                      "train_attention_bwd": roofline.train_attention_bound_ms(
                          groups, 128, 90, True, 16)[0]}
