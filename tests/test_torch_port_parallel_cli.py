"""The port's train CLIs over 4 ranks against 1, and ``dryrun_multichip``.

Each CLI runs as ``python -m torch.distributed.run`` would start it: 4 spawned
processes with torchrun's environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), ``--device cpu`` and so
gloo, killed and failed past their deadline. On the synthetic corpus of
tests/test_distributed_training.py:
- the thesis train CLI: ``train_loss``, ``valid_loss`` and ``valid_p2cp_mm``
  of every epoch within rtol 2e-4 of the one-rank run, ``train_manual_spmd``
  1.0 against 0.0, and the same files as the one-rank run (only rank 0
  writes);
- the frame-autoencoder CLI the same way, over every float key;
- ``dryrun_multichip(4, device="cpu")``: all seven families finite.
The one-rank runs equal JAX through tests/test_torch_port_cli.py and
tests/test_torch_port_pc_cli.py, and JAX's dp8 equals its dp1
(tests/test_distributed_training.py), which closes the chain to JAX.
"""

import json
import os
import sys

import numpy as np
import pytest
import yaml

import torch_parallel_ranks as ranks_mod
from artspeech_tpu_torch.cli.common import run_experiment
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu_torch.parallel import dryrun

ARTS = sorted(a for a in TUBE_ARTICULATORS if a != UPPER_INCISOR)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_corpus"))
    info = make_synthetic_corpus(root, subjects=("s1",), sequences=("S01", "S02"),
                                 n_sentences=3, frames_per_sentence=8)
    vocab_path = os.path.join(root, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    return root, vocab_path


def _base(root, vocab_path):
    return {"database_name": "gottingen", "datadir": root, "vocab_filepath": vocab_path,
            "clip_tails": False, "num_epochs": 2, "patience": 5, "learning_rate": 1e-3,
            "train_seq_dict": {"s1": ["S01"]}, "valid_seq_dict": {"s1": ["S02"]},
            "test_seq_dict": {"s1": ["S02"]}, "seed": 0}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _records(output_dir):
    with open(os.path.join(output_dir, "run", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run_both(module_name, cfg, tmp_path, monkeypatch):
    """The CLI at world size 4 (spawned ranks) and 1 (in this process)."""
    cfg_path = tmp_path / f"{module_name}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ws4, ws1 = str(tmp_path / "ws4"), str(tmp_path / "ws1")
    assert dryrun.spawn(4, ranks_mod.run_train_cli, module_name, str(cfg_path), ws4,
                        timeout_s=60.0, torchrun_env=True) == [0, 1, 2, 3]
    module = __import__(f"artspeech_tpu_torch.cli.{module_name}", fromlist=["main"])
    monkeypatch.setattr(sys, "argv", ["train", "--config", str(cfg_path), "--output_dir", ws1,
                                      "--run_name", "run", "--device", "cpu"])
    run_experiment("train", module.main)
    # Only rank 0 wrote: the same files as the one-rank run.
    assert _files(ws4) == _files(ws1)
    return _records(ws4), _records(ws1)


def test_train_cli_four_ranks_match_one(corpus, tmp_path, monkeypatch):
    root, vocab_path = corpus
    cfg = {**_base(root, vocab_path), "batch_size": 4, "articulators": ARTS,
           "model_kwargs": {"hidden_size": 16}}
    dp, single = _run_both("train_phoneme_to_articulation", cfg, tmp_path, monkeypatch)
    assert len(dp) == len(single) == 2
    for dp_rec, single_rec in zip(dp, single):
        for key in ("train_loss", "valid_loss", "valid_p2cp_mm"):
            np.testing.assert_allclose(dp_rec[key], single_rec[key], rtol=2e-4, err_msg=key)
        assert dp_rec["train_manual_spmd"] == 1.0 and single_rec["train_manual_spmd"] == 0.0
    assert np.isfinite(dp[-1]["valid_p2cp_mm"])


def test_frame_autoencoder_cli_four_ranks_match_one(corpus, tmp_path, monkeypatch):
    root, vocab_path = corpus
    cfg = {**_base(root, vocab_path), "batch_size": 16, "indices_dict": {a: 2 for a in ARTS},
           "hidden_features": 8}
    dp, single = _run_both("train_principal_components_autoencoder", cfg, tmp_path, monkeypatch)
    assert len(dp) == len(single) == 2
    floats = 0
    for dp_rec, single_rec in zip(dp, single):
        assert dp_rec.keys() == single_rec.keys()
        for key, value in single_rec.items():
            if key == "train_manual_spmd":
                assert (dp_rec[key], value) == (1.0, 0.0)
            elif isinstance(value, float) and key != "ts":
                np.testing.assert_allclose(dp_rec[key], value, rtol=2e-4, err_msg=key)
                floats += 1
    assert floats >= 6


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    losses = dryrun.dryrun_multichip(4, device="cpu", timeout_s=60.0)
    assert sorted(losses) == sorted(dryrun.FAMILIES) and len(losses) == 7
    assert all(np.isfinite(v) for v in losses.values())
    assert "dryrun_multichip(4): mesh={'data': 2, 'model': 2}" in capsys.readouterr().out
