"""Shared CLI scaffolding: --config YAML + tracker flags + --device
(counterpart of artspeech_tpu/cli/common.py).

Mirrors the reference entry-script surface (argparse with --config /
--mlflow / --experiment / --run_id / --run_name / --checkpoint, e.g.
train_phoneme_to_articulation.py:387-424) so thesis_config YAMLs drive
experiments the same way. The config is read with the port's own reader of
the configs' YAML subset (cli/config_file.py). ``--device`` is the CLI's form
of the ``device=`` that every entry point of the port takes: ``cuda`` unless
``--device cpu`` is given.

Launched by ``python -m torch.distributed.run --nproc_per_node=N -m
artspeech_tpu_torch.cli.<train_cli> ...``, ``run_experiment`` joins the group
that torchrun's environment describes (each rank on ``cuda:LOCAL_RANK``, NCCL;
gloo with ``--device cpu``), and only rank 0 gets a tracker that writes. A
plain ``python -m ...`` run is world size 1.
"""

import argparse
import os
import time
from typing import Callable, Dict

import torch
import torch.distributed as dist

from artspeech_tpu_torch.cli import config_file
from artspeech_tpu_torch.parallel.distributed import (
    initialize_multihost,
    is_initialized,
    is_main_process,
)
from artspeech_tpu_torch.utils.tracking import NullTracker, make_tracker

#: Compute dtypes, by their config spellings (JAX core/config.py:
#: resolve_dtype); float32 is the models' default, so it is dropped from the
#: kwargs.
_COMPUTE_DTYPES = {"float32": None, "fp32": None, "bfloat16": torch.bfloat16,
                   "bf16": torch.bfloat16, "float16": torch.float16, "fp16": torch.float16}


def model_kwargs_from_cfg(cfg: Dict, key: str = "model_kwargs") -> Dict:
    """Model constructor kwargs from a config, with the compute dtype.

    As in JAX (cli/common.py:51-52), two spellings select 16-bit compute with
    float32 parameters: ``compute_dtype: bfloat16`` at the top level, which
    does not override an explicit per-model ``dtype``, and ``dtype`` in the
    model's kwargs. ``float32``/``fp32`` (the default) are dropped,
    ``bfloat16``/``bf16`` become ``dtype=torch.bfloat16`` and
    ``float16``/``fp16`` ``dtype=torch.float16``; any other name raises
    ``ValueError``, where JAX's ``resolve_dtype`` raises ``KeyError``.
    """
    kwargs = dict(cfg.get(key) or {})
    if cfg.get("compute_dtype") is not None:
        kwargs.setdefault("dtype", cfg["compute_dtype"])
    if "dtype" in kwargs:
        name = str(kwargs["dtype"]).lower()
        if name not in _COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {kwargs['dtype']}: one of "
                             f"{', '.join(_COMPUTE_DTYPES)}")
        dtype = _COMPUTE_DTYPES[name]
        if dtype is None:
            del kwargs["dtype"]
        else:
            kwargs["dtype"] = dtype
    return kwargs


def parse_cli(description: str):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", dest="config_filepath", required=True)
    parser.add_argument("--mlflow", dest="mlflow_tracking_uri", default=None)
    parser.add_argument("--experiment", dest="experiment_name", default="artspeech_tpu")
    parser.add_argument("--run_id", dest="run_id", default=None)
    parser.add_argument("--run_name", dest="run_name", default=None)
    parser.add_argument("--checkpoint", dest="checkpoint_filepath", default=None)
    parser.add_argument("--output_dir", dest="output_dir", default="results")
    parser.add_argument("--device", dest="device", default="cuda",
                        help="torch device to run on (default: cuda; the CPU only when asked)")
    args = parser.parse_args()
    return args, config_file.load(args.config_filepath)


def run_experiment(description: str, main_fn: Callable):
    """Parse CLI, join torchrun's process group if there is one, build the
    tracker (rank 0's; the other ranks' records nothing), call
    ``main_fn(cfg, args, tracker)``, and leave the group it joined."""
    args, cfg = parse_cli(description)
    joined = not is_initialized() and initialize_multihost(device=args.device)
    # Unique default so two runs without --run_name never interleave their
    # metrics.jsonl/params.json.
    default_name = f"run_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
    run_dir = os.path.join(args.output_dir, args.run_name or default_name)
    tracker = NullTracker()
    if is_main_process():
        tracker = make_tracker(
            run_dir,
            mlflow_uri=args.mlflow_tracking_uri,
            experiment=args.experiment_name,
            run_id=args.run_id,
            run_name=args.run_name,
        )
    tracker.log_params(cfg)
    try:
        return main_fn(cfg, args, tracker)
    finally:
        tracker.end()
        if joined:
            dist.destroy_process_group()
