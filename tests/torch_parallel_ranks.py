"""Rank functions for tests/test_torch_port_parallel.py,
tests/test_torch_port_parallel_cli.py and tests/test_torch_port_model_axis.py.

``artspeech_tpu_torch.parallel.dryrun.spawn`` runs them in fresh processes,
one per rank of a gloo group on the CPU, and pickles their results back to the
test. They import torch and the port only: the tests compute JAX's side in
their own process.
"""

import contextlib
import os
import sys

import numpy as np

from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer
from artspeech_tpu_torch.ops import hopper_train_attention
from artspeech_tpu_torch.parallel import dryrun
from artspeech_tpu_torch.parallel.distributed import distribute_state, run_distributed_step
from artspeech_tpu_torch.parallel.mesh import data_parallel_mesh, make_mesh, shard_batch
from artspeech_tpu_torch.train import loop
from artspeech_tpu_torch.train.checkpoint import whole_state_dicts
from artspeech_tpu_torch.train.loop import epoch_generator
from artspeech_tpu_torch.train.state import create_train_state
from artspeech_tpu_torch.train.step import (
    make_artspeech_eval_step,
    make_artspeech_train_step,
    make_transformer_eval_step,
    make_transformer_train_step,
)

TO_MM = 136 * 1.6176470518112

#: The families stepped over two ranks against one: case maker, global batch.
PAIR_FAMILIES = {
    "transformer": (dryrun.transformer_case, {}, 8),
    "latent_rnn": (dryrun.latent_rnn_case, {}, 8),
    "frame_autoencoder": (dryrun.frame_autoencoder_case, {}, 32),
    "recognizer_ctc": (dryrun.recognizer_case, {"criterion": "ctc"}, 8),
    "recognizer_ce": (dryrun.recognizer_case, {"criterion": "ce"}, 8),
}


def artspeech_state(state_dict, model_kwargs, lr):
    model = ArtSpeech(**model_kwargs, device="cpu")
    model.load_state_dict(state_dict)
    return create_train_state(model, lr)


def numpy_params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def numpy_grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters() if p.grad is not None}


def artspeech_steps(st, batch, mesh, n_steps):
    """``n_steps`` ArtSpeech train steps (P2CP on) and one eval step; the
    metrics as floats, and the first step's gradients (summed over the group).
    ``mesh`` None: the one-device steps on the whole batch."""
    step = make_artspeech_train_step(TO_MM, with_p2cp=True, device="cpu", mesh=mesh)
    rank = 0 if mesh is None else mesh.data_index
    metrics, first_grads = [], None
    for i in range(n_steps):
        generator = epoch_generator(0, i, "cpu", rank)
        m = step(st, batch, generator) if mesh is None else \
            run_distributed_step(step, st, batch, generator, mesh)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first_grads = numpy_grads(st.model)
    local = batch if mesh is None else shard_batch(batch, mesh)
    ev, _ = make_artspeech_eval_step(TO_MM, device="cpu", mesh=mesh)(st, local)
    return metrics, {k: float(v) for k, v in ev.items()}, first_grads


def parallel_scenarios(rank, inputs):
    """Every multi-rank scenario of tests/test_torch_port_parallel.py in one
    group of 4 ranks."""
    out = {}
    mesh = make_mesh(model_parallel=2, device="cpu")
    out["mesh"] = (mesh.shape, mesh.coords, mesh.grid.tolist())
    try:
        make_mesh(model_parallel=3)
        out["mp3_raises"] = False
    except ValueError:
        out["mp3_raises"] = True
    out["rows"] = shard_batch({"x": inputs["rows"]}, mesh)["x"].numpy()

    # The data-parallel ArtSpeech step, ragged and not (JAX's shard_map test).
    dp = data_parallel_mesh(len(inputs["artspeech"]["batches"][False]["lengths"]), device="cpu")
    out["dp_shape"] = dp.shape
    for ragged, batch in inputs["artspeech"]["batches"].items():
        st = artspeech_state(inputs["artspeech"]["state_dict"], inputs["artspeech"]["model"],
                             inputs["artspeech"]["lr"])
        distribute_state(st, dp)
        metrics, ev, grads = artspeech_steps(st, batch, dp, 2)
        out[("artspeech", ragged)] = {"metrics": metrics, "eval": ev,
                                      "params": numpy_params(st.model) if rank == 0 else None,
                                      "grads": grads if rank == 0 else None}

    # The (data 2, model 2) step with the heads sharded over model.
    tp = inputs["tp"]
    st = artspeech_state(tp["state_dict"], tp["model"], tp["lr"])
    distribute_state(st, mesh)
    step = make_artspeech_train_step(TO_MM, with_p2cp=True, device="cpu", mesh=mesh)
    m = run_distributed_step(step, st, tp["batch"], epoch_generator(0, 0, "cpu", mesh.data_index),
                             mesh)
    out["tp"] = {"metrics": {k: float(v) for k, v in m.items()}, "coords": mesh.coords,
                 "heads": {n: (p.detach().numpy().copy(), p.grad.numpy().copy())
                           for n, p in st.model.decoder.named_parameters()},
                 "trunk_grads": {n: p.grad.numpy().copy()
                                 for n, p in st.model.named_parameters()
                                 if not n.startswith("decoder.")}}

    # The other families over ranks 0 and 1 (ranks 2 and 3 only join the
    # group's creation).
    pair = make_mesh([0, 1], device="cpu")
    if rank < 2:
        for name, (make_case, kwargs, batch) in PAIR_FAMILIES.items():
            case = make_case(batch, "cpu", **kwargs)
            metrics = dryrun.run_case(case, pair)
            out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                         "params": numpy_params(case.state.model) if rank == 0 else None,
                         "grads": numpy_grads(case.state.model) if rank == 0 else None}
    return out


def run_train_cli(rank, module_name, config_path, output_dir):
    """A train CLI's ``run_experiment`` under torchrun's environment (set by
    ``spawn(..., torchrun_env=True)``) on the CPU."""
    import importlib

    from artspeech_tpu_torch.cli.common import run_experiment

    module = importlib.import_module(f"artspeech_tpu_torch.cli.{module_name}")
    sys.argv = ["train", "--config", config_path, "--output_dir", output_dir, "--run_name", "run",
                "--device", "cpu"]
    run_experiment("train", module.main)
    return rank


def one_rank_missing(rank):
    """Rank 1 never reaches the barrier that rank 0 waits in."""
    import time

    import torch.distributed as dist

    if rank == 1:
        time.sleep(600)
    dist.barrier()
    return rank


# -- the transformer on a model axis (tests/test_torch_port_model_axis.py) ------

def transformer_state(state_dict, model_kwargs, lr, dropout=0.0):
    model = ArtSpeechTransformer(**model_kwargs, dropout=dropout, device="cpu")
    model.load_state_dict(state_dict)
    return create_train_state(model, lr)


@contextlib.contextmanager
def counted_attends():
    """Yields a list that records (G, n_pairs) of every
    ``fused_causal_attend`` call made inside the block."""
    attend, calls = hopper_train_attention.fused_causal_attend, []

    def counted(q, k, v, keep, n_pairs):
        calls.append((q.shape[0], n_pairs))
        return attend(q, k, v, keep, n_pairs)

    hopper_train_attention.fused_causal_attend = counted
    try:
        yield calls
    finally:
        hopper_train_attention.fused_causal_attend = attend


def transformer_steps(st, batch, mesh, n_steps):
    """``n_steps`` transformer train steps (P2CP on) from generators seeded
    (0, step, data rank); the metrics as floats and the first step's
    gradients. ``mesh`` None: the one-device steps on the whole batch."""
    step = make_transformer_train_step(TO_MM, with_p2cp=True, device="cpu", mesh=mesh)
    rank = 0 if mesh is None else mesh.data_index
    metrics, first_grads = [], None
    for i in range(n_steps):
        generator = epoch_generator(0, i, "cpu", rank)
        m = step(st, batch, generator) if mesh is None else \
            run_distributed_step(step, st, batch, generator, mesh)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first_grads = numpy_grads(st.model)
    return metrics, first_grads


class ContourCorpus:
    """Seeded in-memory sentences with the ArtSpeechDataset item interface,
    targets (length, n_art, 2, d) in [0, 1]."""

    def __init__(self, n, seed, n_art, d, vocab, max_len=12):
        rng = np.random.default_rng(seed)
        self.items = []
        for i, length in enumerate(rng.integers(3, max_len + 1, n)):
            self.items.append({
                "sentence_name": f"S{i:02d}", "length": int(length),
                "tokens": rng.integers(0, vocab, length).astype(np.int32),
                "targets": rng.random((length, n_art, 2, d)).astype(np.float32),
                "references": np.zeros((length, 1, 2, d), np.float32),
                "critical_masks": np.zeros((1, length), np.int32),
                "voicing": np.zeros(length, np.float32),
                "phonemes": ["p"] * length, "frame_ids": list(range(length))})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def transformer_fit(state, mesh, fit_args, checkpoints_dir, n_epochs, **kwargs):
    """``fit`` of the transformer at dropout 0 over ``mesh`` (None: one
    device); returns its history."""
    c, d, vocab = fit_args["n_art"], fit_args["d"], fit_args["vocab"]
    batch_size = fit_args["batch_size"]
    train = BucketedLoader(ContourCorpus(fit_args["n_train"], 1, c, d, vocab), batch_size,
                           buckets=(16,), seed=0)
    valid = BucketedLoader(ContourCorpus(fit_args["n_valid"], 2, c, d, vocab), batch_size,
                           buckets=(16,), shuffle=False)
    result = loop.fit(
        state, train, valid, None, None, n_epochs, checkpoints_dir, device="cpu", mesh=mesh,
        train_step_factory=lambda m: make_transformer_train_step(TO_MM, device="cpu", mesh=m),
        eval_step_factory=lambda m: make_transformer_eval_step(TO_MM, device="cpu", mesh=m),
        **kwargs)
    return result.history


def model_axis_scenarios(rank, inputs):
    """Every multi-rank scenario of tests/test_torch_port_model_axis.py in
    one group of 4 ranks."""
    out = {}
    tf = inputs["transformer"]

    # The (data 2, model 2) step at dropout 0.
    mesh = make_mesh(model_parallel=2, device="cpu")
    st = transformer_state(tf["state_dict"], tf["model"], tf["lr"])
    distribute_state(st, mesh)
    with counted_attends() as calls:
        metrics, grads = transformer_steps(st, tf["batch"], mesh, 1)
    out["mesh22"] = {"coords": mesh.coords, "metrics": metrics[0], "grads": grads,
                     "params": numpy_params(st.model), "attends": calls}

    # The (data 1, model 2) pair at dropout 0.1, two updates.
    pair = make_mesh([0, 1], model_parallel=2, device="cpu")
    if rank < 2:
        st = transformer_state(tf["state_dict"], tf["model"], tf["lr"], dropout=0.1)
        distribute_state(st, pair)
        with counted_attends() as calls:
            metrics, _ = transformer_steps(st, tf["batch"], pair, 2)
        model_sd, _ = whole_state_dicts(st.model)
        out["pair"] = {"metrics": metrics, "attends": calls,
                       "params": {k: v.numpy().copy() for k, v in model_sd.items()}}

    # fit for 2 epochs on (data 2, model 2) and on (data 2, model 1), then a
    # resume on (data 2, model 2) from the first one's last/.
    fit_args, tmp = inputs["fit"], inputs["tmp"]
    data_only = make_mesh([0, 1], device="cpu")
    st = transformer_state(tf["state_dict"], tf["model"], fit_args["lr"])
    out["fit_model_axis"] = transformer_fit(st, mesh, fit_args, os.path.join(tmp, "model_axis"), 2)
    if rank < 2:
        st = transformer_state(tf["state_dict"], tf["model"], fit_args["lr"])
        out["fit_data_only"] = transformer_fit(st, data_only, fit_args,
                                               os.path.join(tmp, "data_only"), 2)
    st = transformer_state(tf["state_dict"], tf["model"], fit_args["lr"])
    out["resume_mesh"] = transformer_fit(
        st, mesh, fit_args, os.path.join(tmp, "resume_mesh"), 3,
        resume_from=os.path.join(tmp, "model_axis", "last"))
    out["sharded_shapes"] = {n: tuple(p.shape) for n, p in st.model.named_parameters()}

    # C = 3 on the model axis of 2: the channel stacks stay whole.
    st = transformer_state(inputs["odd"]["state_dict"], inputs["odd"]["model"], tf["lr"])
    distribute_state(st, mesh)
    metrics, grads = transformer_steps(st, inputs["odd"]["batch"], mesh, 1)
    out["odd"] = {"metrics": metrics[0], "grads": grads}
    return out
