"""One sharded train step of every model family over n ranks (counterpart of
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``), and
``spawn``, which runs a function on n ranks of a fresh process group.

``dryrun_multichip(n)`` spawns n processes, joins them in a group, lays them
out as a (data, model) mesh (model 2 when n is even) and runs one step of
each of the seven families at tiny shapes: the ArtSpeech step with its heads
sharded over ``model``, the ArtSpeech step over a data-only mesh of the same
ranks, the transformer with its decoder's channel stacks and its heads
sharded over ``model`` (C = 4), the recognizer (CTC), the latent RNN, the
frame autoencoder and the synthesize-then-recognize pipeline. It asserts that every
loss is finite and prints one summary line. On ``cuda`` the ranks take
``cuda:rank`` and NCCL; with fewer cards than ranks it raises unless
``backend="gloo"`` is asked for, which lets ranks share a card.
"""

import math
import multiprocessing
import pickle
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device

#: Seconds a spawned group may take, and its collectives may wait, by default.
SPAWN_TIMEOUT_S = 60.0


def free_port() -> int:
    """A free TCP port on the loopback address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n_ranks, port, device, backend, timeout_s, torchrun_env, fn, args,
               results):
    import os

    import torch.distributed as dist

    from artspeech_tpu_torch.parallel.distributed import initialize_multihost

    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        if torchrun_env:
            os.environ.update(WORLD_SIZE=str(n_ranks), RANK=str(rank), LOCAL_RANK=str(rank),
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        else:
            initialize_multihost(f"127.0.0.1:{port}", n_ranks, rank, backend=backend,
                                 device=device, timeout_s=timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        # Pickled here, by value: torch's queue pickler would share tensor
        # storage through file descriptors that die with this process.
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(n_ranks: int, fn: Callable, *args, device: DeviceLike = "cpu",
          backend: Optional[str] = None, timeout_s: float = SPAWN_TIMEOUT_S,
          torchrun_env: bool = False) -> List:
    """Run ``fn(rank, *args)`` in ``n_ranks`` fresh processes joined in one
    group (gloo on the CPU, NCCL on cuda unless ``backend`` says otherwise);
    returns the ranks' results in rank order. With ``torchrun_env`` the ranks
    get ``torch.distributed.run``'s environment (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) instead, and ``fn``
    joins the group itself, as a CLI's ``run_experiment`` does. CPU ranks
    run one thread each.

    ``fn`` and the results must pickle (``fn`` by its import path). The group
    gives up on a collective after ``timeout_s`` seconds, and the whole run
    must end within ``2 * timeout_s``: past that every rank is killed and a
    ``TimeoutError`` raised. A rank's exception is raised here with its
    traceback.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, port, device, backend, timeout_s, torchrun_env, fn,
                               args, results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 2 * timeout_s
    out, errors = {}, []
    try:
        while len(out) + len(errors) < n_ranks:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"{n_ranks} ranks did not finish within {2 * timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(remaining, 1.0))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    errors.append("a rank died without reporting")
                    break
                continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        if not errors:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawned rank failed: " + "\n".join(errors))
    return [out[r] for r in range(n_ranks)]


def dryrun_multichip(n_ranks: int, device: DeviceLike = None, backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> dict:
    """One sharded train step of each of the seven ``FAMILIES`` on
    ``n_ranks`` spawned ranks; returns {family: loss} and prints the summary
    line. Raises if a loss is not finite, and on cuda with fewer cards than
    ranks unless ``backend="gloo"``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and backend != "gloo" and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"dryrun_multichip({n_ranks}) needs {n_ranks} cards for NCCL, found "
                           f"{torch.cuda.device_count()}; backend='gloo' lets ranks share one")
    results = spawn(n_ranks, _dryrun_rank, dev.type, device=dev.type, backend=backend,
                    timeout_s=timeout_s)
    mesh_shape, losses = results[0]
    for name, loss in losses.items():
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite {name} loss in multichip dryrun: {loss}")
    summary = " ".join(f"{k}={v:.4f}" for k, v in losses.items())
    print(f"dryrun_multichip({n_ranks}): mesh={mesh_shape} {summary} OK")
    return losses


def _dryrun_rank(rank, device):
    from artspeech_tpu_torch.parallel.mesh import make_mesh, world

    n, _ = world()
    model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    meshes = {"model": make_mesh(model_parallel=model_parallel, device=device),
              "data": make_mesh(model_parallel=1, device=device)}
    losses = {}
    for name, (mesh_kind, make_case, batch_per_rank) in FAMILIES.items():
        mesh = meshes[mesh_kind]
        losses[name] = float(run_case(make_case(batch_per_rank * n, mesh.device), mesh)["loss"])
    return meshes["model"].shape, losses


@dataclass
class FamilyCase:
    """One family's tiny train step: a fresh ``state``, a host ``batch`` and
    ``make_step(mesh)`` (``mesh`` None: the one-device step)."""

    state: object
    batch: Dict[str, np.ndarray]
    make_step: Callable


def run_case(case: FamilyCase, mesh=None, seed: int = 2) -> Dict[str, torch.Tensor]:
    """One step of ``case``: on this rank's rows of its batch over ``mesh``
    (its state placed by ``distribute_state`` first), or on the whole batch
    without one. The dropout generator folds in the data rank."""
    from artspeech_tpu_torch.parallel.distributed import distribute_state, run_distributed_step
    from artspeech_tpu_torch.train.loop import epoch_generator

    device = next(case.state.model.parameters()).device
    if mesh is None:
        return case.make_step(None)(case.state, case.batch, epoch_generator(seed, 0, device))
    distribute_state(case.state, mesh)
    generator = epoch_generator(seed, 0, device, mesh.data_index)
    return run_distributed_step(case.make_step(mesh), case.state, case.batch, generator, mesh)


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _lengths(rng, batch: int, t: int) -> np.ndarray:
    """Ragged lengths in [2, t], the first row full."""
    lengths = rng.integers(2, t + 1, batch).astype(np.int32)
    lengths[0] = t
    return lengths


def artspeech_case(batch: int, device, n_articulators: int = 8, hidden_size: int = 128,
                   t: int = 32) -> FamilyCase:
    """ArtSpeech(vocab 40, Nart 8) on a (batch, 32) batch (JAX
    __graft_entry__.py:_make_model_and_batch, ragged here), P2CP on."""
    from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
    from artspeech_tpu_torch.train.state import create_train_state
    from artspeech_tpu_torch.train.step import make_artspeech_train_step

    rng = np.random.default_rng(0)
    host = {"tokens": rng.integers(0, 40, (batch, t)).astype(np.int32),
            "lengths": _lengths(rng, batch, t),
            "targets": rng.uniform(size=(batch, t, n_articulators, 2, 50)).astype(np.float32)}
    model = ArtSpeech(vocab_size=40, n_articulators=n_articulators, hidden_size=hidden_size,
                      generator=_seeded(0), device=device)
    return FamilyCase(create_train_state(model, 1e-4), host, lambda mesh: make_artspeech_train_step(
        to_mm=136 * 1.6176, with_p2cp=True, device=device, mesh=mesh))


def transformer_case(batch: int, device) -> FamilyCase:
    """The multi-channel transformer's teacher-forced step (JAX
    __graft_entry__.py:_dryrun_transformer shapes), P2CP on."""
    from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer
    from artspeech_tpu_torch.train.state import create_train_state
    from artspeech_tpu_torch.train.step import make_transformer_train_step

    n_art, seq, d = 4, 8, 10
    model = ArtSpeechTransformer(vocab_size=16, num_articulators=n_art, embed_dim=16,
                                 num_heads=2, num_layers=1, num_feat=2 * d, encoder_ff_dim=32,
                                 generator=_seeded(0), device=device)
    rng = np.random.default_rng(0)
    host = {"tokens": rng.integers(0, 16, (batch, seq)).astype(np.int32),
            "lengths": _lengths(rng, batch, seq),
            "targets": rng.uniform(size=(batch, seq, n_art, 2, d)).astype(np.float32)}
    return FamilyCase(create_train_state(model, 1e-4), host,
                      lambda mesh: make_transformer_train_step(
                          to_mm=136 * 1.6176, with_p2cp=True, device=device, mesh=mesh))


def recognizer_case(batch: int, device, criterion: str = "ctc") -> FamilyCase:
    """DeepSpeech2 on vocal-tract features, CTC or frame-level CE."""
    from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2
    from artspeech_tpu_torch.train.recognition_step import make_recognition_train_step
    from artspeech_tpu_torch.train.state import create_train_state

    n_feat, t, n_classes = 20, 16, 8
    model = DeepSpeech2(in_channels=2, num_residual_layers=1, num_rnn_layers=1,
                        rnn_hidden_size=16, num_classes=n_classes, num_features=n_feat,
                        dropout=0.0, generator=_seeded(0), device=device)
    rng = np.random.default_rng(0)
    lengths = _lengths(rng, batch, t)
    host = {"features": rng.normal(size=(batch, 2, n_feat, t)).astype(np.float32),
            "input_lengths": lengths}
    if criterion == "ctc":
        host["target"] = rng.integers(1, n_classes, (batch, 4)).astype(np.int32)
        host["target_lengths"] = rng.integers(1, 5, batch).astype(np.int32)
    else:
        frames = rng.integers(0, n_classes, (batch, t)).astype(np.int32)
        host["target"] = np.where(np.arange(t) < lengths[:, None], frames, -1).astype(np.int32)
    return FamilyCase(create_train_state(model, 1e-4), host,
                      lambda mesh: make_recognition_train_step(
                          criterion, "target", feature="vocal_tract", device=device, mesh=mesh))


def _frozen_ae(indices, in_f, device):
    from artspeech_tpu_torch.models.autoencoder import MultiDecoder, MultiEncoder

    enc = MultiEncoder(indices, in_features=in_f, hidden_features=8, generator=_seeded(0),
                       device=device).requires_grad_(False)
    dec = MultiDecoder(indices, in_features=in_f, hidden_features=8, generator=_seeded(1),
                       device=device).requires_grad_(False)
    return (lambda x: torch.tanh(enc(x))), dec


PC_ARTICULATORS = ["lower-lip", "soft-palate", "tongue", "upper-lip"]


def latent_rnn_case(batch: int, device) -> FamilyCase:
    """The latent RNN with the frozen-autoencoder composite loss, P2CP on."""
    from artspeech_tpu_torch.losses.autoencoder import make_autoencoder_loss
    from artspeech_tpu_torch.models.autoencoder import normalize_indices_dict
    from artspeech_tpu_torch.models.latent_rnn import PrincipalComponentsArtSpeech
    from artspeech_tpu_torch.train.pc_step import make_latent_rnn_train_step
    from artspeech_tpu_torch.train.state import create_train_state

    arts = PC_ARTICULATORS
    indices = normalize_indices_dict({a: 2 for a in arts})
    d, t = 10, 8
    encode_fn, decode_fn = _frozen_ae(indices, 2 * d, device)
    mean = torch.zeros((len(arts), 2, d), device=device)
    std = torch.ones((len(arts), 2, d), device=device)
    loss_fn = make_autoencoder_loss(encode_fn, decode_fn, ["LA"], arts, beta1=0.5, beta2=3.0,
                                    beta3=1.0, denorm_mean=mean, denorm_std=std)
    model = PrincipalComponentsArtSpeech(16, indices, hidden_size=16, generator=_seeded(0),
                                         device=device)
    rng = np.random.default_rng(0)
    host = {"tokens": rng.integers(0, 16, (batch, t)).astype(np.int32),
            "lengths": _lengths(rng, batch, t),
            "targets": rng.normal(size=(batch, t, len(arts), 2, d)).astype(np.float32),
            "references": np.full((batch, t, 1, 2, d), 0.5, np.float32),
            "critical_masks": rng.integers(0, 2, (batch, 1, t)).astype(np.int32),
            "voicing": np.zeros((batch, t), np.float32)}
    return FamilyCase(create_train_state(model, 1e-4), host,
                      lambda mesh: make_latent_rnn_train_step(
                          loss_fn, decode_fn, mean, std, to_mm=220.0, with_p2cp=True,
                          device=device, mesh=mesh))


def frame_autoencoder_case(batch: int, device) -> FamilyCase:
    """The frame autoencoder's regularised-latents step, the last quarter of
    the rows zero-weight dummies, P2CP on."""
    from artspeech_tpu_torch.models.autoencoder import (
        MultiArticulatorAutoencoder,
        normalize_indices_dict,
    )
    from artspeech_tpu_torch.train.pc_step import make_autoencoder_train_step
    from artspeech_tpu_torch.train.state import create_train_state

    arts = PC_ARTICULATORS
    indices = normalize_indices_dict({a: 2 for a in arts})
    d = 10
    model = MultiArticulatorAutoencoder(indices, in_features=2 * d, generator=_seeded(0),
                                        device=device)
    rng = np.random.default_rng(0)
    weights = rng.uniform(0.1, 3.0, batch).astype(np.float32)
    weights[batch - batch // 4:] = 0.0
    host = {"inputs": rng.normal(size=(batch, len(arts), 2 * d)).astype(np.float32),
            "weights": weights}
    stats = (np.zeros((len(arts), 2, d), np.float32), np.ones((len(arts), 2, d), np.float32))
    return FamilyCase(create_train_state(model, 1e-4), host,
                      lambda mesh: make_autoencoder_train_step(
                          indices, 0.1, *stats, to_mm=220.0, with_p2cp=True, device=device,
                          mesh=mesh))


def _serving_pipeline(batch: int, device) -> FamilyCase:
    """Synthesize then recognize on the rank's rows: BiGRU contours ->
    stacked vocal-tract features -> DeepSpeech2 -> greedy CTC ids. Its
    "step" trains nothing and reports the batch's mean decoded length,
    summed over the data group, as its loss."""
    from artspeech_tpu_torch.eval.decoders import greedy_ctc_decode
    from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
    from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2, to_recognizer_layout
    from artspeech_tpu_torch.parallel.collectives import group_sum
    from artspeech_tpu_torch.train.state import create_train_state

    n_art, d, t = 8, 50, 32
    rng = np.random.default_rng(0)
    host = {"tokens": rng.integers(0, 40, (batch, t)).astype(np.int32),
            "lengths": np.full((batch,), t, np.int32)}
    art = ArtSpeech(vocab_size=40, n_articulators=n_art, generator=_seeded(0), device=device)
    rec = DeepSpeech2(in_channels=2, num_residual_layers=1, num_rnn_layers=1,
                      rnn_hidden_size=16, num_classes=8, num_features=n_art * d,
                      generator=_seeded(3), device=device)
    both = torch.nn.ModuleDict({"art": art, "rec": rec})

    def make_step(mesh):
        def step(state, local, generator=None):
            with torch.no_grad():
                contours = art(local["tokens"], local["lengths"])
                logits = rec(to_recognizer_layout(contours), lengths=local["lengths"])
                _, lens = greedy_ctc_decode(torch.log_softmax(logits, dim=-1), local["lengths"])
            group = None if mesh is None else mesh.data_group
            return {"loss": group_sum(lens.float().sum(), group) / batch}

        return step

    return FamilyCase(create_train_state(both, 1e-4), host, make_step)


#: family -> (mesh, case maker, batch rows per rank); "model": the
#: (data, model) mesh, "data": every rank a data rank.
FAMILIES = {
    "artspeech": ("model", artspeech_case, 1),
    "transformer": ("model", transformer_case, 1),
    "recognizer": ("model", recognizer_case, 1),
    "latent_rnn": ("model", latent_rnn_case, 1),
    "frame_autoencoder": ("model", frame_autoencoder_case, 16),
    "artspeech_data_parallel": ("data", artspeech_case, 1),
    "serving_pipeline": ("data", _serving_pipeline, 1),
}
