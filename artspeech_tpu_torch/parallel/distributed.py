"""Process groups, state placement and one sharded step (counterpart of
artspeech_tpu/parallel/distributed.py).

The port runs one process per rank over ``torch.distributed``: NCCL on the
card and gloo on the CPU by default, gloo on the card only when asked for
(NCCL refuses two ranks on one GPU). ``initialize_multihost`` joins a group,
``distribute_state`` gives every rank rank 0's parameters and AdamW moments
and, on a mesh with a model axis, keeps each rank's slice of the ArtSpeech
heads and of the transformer's channel stacks, and ``run_distributed_step`` runs a step on the rank's rows of a host
batch. Only rank 0 writes files (``is_main_process``); ``barrier`` lets the
other ranks wait for them.

Not ported, by design: JAX's ``prefer_manual_spmd`` (a TPU dispatch floor
choosing between XLA's automatic partitioning and shard_map). The port's
kernels run on every rank's shard, so every multi-rank step takes the
explicit all-reduce.
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, params_shardings, shard_batch

#: Seconds a collective or the rendezvous waits for the other ranks.
DEFAULT_TIMEOUT_S = 600.0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_main_process() -> bool:
    """True on rank 0 of the group (and without a group): the rank that writes."""
    return not is_initialized() or dist.get_rank() == 0


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of ``mesh``; a no-op without a mesh or a group."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` (picklable) on every rank of ``mesh``; ``obj`` itself
    without a mesh or a group. For decisions that every rank must take alike
    from a result that only rank 0 computes."""
    if mesh is None or mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=int(mesh.grid.flat[0]), group=mesh.group)
    return box[0]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device: DeviceLike = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a process group; returns whether one is initialised afterwards.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` it calls ``init_process_group(init_method="tcp://...")``.
    With none of them it joins the group that ``torch.distributed.run``'s
    environment describes (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when ``WORLD_SIZE`` > 1, and is otherwise a no-op. A
    second call is tolerated. ``backend``: NCCL for ``device`` cuda (the
    default device), gloo for the CPU. On the card each rank takes
    ``cuda:LOCAL_RANK`` (``process_id`` without torchrun). Every collective
    and the rendezvous give up after ``timeout_s`` seconds.
    """
    if is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id) != (None, None, None)
    if not explicit and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id if explicit else 0) or 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = dict(backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
                  timeout=datetime.timedelta(seconds=timeout_s))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and process_id go together")
        kwargs.update(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                      rank=int(process_id))
    dist.init_process_group(**kwargs)
    return True


def _broadcast_(tensors, mesh: Mesh) -> None:
    src = int(mesh.grid.flat[0])
    for t in tensors:
        dist.broadcast(t.data, src=src, group=mesh.group)


def distribute_state(state, mesh: Mesh):
    """Place a ``TrainState`` on ``mesh``, in place; returns it.

    Every rank of the mesh takes rank 0's parameters, buffers and AdamW
    moments (a broadcast). With a model axis (> 1), each module that computes
    over a stacked leading axis (one with ``shard_model_axis``: the ArtSpeech
    heads, the transformer's decoder layers and heads) keeps only its rank's
    slice of those parameters and of their moments, when ``params_shardings``
    places every one of them on ``model``. Where the model axis does not
    divide that leading axis, JAX's heuristic replicates them, and so does
    this: the module then computes all of it on every rank.

    Stays replicated, though JAX's heuristic places it on ``model`` too: the
    embeddings; the GRU, LSTM and Dense kernels (their leading axis is an
    input width, not a channel or a head; XLA gathers each where it is used,
    so the numbers are the same whole); the frame autoencoder's and the
    latent RNN's per-articulator modules, which JAX keeps as separate named
    modules with no stacked axis.
    """
    if mesh.group is not None:
        model = state.model
        _broadcast_(list(model.parameters()) + list(model.buffers()), mesh)
        for p in model.parameters():
            # The moments; AdamW's step count is a host scalar that every
            # rank already holds alike.
            _broadcast_([v for v in state.optimizer.state.get(p, {}).values()
                         if torch.is_tensor(v) and v.shape == p.shape], mesh)
    if mesh.shape[MODEL_AXIS] > 1:
        shardings = params_shardings(state.model, mesh)
        done = []
        for name, module in state.model.named_modules():
            if not hasattr(module, "shard_model_axis") or \
                    any(name.startswith(f"{outer}.") or not outer for outer in done):
                continue
            done.append(name)  # its submodules follow it
            stacked = [f"{name}.{n}" if name else n for n, _ in module.model_axis_parameters()]
            if stacked and all(shardings[n].axis == MODEL_AXIS for n in stacked):
                module.shard_model_axis(mesh.model_group, mesh.model_index,
                                        mesh.shape[MODEL_AXIS], state.optimizer)
    return state


def run_distributed_step(train_step, state, batch, generator, mesh: Mesh):
    """Run ``train_step`` on this rank's rows of the host ``batch``."""
    return train_step(state, shard_batch(batch, mesh), generator)
