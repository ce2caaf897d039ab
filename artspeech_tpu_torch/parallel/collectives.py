"""The collectives of the port's multi-rank steps, over ``torch.distributed``
process groups (the port's counterpart of the psums and gathers that XLA
inserts in the JAX package).

Every function takes a process group, or None for "no group": then it is the
identity and runs no collective, so a step written with them is the
one-device step when it is given no group. Only ``all_reduce`` (SUM) is used,
because gloo supports nothing else on CUDA tensors besides ``broadcast`` and
``barrier``: the gather along the model axis is an ``all_reduce`` of a
zero-filled full tensor, which adds only zeros to every slice and so is exact.

Along the model axis (the ranks of one data row, ``Mesh.model_group``), a
tensor is either the same on every rank or one rank's slice along an axis:

- ``copy_to_model_axis``: a tensor every rank holds alike and feeds to its
  own part of the work; its gradient is summed over the ranks.
- ``slice_model_axis``: the rank's slice of such a tensor along an axis.
- ``gather_model_axis``: the slices gathered whole, for work every rank then
  does alike (the heads' outputs into the loss); the backward hands each
  rank its slice's gradient once.
- ``exchange_model_axis``: the slices gathered whole, for work each rank
  does differently (the transformer's queries from every other channel);
  the backward sums the whole's gradient over the ranks first.
- ``gather_leading_slices``: parameters and moments gathered whole, without
  gradient, for a checkpoint.
"""

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, as a new tensor without gradient
    (``x`` itself when ``group`` is None)."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (SUM) whose backward is the all-reduce of the incoming
    gradients: the adjoint of a sum over ranks, for a loss that every rank
    computes from the group's sum and that the step counts once a rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def differentiable_group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, with gradients summed back over
    them (``x`` itself when ``group`` is None)."""
    return x if group is None else _SumOverGroup.apply(x, group)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum every tensor of ``tensors`` over ``group`` in ONE all-reduce of
    their flattened concatenation (float32); returns the sums in their shapes."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


def reduce_gradients(parameters: Iterable[torch.nn.Parameter], group,
                     extras: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Sum the parameters' gradients (a missing one counts as zeros) and the
    ``extras`` (the step's loss and metric sums) over ``group`` in one
    all-reduce. The gradients are written back to ``p.grad``; returns the
    summed extras. With ``group`` None nothing moves."""
    if group is None:
        return list(extras)
    params = [p for p in parameters if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    summed = all_reduce_flat(grads + list(extras), group)
    for p, g in zip(params, summed[:len(params)]):
        p.grad = g
    return summed[len(params):]


class _CopyToModelAxis(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group,
    because every model rank feeds the same input to its own slice of heads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherModelAxis(torch.autograd.Function):
    """Gather ``size`` slices along ``dim`` (this rank's at ``index``) by an
    all-reduce of a zero-filled full tensor. The backward hands this rank the
    gradient of its own slice, once: every model rank computes the same loss
    from the gathered tensor, so the gradient is not summed ``size`` times."""

    @staticmethod
    def forward(ctx, x, group, index: int, size: int, dim: int):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= size
        full = x.new_zeros(shape)
        full.narrow(dim, index * ctx.n, ctx.n).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None, None


def copy_to_model_axis(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    return x if group is None else _CopyToModelAxis.apply(x, group)


def gather_model_axis(x: torch.Tensor, group, index: int, size: int, dim: int = 0):
    return x if group is None else _GatherModelAxis.apply(x, group, index, size, dim)


def exchange_model_axis(x: torch.Tensor, group, index: int, size: int, dim: int = 0):
    return copy_to_model_axis(gather_model_axis(x, group, index, size, dim), group)


def slice_model_axis(x: torch.Tensor, group, index: int, size: int, dim: int = 0):
    if group is None:
        return x
    n = x.shape[dim] // size
    return copy_to_model_axis(x, group).narrow(dim, index * n, n)


def gather_leading_slices(tensors: Sequence[torch.Tensor], group, index: int,
                          size: int) -> List[torch.Tensor]:
    """Whole tensors from every rank's ``index``-th of ``size`` slices of
    their leading axes, in ONE all-reduce (float32) of zero-filled whole
    tensors, each returned with storage of its own (not a view of the
    flattened buffer, which a pickle or ``torch.save`` would copy whole).
    Every rank of ``group`` calls it with its slices of the same tensors, in
    the same order."""
    wholes = []
    for t in tensors:
        n = t.shape[0]
        whole = t.new_zeros((n * size, *t.shape[1:]))
        whole[index * n:(index + 1) * n] = t.detach()
        wholes.append(whole)
    return [t.clone() for t in all_reduce_flat(wholes, group)]
