"""The collectives of the sharded steps (``parallel/mesh.py``) and of the
dp training step's BatchNorm and loss (``models/yolo``): thin wrappers over
``torch.distributed`` that add the host time spent in them to ``comm_ms``.
"""

from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

# Host milliseconds this rank spent in collective calls since the last
# reset_comm(): gloo's calls return when the exchange is done; NCCL's
# return once enqueued on the stream.
comm_ms = [0.0]


def reset_comm() -> None:
    comm_ms[0] = 0.0


def all_gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """The group's tensors of x's shape, in rank order."""
    t = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    comm_ms[0] += (time.perf_counter() - t) * 1e3
    return parts


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of x's shape, concatenated along `dim` in rank order."""
    return torch.cat(all_gather_list(x, group), dim=dim)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over the group, in place."""
    t = time.perf_counter()
    dist.all_reduce(x, group=group)
    comm_ms[0] += (time.perf_counter() - t) * 1e3
    return x


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose gradient is the sum of the ranks'
    gradients (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of x over the group."""
    return _AllReduceSum.apply(x, group)
