"""YOLO training step: the loss, the optimizer step and the training state,
the port's counterpart of ``rtvm_tpu/models/yolo/train.py``.

The loss is the JAX package's simplified YOLOv8 recipe: center-prior
assignment (a target goes to the cells whose anchor point lies inside its
box, or whose cell holds its center, on the scale that suits its size; a
cell takes its smallest candidate, the first on ties as ``jnp.argmin``),
BCE classification over as many classes as the logits have (so the
open-vocabulary head trains through the same loss), CIoU box loss and DFL.
The heads' NCHW outputs are laid out NHWC first, so the arithmetic reads as
JAX's.

``TrainState`` holds the model (parameters and BatchNorm statistics), its
``torch.optim.AdamW`` and the update count. ``state_tree`` lays it out as
the JAX ``TrainState`` pytree (params and batch_stats in Flax's layout, the
AdamW moments as optax's ``mu``/``nu``), so that a ``*_trainstate.npz``
resumes in either package (``load_state_tree``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from rtvm_tpu_torch.models.optim import (AdamW, adam_moments, constant_schedule,
                                         set_adam_moments)
from rtvm_tpu_torch.models.yolo.convert import flax_to_torch, torch_to_flax, torch_to_flax_arrays
from rtvm_tpu_torch.models.yolo.modules import synced_batch_stats
from rtvm_tpu_torch.utils.checkpoint import NamedNode, flat_to_nested


class Targets(NamedTuple):
    """Padded ground truth: boxes [B, M, 4] xyxy px, classes [B, M], valid [B, M]."""

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    """jnp.maximum(x, v): at a tie the gradient splits between the two, as
    torch.maximum's does (clamp's would pass whole). The scalar is filled on
    x's device: a tensor made from it on the host would be a blocking copy."""
    return torch.maximum(x, x.new_full((), v))


def _ciou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Complete-IoU between [..., 4] xyxy boxes."""
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = _max(x2 - x1, 0.0) * _max(y2 - y1, 0.0)
    a1 = _max(box1[..., 2] - box1[..., 0], 0.0) * _max(box1[..., 3] - box1[..., 1], 0.0)
    a2 = _max(box2[..., 2] - box2[..., 0], 0.0) * _max(box2[..., 3] - box2[..., 1], 0.0)
    union = a1 + a2 - inter
    iou = inter / _max(union, 1e-9)
    # enclosing box diagonal + center distance
    ex1 = torch.minimum(box1[..., 0], box2[..., 0])
    ey1 = torch.minimum(box1[..., 1], box2[..., 1])
    ex2 = torch.maximum(box1[..., 2], box2[..., 2])
    ey2 = torch.maximum(box1[..., 3], box2[..., 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2 + 1e-9
    cx1 = (box1[..., 0] + box1[..., 2]) / 2
    cy1 = (box1[..., 1] + box1[..., 3]) / 2
    cx2 = (box2[..., 0] + box2[..., 2]) / 2
    cy2 = (box2[..., 1] + box2[..., 3]) / 2
    rho2 = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2
    w1 = _max(box1[..., 2] - box1[..., 0], 1e-9)
    h1 = _max(box1[..., 3] - box1[..., 1], 1e-9)
    w2 = _max(box2[..., 2] - box2[..., 0], 1e-9)
    h2 = _max(box2[..., 3] - box2[..., 1], 1e-9)
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = v / _max(1 - iou + v, 1e-9)
    return iou - rho2 / c2 - alpha * v


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def yolo_loss(model, images: torch.Tensor, targets: Targets, train: bool = True, group=None):
    """images [B, 3, S, S] RGB in 0..1 -> (loss, metrics). `model` is called
    on the images and has a ``cfg`` (strides, reg_max); with train=True its
    BatchNorm layers normalise with the batch's statistics and update their
    running statistics (``model.train(train)`` is set first).

    With a process `group` (the dp training step), the images are this
    rank's equal share of a batch split over the group: the normalisers are
    the whole batch's (its size, its positive count summed over the group),
    so the ranks' losses add up to the loss of the whole batch, which
    ``metrics["loss"]`` holds."""
    strides = model.cfg.strides
    reg_max = model.cfg.reg_max
    model.train(train)
    box_logits, cls_logits = model(images)
    box_logits = [bl.permute(0, 2, 3, 1) for bl in box_logits]
    cls_logits = [cl.permute(0, 2, 3, 1) for cl in cls_logits]
    dev = images.device
    tb = targets.boxes.to(torch.float32)  # [B, M, 4]
    valid = targets.valid.to(torch.bool)
    classes = targets.classes.to(torch.int64)

    total_cls = 0.0
    total_box = 0.0
    total_dfl = 0.0
    total_pos = 1e-6
    npos = 0.0
    for bl, cl, s in zip(box_logits, cls_logits, strides):
        b, h, w, _ = bl.shape
        cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * s
        cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * s
        pcx = cx[None, None, :].expand(b, h, w)
        pcy = cy[None, :, None].expand(b, h, w)

        bcx = (tb[..., 0] + tb[..., 2]) / 2
        bcy = (tb[..., 1] + tb[..., 3]) / 2
        inside = (
            (pcx[..., None] > tb[:, None, None, :, 0])
            & (pcx[..., None] < tb[:, None, None, :, 2])
            & (pcy[..., None] > tb[:, None, None, :, 1])
            & (pcy[..., None] < tb[:, None, None, :, 3])
        )  # [B, H, W, M]
        # a box smaller than one cell may hold no anchor center: the cell
        # nearest its center is a candidate too (the ~8 px 'person' boxes)
        nearest = (torch.abs(pcx[..., None] - bcx[:, None, None, :]) <= s / 2) & (
            torch.abs(pcy[..., None] - bcy[:, None, None, :]) <= s / 2
        )
        # scale gate: a box size that suits this stride; the finest level
        # has no lower bound
        sz = torch.sqrt(_max(tb[..., 2] - tb[..., 0], 1.0) * _max(tb[..., 3] - tb[..., 1], 1.0))
        lo = 0.0 if s == min(strides) else s * 2
        gate = (sz[:, None, None, :] >= lo) & (sz[:, None, None, :] < s * 16)
        cand = (inside | nearest) & gate & valid[:, None, None, :]
        # each cell takes its smallest matching target
        area = _max(tb[..., 2] - tb[..., 0], 1.0) * _max(tb[..., 3] - tb[..., 1], 1.0)
        cost = torch.where(cand, area[:, None, None, :], torch.full_like(area[:, None, None, :], math.inf))
        tgt_idx = torch.argmin(cost, dim=-1)  # [B, H, W], the first minimum
        assigned = torch.any(cand, dim=-1).to(torch.float32)  # [B, H, W]

        flat = tgt_idx.reshape(b, -1)
        tgt_box = torch.gather(tb, 1, flat[..., None].expand(-1, -1, 4)).reshape(b, h, w, 4)
        tgt_cls = torch.gather(classes, 1, flat).reshape(b, h, w)

        # classification: one-hot where assigned; the width follows the
        # logits (closed-set: the classes; the world head: the prompts). A
        # comparison, not F.one_hot, which reads the classes' range back from
        # the card; a class past the width gives zeros, as jax.nn.one_hot
        width = torch.arange(cl.shape[-1], device=dev)
        onehot = (tgt_cls[..., None] == width).to(torch.float32) * assigned[..., None]
        cls_l = _sigmoid_bce(cl, onehot).sum(-1)
        total_cls = total_cls + cls_l.mean() * (h * w)

        # box + dfl on assigned cells
        logits = bl.reshape(b, h, w, 4, reg_max)
        bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
        d = torch.sum(torch.softmax(logits, dim=-1) * bins, dim=-1)  # ltrb, stride units
        pred_box = torch.stack([pcx - d[..., 0] * s, pcy - d[..., 1] * s,
                                pcx + d[..., 2] * s, pcy + d[..., 3] * s], dim=-1)
        ciou = _ciou(pred_box, tgt_box)
        total_box = total_box + torch.sum((1.0 - ciou) * assigned)

        # DFL: each side's distance distribution against the target distance
        t_ltrb = torch.stack([(pcx - tgt_box[..., 0]) / s, (pcy - tgt_box[..., 1]) / s,
                              (tgt_box[..., 2] - pcx) / s, (tgt_box[..., 3] - pcy) / s], dim=-1)
        t_ltrb = torch.clamp(t_ltrb, 0, reg_max - 1.001)
        tl = torch.floor(t_ltrb)
        wr = t_ltrb - tl
        logp = torch.log_softmax(logits, dim=-1)
        lo_i = tl.to(torch.int64)[..., None]
        dfl = -(torch.gather(logp, -1, lo_i)[..., 0] * (1 - wr)
                + torch.gather(logp, -1, lo_i + 1)[..., 0] * wr).sum(-1)
        total_dfl = total_dfl + torch.sum(dfl * assigned)
        total_pos = total_pos + torch.sum(assigned)
        npos = npos + torch.sum(assigned)

    cells = sum(x.shape[1] * x.shape[2] for x in box_logits)
    if group is None:
        loss = 0.5 * total_cls / (b * cells) + (7.5 * total_box + 1.5 * total_dfl) / total_pos
        return loss, {"loss": loss.detach(), "num_pos": total_pos.detach()}
    from rtvm_tpu_torch.parallel.collectives import all_reduce_

    # total_cls sums each level's per-image mean over this rank's b images;
    # the whole batch's term is 0.5 * sum / (B * B * cells), B = b * ranks
    nb = b * dist.get_world_size(group)
    total_pos = 1e-6 + all_reduce_(npos.detach().clone(), group)
    loss = (0.5 * total_cls * b / (nb * nb * cells)
            + (7.5 * total_box + 1.5 * total_dfl) / total_pos)
    return loss, {"loss": all_reduce_(loss.detach().clone(), group), "num_pos": total_pos}


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), its AdamW and
    the number of updates taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_step(model, tx: AdamW, group=None):
    """train_step(state, images [B, 3, S, S], targets) -> (state, metrics):
    the loss in training mode through `model` (the state's model, or an
    adapter over it), its gradients and one update of `tx`, in place.

    With a process `group`, the dp step: each rank passes its equal share
    of the batch, BatchNorm takes the whole batch's statistics
    (``synced_batch_stats``), the loss its normalisers (``yolo_loss``), and
    the gradients are summed over the group before the update, so that
    every rank takes the one-process step of the whole batch."""

    def train_step(state: TrainState, images: torch.Tensor, targets: Targets):
        state.optimizer.zero_grad(set_to_none=True)
        with synced_batch_stats(group):
            loss, metrics = yolo_loss(model, images, targets, train=True, group=group)
            loss.backward()
        if group is not None:
            _all_reduce_grads(state.optimizer, group)
        tx.update(state.optimizer, state.step)
        state.step += 1
        return state, metrics

    return train_step


def _all_reduce_grads(optimizer: torch.optim.Optimizer, group) -> None:
    """Sum every parameter's gradient over the group, in one flat exchange
    (a parameter without one takes zeros, as optax gives every leaf one)."""
    from rtvm_tpu_torch.parallel.collectives import all_reduce_

    params = [p for g in optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]), group)
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def init_train_state(model: nn.Module, lr: float = 1e-3) -> Tuple[TrainState, AdamW]:
    """The state and optimizer of ``optax.chain(clip_by_global_norm(10),
    adamw(lr))``: a constant rate and optax's default weight decay, 1e-4."""
    tx = AdamW(constant_schedule(lr), weight_decay=1e-4, clip_norm=10.0)
    return TrainState(model, tx.init(model.parameters())), tx


def _empty() -> NamedNode:
    return NamedNode("EmptyState")


def state_tree(state: TrainState) -> NamedNode:
    """The JAX ``TrainState`` pytree of `state` (numpy leaves) as the
    trainers' ``optax.chain(clip_by_global_norm, adamw(schedule))`` lays it
    out: (params, batch_stats, (EmptyState, (ScaleByAdamState(count, mu,
    nu), EmptyState, ScaleByScheduleState(count))), step)."""
    named = dict(state.model.named_parameters())
    count, mu, nu = adam_moments(state.optimizer, named)
    variables = torch_to_flax(state.model)

    def params_tree(moments):
        return flat_to_nested(torch_to_flax_arrays(moments))["params"]

    c = np.int32(count)
    opt = (_empty(), (NamedNode("ScaleByAdamState", (c, params_tree(mu), params_tree(nu))),
                      _empty(), NamedNode("ScaleByScheduleState", (c,))))
    return NamedNode("TrainState", (variables["params"], variables["batch_stats"], opt,
                                    np.int32(state.step)))


def load_state_tree(state: TrainState, tree: NamedNode) -> TrainState:
    """Sets `state` from a JAX ``TrainState`` pytree (``state_tree``'s
    layout, as ``utils.checkpoint.load_pytree_npz(path, like)`` returns it):
    the model's parameters and statistics, the AdamW moments and count, the
    step."""
    params, batch_stats, opt, step = tree.children
    adam = opt[1][0]
    count, mu, nu = adam.children
    dev = next(state.model.parameters()).device
    sd = flax_to_torch({"params": params, "batch_stats": batch_stats})
    state.model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    named = dict(state.model.named_parameters())
    set_adam_moments(state.optimizer, named, int(count), flax_to_torch({"params": mu}),
                     flax_to_torch({"params": nu}))
    state.step = int(step)
    return state
