"""Train YOLO on synthetic aerial scenes (``synth.py``): the port's
counterpart of ``rtvm_tpu/models/yolo/train_synth.py``.

Usage (on the card; ``main(argv, device="cpu")`` runs it on the CPU):

    python -m rtvm_tpu_torch.models.yolo.train_synth --steps 3000 --batch 16 --out-dir DIR

Writes ``<out-dir>/<model>_aerial.npz`` (the Flax variables, which both
packages' ``ObjectDetector`` load), ``<model>_aerial.json`` (the eval
report) and ``<model>_aerial_trainstate.npz`` (the JAX ``TrainState``
layout, which ``--resume`` of either package reads). The default out-dir
is ``weights/``, as in JAX: it overwrites the repo's checkpoints.
mAP@0.5 on a held-out synthetic set (seed 9999) measures the result.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.models.yolo.synth import AERIAL_CLASSES, BackgroundPool, make_batch, make_scene


def _bgr_to_rgb01(imgs_u8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] BGR uint8 -> [B, 3, H, W] RGB float32 in 0..1."""
    return imgs_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0


def predict_scenes(model, images_u8, conf: float = 0.25, iou: float = 0.45, bf16: bool = True):
    """Batched inference on square scenes (size == the training imgsz) on
    the model's device, in bfloat16 by default (every weight, statistic and
    the input, as JAX casts them; the logits back to float32 for decode and
    NMS). Returns per-image detection dicts like ObjectDetector._run_pass.
    The model is not changed (a copy in eval mode runs)."""
    from rtvm_tpu_torch.models.yolo import postprocess as pp

    dev = next(model.parameters()).device
    m = copy.deepcopy(model).eval()
    dtype = torch.bfloat16 if bf16 else torch.float32
    m = m.to(dtype)
    x = _bgr_to_rgb01(torch.as_tensor(np.asarray(images_u8)).to(dev)).to(dtype)
    with torch.inference_mode():
        box_l, cls_l = m(x)
        box_l = [b.float() for b in box_l]
        cls_l = [c.float() for c in cls_l]
        boxes, scores = pp.decode_predictions(box_l, cls_l, model.cfg.strides, model.cfg.reg_max)
        det = pp.nms_fixed(boxes, scores, conf, iou)
        table = torch.cat([det.boxes, det.scores[..., None], det.classes[..., None].float(),
                           det.valid[..., None].float()], -1).cpu().numpy()
    return [_dets(rows) for rows in table]


def _dets(rows: np.ndarray) -> List[dict]:
    """Detection dicts of one image's [K, 7] (box, score, class, valid) rows."""
    return [{"bbox": [float(v) for v in r[:4]],
             "class": AERIAL_CLASSES[int(r[5])],
             "confidence": float(r[4])}
            for r in rows[rows[:, 6] > 0]]


def make_eval_set(n: int = 64, size: int = 320, seed: int = 9999):
    rng = np.random.RandomState(seed)
    bg = BackgroundPool(size, rng=rng)
    imgs, gtb, gtc = [], [], []
    for _ in range(n):
        img, b, c = make_scene(rng, bg, size)
        imgs.append(img)
        gtb.append(b)
        gtc.append(c)
    return np.stack(imgs), gtb, gtc


def evaluate(model, n: int = 64, size: int = 320, conf: float = 0.25):
    """mAP@0.5 report on `n` held-out scenes, 16 at a time in bfloat16."""
    from rtvm_tpu_torch.models.yolo.eval import evaluate_map

    imgs, gtb, gtc = make_eval_set(n, size)
    dets = []
    for i in range(0, len(imgs), 16):
        dets += predict_scenes(model, imgs[i : i + 16], conf=conf)
    return evaluate_map(dets, gtb, gtc, AERIAL_CLASSES)


def save_outputs(out_dir: str, stem: str, state, imgsz: int, step: int, report: dict) -> None:
    """``{stem}.npz``, ``{stem}.json`` and ``{stem}_trainstate.npz`` of a
    YOLO trainer, as the JAX trainers write them."""
    from rtvm_tpu_torch.models.yolo.convert import torch_to_flax
    from rtvm_tpu_torch.models.yolo.train import state_tree
    from rtvm_tpu_torch.utils.checkpoint import save_pytree_npz

    save_pytree_npz(os.path.join(out_dir, f"{stem}.npz"), torch_to_flax(state.model))
    with open(os.path.join(out_dir, f"{stem}.json"), "w") as f:
        json.dump({"classes": AERIAL_CLASSES, "imgsz": imgsz, "step": step, "eval": report}, f)
    save_pytree_npz(os.path.join(out_dir, f"{stem}_trainstate.npz"), state_tree(state))


def resume_state(state, path: str):
    """`state` set from a ``*_trainstate.npz`` of either package."""
    from rtvm_tpu_torch.models.yolo.train import load_state_tree, state_tree
    from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

    load_state_tree(state, load_pytree_npz(path, like=state_tree(state)))
    print(f"resumed from {path} at step {state.step}")
    return state


def train(
    model_name: str = "yolov8n",
    steps: int = 3000,
    batch: int = 16,
    imgsz: int = 320,
    lr: float = 2e-3,
    seed: int = 0,
    eval_every: int = 1000,
    out_dir: str = "weights",
    log_every: int = 50,
    resume: Optional[str] = None,
    device=None,
):
    """JAX's ``train``, on `device` (``cuda`` unless given). The model starts
    from PyTorch's seeded initialisation (not Flax's). Returns (state, model)."""
    from rtvm_tpu_torch.models.optim import AdamW, warmup_cosine_decay_schedule
    from rtvm_tpu_torch.models.yolo.model import build_yolo
    from rtvm_tpu_torch.models.yolo.train import Targets, TrainState, make_train_step

    dev = resolve_device(device)
    model = build_yolo(model_name, num_classes=len(AERIAL_CLASSES), seed=seed, device=dev)

    sched = warmup_cosine_decay_schedule(0.0, lr, min(500, steps // 4), steps, lr * 0.05)
    tx = AdamW(sched, weight_decay=5e-4, clip_norm=10.0)
    state = TrainState(model, tx.init(model.parameters()))
    if resume:
        resume_state(state, resume)
    step_fn = make_train_step(model, tx)

    rng = np.random.RandomState(seed + 1)
    bg = BackgroundPool(imgsz, rng=rng)
    print(f"backgrounds: {len(bg.frames)} clip frames "
          f"({'procedural only' if not bg.frames else 'drone clips'})")

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    for it in range(state.step, steps):
        imgs, boxes, cls, valid = make_batch(rng, bg, batch, imgsz)
        images = _bgr_to_rgb01(torch.from_numpy(imgs).to(dev))
        targets = Targets(*(torch.from_numpy(a).to(dev) for a in (boxes, cls, valid)))
        state, metrics = step_fn(state, images, targets)
        if (it + 1) % log_every == 0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {it + 1}/{steps} loss {loss:.3f} ({dt:.0f}s, {(it + 1) / dt:.1f} it/s)",
                  flush=True)
        if (it + 1) % eval_every == 0 or it + 1 == steps:
            report = evaluate(model, n=48, size=imgsz)
            print(f"step {it + 1} eval: {json.dumps(report)}", flush=True)
            save_outputs(out_dir, f"{model_name}_aerial", state, imgsz, it + 1, report)
    return state, model


def main(argv=None, device=None):
    """JAX's command line; runs on `device` (``cuda`` unless given)."""
    ap = argparse.ArgumentParser(description="Train YOLO on synthetic aerial scenes")
    ap.add_argument("--model", default="yolov8n")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--imgsz", type=int, default=320)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--out-dir", default="weights",
                    help="where the checkpoints go (the default overwrites the repo's)")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    train(a.model, a.steps, a.batch, a.imgsz, a.lr, a.seed, a.eval_every, a.out_dir,
          resume=a.resume, device=device)


if __name__ == "__main__":
    main()
