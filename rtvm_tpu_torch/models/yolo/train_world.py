"""Train the open-vocabulary YOLOWorld on synthetic aerial scenes: the
port's counterpart of ``rtvm_tpu/models/yolo/train_world.py``.

The trunk, the region-embedding head and the trigram text encoder
(``world.py``) train together. Each step samples one prompt per class from
its synonyms (``SYNONYMS``) with the same ``RandomState`` as the scenes,
so the text encoder learns a neighbourhood rather than a lookup table.
``evaluate(prompts=[UNSEEN_PROMPTS[c] for c in AERIAL_CLASSES])`` measures
the held-out vocabulary.

Usage (on the card; ``main(argv, device="cpu")`` runs it on the CPU):

    python -m rtvm_tpu_torch.models.yolo.train_world --steps 4000 --batch 16 --out-dir DIR

Writes ``<out-dir>/<variant>_world.npz`` (which both packages'
``YoloWorldDetector`` load), ``.json`` and ``_trainstate.npz``; the default
out-dir ``weights/`` overwrites the repo's checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.models.yolo.synth import AERIAL_CLASSES, BackgroundPool, make_batch

# Prompt variants per training class (sampled per step).
SYNONYMS = {
    "person": ["person", "people", "pedestrian", "human"],
    "car": ["car", "cars", "automobile", "vehicle"],
    "truck": ["truck", "lorry", "trucks"],
    "bus": ["bus", "buses", "minibus"],
    "building": ["building", "house", "roof", "buildings"],
    "boat": ["boat", "ship", "vessel"],
    "tent": ["tent", "tents", "canopy"],
    "pool": ["pool", "swimming pool", "pond"],
}

# Held-out prompts for the open-vocabulary eval: strings the trainer never
# tokenizes (not in SYNONYMS), related to a class the way real vocabulary is.
# Adding one to SYNONYMS would turn the unseen eval into a seen one.
UNSEEN_PROMPTS = {
    "person": "pedestrians",
    "car": "vehicles",
    "truck": "lorries",
    "bus": "school bus",
    "building": "rooftop",
    "boat": "ships",
    "tent": "canopies",
    "pool": "water pool",
}
if any(UNSEEN_PROMPTS[c] in SYNONYMS[c] for c in UNSEEN_PROMPTS):
    raise ValueError("an unseen prompt is among the training synonyms")


class _WorldAdapter:
    """YOLOWorld as the (cfg, call, train) surface ``yolo_loss`` expects,
    with the step's prompt tokens bound."""

    def __init__(self, model, ids: torch.Tensor, mask: torch.Tensor):
        self.model = model
        self.cfg = model.cfg
        self.ids = ids
        self.mask = mask

    def train(self, mode: bool = True):
        self.model.train(mode)
        return self

    def __call__(self, x):
        return self.model(x, self.ids, self.mask)


def _tokens(prompts, dev):
    from rtvm_tpu_torch.models.yolo.world import tokenize_names

    ids, mask = tokenize_names(prompts)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)


def train(
    variant: str = "yolov8n",
    steps: int = 4000,
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
    """JAX's ``train``, on `device` (``cuda`` unless given), from PyTorch's
    seeded initialisation. Returns (state, model)."""
    from rtvm_tpu_torch.models.optim import AdamW, warmup_cosine_decay_schedule
    from rtvm_tpu_torch.models.yolo.train import Targets, TrainState, make_train_step
    from rtvm_tpu_torch.models.yolo.train_synth import _bgr_to_rgb01, resume_state, save_outputs
    from rtvm_tpu_torch.models.yolo.world import build_yolo_world

    dev = resolve_device(device)
    model = build_yolo_world(variant, seed=seed, device=dev)

    sched = warmup_cosine_decay_schedule(0.0, lr, min(500, steps // 4), steps, lr * 0.05)
    tx = AdamW(sched, weight_decay=5e-4, clip_norm=10.0)
    state = TrainState(model, tx.init(model.parameters()))
    if resume:
        resume_state(state, resume)

    rng = np.random.RandomState(seed + 1)
    bg = BackgroundPool(imgsz, rng=rng)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    for it in range(state.step, steps):
        imgs, boxes, cls, valid = make_batch(rng, bg, batch, imgsz)
        prompts = [SYNONYMS[c][rng.randint(len(SYNONYMS[c]))] for c in AERIAL_CLASSES]
        step_fn = make_train_step(_WorldAdapter(model, *_tokens(prompts, dev)), tx)
        images = _bgr_to_rgb01(torch.from_numpy(imgs).to(dev))
        targets = Targets(*(torch.from_numpy(a).to(dev) for a in (boxes, cls, valid)))
        state, metrics = step_fn(state, images, targets)
        if (it + 1) % log_every == 0:
            dt = time.time() - t0
            print(f"step {it + 1}/{steps} loss {float(metrics['loss']):.3f} "
                  f"({dt:.0f}s, {(it + 1) / dt:.1f} it/s)", flush=True)
        if (it + 1) % eval_every == 0 or it + 1 == steps:
            report = evaluate(model, imgsz=imgsz)
            print(f"step {it + 1} eval: {json.dumps(report)}", flush=True)
            save_outputs(out_dir, f"{variant}_world", state, imgsz, it + 1, report)
    return state, model


def evaluate(model, n: int = 48, imgsz: int = 320, conf: float = 0.25,
             prompts: Optional[List[str]] = None):
    """mAP@0.5 on held-out synthetic scenes, in float32 as JAX runs it.
    `prompts` (parallel to AERIAL_CLASSES) defaults to the class names; the
    class-i prompt scores class-i regions whatever its text. Leaves the
    model in eval mode."""
    from rtvm_tpu_torch.models.yolo import postprocess as pp
    from rtvm_tpu_torch.models.yolo.eval import evaluate_map
    from rtvm_tpu_torch.models.yolo.train_synth import _bgr_to_rgb01, _dets, make_eval_set

    dev = next(model.parameters()).device
    imgs, gtb, gtc = make_eval_set(n, imgsz)
    ids, mask = _tokens(list(prompts) if prompts is not None else AERIAL_CLASSES, dev)
    model.eval()
    dets: List[List[dict]] = []
    for i in range(0, len(imgs), 16):
        x = _bgr_to_rgb01(torch.from_numpy(imgs[i : i + 16]).to(dev))
        with torch.inference_mode():
            box_l, cls_l = model(x, ids, mask)
            boxes, scores = pp.decode_predictions(box_l, cls_l, model.cfg.strides,
                                                  model.cfg.reg_max)
            det = pp.nms_fixed(boxes, scores, conf, 0.45)
            table = torch.cat([det.boxes, det.scores[..., None], det.classes[..., None].float(),
                               det.valid[..., None].float()], -1).cpu().numpy()
        dets += [_dets(rows) for rows in table]
    return evaluate_map(dets, gtb, gtc, AERIAL_CLASSES)


def main(argv=None, device=None):
    """JAX's command line; runs on `device` (``cuda`` unless given)."""
    ap = argparse.ArgumentParser(description="Train open-vocab YOLOWorld on synthetic aerial scenes")
    ap.add_argument("--variant", default="yolov8n")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--imgsz", type=int, default=320)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--out-dir", default="weights",
                    help="where the checkpoints go (the default overwrites the repo's)")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    train(a.variant, a.steps, a.batch, a.imgsz, a.lr, a.seed, a.eval_every, a.out_dir,
          resume=a.resume, device=device)


if __name__ == "__main__":
    main()
