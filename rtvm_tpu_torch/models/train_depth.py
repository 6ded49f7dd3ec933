"""Train DepthNet on synthetic aerial terrain scenes (``models/depth_synth.py``):
the port's counterpart of ``rtvm_tpu/models/train_depth.py``.

Loss: absolute MSE on normalised nearness, relative L1, the eval metric
itself (the per-image affine-aligned abs-rel, its closed-form scale clipped
to [0.05, 20] so that an inverted fit cannot win) and gradient matching at
full, half and quarter resolution. AdamW with a cosine decay to 0.05 of the
rate and weight decay 1e-5, no clipping. The scenes come from a recycling
pool of spawned workers (each batch from its own seed), as in JAX.

Usage (on the card; ``main(argv, device="cpu")`` runs it on the CPU):

    python -m rtvm_tpu_torch.models.train_depth --steps 3000 --batch 8 --out-dir DIR

Writes ``<out-dir>/depthnet.npz`` (the Flax params, which both packages'
depth estimators load) and ``depthnet.json`` (abs_rel and pearson on 16
scenes of seed 777); the default out-dir ``weights/`` overwrites the
repo's checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from rtvm_tpu_torch.models.depth_synth import make_depth_batch


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    """jnp.maximum(x, v) (and jnp.clip's lower side): a tie splits the
    gradient, as torch.maximum's does; the scalar is filled on x's device."""
    return torch.maximum(x, x.new_full((), v))


def _nchw(imgs: torch.Tensor) -> torch.Tensor:
    return imgs.permute(0, 3, 1, 2)


def loss_fn(model, imgs: torch.Tensor, near: torch.Tensor) -> torch.Tensor:
    """imgs [B, H, W, 3] RGB in 0..1, near [B, H, W] -> the scalar loss
    5 mse + rel + 3 aligned + the gradient terms (JAX's ``loss_fn``)."""
    pred = model(_nchw(imgs))[:, 0]  # [B, H, W] in (0, 1)
    mse = torch.mean((pred - near) ** 2)
    rel = torch.mean(torch.abs(pred - near) / _max(near, 0.05))

    # per-image least-squares (s, b) with s clipped to [0.05, 20], then the
    # weighted abs-rel the evaluator reports
    p2 = pred.reshape(pred.shape[0], -1)
    t2 = near.reshape(near.shape[0], -1)
    pm = torch.mean(p2, 1, keepdim=True)
    tm = torch.mean(t2, 1, keepdim=True)
    cov = torch.mean((p2 - pm) * (t2 - tm), 1, keepdim=True)
    var = torch.mean((p2 - pm) ** 2, 1, keepdim=True)
    s = cov / _max(var, 1e-8)
    s = torch.minimum(_max(s, 0.05), s.new_full((), 20.0))
    bshift = tm - s * pm
    pa = s * p2 + bshift
    aligned = torch.mean(torch.abs(pa - t2) / _max(t2, 0.05))

    def grad_l1(p, t):
        gx = torch.abs(torch.diff(p, dim=2) - torch.diff(t, dim=2))
        gy = torch.abs(torch.diff(p, dim=1) - torch.diff(t, dim=1))
        return torch.mean(gx) + torch.mean(gy)

    g = sum(grad_l1(pred[:, ::k, ::k], near[:, ::k, ::k]) for k in (1, 2, 4))
    return 5.0 * mse + rel + 3.0 * aligned + g


def train_step(model, tx, optimizer, count: int, imgs: torch.Tensor, near: torch.Tensor):
    """One update (the `count`-th, from 0) in place; returns the loss (a
    0-dim tensor, not read back)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, imgs, near)
    loss.backward()
    tx.update(optimizer, count)
    return loss.detach()


def evaluate(model, h: int, w: int, n: int = 16):
    """(abs_rel, pearson) on `n` scenes of seed 777: the affine-invariant
    abs-rel after a per-image least-squares fit (clipped at 1e-3), and the
    mean correlation."""
    rng = np.random.RandomState(777)
    imgs, near = make_depth_batch(rng, n, h, w)
    dev = next(model.parameters()).device
    model.eval()
    with torch.inference_mode():
        pred = model(_nchw(torch.from_numpy(imgs).to(dev)))[:, 0].cpu().numpy()
    errs, rhos = [], []
    for i in range(n):
        p, t = pred[i].ravel(), near[i].ravel()
        A = np.stack([p, np.ones_like(p)], 1)
        s, b = np.linalg.lstsq(A, t, rcond=None)[0]
        pa = np.clip(s * p + b, 1e-3, None)
        errs.append(np.mean(np.abs(pa - t) / np.maximum(t, 0.05)))
        rhos.append(np.corrcoef(p, t)[0, 1])
    return float(np.mean(errs)), float(np.mean(rhos))


def main(argv=None, device=None):
    """JAX's command line; runs on `device` (``cuda`` unless given)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--out-dir", default="weights",
                    help="where the checkpoint goes (the default overwrites the repo's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", default=None,
                    help="warm-start params from an existing depthnet .npz")
    a = ap.parse_args(argv)

    from rtvm_tpu_torch.device import resolve_device
    from rtvm_tpu_torch.models.depthnet import build_depthnet, state_dict_to_flax
    from rtvm_tpu_torch.models.optim import AdamW, cosine_decay_schedule
    from rtvm_tpu_torch.utils.checkpoint import flat_to_nested, save_pytree_npz

    dev = resolve_device(device)
    h, w = a.size
    model = build_depthnet(a.init, device=dev, seed=a.seed)
    tx = AdamW(cosine_decay_schedule(a.lr, a.steps, 0.05), weight_decay=1e-5, clip_norm=None)
    optimizer = tx.init(model.parameters())

    # Host synthesis is slower than the card's step, so the loader is a
    # recycling pool: spawned workers keep making batches from their own
    # seeds, and the loop takes what is ready, re-drawing one of the last
    # `pool_cap` batches when generation lags (i.i.d. synthetic data
    # tolerates reuse).
    import multiprocessing as mp

    workers = min(8, mp.cpu_count() or 1)
    pool = mp.get_context("spawn").Pool(workers, initializer=_init_worker, initargs=(h, w, a.batch))
    pending = [pool.apply_async(_gen_batch, (a.seed + 1 + i,)) for i in range(2 * workers)]
    next_seed = a.seed + 1 + len(pending)
    recycled = []  # the most recent ready batches
    pool_cap = 64
    draw_rng = np.random.RandomState(a.seed + 991)

    def next_batch():
        nonlocal next_seed
        # drain every finished job first (each refills its worker's slot)
        fresh = None
        for job in list(pending):
            if job.ready():
                pending.remove(job)
                fresh = job.get()
                recycled.append(fresh)
                pending.append(pool.apply_async(_gen_batch, (next_seed,)))
                next_seed += 1
        if len(recycled) > pool_cap:
            del recycled[: len(recycled) - pool_cap]
        if fresh is not None:
            return fresh
        if recycled:
            return recycled[draw_rng.randint(len(recycled))]
        out = pending.pop(0).get()  # cold start: wait for the first batch
        recycled.append(out)
        pending.append(pool.apply_async(_gen_batch, (next_seed,)))
        next_seed += 1
        return out

    os.makedirs(a.out_dir, exist_ok=True)
    out = os.path.join(a.out_dir, "depthnet.npz")

    def save(i):
        absrel, rho = evaluate(model, h, w)
        save_pytree_npz(out, flat_to_nested(state_dict_to_flax(model.state_dict())))
        with open(os.path.join(a.out_dir, "depthnet.json"), "w") as f:
            json.dump({"steps": i, "size": [h, w], "abs_rel": absrel, "pearson": rho}, f)
        print(f"step {i} saved {out}: abs_rel={absrel:.4f} pearson={rho:.4f}", flush=True)

    t0 = time.time()
    try:
        for i in range(1, a.steps + 1):
            imgs, near = next_batch()
            loss = train_step(model, tx, optimizer, i - 1, torch.from_numpy(imgs).to(dev),
                              torch.from_numpy(near).to(dev))
            if i % 50 == 0:
                el = time.time() - t0
                print(f"step {i}/{a.steps} loss {float(loss):.4f} ({el:.0f}s, {i / el:.1f} it/s)",
                      flush=True)
            if i % a.eval_every == 0 or i == a.steps:
                save(i)
    finally:
        pool.terminate()
        pool.join()
    return model


_WORKER_STATE = {}


def _init_worker(h, w, batch):
    _WORKER_STATE.update(h=h, w=w, batch=batch)


def _gen_batch(seed):
    s = _WORKER_STATE
    rng = np.random.RandomState(seed)
    return make_depth_batch(rng, s["batch"], s["h"], s["w"])


if __name__ == "__main__":
    main()
