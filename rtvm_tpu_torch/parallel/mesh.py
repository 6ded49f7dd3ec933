"""Multi-device execution of the mosaic engine (counterpart of
``rtvm_tpu/parallel/mesh.py``), in ``torch.distributed`` with explicit
collectives.

The JAX module declares shardings on a (dp, tp) mesh and lets XLA insert
the collectives. Here every rank is a process and every exchange is written
out:

- **dp** (data parallel): the frames of a window, the frames of a detection
  batch, the images of a training batch. Each dp rank works on its slice and
  the results are gathered (``all_gather``) or summed (``all_reduce``).
- **tp** (tensor parallel): the canvas rows. Each tp rank holds one band of
  the canvas (and of the coarse union grid) and paints only that band, with
  the halo of rows that the paint chain reads around it.

``make_mesh`` factors n as JAX does and returns a ``DeviceMesh`` with the
dims ("dp", "tp") over the process group that is already initialised; rank r
is (r // tp, r % tp), JAX's row-major ``devices.reshape(dp, tp)``.

``run_ranks`` spawns the ranks (``torch.multiprocessing``, start method
``spawn``) with a ``file://`` store in a temporary directory, runs a list of
module-level jobs in each and returns what each rank returns. Rank r uses
``cuda:(r % device_count)``. The backend is NCCL where every rank has a
card of its own, gloo where ranks share a card (NCCL refuses two ranks on
one device) and on the CPU; ``choose_backend`` decides from the device
count before anything starts. gloo takes every collective used here on CUDA
tensors (``all_gather`` of float32, int32, int64, uint8 and bool,
``all_reduce``, the autograd all-reduce of ``_AllReduceSum``; checked on an
H100 with torch 2.11), so nothing is staged through the host by this
module: gloo copies to and from the host inside each call. Point-to-point
``send``/``recv`` is not used. A rank that fails or hangs fails the call:
``init_process_group`` gets a timeout, the parent waits with a deadline and
kills the other ranks.

``dryrun_multichip`` mirrors the JAX dry run: the tiny ORB window step, the
dp YOLO training step, dp detection and, with ``production``, the 360x640
window of 8 at K=700 onto the 720x768 canvas.
"""

from __future__ import annotations

import datetime
import functools
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rtvm_tpu_torch import kernels
from rtvm_tpu_torch.config import FeatureConfig, MosaicConfig
from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.mosaic import stitcher as S
from rtvm_tpu_torch.ops import color
from rtvm_tpu_torch.ops import warp as warp_ops
from rtvm_tpu_torch.parallel import collectives
from rtvm_tpu_torch.parallel.collectives import all_gather_cat, all_gather_list

# Rows of halo the paint of a band reads (ops/warp.py):
# - the weight blur (blend_weights_smoothed, 31 taps) reads BLEND_RADIUS rows
#   of alpha and of the union indicator on each side of the band; those rows
#   need w_new, w_old and the canvas coverage;
# - w_new (frame_weight_with_holes) takes the distance to black holes on the
#   stride-2 grid: HOLE_RADIUS coarse rows each way (32 canvas rows), plus
#   the pairing of rows for the any-pool and the next coarse row of the 2x
#   upsample: 2 * HOLE_RADIUS + 4 canvas rows below, 2 * HOLE_RADIUS above
#   (paint_rows);
# - coarse_union_distance is a global chamfer on the coarse grid, so the
#   coarse footprints (one bool per 4x4 cell) are gathered over tp whole.
# Together about 50 rows each side of a band: paint_rows gives the exact
# ranges. Band edges lie on multiples of CELL_PX (4, so of 2 too).
BLEND_RADIUS = warp_ops.BLEND_SMOOTH_RADIUS
HOLE_RADIUS = 16  # frame_weight_with_holes's radius (stride-2 cells)
JOIN_TIMEOUT_S = 300.0  # a hung rank fails the call after this; gloo's collectives time out too

# ---------------------------------------------------------------- the mesh


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) for n devices, JAX's factoring: tp is the largest power of two
    <= isqrt(n) that divides n, dp = n / tp."""
    if tp is None:
        tp = 1
        while tp * 2 <= int(math.isqrt(n)) and n % (tp * 2) == 0:
            tp *= 2
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh ({dp}, {tp}) does not hold {n} devices")
    return dp, tp


@functools.lru_cache(maxsize=8)
def _device_mesh(device_type: str, dp: int, tp: int):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device=None):
    """A (dp, tp) ``DeviceMesh`` over the process group already initialised
    (``run_ranks`` starts one in each rank), on ``device``'s type (``cuda``
    unless given). n_devices defaults to the world size and must equal it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (see run_ranks)")
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"make_mesh: {n} devices asked of a world of {dist.get_world_size()}")
    dp, tp = mesh_shape(n, dp, tp)
    return _device_mesh(resolve_device(device).type, dp, tp)


def shard_batch(mesh, x, axis: int = 0):
    """This rank's dp slice of x along `axis` (replicated over tp, as
    ``P("dp")`` is in JAX). The length must divide by dp."""
    dp, r = mesh.size(0), mesh.get_coordinate()[0]
    n = x.shape[axis]
    if n % dp:
        raise ValueError(f"shard_batch: {n} items do not split over dp={dp}")
    return x.narrow(axis, r * (n // dp), n // dp)


# --------------------------------------------------- the sharded window step


def canvas_bands(hc: int, tp: int) -> List[Tuple[int, int]]:
    """The canvas rows [a, b) of each tp rank: whole coarse cells, as even as
    the cells allow. Each band must be at least BLEND_RADIUS rows, so that
    its halo comes from its neighbours alone."""
    cell = warp_ops.CELL_PX
    cells = -(-hc // cell)
    per = -(-cells // tp)
    bands = [(min(hc, t * per * cell), min(hc, (t + 1) * per * cell)) for t in range(tp)]
    if any(b - a < BLEND_RADIUS for a, b in bands):
        raise ValueError(f"a canvas of {hc} rows is too short for tp={tp}: bands {bands}")
    return bands


def paint_rows(band: Tuple[int, int], hc: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((l, h), (lo, hi)) for a band [a, b): [l, h) the rows whose blend
    weights the band's blur reads, [lo, hi) the rows warped and weighted so
    that w_new is exact on [l, h) (see the halo note at the top)."""
    a, b = band
    l, h = max(0, a - BLEND_RADIUS), min(hc, b + BLEND_RADIUS)
    lo = max(0, 2 * (l // 2) - 2 * HOLE_RADIUS)
    hi = min(hc, 2 * ((h - 1) // 2) + 2 * HOLE_RADIUS + 4)
    return (l, h), (lo, hi)


def _band(mesh, hc: int) -> Tuple[int, int]:
    return canvas_bands(hc, mesh.size(1))[mesh.get_coordinate()[1]]


def shard_state(mesh, state: S.MosaicState) -> S.MosaicState:
    """This rank's part of a full MosaicState: its canvas band and the
    coarse union rows of that band; everything else replicated."""
    hc = state.canvas.shape[1]
    a, b = _band(mesh, hc)
    cell = warp_ops.CELL_PX
    return state._replace(canvas=state.canvas[:, a:b].clone(),
                          union_coarse=state.union_coarse[a // cell : -(-b // cell)].clone())


def _gather_bands(x: torch.Tensor, sizes: Sequence[int], group) -> torch.Tensor:
    """Concatenate the tp ranks' bands x [..., rows_t, W] along the rows:
    each is padded to the largest before the gather and cut after."""
    per = max(sizes)
    pad = per - x.shape[-2]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))], dim=-2)
    parts = all_gather_list(x, group)
    return torch.cat([p[..., :n, :] for p, n in zip(parts, sizes)], dim=-2)


def gather_state(mesh, state: S.MosaicState, hc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(canvas [3, Hc, Wc], union_coarse) assembled from the tp ranks' bands
    on every tp rank: for checks, never inside the step."""
    cell = warp_ops.CELL_PX
    bands = canvas_bands(hc, mesh.size(1))
    tpg = mesh.get_group("tp")
    canvas = _gather_bands(state.canvas, [b - a for a, b in bands], tpg)
    union = _gather_bands(state.union_coarse.to(torch.uint8),
                          [-(-b // cell) - a // cell for a, b in bands], tpg)
    return canvas, union.to(torch.bool)


def _halo_rows(own: torch.Tensor, band, rows, tpg) -> torch.Tensor:
    """Rows [l, h) of a tp-sharded [rows, W] map from this rank's band `own`
    (rows [a, b)) and the BLEND_RADIUS edge rows of its neighbours."""
    (a, b), (l, h) = band, rows
    r = BLEND_RADIUS
    edges = all_gather_list(torch.stack([own[:r], own[-r:]]), tpg)  # [2, r, W] a rank
    t = dist.get_rank(tpg)
    above = edges[t - 1][1][r - (a - l):] if a > l else own[:0]
    below = edges[t + 1][0][: h - b] if h > b else own[:0]
    return torch.cat([above, own, below], dim=0)


def make_sharded_window_step(frame_shape, cfg: MosaicConfig, mesh):
    """The window step of ``mosaic/stitcher.py:make_step_body`` on a (dp, tp)
    mesh. Returns step(state, frames_u8, seed, fweight, weight_table,
    uniforms=None) -> (state, WindowAux), where `state` holds this rank's
    canvas band (``shard_state``), `frames_u8` [B / dp, H, W, 3] this dp
    rank's frames of the window (``shard_batch``) and `uniforms`, if given,
    the whole window's RANSAC draws [B, num_hypotheses, K]. WindowAux is the
    whole window's, on every rank.

    Rank by rank: features for the rank's frames; every frame's keypoints
    and descriptors gathered over dp (pair i reads frame i - 1, which may
    lie on another rank); matching and RANSAC for the rank's own pairs,
    with the draws of pair_uniforms seeded by the frame, so they do not
    depend on the rank; H_rel and the flags gathered over dp; the 3x3 chain
    replicated; the uint8 frames gathered over dp; then the rank paints its
    band of the canvas, rows [a, b), warping and weighting [lo, hi)
    (``paint_rows``) and exchanging only the coarse footprints (all of them,
    over tp) and the canvas coverage's BLEND_RADIUS edge rows."""
    S._check_config(cfg)
    hf, wf = frame_shape[0], frame_shape[1]
    hc, wc = S.canvas_hw(frame_shape, cfg)
    cell = warp_ops.CELL_PX
    dpg, tpg = mesh.get_group("dp"), mesh.get_group("tp")
    dp_rank = mesh.get_coordinate()[0]
    dp = mesh.size(0)
    bands = canvas_bands(hc, mesh.size(1))
    band = _band(mesh, hc)
    (l, h), (lo, hi) = paint_rows(band, hc)
    a, b = band
    coarse_sizes = [-(-bb // cell) - aa // cell for aa, bb in bands]

    def step(state: S.MosaicState, frames: torch.Tensor, seed: int, fweight: torch.Tensor,
             weight_table: torch.Tensor, uniforms: Optional[torch.Tensor] = None):
        dev = state.canvas.device
        if state.canvas.shape[1:] != (b - a, wc):
            raise ValueError(f"state canvas {tuple(state.canvas.shape)} is not this rank's "
                             f"band [{a}, {b}) of {hc}x{wc}")
        bl = frames.shape[0]
        nb, i0 = bl * dp, dp_rank * bl

        # --- 1. features for this dp rank's frames, then every frame's ---
        kps_l, descs_l, valids_l = S._extract_features(color.bgr2gray(frames), cfg)
        kps, descs = all_gather_cat(kps_l, dpg), all_gather_cat(descs_l, dpg)
        valids = all_gather_cat(valids_l, dpg)

        # --- 2. match + RANSAC for this rank's pairs (pair i: frame i vs i-1) ---
        if uniforms is None:
            u = S.pair_uniforms(seed, int(state.frame_idx) + i0, bl, cfg, dev)
        else:
            u = uniforms[i0 : i0 + bl]
        if i0 == 0:
            prev = (state.kp, state.desc, state.kp_valid)
        else:
            prev = (kps[i0 - 1], descs[i0 - 1], valids[i0 - 1])
        res, mvalid = S.match_and_fit(kps_l, descs_l, valids_l, *prev, u, cfg)
        packed = torch.cat([res.H.reshape(bl, 9), res.ok.to(torch.float32)[:, None],
                            res.num_inliers.to(torch.float32)[:, None],
                            torch.sum(mvalid, dim=-1).to(torch.float32)[:, None]], dim=1)
        packed = all_gather_cat(packed, dpg)  # [B, 12]: small integers are exact
        H_rels = packed[:, :9].reshape(nb, 3, 3).contiguous()
        r_ok = packed[:, 9] > 0.5
        num_inliers = packed[:, 10].to(res.num_inliers.dtype)
        num_matches = packed[:, 11].to(torch.int64)

        # --- 3. the 3x3 chain, replicated ---
        ok_seq, H_abs, H_old, hbuf, hcount = S.compose_chain(state, H_rels, r_ok,
                                                             weight_table, cfg)
        blended = r_ok

        # --- 4. paint this rank's band ---
        frames_all = all_gather_cat(frames, dpg)
        frames_cm = frames_all.to(torch.float32).permute(0, 3, 1, 2).contiguous()
        canvas, union = S.paint_band(
            state.canvas, state.union_coarse, frames_cm, H_abs, blended, (hf, wf), (hc, wc),
            band=band, rows=((l, h), (lo, hi)),
            # the whole coarse grid: union0's and the footprints' bands of every rank
            gather_coarse=lambda x: _gather_bands(x.to(torch.uint8), coarse_sizes, tpg) > 0,
            halo_rows=lambda x: _halo_rows(x.to(torch.uint8), band, (l, h), tpg) > 0)

        kp_l, desc_l, valid_l = S.last_accepted_features(state, kps, descs, valids, blended)
        new_state = S.MosaicState(
            canvas=canvas, union_coarse=union, H_old=H_old,
            kp=kp_l, desc=desc_l, kp_valid=valid_l, hbuf=hbuf, hcount=hcount,
            frame_idx=state.frame_idx + nb,
        )
        aux = S.WindowAux(num_matches=num_matches, num_inliers=num_inliers, H_abs=H_abs,
                          ok=ok_seq, blended=blended)
        return new_state, aux

    step.band, step.rows = band, ((l, h), (lo, hi))
    return step


# ---------------------------------------------------------------- the ranks


class RankContext(NamedTuple):
    """What a job learns of its rank."""

    rank: int
    world: int
    device: torch.device
    backend: str


def choose_backend(device_type: str, n: int) -> str:
    """NCCL where every one of the n ranks has a card of its own; gloo where
    ranks share a card (NCCL refuses two ranks on one device) and on the
    CPU. Decided from the device count, before any rank starts."""
    if device_type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, init_method: str, backend: str, device_type: str,
               jobs, timeout_s: float, results) -> None:
    try:
        if device_type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)  # several ranks share the host's cores
        t = time.perf_counter()
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = {"init_s": time.perf_counter() - t, "jobs": []}
        ctx = RankContext(rank, world, dev, backend)
        for fn, kw in jobs:
            out["jobs"].append(fn(ctx, **kw))
        dist.destroy_process_group()
        results.put(("ok", rank, out))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(n: int, jobs: Sequence[Tuple[Callable, dict]], device=None,
              timeout: float = JOIN_TIMEOUT_S) -> dict:
    """Spawn n ranks, each running job(ctx, **kwargs) for every (job, kwargs)
    in `jobs` in order (module-level functions: spawn imports them), on
    ``device``'s type (``cuda`` unless given). Returns {"backend", "spawn_s"
    (start to the last rank's results), "init_s" [n], "jobs": [job][rank]}.
    Raises if a rank fails, or if the ranks have not all finished within
    `timeout` seconds; the other ranks are killed. The backend is
    ``choose_backend``'s."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    backend = choose_backend(dev.type, n)
    if dev.type == "cuda":
        kernels.build()  # the ranks only load the library: concurrent builds would race
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rtvm_mesh_")
    results = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, "file://" + os.path.join(tmp, "store"), backend, dev.type,
                               list(jobs), timeout, results))
             for r in range(n)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = t0 + timeout
        while len(got) < n:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise TimeoutError(f"run_ranks: ranks {sorted(set(range(n)) - set(got))} "
                                   f"did not finish in {timeout:.0f} s")
            try:
                kind, rank, payload = results.get(timeout=min(1.0, left))
            except queue.Empty:
                gone = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if gone:
                    raise RuntimeError(f"run_ranks: rank {gone[0]} exited with "
                                       f"{procs[gone[0]].exitcode} and no result")
                continue
            if kind == "error":
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{payload}")
            got[rank] = payload
        spawn_s = time.perf_counter() - t0
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.perf_counter()))
            if p.exitcode != 0:
                raise RuntimeError(f"run_ranks: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"backend": backend, "spawn_s": spawn_s,
            "init_s": [got[r]["init_s"] for r in range(n)],
            "jobs": [[got[r]["jobs"][j] for r in range(n)] for j in range(len(jobs))]}


# ------------------------------------------------------------------ the jobs
# Each job runs in every rank (run_ranks) as job(ctx, **case): module-level,
# so that spawn imports it. The *_case functions make the inputs with numpy from
# a seed, so a caller can run the same case in one process (single_*) and
# hold the ranks' result against it.


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_mib(dev: torch.device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def tiny_window_case(dp: int) -> dict:
    """JAX's dry-run window (``mesh.py:79-93``): 64x128 random frames, ORB
    with K=64, a window of max(2, dp) onto a 128x160 canvas."""
    h, w = 64, 128
    b = max(2, dp)
    cfg = MosaicConfig(window_size=b, output_height_times=2.0, output_width_times=1.25,
                       features=FeatureConfig(detector_type="orb", max_keypoints=64,
                                              border_margin=8))
    rng = np.random.RandomState(0)
    first = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
    frames = rng.randint(0, 255, (b, h, w, 3), dtype=np.uint8)
    return {"first": first, "windows": frames[None], "cfg": cfg, "detector": "orb"}


def production_case(detector: str = "orb", n_windows: int = 1) -> dict:
    """JAX's production dry run (``mesh.py:166-180``): 360x640 frames
    drifting 2 px a frame, a window of 8 at the default K=700 onto the
    720x768 canvas."""
    h, w, b = 360, 640, 8
    n = b * n_windows
    rng = np.random.RandomState(1)
    base = rng.randint(0, 255, (h + 2 * n, w + 2 * n, 3), dtype=np.uint8)
    frames = np.stack([base[2 * i : 2 * i + h, 2 * i : 2 * i + w] for i in range(n)])
    return {"first": base[:h, :w].copy(), "windows": frames.reshape(n_windows, b, h, w, 3),
            "cfg": MosaicConfig(window_size=b), "detector": detector}


def _window_setup(case: dict, device):
    m = S.VideMosaic(case["first"], detector_type=case["detector"], config=case["cfg"],
                     seed=case.get("seed", 0), device=device)
    if case.get("snap") is not None:  # a checkpoint to start from (either package's)
        m.restore(case["snap"])
    return m, [torch.from_numpy(np.ascontiguousarray(w)).to(m.device) for w in case["windows"]]


def _uniforms(case: dict, w: int, dev) -> Optional[torch.Tensor]:
    u = case.get("uniforms")
    return None if u is None else torch.from_numpy(np.asarray(u[w])).to(dev)


def _window_result(state: S.MosaicState, auxs, canvas, union) -> dict:
    aux = S.WindowAux(*(torch.stack(f) for f in zip(*auxs)))
    out = {k: v.cpu().numpy() for k, v in aux._asdict().items()}
    out.update(canvas=canvas.cpu().numpy(), union_coarse=union.cpu().numpy(),
               H_old=state.H_old.cpu().numpy(), kp=state.kp.cpu().numpy(),
               desc=state.desc.cpu().numpy(), kp_valid=state.kp_valid.cpu().numpy(),
               hbuf=state.hbuf.cpu().numpy(), hcount=int(state.hcount),
               frame_idx=int(state.frame_idx))
    return out


def single_window_run(case: dict, device=None) -> dict:
    """The case's windows through VideMosaic's step in this process."""
    m, windows = _window_setup(case, device)
    kernels.reset_launches()
    auxs = [m.process_window(fr, uniforms=_uniforms(case, w, m.device))
            for w, fr in enumerate(windows)]
    out = _window_result(m.state, auxs, m.state.canvas, m.state.union_coarse)
    out["launches"] = dict(kernels.launches)
    return out


def window_job(ctx: RankContext, first, windows, cfg, detector="orb", uniforms=None,
               seed=0, snap=None, tp=None) -> dict:
    """The case's windows through the sharded window step, on the mesh
    ``make_mesh`` gives the world (tp, if given, fixes its tp). Every rank
    returns its band, the rows it painted, its launches, step times,
    collective time and peak memory; rank 0 also the window's aux and the
    state, with the canvas gathered from the bands for the check."""
    dev = ctx.device
    case = {"first": first, "windows": windows, "cfg": cfg, "detector": detector,
            "uniforms": uniforms, "seed": seed, "snap": snap}
    mesh = make_mesh(ctx.world, tp=tp, device=dev)
    m, frames = _window_setup(case, dev)
    hc = m.canvas_shape[0]
    step = make_sharded_window_step(m.frame_shape, m.config, mesh)
    state = shard_state(mesh, m.state)
    m.state = None  # this rank keeps its band only
    _sync(dev)
    _reset_peak(dev)
    kernels.reset_launches()
    auxs, step_ms, comm = [], [], []
    for w, fr in enumerate(frames):
        local = shard_batch(mesh, fr)
        u = _uniforms(case, w, dev)
        _sync(dev)
        collectives.reset_comm()
        t = time.perf_counter()
        state, aux = step(state, local, m.seed, m._fweight, m._wtable, u)
        _sync(dev)
        step_ms.append((time.perf_counter() - t) * 1e3)
        comm.append(collectives.comm_ms[0])
        auxs.append(aux)
    launches = dict(kernels.launches)
    out = {"rank": ctx.rank, "coord": tuple(mesh.get_coordinate()), "band": step.band,
           "rows": step.rows, "canvas_band": tuple(state.canvas.shape),
           "union_band": tuple(state.union_coarse.shape), "frames_local": tuple(local.shape),
           "launches": launches, "step_ms": step_ms, "comm_ms": comm,
           "peak_mib": _peak_mib(dev), "mesh": (mesh.size(0), mesh.size(1))}
    canvas, union = gather_state(mesh, state, hc)
    if ctx.rank == 0:
        out.update(_window_result(state, auxs, canvas, union))
    return out


def detection_case(dp: int, model: str = "yolov8n", imgsz: int = 128) -> dict:
    """JAX's dp detection dry run (``mesh.py:143-163``): max(2, dp) random
    128x128 frames; here through ObjectDetector._infer_fn in float32 (the
    bundled checkpoint where there is one)."""
    rng = np.random.RandomState(2)
    frames = rng.randint(0, 255, (max(2, dp), imgsz, imgsz, 3), dtype=np.uint8)
    return {"frames": frames, "model": model, "imgsz": imgsz, "conf": 0.25, "iou": 0.45}


def _detector(model: str, device):
    from rtvm_tpu_torch.detect.detector import ObjectDetector

    return ObjectDetector(model, load_world=False, device=device)


def _det_numpy(det) -> dict:
    return {k: v.cpu().numpy() for k, v in det._asdict().items()}


def single_detection_run(case: dict, device=None) -> dict:
    d = _detector(case["model"], device)
    run = d._infer_fn(case["imgsz"], case["conf"], case["iou"], dtype=torch.float32)
    return _det_numpy(run(case["frames"]))


def detection_job(ctx: RankContext, frames, model="yolov8n", imgsz=128, conf=0.25,
                  iou=0.45) -> dict:
    """Each dp rank runs the detector's float32 ``_infer_fn`` on its dp
    slice; the detections are gathered over dp. Rank 0 returns them."""
    dev = ctx.device
    mesh = make_mesh(ctx.world, device=dev)
    run = _detector(model, dev)._infer_fn(imgsz, conf, iou, dtype=torch.float32)
    local = shard_batch(mesh, torch.from_numpy(frames).to(dev))
    run(local)  # warm
    _sync(dev)
    collectives.reset_comm()
    t = time.perf_counter()
    det = run(local)
    det = type(det)(*(all_gather_cat(x, mesh.get_group("dp")) for x in det))
    _sync(dev)
    out = {"rank": ctx.rank, "ms": (time.perf_counter() - t) * 1e3,
           "comm_ms": collectives.comm_ms[0], "batch_local": local.shape[0]}
    if ctx.rank == 0:
        out.update(_det_numpy(det))
    return out


def train_case(n: int, imgsz: int = 64) -> dict:
    """JAX's dry-run training step (``mesh.py:226-255``): YOLOv8n with 8
    classes on random images with two boxes each; the batch is max(2, n),
    so that every one of the n ranks holds at least one image."""
    b = max(2, n)
    rng = np.random.RandomState(0)
    images = rng.rand(b, imgsz, imgsz, 3).astype(np.float32).transpose(0, 3, 1, 2).copy()
    boxes = np.tile(np.array([[8.0, 8.0, 40.0, 40.0], [20.0, 24.0, 56.0, 60.0]],
                             np.float32)[None], (b, 1, 1))
    return {"images": images, "boxes": boxes, "classes": np.zeros((b, 2), np.int64),
            "valid": np.ones((b, 2), bool), "variant": "yolov8n", "num_classes": 8}


def _train_setup(case: dict, device, sl=slice(None)):
    from rtvm_tpu_torch.models.yolo.model import build_yolo
    from rtvm_tpu_torch.models.yolo.train import Targets, init_train_state

    model = build_yolo(case["variant"], num_classes=case["num_classes"], seed=0, device=device)
    state, tx = init_train_state(model)
    dev = next(model.parameters()).device
    targets = Targets(*(torch.from_numpy(case[k][sl]).to(dev)
                        for k in ("boxes", "classes", "valid")))
    return model, state, tx, torch.from_numpy(case["images"][sl]).to(dev), targets


def _train_result(model, metrics) -> dict:
    return {"loss": float(metrics["loss"]), "num_pos": float(metrics["num_pos"]),
            "state_dict": {k: v.cpu().numpy().copy() for k, v in model.state_dict().items()}}


def single_train_run(case: dict, device=None) -> dict:
    from rtvm_tpu_torch.models.yolo.train import make_train_step

    model, state, tx, images, targets = _train_setup(case, device)
    state, metrics = make_train_step(model, tx)(state, images, targets)
    return _train_result(model, metrics)


def train_job(ctx: RankContext, images, boxes, classes, valid, variant="yolov8n",
              num_classes=8) -> dict:
    """One dp training step: the batch split over all the ranks, BatchNorm's
    statistics, the loss's normalisers and the gradients summed over them.
    Rank 0 returns the loss and the model's state_dict after the step."""
    from rtvm_tpu_torch.models.yolo.train import make_train_step

    dev = ctx.device
    case = {"images": images, "boxes": boxes, "classes": classes, "valid": valid,
            "variant": variant, "num_classes": num_classes}
    n, b = ctx.world, images.shape[0]
    if b % n:
        raise ValueError(f"train_job: a batch of {b} does not split over {n} ranks")
    sl = slice(ctx.rank * (b // n), (ctx.rank + 1) * (b // n))
    model, state, tx, imgs, targets = _train_setup(case, dev, sl)
    step = make_train_step(model, tx, group=dist.group.WORLD)
    _sync(dev)
    _reset_peak(dev)
    collectives.reset_comm()
    t = time.perf_counter()
    state, metrics = step(state, imgs, targets)
    _sync(dev)
    out = {"rank": ctx.rank, "ms": (time.perf_counter() - t) * 1e3,
           "comm_ms": collectives.comm_ms[0], "peak_mib": _peak_mib(dev),
           "batch_local": imgs.shape[0], "step": state.step}
    if ctx.rank == 0:
        out.update(_train_result(model, metrics))
    # a second step on the same batch, warm, for its time alone
    collectives.reset_comm()
    t = time.perf_counter()
    step(state, imgs, targets)
    _sync(dev)
    out.update(warm_ms=(time.perf_counter() - t) * 1e3, warm_comm_ms=collectives.comm_ms[0])
    return out


def dryrun_multichip(n_devices: int, device=None, production: bool = True) -> dict:
    """The counterpart of the JAX dry run, in n_devices spawned ranks on a
    (dp, tp) mesh: the tiny ORB window step, the dp YOLO training step, dp
    detection and, with `production`, the 360x640 ORB window of 8 at K=700
    onto the 720x768 canvas. Prints the JAX dry run's ok lines and returns
    {case: [each rank's result]} with run_ranks's "backend", "spawn_s",
    "init_s" and the inputs under "cases"."""
    dev = resolve_device(device)
    dp, tp = mesh_shape(n_devices)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    print(f"dryrun_multichip: {n_devices} ranks on {dev.type} ({cards} card(s)), mesh "
          f"({dp}, {tp}), backend {choose_backend(dev.type, n_devices)}", flush=True)
    cases = {"window": tiny_window_case(dp), "train": train_case(n_devices),
             "detect": detection_case(dp)}
    jobs = {"window": window_job, "train": train_job, "detect": detection_job}
    if production:
        cases["production"], jobs["production"] = production_case("orb"), window_job
    res = run_ranks(n_devices, [(jobs[k], c) for k, c in cases.items()], device=dev)
    out = dict(zip(cases, res["jobs"]))
    w = out["window"][0]
    print(f"dryrun_multichip ok: mesh={w['mesh']} dp={dp} canvas={w['canvas'].shape} "
          f"bands={[r['band'] for r in out['window'][:tp]]}", flush=True)
    print(f"yolo train dryrun ok: loss={out['train'][0]['loss']:.3f} mesh={(dp, tp)}", flush=True)
    d = out["detect"][0]
    print(f"dp detection dryrun ok: batch={d['boxes'].shape[0]} boxes={d['boxes'].shape} "
          f"mesh={(dp, tp)}", flush=True)
    if production:
        p = out["production"][0]
        print(f"production dryrun ok: 360p window={p['ok'].shape[1]} "
              f"K={cases['production']['cfg'].features.max_keypoints} "
              f"canvas={p['canvas'].shape} ok_frames={int(p['ok'].sum())}/{p['ok'].size} "
              f"bands={[r['band'] for r in out['production'][:tp]]}", flush=True)
    out.update(backend=res["backend"], spawn_s=res["spawn_s"], init_s=res["init_s"],
               cases=cases)
    return out
