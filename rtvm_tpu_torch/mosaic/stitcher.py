"""The streaming mosaic stitcher (counterpart of ``rtvm_tpu/mosaic/stitcher.py``).

One window step processes B consecutive frames:
  1. gray + detection/description for all B frames at once: FAST-9 and
     rBRIEF for ORB, DoG SIFT for SIFT;
  2. matching (Hamming cross-check for ORB, L2 ratio for SIFT) + RANSAC for
     the B consecutive pairs at once;
  3. a short sequential pass over the 3x3 chain: validate -> smooth ->
     compose H_abs = H_old @ H_rel;
  4. paint: the warp (kernel A, one launch for the window) and every weight
     map are batched over the window; only the blend recurrence
     (``blend_apply_cm``) runs frame by frame, as in the JAX stitcher.

Reference behaviours kept as they are: the blend is not renormalised; a match
or RANSAC failure skips the frame entirely while a validation failure blends
it at identity; the last accepted frame's features become the next match
target.

RANSAC draws: pair i of a window draws its hypotheses from a
``torch.Generator`` seeded from (seed, absolute frame number), so a run
depends only on the seed and the frames, not on how they were cut into
windows. A caller may pass the draws instead (``uniforms``), which is how
the tests replay the JAX package's random stream.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.config import MosaicConfig
from rtvm_tpu_torch.device import resolve_device, upload_frames
from rtvm_tpu_torch.geometry import homography as geo
from rtvm_tpu_torch.io.jpeg import imwrite_jpg
from rtvm_tpu_torch.ops import color
from rtvm_tpu_torch.ops import match as match_ops
from rtvm_tpu_torch.ops import warp as warp_ops
from rtvm_tpu_torch.ops.features import fast as fast_ops
from rtvm_tpu_torch.ops.features import orb as orb_ops
from rtvm_tpu_torch.ops.features import sift as sift_ops
from rtvm_tpu_torch.ops.kernel_warp import inverse_maps, warp_batch
from rtvm_tpu_torch.utils import draw
from rtvm_tpu_torch.utils.timing import span

class MosaicState(NamedTuple):
    """Full resumable pipeline state (the same fields as the JAX package's)."""

    canvas: torch.Tensor  # [3, Hc, Wc] float32
    union_coarse: torch.Tensor  # [Hc/4, Wc/4] bool mosaic coverage at 4-px cells
    H_old: torch.Tensor  # [3, 3] float32 frame -> canvas
    kp: torch.Tensor  # [K, 2] float32 previous-frame keypoints
    desc: torch.Tensor  # [K, 8] int32 packed words (orb; uint32 in a checkpoint) /
    # [K, 128] float32 (sift)
    kp_valid: torch.Tensor  # [K] bool
    hbuf: torch.Tensor  # [S, 3, 3] float32 relative-homography history
    hcount: torch.Tensor  # int64 history fill count
    frame_idx: torch.Tensor  # int64 frames processed so far (frame 0 included);
    # kept on the host: it seeds the RANSAC draws


class WindowAux(NamedTuple):
    """Per-frame diagnostics from one window step."""

    num_matches: torch.Tensor  # [B] int64
    num_inliers: torch.Tensor  # [B] int64
    H_abs: torch.Tensor  # [B, 3, 3] absolute homographies (frame -> canvas)
    ok: torch.Tensor  # [B] bool homography accepted (vs identity fallback)
    blended: torch.Tensor  # [B] bool frame was painted (False: match/RANSAC failure)


def state_from_numpy(snap: dict, device) -> MosaicState:
    """A MosaicState from a checkpoint dict of numpy arrays, as either
    package's ``VideMosaic.checkpoint()`` writes it."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.array(snap[name]), dtype=dtype).to(dev)

    desc = np.array(snap["desc"])
    # ORB's packed uint32 words keep their bit pattern as int32
    desc = desc.view(np.int32) if desc.dtype in (np.uint32, np.int32) else desc.astype(np.float32)

    return MosaicState(
        canvas=t("canvas", torch.float32),
        union_coarse=t("union_coarse", torch.bool),
        H_old=t("H_old", torch.float32),
        kp=t("kp", torch.float32),
        desc=torch.from_numpy(desc).to(dev),
        kp_valid=t("kp_valid", torch.bool),
        hbuf=t("hbuf", torch.float32),
        hcount=t("hcount", torch.int64),
        frame_idx=torch.as_tensor(int(np.asarray(snap["frame_idx"])), dtype=torch.int64),
    )


def _check_config(cfg: MosaicConfig) -> None:
    if cfg.features.detector_type not in ("orb", "sift"):
        raise ValueError(f"unknown detector_type: {cfg.features.detector_type}")


def canvas_hw(frame_shape, cfg: MosaicConfig) -> Tuple[int, int]:
    """The canvas (rows, columns) for a frame shape and config: the config's
    ``canvas_hw``, else the frame scaled by the output factors."""
    if cfg.canvas_hw is not None:
        return tuple(cfg.canvas_hw)
    return (int(cfg.output_height_times * frame_shape[0]),
            int(cfg.output_width_times * frame_shape[1]))


def _extract_features(grays: torch.Tensor, cfg: MosaicConfig):
    """grays [B, H, W] -> (kp [B,K,2], desc, valid [B,K]); desc is [B,K,8]
    int32 words for ORB, [B,K,128] float32 for SIFT."""
    f = cfg.features
    if f.detector_type == "orb":
        kps = fast_ops.detect_fast(grays, f.max_keypoints, f.fast_threshold, f.border_margin,
                                   f.fast_arc_length)
        desc = orb_ops.describe_orb_batch(
            grays, kps.xy, kps.valid, n_bits=f.brief_bits, pattern_radius=f.brief_patch_radius,
            blur_sigma=f.brief_blur_sigma, orientation_radius=f.orientation_radius,
        )
        return kps.xy, desc.bits, kps.valid
    return sift_ops.detect_and_describe(grays, f)


def _match_pairs(desc_q, valid_q, desc_t, valid_t, cfg: MosaicConfig) -> match_ops.Matches:
    if cfg.features.detector_type == "orb":
        return match_ops.match_hamming_crosscheck(desc_q, valid_q, desc_t, valid_t)
    return match_ops.match_l2_ratio(desc_q, valid_q, desc_t, valid_t, cfg.match.ratio)


def _pair_seed(seed: int, frame: int) -> int:
    """A 64-bit generator seed from (seed, frame), mixed by splitmix64 so that
    every bit depends on both: the CPU generator keeps only the low 32 bits
    of its seed."""
    m = (1 << 64) - 1
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(frame) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15 & m
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & m
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & m
    return z ^ (z >> 31)


def pair_uniforms(seed: int, first_frame: int, b: int, cfg: MosaicConfig,
                  device: torch.device) -> torch.Tensor:
    """RANSAC draws [B, num_hypotheses, K] for pairs first_frame..first_frame+B-1,
    pair f from a generator seeded with (seed, f)."""
    nh, k = cfg.ransac.num_hypotheses, cfg.features.max_keypoints
    out = torch.empty((b, nh, k), dtype=torch.float32, device=device)
    for i in range(b):
        g = torch.Generator(device=device)
        g.manual_seed(_pair_seed(seed, first_frame + i))
        out[i] = torch.rand((nh, k), generator=g, device=device)
    return out


def match_and_fit(kps, descs, valids, kp0, desc0, valid0, uniforms: torch.Tensor,
                  cfg: MosaicConfig):
    """Matching and RANSAC for the pairs (frame i, frame i - 1) of a run of
    consecutive frames: kps/descs/valids [N, ...] of frames i, and the
    frame before the first (kp0, desc0, valid0). `uniforms` [N,
    num_hypotheses, K] are the pairs' draws. Returns (RANSAC result, the
    correspondences' validity [N, K])."""
    rc = cfg.ransac
    kp_prev = torch.cat([kp0[None], kps[:-1]], dim=0)
    desc_prev = torch.cat([desc0[None], descs[:-1]], dim=0)
    valid_prev = torch.cat([valid0[None], valids[:-1]], dim=0)
    m = _match_pairs(descs, valids, desc_prev, valid_prev, cfg)
    src, dst, mvalid = match_ops.gather_correspondences(kps, kp_prev, m)
    res = geo.ransac_homography(
        src, dst, mvalid,
        samples=geo.sample_indices(uniforms, mvalid),
        num_hypotheses=rc.num_hypotheses,
        reproj_threshold=rc.reproj_threshold,
        refine_iterations=rc.refine_iterations,
        min_matches=rc.min_matches,
    )
    return res, mvalid


def compose_chain(state: MosaicState, H_rels: torch.Tensor, r_ok: torch.Tensor,
                  weight_table: torch.Tensor, cfg: MosaicConfig):
    """The sequential 3x3 chain of a window: validate -> smooth -> compose.
    A match/RANSAC failure skips the frame (no warp, no blend, no history
    push); a validation failure degrades H_rel to identity and the frame is
    still blended at the previous pose. Returns (ok [B], H_abs [B, 3, 3],
    H_old, hbuf, hcount)."""
    st = cfg.stabilization
    dev = H_rels.device
    ok_seq = r_ok & geo.validate_homography(
        H_rels, st.translation_threshold, st.scale_threshold, st.perspective_threshold
    )
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    H_old, hbuf, hcount = state.H_old, state.hbuf, state.hcount
    H_abs_list = []
    for i in range(H_rels.shape[0]):
        H_v = torch.where(ok_seq[i], H_rels[i], eye)
        if st.enabled:
            hbuf2, hcount2, H_s = geo.smooth_homography_step(hbuf, hcount, H_v, weight_table)
        else:
            hbuf2, hcount2, H_s = hbuf, hcount, H_v
        hbuf = torch.where(r_ok[i], hbuf2, hbuf)
        hcount = torch.where(r_ok[i], hcount2, hcount)
        H_old = torch.where(r_ok[i], H_old @ H_s, H_old)
        H_abs_list.append(H_old)
    return ok_seq, torch.stack(H_abs_list), H_old, hbuf, hcount


def last_accepted_features(state: MosaicState, kps, descs, valids, blended_seq):
    """The last accepted frame's (kp, desc, valid), the next window's match
    target; the state's own when no frame of the window was accepted."""
    b = blended_seq.shape[0]
    any_ok = torch.any(blended_seq)
    last = (b - 1 - torch.argmax(torch.flip(blended_seq, (0,)).to(torch.int32))).reshape(1)
    kp_l = torch.where(any_ok, kps.index_select(0, last)[0], state.kp)
    desc_l = torch.where(any_ok, descs.index_select(0, last)[0], state.desc)
    valid_l = torch.where(any_ok, valids.index_select(0, last)[0], state.kp_valid)
    return kp_l, desc_l, valid_l


def paint_band(canvas: torch.Tensor, union_coarse: torch.Tensor, frames_cm: torch.Tensor,
               H_abs: torch.Tensor, blended: torch.Tensor, frame_hw: Tuple[int, int],
               canvas_hw: Tuple[int, int], band: Optional[Tuple[int, int]] = None,
               rows=None, gather_coarse=None, halo_rows=None):
    """The paint stage of a window: warp the frames [B, 3, H, W] by H_abs,
    weight them and blend the `blended` ones into the canvas one after the
    other (everything but the blend recurrence is batched).

    `canvas` [3, b - a, Wc] and `union_coarse` hold the canvas rows band =
    [a, b) (default: all of them) and their coarse cells. rows = ((l, h),
    (lo, hi)) are the rows whose blend weights the band reads and the rows
    warped and weighted for them (``parallel/mesh.py:paint_rows``; default:
    the whole canvas). The exchanges of a band with the others' are given
    as functions, identities for the whole canvas: gather_coarse(x) maps
    the band's coarse rows [N, rows, Gw] to the whole coarse grid,
    halo_rows(x) the band's [b - a, Wc] map to its rows [l, h). Returns the
    band's (canvas, union_coarse)."""
    hf, wf = frame_hw
    hc, wc = canvas_hw
    a, b = band or (0, hc)
    (l, h), (lo, hi) = rows or ((0, hc), (0, hc))
    new = warp_batch(frames_cm, inverse_maps(H_abs), hi - lo, wc, row0=lo)
    wq = warp_ops.frame_weight_eval(warp_ops.frame_weight_params(H_abs, hf, wf, hc, wc),
                                    hc, wc, row0=lo, rows=hi - lo)
    wnew = warp_ops.frame_weight_with_holes(new, wq)[:, l - lo : h - lo]
    new = new[:, :, l - lo : h - lo]
    wnew = torch.where(blended[:, None, None], wnew, torch.zeros_like(wnew))
    own = slice(a - l, b - l)
    # the mosaic mask before frame i is union0 OR the first i footprints
    coarse = torch.cat([union_coarse[None], warp_ops.coarse_footprint(wnew[:, own])])
    if gather_coarse is not None:
        coarse = gather_coarse(coarse)
    union0, foot = coarse[0], coarse[1:]
    inc = torch.cumsum(foot.to(torch.int32), dim=0) > 0
    unions_before = torch.cat([union0[None], union0[None] | inc[:-1]], dim=0)
    ups = warp_ops.upsample_weight(warp_ops.coarse_union_distance(unions_before), hc, wc,
                                   row0=l, rows=h - l)
    cover0 = torch.amax(canvas, dim=0) > 0.0
    if halo_rows is not None:
        cover0 = halo_rows(cover0)
    incc = torch.cumsum((wnew > 0.0).to(torch.int32), dim=0) > 0
    covers_before = torch.cat([cover0[None], cover0[None] | incc[:-1]], dim=0)
    wold = torch.where(covers_before, torch.clamp(ups - warp_ops.CELL_PX / 2.0, min=1.0),
                       torch.zeros_like(ups))
    alpha, beta = warp_ops.blend_weights_smoothed(wnew, wold)
    for i in range(frames_cm.shape[0]):
        canvas = warp_ops.blend_apply_cm(canvas, new[i, :, own], wnew[i, own], wold[i, own],
                                         alpha[i, own], beta[i, own])
    cell = warp_ops.CELL_PX
    return canvas, union_coarse | inc[-1][a // cell : -(-b // cell)]


def make_step_body(frame_shape: Tuple[int, int, int], cfg: MosaicConfig):
    """The window step for a frame shape and config.

    Returns step(state, frames_u8 [B, H, W, 3], seed, fweight, weight_table,
    uniforms=None) -> (state, WindowAux). `uniforms` [B, num_hypotheses, K]
    are the pairs' RANSAC draws; by default they come from pair_uniforms."""
    _check_config(cfg)
    hf, wf = frame_shape[0], frame_shape[1]

    def step(state: MosaicState, frames: torch.Tensor, seed: int, fweight: torch.Tensor,
             weight_table: torch.Tensor, uniforms: Optional[torch.Tensor] = None):
        dev = state.canvas.device
        b = frames.shape[0]
        frames_cm = frames.to(torch.float32).permute(0, 3, 1, 2).contiguous()  # [B, 3, H, W]

        # --- 1. batched feature extraction ---
        with span("window.features", device_range=True):
            kps, descs, valids = _extract_features(color.bgr2gray(frames), cfg)

        # --- 2. batched pairwise match + RANSAC (pair i: frame i vs frame i-1) ---
        with span("window.match_ransac", device_range=True):
            if uniforms is None:
                uniforms = pair_uniforms(seed, int(state.frame_idx), b, cfg, dev)
            res, mvalid = match_and_fit(kps, descs, valids, state.kp, state.desc,
                                        state.kp_valid, uniforms, cfg)
        H_rels, r_ok = res.H, res.ok

        # --- 3. sequential 3x3 chain: validate -> smooth -> compose ---
        with span("window.chain", device_range=True):
            ok_seq, H_abs_seq, H_old, hbuf, hcount = compose_chain(
                state, H_rels, r_ok, weight_table, cfg)
        blended_seq = r_ok

        # --- 4. paint: everything but the blend recurrence is batched ---
        hc, wc = state.canvas.shape[1], state.canvas.shape[2]
        with span("window.paint", device_range=True):
            canvas, union = paint_band(state.canvas, state.union_coarse, frames_cm, H_abs_seq,
                                       blended_seq, (hf, wf), (hc, wc))

        # last ACCEPTED frame's features become the next matching target
        kp_l, desc_l, valid_l = last_accepted_features(state, kps, descs, valids, blended_seq)

        new_state = MosaicState(
            canvas=canvas, union_coarse=union, H_old=H_old,
            kp=kp_l, desc=desc_l, kp_valid=valid_l, hbuf=hbuf, hcount=hcount,
            frame_idx=state.frame_idx + b,
        )
        aux = WindowAux(num_matches=torch.sum(mvalid, dim=-1), num_inliers=res.num_inliers,
                        H_abs=H_abs_seq, ok=ok_seq, blended=blended_seq)
        return new_state, aux

    return step


def make_window_step(frame_shape: Tuple[int, int, int], cfg: MosaicConfig):
    """The single-window step (PyTorch runs eagerly: nothing to compile)."""
    return make_step_body(frame_shape, cfg)


def make_clip_step(frame_shape: Tuple[int, int, int], cfg: MosaicConfig, det_fn=None):
    """Multi-window step: runs W whole windows [W, B, H, Wd, 3] one after the
    other, carrying the state. Returns clip(state, windows, seed, fweight,
    wtable) -> (state, WindowAux stacked over W[, detections]).

    det_fn, if given, maps frames_u8 [N, H, W, 3] to a NamedTuple of tensors
    with N leading (e.g. ObjectDetector._infer_fn(...)). It runs once
    over all W*B frames of the clip after the window loop (detection carries
    nothing from frame to frame), and its outputs come back as [W, B, ...].
    Its memory grows with W*B, so a caller chunks a long clip."""
    body = make_step_body(frame_shape, cfg)

    def clip(state, windows, seed, fweight, wtable):
        auxs = []
        for w in range(windows.shape[0]):
            state, aux = body(state, windows[w], seed, fweight, wtable)
            auxs.append(aux)
        aux = WindowAux(*(torch.stack(f) for f in zip(*auxs)))
        if det_fn is None:
            return state, aux
        w, b = windows.shape[0], windows.shape[1]
        with span("clip.detect", device_range=True):
            dets = det_fn(windows.reshape((w * b,) + windows.shape[2:]))
        return state, aux, type(dets)(*(d.reshape((w, b) + d.shape[1:]) for d in dets))

    return clip


class VideMosaic:
    """Counterpart of the JAX package's VideMosaic, with its positional
    arguments in its order and ``device`` last.

    Frames are BGR uint8 arrays of a fixed shape (set by the first frame), or
    uint8 tensors already on the device. Runs on ``device`` (``cuda`` unless
    the caller asks for another). With ``output_dir``, every fourth window
    writes ``mosaic_progress.jpg`` there when ``show_intermediate`` is on and
    ``matches.jpg`` (``render_matches`` of the window's last two frames)
    when ``visualize`` is on, as the JAX class does."""

    def __init__(
        self,
        first_image,
        output_height_times: float = 2.0,
        output_width_times: float = 1.2,
        detector_type: str = "sift",
        show_intermediate: bool = True,
        output_dir: Optional[str] = None,
        visualize: bool = False,
        config: Optional[MosaicConfig] = None,
        seed: int = 0,
        device=None,
    ):
        if config is None:
            config = MosaicConfig(
                output_height_times=output_height_times,
                output_width_times=output_width_times,
            )
        if detector_type != config.features.detector_type:
            config = dataclasses.replace(
                config, features=dataclasses.replace(config.features, detector_type=detector_type)
            )
        _check_config(config)
        self.config = config
        self.detector_type = config.features.detector_type
        self.show_intermediate = show_intermediate
        self.output_dir = output_dir
        self.visualize = visualize
        self.device = resolve_device(device)
        self.seed = int(seed)

        first_image = np.asarray(first_image)
        h, w, c = first_image.shape
        self.frame_shape = (h, w, c)
        hc, wc = canvas_hw(self.frame_shape, config)
        if config.canvas_hw is not None:
            r0, c0 = config.seed_offset or (hc - h, int(wc / 2 - w / 2))
            self.w_offset = int(np.clip(r0, 0, hc - h))  # row offset
            self.h_offset = int(np.clip(c0, 0, wc - w))  # col offset
        else:
            # frame 0 sits at the bottom, centered in x
            self.w_offset = hc - h
            self.h_offset = int(wc / 2 - w / 2)
        self.canvas_shape = (hc, wc, c)

        self._fweight = torch.from_numpy(warp_ops.edge_distance_px(h, w)).to(self.device)
        self._wtable = geo.smoothing_weights(config.stabilization.history_size, self.device)
        self._step = make_window_step(self.frame_shape, config)
        self._clip = make_clip_step(self.frame_shape, config)
        self.state = self._init_state(first_image)

    def _init_state(self, first_image: np.ndarray) -> MosaicState:
        h, w, c = self.frame_shape
        hc, wc, _ = self.canvas_shape
        dev = self.device
        f = upload_frames(first_image, self.device)
        kp, desc, valid = _extract_features(color.bgr2gray(f)[None], self.config)
        canvas = torch.zeros((c, hc, wc), dtype=torch.float32, device=dev)
        canvas[:, self.w_offset : self.w_offset + h, self.h_offset : self.h_offset + w] = (
            f.to(torch.float32).permute(2, 0, 1)
        )
        seed_w = torch.zeros((hc, wc), dtype=torch.float32, device=dev)
        seed_w[self.w_offset : self.w_offset + h, self.h_offset : self.h_offset + w] = self._fweight
        s = self.config.stabilization.history_size
        return MosaicState(
            canvas=canvas,
            union_coarse=warp_ops.coarse_footprint(seed_w),
            H_old=torch.tensor(
                [[1.0, 0.0, self.h_offset], [0.0, 1.0, self.w_offset], [0.0, 0.0, 1.0]],
                dtype=torch.float32, device=dev,
            ),
            kp=kp[0], desc=desc[0], kp_valid=valid[0],
            hbuf=torch.eye(3, dtype=torch.float32, device=dev).repeat(s, 1, 1),
            hcount=torch.zeros((), dtype=torch.int64, device=dev),
            frame_idx=torch.ones((), dtype=torch.int64),
        )

    def process_window(self, frames, uniforms: Optional[torch.Tensor] = None) -> WindowAux:
        """Process a [B, H, W, 3] uint8 window of consecutive frames.
        `uniforms` optionally gives the pairs' RANSAC draws (see make_step_body).
        With auto_grow the canvas grows after the step when the window came
        near an edge (``_maybe_grow``: one read of the window's H_abs)."""
        frames = upload_frames(frames, self.device)
        self.state, aux = self._step(
            self.state, frames, self.seed, self._fweight, self._wtable, uniforms
        )
        pad = (0, 0)
        if self.config.auto_grow:
            pad = self._maybe_grow(aux)
        if self.output_dir and (self.visualize or self.show_intermediate):
            # a full-canvas read every fourth window, as the JAX class throttles it
            self._windows_seen = getattr(self, "_windows_seen", 0) + 1
            if self._windows_seen % 4 == 1:
                self._dump_intermediate(frames, aux, pad)
        return aux

    def _maybe_grow(self, aux: WindowAux) -> tuple:
        """Grow the canvas when the window's warped frames, or the next
        window's extrapolated from the last two frames' drift, come within
        ``grow_margin`` px of an edge: pad it (and ``union_coarse``) by
        multiples of ``grow_quantum`` px and shift H_old and the offsets to
        the new origin. Reads H_abs and the blended flags once (one device
        sync). Returns the (left, top) pad, (0, 0) without growth; aux.H_abs
        stays in the canvas coordinates from before the pad."""
        cfg = self.config
        h, w = self.frame_shape[:2]
        hc, wc, c = self.canvas_shape
        b = aux.H_abs.shape[0]
        host = torch.cat([aux.H_abs.reshape(b, 9), aux.blended.to(aux.H_abs.dtype)[:, None]],
                         dim=1).cpu().numpy()
        hs, blended = host[:, :9].reshape(b, 3, 3), host[:, 9] > 0
        corners_src = np.array(
            [[0.0, 0.0, 1.0], [w, 0.0, 1.0], [w, float(h), 1.0], [0.0, float(h), 1.0]]
        ).T
        xs_all, ys_all = [], []
        for Hm, ok in zip(hs, blended):
            if not ok:
                continue
            p = Hm.astype(np.float64) @ corners_src
            den = p[2]
            if np.any(den <= 1e-9):
                continue
            xs_all.append(p[0] / den)
            ys_all.append(p[1] / den)
        if not xs_all:
            return (0, 0)
        xs_f = np.concatenate(xs_all)
        ys_f = np.concatenate(ys_all)
        # look one window ahead: growth is checked after painting, so widen
        # the extent on the motion side by the centroid's drift over a window
        if len(xs_all) >= 2:
            n_ahead = len(hs)
            vx = float(np.mean(xs_all[-1]) - np.mean(xs_all[-2]))
            vy = float(np.mean(ys_all[-1]) - np.mean(ys_all[-2]))
            xs_f = np.concatenate([xs_f, xs_all[-1] + vx * n_ahead])
            ys_f = np.concatenate([ys_f, ys_all[-1] + vy * n_ahead])
        m, q = cfg.grow_margin, cfg.grow_quantum

        def need(amount):
            return int(np.ceil(max(amount, 0.0) / q) * q) if amount > 0 else 0

        left = need(m - xs_f.min())
        top = need(m - ys_f.min())
        right = need(xs_f.max() - (wc - 1 - m))
        bottom = need(ys_f.max() - (hc - 1 - m))
        if not (left or top or right or bottom):
            return (0, 0)
        st = self.state
        canvas = torch.nn.functional.pad(st.canvas, (left, right, top, bottom))
        cell = warp_ops.CELL_PX
        gh, gw = st.union_coarse.shape
        union = torch.zeros((gh + (top + bottom) // cell, gw + (left + right) // cell),
                            dtype=torch.bool, device=st.union_coarse.device)
        union[top // cell : top // cell + gh, left // cell : left // cell + gw] = st.union_coarse
        # shift @ H_old for the shift [[1, 0, left], [0, 1, top], [0, 0, 1]]
        H = st.H_old
        H_old = torch.stack([H[0] + left * H[2], H[1] + top * H[2], H[2]])
        self.state = st._replace(canvas=canvas, union_coarse=union, H_old=H_old)
        self.canvas_shape = (hc + top + bottom, wc + left + right, c)
        self.w_offset += top
        self.h_offset += left
        return (left, top)

    def process_clip(self, windows, det_fn=None):
        """Process [W, B, H, Wd, 3] uint8 windows in one call (see
        make_clip_step). Returns the stacked WindowAux, or (aux, detections
        as [W, B, ...]) when det_fn is given. As in the JAX class, the canvas
        does not grow here and no progress image is written: a clip that may
        leave the canvas goes through process_window, or gets a canvas sized
        beforehand (mosaic/prescan.py)."""
        clip = self._clip if det_fn is None else make_clip_step(self.frame_shape, self.config,
                                                                det_fn)
        self.state, *out = clip(self.state, upload_frames(windows, self.device), self.seed,
                                self._fweight, self._wtable)
        return out[0] if det_fn is None else tuple(out)

    def process_frame(self, frame_cur, frame_count: int = 0) -> bool:
        """Single-frame path. Returns True if the frame's homography was accepted."""
        aux = self.process_window(upload_frames(frame_cur, self.device)[None])
        return bool(aux.ok[0])

    @property
    def output_img(self) -> np.ndarray:
        """Canvas as a [Hc, Wc, 3] float array."""
        return self.state.canvas.permute(1, 2, 0).cpu().numpy()

    @property
    def output_img_u8(self) -> np.ndarray:
        """Canvas clipped to [0, 255] as a [Hc, Wc, 3] uint8 array."""
        return np.clip(self.output_img, 0, 255).astype(np.uint8)

    @property
    def H_old(self) -> np.ndarray:
        return self.state.H_old.cpu().numpy()

    def get_transformed_corners(self, frame, H) -> np.ndarray:
        """[4, 2] corners (0,0), (w,0), (w,h), (0,h) of `frame` warped by H."""
        h, w = frame.shape[:2]
        return geo.transform_corners(w, h, torch.as_tensor(H, dtype=torch.float32).cpu()).numpy()

    @staticmethod
    def draw_border(image: np.ndarray, corners: np.ndarray, color=(0, 0, 0),
                    thickness: int = 5) -> np.ndarray:
        """Draw the warped frame's border polygon on the mosaic, in the JAX
        class's closed-loop line order."""
        c = np.asarray(corners).reshape(-1, 2).astype(int)
        for i in range(c.shape[0] - 1, -1, -1):
            draw.line(image, tuple(c[i]), tuple(c[i - 1]), color, thickness)
        return image

    def render_matches(self, frame_prev, frame_cur) -> np.ndarray:
        """cv2.drawMatches-style picture of a frame pair: the current frame
        left of the previous one, each match a radius-3 circle at both ends
        and a line between them, in colours drawn from
        ``np.random.RandomState(0)`` in the JAX class's order. The features
        and matches are recomputed on the device and read once."""
        fc, fp = upload_frames(frame_cur, self.device), upload_frames(frame_prev, self.device)
        kp, desc, valid = _extract_features(color.bgr2gray(torch.stack([fc, fp])), self.config)
        m = _match_pairs(desc[:1], valid[:1], desc[1:], valid[1:], self.config)
        src, dst, ok = match_ops.gather_correspondences(kp[:1], kp[1:], m)
        host = torch.cat([src[0], dst[0], ok[0, :, None].to(src.dtype)], dim=1).cpu().numpy()
        src, dst, ok = host[:, :2], host[:, 2:4], host[:, 4] > 0
        h1, w1 = fc.shape[:2]
        h2, w2 = fp.shape[:2]
        canvas = np.zeros((max(h1, h2), w1 + w2, 3), np.uint8)
        canvas[:h1, :w1] = fc.cpu().numpy()
        canvas[:h2, w1:] = fp.cpu().numpy()
        rng = np.random.RandomState(0)
        for s, d in zip(src[ok], dst[ok]):
            colr = tuple(int(v) for v in rng.randint(64, 255, 3))
            p1 = (int(s[0]), int(s[1]))
            p2 = (int(d[0]) + w1, int(d[1]))
            draw.circle(canvas, p1, 3, colr, 1)
            draw.circle(canvas, p2, 3, colr, 1)
            draw.line(canvas, p1, p2, colr, 1)
        return canvas

    def _dump_intermediate(self, frames, aux: WindowAux, pad=(0, 0)) -> None:
        """Debug pictures in output_dir: mosaic_progress.jpg (the canvas with
        the window's last frame's border) with show_intermediate, and
        matches.jpg (the window's last frame pair) with visualize. `pad` is
        the (left, top) growth applied after the step; aux.H_abs is in the
        canvas coordinates from before it."""
        os.makedirs(self.output_dir, exist_ok=True)
        if self.show_intermediate:
            img = self.output_img_u8.copy()
            corners = self.get_transformed_corners(frames[-1], aux.H_abs[-1])
            self.draw_border(img, corners + np.asarray(pad, corners.dtype))
            imwrite_jpg(os.path.join(self.output_dir, "mosaic_progress.jpg"), img)
        if self.visualize and len(frames) >= 2:
            imwrite_jpg(os.path.join(self.output_dir, "matches.jpg"),
                        self.render_matches(frames[-2], frames[-1]))

    @staticmethod
    def findHomography(src_pts, dst_pts, seed: int = 0, samples=None, device=None):
        """Homography from correspondences [N, 2] by RANSAC (the window
        step's settings) -> (H [3, 3], inliers [N]) as numpy arrays. The
        hypotheses are `samples` [512, 4] when given (e.g. from the JAX
        package's draws), else drawn from a CPU generator seeded with
        `seed`, so the card and the CPU draw the same ones."""
        dev = resolve_device(device)
        src = torch.as_tensor(np.asarray(src_pts), dtype=torch.float32).reshape(-1, 2).to(dev)
        dst = torch.as_tensor(np.asarray(dst_pts), dtype=torch.float32).reshape(-1, 2).to(dev)
        valid = torch.ones((src.shape[0],), dtype=torch.bool, device=dev)
        if samples is None:
            g = torch.Generator()
            g.manual_seed(_pair_seed(seed, 0))
            samples = geo.sample_indices(torch.rand((512, src.shape[0]), generator=g).to(dev), valid)
        res = geo.ransac_homography(src, dst, valid, samples=torch.as_tensor(samples).to(dev))
        return res.H.cpu().numpy(), res.inliers.cpu().numpy()

    def process_first_frame(self, first_image) -> None:
        """Make `first_image`'s features the next match target."""
        gray = color.bgr2gray(upload_frames(first_image, self.device))
        kp, desc, valid = _extract_features(gray[None], self.config)
        self.state = self.state._replace(kp=kp[0], desc=desc[0], kp_valid=valid[0])

    def match(self, des_cur, des_prev, valid_cur=None, valid_prev=None) -> match_ops.Matches:
        """Match the current frame's descriptors [K, D] against the previous
        frame's with the detector's matcher (all valid by default)."""
        def tensor(x):
            if torch.is_tensor(x):
                return x.to(self.device)
            x = np.asarray(x)
            # ORB's packed uint32 words keep their bit pattern as int32
            return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(self.device)

        def flags(v, d):
            if v is None:
                return torch.ones((d.shape[0],), dtype=torch.bool, device=self.device)
            return tensor(v)

        dc, dp = tensor(des_cur), tensor(des_prev)
        return _match_pairs(dc, flags(valid_cur, dc), dp, flags(valid_prev, dp), self.config)

    def validate_homography(self, H) -> bool:
        """The window step's anti-shake check of a relative homography, read
        on the host."""
        st = self.config.stabilization
        return bool(geo.validate_homography(self._h(H), st.translation_threshold,
                                            st.scale_threshold, st.perspective_threshold))

    def smooth_homography(self, H) -> np.ndarray:
        """Push H into the smoothing history (``state.hbuf`` and
        ``state.hcount`` change, as in the JAX class) and return the
        smoothed homography."""
        hbuf, hcount, H_s = geo.smooth_homography_step(self.state.hbuf, self.state.hcount,
                                                       self._h(H), self._wtable)
        self.state = self.state._replace(hbuf=hbuf, hcount=hcount)
        return H_s.cpu().numpy()

    def warp(self, frame_cur, H) -> np.ndarray:
        """Warp one frame into the canvas by an absolute H (frame -> canvas)
        and blend it in against the mosaic's union weight; updates the canvas
        and its coarse union. Returns output_img."""
        hc, wc = self.canvas_shape[0], self.canvas_shape[1]
        frame_cm = upload_frames(frame_cur, self.device).to(torch.float32).permute(2, 0, 1)
        new_px, w_new = warp_ops.warp_frame_cm(frame_cm, self._fweight, self._h(H), hc, wc)
        w_old = warp_ops.union_weight(self.state.canvas, self.state.union_coarse, hc, wc)
        canvas, _ = warp_ops._blend_cm(self.state.canvas, w_old, new_px, w_new)
        union = self.state.union_coarse | warp_ops.coarse_footprint(w_new)
        self.state = self.state._replace(canvas=canvas, union_coarse=union)
        return self.output_img

    def _h(self, H) -> torch.Tensor:
        if not torch.is_tensor(H):
            H = torch.as_tensor(np.asarray(H, np.float32))
        return H.to(device=self.device, dtype=torch.float32)

    @property
    def _detector(self):
        """The ObjectDetector (with its defaults) on this stitcher's device,
        built at first use."""
        if not hasattr(self, "_detector_inst"):
            from rtvm_tpu_torch.detect.detector import ObjectDetector

            self._detector_inst = ObjectDetector(device=self.device)
        return self._detector_inst

    def detect_people(self, frame):
        """Person boxes of one BGR frame."""
        return self._detector.detect_people(frame)

    def detect_objects(self, image):
        """Multi-pass aerial detection on a BGR image (e.g. the mosaic)."""
        return self._detector.detect_objects(image)

    def checkpoint(self) -> dict:
        """Snapshot of the full state as numpy arrays, with the JAX package's
        keys and dtypes (so either package can restore it): ORB's words go
        out as uint32."""
        s = self.state
        desc = s.desc.cpu().numpy()
        if desc.dtype == np.int32:
            desc = desc.view(np.uint32)
        return {
            "canvas": s.canvas.cpu().numpy(),
            "union_coarse": s.union_coarse.cpu().numpy(),
            "H_old": s.H_old.cpu().numpy(),
            "kp": s.kp.cpu().numpy(),
            "desc": desc,
            "kp_valid": s.kp_valid.cpu().numpy(),
            "hbuf": s.hbuf.cpu().numpy(),
            "hcount": np.int32(s.hcount.item()),
            "frame_idx": np.int32(s.frame_idx.item()),
        }

    def restore(self, snap: dict) -> None:
        self.state = state_from_numpy(snap, self.device)
