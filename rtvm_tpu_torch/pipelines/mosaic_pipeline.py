"""The mosaic pipeline driver, the counterpart of
``rtvm_tpu/pipelines/mosaic_pipeline.py``: ``run_mosaic`` stitches a whole
clip window by window (or in fused multi-window calls), and ``main`` writes
the outputs: ``mosaic.jpg``, ``mosaic_progress.jpg`` (``show_intermediate``)
and ``Detections/frame_NNNNN_detected.jpg`` (``per_frame_detection``), then
runs the detection on the mosaic (``debug_watershed.jpg``) and the
navigation map (``debug_texture_mask.jpg``, ``navigation_map.jpg``), with
the progress lines every 50 frames in Russian and English (the web UI parses
stdout) and ``update_callback(frame_count, mosaic_u8, progress_pct)``.

The device is ``cuda`` unless the caller passes ``device``. The host reads
from the device only where the JAX driver does: to grow the canvas, for the
callback, for the per-frame detections, for the progress image, and the
windows' diagnostics once after the loop. Unlike the JAX driver, no window
waits for the device (that was a workaround for the TPU's transport); the
clock stops after ``torch.cuda.synchronize()``.

The loops' stages (``utils/timing.py``) record the spans inside them with
each window's (or fused chunk's) request id; on CUDA the driver waits for
the device once before the loop, records a CUDA event after each window's
or chunk's step, and sets the stage's ``done`` from it after the last sync.

Unlike the JAX driver, ``main`` does not catch an exception of the
detection on the mosaic or of the navigation map: a run whose detection
fails raises instead of writing a partial output. ``main(images_dir=...)``
takes the image-directory route (``pipelines/images_pipeline.py``) instead.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from rtvm_tpu_torch.config import MosaicConfig, PipelineConfig
from rtvm_tpu_torch.device import resolve_device, upload_frames
from rtvm_tpu_torch.io.jpeg import imwrite_jpg
from rtvm_tpu_torch.io.video import VideoReader
from rtvm_tpu_torch.mosaic.stitcher import VideMosaic, WindowAux
from rtvm_tpu_torch.utils.image import crop_black_areas, scale_to_screen
from rtvm_tpu_torch.utils.timing import StageTimer


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rereadable(source):
    """The pre-scan reads the clip once before the stitch reads it again: a
    one-shot iterator of frames is kept as a list."""
    if isinstance(source, (str, os.PathLike, np.ndarray)) or iter(source) is not source:
        return source
    return list(source)


def _total_hint(reader: VideoReader, max_frames: Optional[int]) -> Optional[int]:
    total = reader.frame_count_hint if reader.frame_count_hint > 0 else None
    if total and max_frames:
        total = min(total, max_frames)  # pct against what will actually run
    return total


def run_mosaic(
    video_path,
    config: Optional[MosaicConfig] = None,
    detector_type: str = "sift",
    update_callback: Optional[Callable] = None,
    callback_every: int = 10,
    max_frames: Optional[int] = None,
    timer: Optional[StageTimer] = None,
    per_frame_detector=None,
    detections_dir: Optional[str] = None,
    show_intermediate: bool = False,
    visualize: bool = False,
    viz_dir: Optional[str] = None,
    fused: bool = False,
    device=None,
) -> tuple[VideMosaic, dict]:
    """Stitch a whole clip (any source ``io.video.VideoReader`` reads).
    Returns (stitcher, stats).

    update_callback(frame_count, mosaic_u8, progress_pct) fires every
    `callback_every` windows. With a per_frame_detector every frame goes
    through its ``_run_pass(frames, 640, 0.25, 0.45)``, and the frames with a
    detection are drawn and written to `detections_dir`.

    fused=True runs chunks of ``RTVM_CLIP_CHUNK`` (default 6) full windows
    per ``process_clip`` call, with the per-frame detector's
    ``_infer_fn(640, 0.25, 0.45)`` inside it; the callback fires once per
    chunk and once at 100%. With auto_grow the canvas is sized by the
    pre-scan first; when there is per-window host work (detections_dir,
    show_intermediate, visualize) or the pre-scan cannot track the clip, the
    run falls back to the window loop, as in the JAX driver."""
    dev = resolve_device(device)
    timer = timer or StageTimer()
    if fused:
        needs_host_work = detections_dir is not None or show_intermediate or visualize
        if not needs_host_work and config is not None and config.auto_grow:
            from rtvm_tpu_torch.mosaic.prescan import prescan_canvas_from_video

            video_path = _rereadable(video_path)
            with timer.stage("prescan"):
                pre = prescan_canvas_from_video(video_path, max_frames=max_frames, device=dev)
            if pre is not None:
                config = dataclasses.replace(
                    config, canvas_hw=pre[0], seed_offset=pre[1], auto_grow=False
                )
                print(
                    f"run_mosaic: предварительное сканирование — холст "
                    f"{pre[0][0]}x{pre[0][1]}, смещение {pre[1]}"
                )
            else:
                needs_host_work = True  # reactive growth requires the window loop
        if needs_host_work:
            print(
                "run_mosaic: fused=True понижен до оконного цикла "
                "(detections_dir/визуализация/неотслеживаемый рост требуют "
                "пооконной обработки)"
            )
        else:
            return _run_mosaic_fused(
                video_path, config=config, detector_type=detector_type,
                update_callback=update_callback, max_frames=max_frames,
                timer=timer, per_frame_detector=per_frame_detector, device=dev,
            )
    config = config or MosaicConfig()
    reader = VideoReader(video_path, window=config.window_size, max_frames=max_frames)
    total_hint = _total_hint(reader, max_frames)

    with timer.stage("init"):
        mosaic = VideMosaic(
            reader.first_frame,
            output_height_times=config.output_height_times,
            output_width_times=config.output_width_times,
            detector_type=detector_type,
            config=config,
            show_intermediate=show_intermediate,
            visualize=visualize,
            output_dir=viz_dir if (show_intermediate or visualize) else None,
            device=dev,
        )

    frame_count = 1
    per_frame_dets = []
    aux_pending = []  # kept on the device; read once after the loop
    timer.device_reference(dev)
    t0 = time.perf_counter()
    windows = 0
    first_done = [None, 1]  # (t after first window, frames it covered)
    for frames, n_valid in reader.windows():
        timer.request = windows
        with timer.stage("window") as rec:
            win = upload_frames(frames, dev)
            aux = mosaic.process_window(win)
            timer.mark_done(rec)
        aux_pending.append((aux, n_valid))
        if per_frame_detector is not None:
            with timer.stage("detect"):
                dets = per_frame_detector._run_pass(win[:n_valid], imgsz=640, conf=0.25,
                                                    iou=0.45)
            per_frame_dets.extend(dets)
            if detections_dir is not None:
                os.makedirs(detections_dir, exist_ok=True)
                for i, d in enumerate(dets):
                    if d:
                        with timer.stage("draw"):
                            vis = per_frame_detector.draw_detections(frames[i], d)
                        with timer.stage("export"):
                            imwrite_jpg(os.path.join(
                                detections_dir, f"frame_{frame_count + i:05d}_detected.jpg"), vis)
        windows += 1
        frame_count += n_valid
        if first_done[0] is None:
            _sync(dev)
            first_done[:] = [time.perf_counter(), frame_count]
        if frame_count % 50 < config.window_size:
            pct = 100.0 * frame_count / total_hint if total_hint else 0.0
            print(f"Обработан кадр {frame_count}/{total_hint or '?'} ({pct:.1f}%)")
            print(f"Processed frame {frame_count}/{total_hint or '?'} ({pct:.1f}%)")
        if update_callback is not None and windows % callback_every == 0:
            pct = 100.0 * frame_count / total_hint if total_hint else 0.0
            update_callback(frame_count, mosaic.output_img_u8, pct)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    timer.request = None
    timer.resolve_done()
    ok_frames = 0
    if aux_pending:
        flags = torch.stack([a.ok for a, _ in aux_pending]).cpu().numpy()
        for ok, (_, n_valid) in zip(flags, aux_pending):
            ok_frames += int(ok[:n_valid].sum())

    stats = {
        "frames": frame_count,
        "accepted": ok_frames,
        "elapsed_s": elapsed,
        "fps": frame_count / elapsed if elapsed > 0 else 0.0,
    }
    if per_frame_detector is not None:
        stats["per_frame_detections"] = sum(len(d) for d in per_frame_dets)
    if first_done[0] is not None and frame_count > first_done[1]:
        # steady-state wall rate past the first window
        steady_el = elapsed - (first_done[0] - t0)
        if steady_el > 0:
            stats["steady_fps"] = (frame_count - first_done[1]) / steady_el
            stats["first_window_s"] = first_done[0] - t0
    return mosaic, stats


def _run_mosaic_fused(
    video_path,
    config: Optional[MosaicConfig] = None,
    detector_type: str = "sift",
    update_callback: Optional[Callable] = None,
    max_frames: Optional[int] = None,
    timer: Optional[StageTimer] = None,
    per_frame_detector=None,
    device=None,
) -> tuple[VideMosaic, dict]:
    """Fused path: the reader's worker decodes while the device stitches the
    previous chunk of ``RTVM_CLIP_CHUNK`` windows (with the per-frame
    detection inside the same ``process_clip`` call); the last, short window
    runs through ``process_window``. ``decode_wait`` in the timer is the time
    the loop waited for the decoder."""
    dev = resolve_device(device)
    config = config or MosaicConfig()
    timer = timer or StageTimer()
    B = config.window_size
    chunk = int(os.environ.get("RTVM_CLIP_CHUNK", "6"))

    reader = VideoReader(video_path, window=B, queue_depth=2 * chunk, max_frames=max_frames)
    with timer.stage("init"):
        mosaic = VideMosaic(reader.first_frame, detector_type=detector_type, config=config,
                            device=dev)

    det_fn = None
    if per_frame_detector is not None:
        det_fn = per_frame_detector._infer_fn(640, 0.25, 0.45)

    total_hint = _total_hint(reader, max_frames)
    t0 = time.perf_counter()
    auxes, detss = [], []
    n_full = 0
    n_frames = 0
    first_done = [None, 0]  # (t after first dispatch, windows it covered)
    buf: list = []  # full windows accumulating toward one chunk
    tail: list = []  # the final short window, if any

    def dispatch(windows):
        nonlocal n_full
        with timer.stage("clip") as rec:
            out = mosaic.process_clip(upload_frames(np.stack(windows), dev), det_fn=det_fn)
            timer.mark_done(rec)
            a, d = out if det_fn is not None else (out, None)
            auxes.append(a)
            detss.append(d)
        n_full += len(windows)
        if first_done[0] is None:
            _sync(dev)
            first_done[:] = [time.perf_counter(), n_full]
        if update_callback is not None:
            done = 1 + n_full * B
            pct = min(99.0, 100.0 * done / total_hint) if total_hint else 0.0
            with timer.stage("callback"):
                update_callback(done, mosaic.output_img_u8, pct)

    timer.device_reference(dev)
    it = reader.windows()
    while True:
        timer.request = len(auxes)  # the chunk being gathered
        with timer.stage("decode_wait"):
            item = next(it, None)
        if item is None:
            break
        frames, n_valid = item
        n_frames += n_valid
        if n_valid == B:
            buf.append(frames)
        else:
            tail.append((frames, n_valid))
        if len(buf) == chunk:
            dispatch(buf)
            buf = []
    if buf:
        dispatch(buf)
    aux = dets = None
    if auxes:
        aux = WindowAux(*(torch.cat(f) for f in zip(*auxes)))
        if det_fn is not None:
            dets = type(detss[0])(*(torch.cat(f) for f in zip(*detss)))
    tail_ok = 0
    for frames, n_valid in tail:
        with timer.stage("window") as rec:
            tail_aux = mosaic.process_window(upload_frames(frames, dev))
            timer.mark_done(rec)
        tail_ok += int(tail_aux.ok[:n_valid].sum())
    _sync(dev)
    elapsed = time.perf_counter() - t0
    timer.request = None
    timer.resolve_done()

    frames_total = 1 + n_frames
    ok = (int(aux.ok.sum()) if aux is not None else 0) + tail_ok
    if update_callback is not None:
        update_callback(frames_total, mosaic.output_img_u8, 100.0)
    stats = {
        "frames": frames_total,
        "accepted": ok,
        "elapsed_s": elapsed,
        "fps": frames_total / elapsed if elapsed > 0 else 0.0,
        "decode_wait_s": timer.totals.get("decode_wait", 0.0),
        "fused_windows": n_full,
    }
    if first_done[0] is not None and n_full > first_done[1]:
        # steady-state wall rate: everything after the first chunk
        steady_el = elapsed - (first_done[0] - t0)
        steady_fr = frames_total - (1 + first_done[1] * B)
        if steady_el > 0:
            stats["steady_fps"] = steady_fr / steady_el
            stats["first_chunk_s"] = first_done[0] - t0
    if dets is not None:
        stats["det_scores_shape"] = tuple(dets.scores.shape)
    return mosaic, stats


def main(
    video_path=None,
    update_callback: Optional[Callable] = None,
    show_intermediate: bool = True,
    output_dir: Optional[str] = None,
    images_dir: Optional[str] = None,
    detector_type: str = "sift",
    enable_detection: bool = True,
    enable_navigation: bool = True,
    per_frame_detection: bool = False,
    config: Optional[PipelineConfig] = None,
    max_frames: Optional[int] = None,
    device=None,
):
    """Stitch the clip and write ``mosaic.jpg`` (cropped to the painted
    area, scaled to fit the screen) into `output_dir` (default: the working
    directory); with ``show_intermediate``, ``mosaic_progress.jpg`` as the
    stitch goes; with ``per_frame_detection``, ``Detections/`` from
    ``ObjectDetector(model=config.detect.model, load_world=False)`` (the
    JAX driver builds it with the open-vocabulary model too, which only the
    detection on the mosaic uses). With ``enable_detection``,
    ``ObjectDetector(model=config.detect.model).detect_objects`` on the
    written mosaic (``stats["detections"]``, ``debug_watershed.jpg``); with
    ``enable_navigation``, ``navigation_map.jpg`` and
    ``debug_texture_mask.jpg``. The stages are timed as ``detect_init``,
    ``detect_mosaic``, ``navigate`` and ``navigation_jpg``. With `images_dir`, it runs
    ``images_pipeline.process_images_dir`` on that directory instead and
    returns its result, as the JAX ``main`` does.

    `video_path` is any source ``io.video.VideoReader`` reads; there is no
    default clip. Returns (stitcher, stats)."""
    if images_dir is not None:
        from rtvm_tpu_torch.pipelines.images_pipeline import process_images_dir

        return process_images_dir(images_dir, output_dir or ".", config or PipelineConfig(),
                                  device=device)
    if video_path is None:
        raise ValueError("no video given: pass a video path, a .npy file or a uint8 array "
                         "of frames")
    dev = resolve_device(device)
    config = config or PipelineConfig()
    out_dir = output_dir or "."
    os.makedirs(out_dir, exist_ok=True)

    timer = StageTimer()
    det = None
    if per_frame_detection:
        try:
            from rtvm_tpu_torch.detect.detector import ObjectDetector

            det = ObjectDetector(model=config.detect.model, load_world=False, device=dev)
        except NotImplementedError:
            raise
        except Exception as e:
            print(f"Предупреждение: покадровая детекция недоступна: {e}")
    mosaic, stats = run_mosaic(
        video_path,
        config=config.mosaic,
        detector_type=detector_type,
        update_callback=update_callback,
        max_frames=max_frames,
        timer=timer,
        per_frame_detector=det,
        detections_dir=os.path.join(out_dir, "Detections") if det else None,
        show_intermediate=show_intermediate,
        viz_dir=out_dir,
        device=dev,
    )
    print(f"Скорость сшивки: {stats['fps']:.1f} кадров/с ({stats['frames']} кадров)")

    output_img = mosaic.output_img_u8
    cropped = crop_black_areas(output_img, threshold=80, margin=30)
    scaled = scale_to_screen(cropped)
    mosaic_path = os.path.join(out_dir, "mosaic.jpg")
    with timer.stage("mosaic_jpg"):
        imwrite_jpg(mosaic_path, scaled)
    print(f"Мозаика сохранена: {mosaic_path}")

    detections = []
    if enable_detection:
        from rtvm_tpu_torch.detect.detector import ObjectDetector

        with timer.stage("detect_init"):
            mosaic_detector = ObjectDetector(model=config.detect.model, device=dev)
        with timer.stage("detect_mosaic"):
            detections = mosaic_detector.detect_objects(scaled, debug_dir=out_dir)
        stats["detections"] = len(detections)
        counts: dict = {}
        for d in detections:
            counts[d["class"]] = counts.get(d["class"], 0) + 1
        for cls, n in sorted(counts.items()):
            print(f"  {cls}: {n}")

    if enable_navigation:
        from rtvm_tpu_torch.navigate.mapping import analyze_for_navigation

        with timer.stage("navigate"):
            nav = analyze_for_navigation(scaled, detections, debug_dir=out_dir, device=dev)
        nav_path = os.path.join(out_dir, "navigation_map.jpg")
        with timer.stage("navigation_jpg"):
            imwrite_jpg(nav_path, nav)
        print(f"Карта навигации сохранена: {nav_path}")

    if update_callback is not None:
        update_callback(stats["frames"], output_img, 100.0)
    print(timer.report())
    trace_path = os.environ.get("RTVM_TRACE")
    if trace_path:
        print(f"Трассировка сохранена: {timer.write_chrome_trace(trace_path)}")
    return mosaic, stats
