"""Command-line interface, the counterpart of ``rtvm_tpu/cli.py``.

    python -m rtvm_tpu_torch mosaic <clip> [--output-dir DIR] [--hide]
        [--detector sift|orb] [--no-detect] [--no-nav] [--max-frames N]
        [--window B] [--per-frame-detect]
    python -m rtvm_tpu_torch mosaic --images-dir DIR [--output-dir DIR]
    python -m rtvm_tpu_torch slam <clip> [--output-dir DIR] [--max-frames N]
        [--viz-3d] [--webcam]
    python -m rtvm_tpu_torch terrain <image> [--output OUT.jpg]

The flags are the JAX CLI's, and as there a bare clip path means ``mosaic``.
A clip is a video file (decoded with cv2, where it is installed), or a
``.npy`` file of uint8 frames [N, H, W, 3]; images are JPEG or PNG files
(``io/imread.py``). Everything runs on ``cuda``. By default the mosaic
command also detects objects on the mosaic and writes the navigation map;
``--no-detect`` and ``--no-nav`` leave them out; ``--images-dir`` runs the
detection and the navigation map on each image of a directory instead.
``slam`` has no default clip (the JAX CLI falls back to a bundled video);
``--webcam`` needs cv2 and ``--viz-3d`` matplotlib. ``terrain`` writes its
picture as JPEG; ``--reconstruct-3d`` is not ported. The other subcommands
of the JAX CLI exist and raise NotImplementedError (ROADMAP.md, Queue 1
item 6).
"""

from __future__ import annotations

import argparse
import os
import sys

OTHER_COMMANDS = ("depth3d", "stereo-demo", "view", "web", "gui", "menu")
NOT_PORTED = "the {!r} command is not ported yet (ROADMAP.md, Queue 1 item 6: {})"
OTHER_ITEMS = {"depth3d": "depth3d/ with models/depthnet.py", "stereo-demo": "stereo/",
               "view": "viz/ with io/ply.py", "web": "the UI", "gui": "the UI",
               "menu": "menus.py"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtvm_tpu_torch",
                                description="aerial video mosaic on a CUDA device")
    sub = p.add_subparsers(dest="cmd")

    m = sub.add_parser("mosaic", help="stitch a video into a mosaic (default command)")
    m.add_argument("video_path", nargs="?", default=None)
    m.add_argument("--images-dir", default=None)
    m.add_argument("--output-dir", default=None)
    m.add_argument("--hide", action="store_true", help="no mosaic_progress.jpg")
    m.add_argument("--detector", default="sift", choices=["sift", "orb"])
    m.add_argument("--no-detect", action="store_true")
    m.add_argument("--no-nav", action="store_true")
    m.add_argument("--max-frames", type=int, default=None)
    m.add_argument("--window", type=int, default=None, help="frames per window step")
    m.add_argument("--per-frame-detect", action="store_true",
                   help="run batched YOLO on every frame and export Detections/")

    s = sub.add_parser("slam", help="visual odometry / SLAM on a video")
    s.add_argument("video_path", nargs="?", default=None)
    s.add_argument("--webcam", action="store_true")
    s.add_argument("--output-dir", default="test_output")
    s.add_argument("--max-frames", type=int, default=None)
    s.add_argument("--viz-3d", action="store_true", help="render trajectory PNG after run")

    t = sub.add_parser("terrain", help="terrain / soil analysis of an image")
    t.add_argument("image")
    t.add_argument("--output", default=None)
    t.add_argument("--reconstruct-3d", action="store_true")
    t.add_argument("--model", default="depth-anything-small")
    t.add_argument("--depth-scale", type=float, default=10.0)
    t.add_argument("--fast", action="store_true")
    t.add_argument("--no-vis", action="store_true")

    for name in OTHER_COMMANDS:
        o = sub.add_parser(name, help=f"not ported yet (ROADMAP.md, Queue 1 item 6: "
                                      f"{OTHER_ITEMS[name]})")
        o.add_argument("args", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    """Run the CLI. Returns the command's result: main()'s (stitcher, stats)
    or, with --images-dir, its per-image list; slam's (slam, trajectory);
    terrain's analysis."""
    argv = list(sys.argv[1:] if argv is None else argv)
    known = {"mosaic", "slam", "terrain", *OTHER_COMMANDS, "-h", "--help"}
    if argv and argv[0] not in known:
        argv = ["mosaic"] + argv
    elif not argv:
        argv = ["mosaic"]
    args = build_parser().parse_args(argv)

    if args.cmd == "slam":
        return _slam(args)
    if args.cmd == "terrain":
        return _terrain(args)
    if args.cmd != "mosaic":
        raise NotImplementedError(NOT_PORTED.format(args.cmd, OTHER_ITEMS[args.cmd]))
    import dataclasses

    from rtvm_tpu_torch.config import MosaicConfig, PipelineConfig
    from rtvm_tpu_torch.pipelines.mosaic_pipeline import main as run

    mc = MosaicConfig()
    if args.window:
        mc = dataclasses.replace(mc, window_size=args.window)
    return run(
        video_path=args.video_path,
        images_dir=args.images_dir,
        output_dir=args.output_dir,
        show_intermediate=not args.hide,
        detector_type=args.detector,
        enable_detection=not args.no_detect,
        enable_navigation=not args.no_nav,
        per_frame_detection=args.per_frame_detect,
        config=PipelineConfig(mosaic=mc),
        max_frames=args.max_frames,
    )


def _slam(args):
    """The slam command; returns run_slam_on_video's (slam, trajectory)."""
    from rtvm_tpu_torch.slam.runner import (run_slam_on_video, run_slam_webcam,
                                            visualize_trajectory_3d)

    if args.webcam:
        return run_slam_webcam()
    if args.video_path is None:
        raise ValueError("no video given: pass a video path or a .npy file of uint8 frames")
    out = run_slam_on_video(args.video_path, args.output_dir, max_frames=args.max_frames)
    if args.viz_3d:
        print(visualize_trajectory_3d(os.path.join(args.output_dir, "slam_trajectory_final.npy")))
    return out


def _terrain(args):
    """The terrain command; returns the analysis."""
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.io.jpeg import imwrite_jpg
    from rtvm_tpu_torch.slam.terrain import TerrainSoilAnalyzer

    if args.reconstruct_3d:
        raise NotImplementedError("--reconstruct-3d is not ported yet (ROADMAP.md, Queue 1 "
                                  "item 6: depth3d/ with models/depthnet.py)")
    out = args.output or "terrain_analysis.jpg"
    if not out.lower().endswith((".jpg", ".jpeg")):
        raise ValueError(f"the port writes the terrain picture as JPEG; {out!r} names another "
                         "format")
    img = imread(args.image)
    if img is None:
        sys.exit(f"cannot read image: {args.image}")
    analyzer = TerrainSoilAnalyzer()
    res = analyzer.analyze_image(img)
    print(analyzer.report(res))
    imwrite_jpg(out, analyzer.visualize(img, res))
    print(f"Визуализация: {out}")
    return res
