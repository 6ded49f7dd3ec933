"""Command-line interface, the counterpart of ``rtvm_tpu/cli.py``.

    python -m rtvm_tpu_torch mosaic <clip> [--output-dir DIR] [--hide]
        [--detector sift|orb] [--no-detect] [--no-nav] [--max-frames N]
        [--window B] [--per-frame-detect]

The flags are the JAX CLI's, and as there a bare clip path means ``mosaic``.
The clip is a video file (decoded with cv2, where it is installed), a
``.npy`` file of uint8 frames [N, H, W, 3], or a directory of images
(``--images-dir``, not ported). It runs on ``cuda``. By default the mosaic
command also detects objects on the mosaic and writes the navigation map;
``--no-detect`` and ``--no-nav`` leave them out. The other subcommands of
the JAX CLI exist and raise NotImplementedError (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import argparse
import sys

OTHER_COMMANDS = ("slam", "depth3d", "terrain", "stereo-demo", "view", "web", "gui", "menu")


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
    for name in OTHER_COMMANDS:
        o = sub.add_parser(name, help="not ported yet (ROADMAP.md, Queue 1 item 6)")
        o.add_argument("args", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    """Run the CLI; the mosaic command returns main()'s (stitcher, stats)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    known = {"mosaic", *OTHER_COMMANDS, "-h", "--help"}
    if argv and argv[0] not in known:
        argv = ["mosaic"] + argv
    elif not argv:
        argv = ["mosaic"]
    args = build_parser().parse_args(argv)

    if args.cmd != "mosaic":
        raise NotImplementedError(
            f"the {args.cmd!r} command is not ported yet (ROADMAP.md, Queue 1 item 6)")
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
