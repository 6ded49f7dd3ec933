"""Command-line interface, the counterpart of ``rtvm_tpu/cli.py``.

    python -m rtvm_tpu_torch mosaic <clip> [--output-dir DIR] [--hide]
        [--detector sift|orb] [--no-detect] [--no-nav] [--max-frames N]
        [--window B] [--per-frame-detect]
    python -m rtvm_tpu_torch mosaic --images-dir DIR [--output-dir DIR]
    python -m rtvm_tpu_torch slam <clip> [--output-dir DIR] [--max-frames N]
        [--viz-3d] [--webcam]
    python -m rtvm_tpu_torch depth3d <clip | image | DIR> [--output-dir DIR]
        [--multi-view] [--angle-mode auto|uniform|manual] [--frame-step N]
        [--max-frames N] [--single-frame] [--model NAME]
    python -m rtvm_tpu_torch terrain <image> [--output OUT.jpg|OUT.png]
        [--reconstruct-3d [--fast] [--depth-scale S] [--no-vis]]
    python -m rtvm_tpu_torch stereo-demo [--output-dir DIR]
    python -m rtvm_tpu_torch view <file.ply | file.obj> [--out OUT.png]
        [--backend auto|matplotlib|offscreen] [--size WxH]
    python -m rtvm_tpu_torch web [--host HOST] [--port PORT]
    python -m rtvm_tpu_torch gui
    python -m rtvm_tpu_torch menu

The flags are the JAX CLI's, and as there a bare clip path means ``mosaic``.
A clip is a video file (decoded with cv2, where it is installed), or a
``.npy`` file of uint8 frames [N, H, W, 3]; images are JPEG or PNG files
(``io/imread.py``). Everything runs on ``cuda``. By default the mosaic
command also detects objects on the mosaic and writes the navigation map;
``--no-detect`` and ``--no-nav`` leave them out; ``--images-dir`` runs the
detection and the navigation map on each image of a directory instead.
``slam`` has no default clip (the JAX CLI falls back to a bundled video);
``--webcam`` needs cv2 and ``--viz-3d`` matplotlib. ``depth3d`` takes a
directory (or ``--multi-view``) to the multi-view fusion, a ``.jpg``,
``.jpeg`` or ``.png`` to the single-image route and anything else to the
video route; DepthNet runs from ``weights/depthnet.npz`` (``depth3d/``;
``--model`` is accepted and every name runs DepthNet). ``terrain`` writes
its picture as JPEG or PNG; ``--reconstruct-3d`` adds the depth PNG, the
cloud, the mesh and the depth panels in the working directory.
``stereo-demo`` runs SGM on the synthetic pair and writes
``stereo_left.png`` and ``stereo_disparity.png``. ``view`` renders a cloud
or mesh to a PNG: ``offscreen`` is the port's z-buffer rasterizer at
``--size``, ``matplotlib`` needs matplotlib, and ``auto`` takes matplotlib
for at most 150,000 points where it is installed (the JAX rule) and the
rasterizer otherwise, saying so (the card has no matplotlib). ``web`` serves
the web UI (``ui/web_app.py``), ``gui`` opens the tkinter window (where
tkinter and a display exist) and ``menu`` the text menus (``menus.py``).
"""

from __future__ import annotations

import argparse
import os
import sys

COMMANDS = ("mosaic", "slam", "depth3d", "terrain", "stereo-demo", "view", "web", "gui", "menu")
MATPLOTLIB_MAX_POINTS = 150_000  # view --backend auto: the JAX CLI's limit for matplotlib


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

    d = sub.add_parser("depth3d", help="monocular depth -> 3D reconstruction")
    d.add_argument("input", help="video file or .npy clip, image file, or directory of images")
    d.add_argument("--model", default="depth-anything-small")
    d.add_argument("--output-dir", default=None)
    d.add_argument("--single-frame", action="store_true")
    d.add_argument("--multi-view", action="store_true")
    d.add_argument("--angle-mode", default="auto", choices=["auto", "uniform", "manual"])
    d.add_argument("--frame-step", type=int, default=30)
    d.add_argument("--max-frames", type=int, default=8)

    t = sub.add_parser("terrain", help="terrain / soil analysis of an image")
    t.add_argument("image")
    t.add_argument("--output", default=None)
    t.add_argument("--reconstruct-3d", action="store_true")
    t.add_argument("--model", default="depth-anything-small")
    t.add_argument("--depth-scale", type=float, default=10.0)
    t.add_argument("--fast", action="store_true")
    t.add_argument("--no-vis", action="store_true")

    sd = sub.add_parser("stereo-demo", help="synthetic stereo depth demo")
    sd.add_argument("--output-dir", default=".")

    v = sub.add_parser("view", help="render a .ply/.obj to PNG")
    v.add_argument("path")
    v.add_argument("--out", default=None)
    v.add_argument("--backend", choices=["auto", "matplotlib", "offscreen"], default="auto",
                   help="offscreen = the z-buffer rasterizer at --size")
    v.add_argument("--size", default="1920x1080", help="offscreen render size WxH")

    w = sub.add_parser("web", help="start the web UI")
    w.add_argument("--host", default="127.0.0.1")
    w.add_argument("--port", type=int, default=5000)

    sub.add_parser("gui", help="start the desktop GUI")
    sub.add_parser("menu", help="interactive text menu (reference-style)")
    return p


def main(argv=None):
    """Run the CLI. Returns the command's result: main()'s (stitcher, stats)
    or, with --images-dir, its per-image list; slam's (slam, trajectory);
    depth3d's pipeline result; terrain's analysis; stereo-demo's (left,
    right, disparity); the path view wrote."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in {*COMMANDS, "-h", "--help"}:
        argv = ["mosaic"] + argv
    elif not argv:
        argv = ["mosaic"]
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.cmd == "slam":
        return _slam(args)
    if args.cmd == "depth3d":
        return _depth3d(args)
    if args.cmd == "terrain":
        return _terrain(args)
    if args.cmd == "stereo-demo":
        return _stereo_demo(args)
    if args.cmd == "view":
        return _view(args, parser)
    if args.cmd == "web":
        from rtvm_tpu_torch.ui.web_app import main as web_main

        return web_main(args.host, args.port)
    if args.cmd == "gui":
        from rtvm_tpu_torch.ui.gui import main as gui_main

        return gui_main()
    if args.cmd == "menu":
        from rtvm_tpu_torch.menus import main_menu

        return main_menu()
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


def _depth3d(args):
    """The depth3d command; returns the pipeline's result dict."""
    from rtvm_tpu_torch.depth3d.pipeline import (process_multiple_images_to_3d,
                                                 process_single_image, process_video_to_3d_model)

    if os.path.isdir(args.input) or args.multi_view:
        import glob

        paths = sorted(
            glob.glob(os.path.join(args.input, "*.jpg")) + glob.glob(os.path.join(args.input, "*.png"))
        ) if os.path.isdir(args.input) else [args.input]
        return process_multiple_images_to_3d(paths, args.output_dir, args.model, args.angle_mode)
    if args.input.lower().endswith((".jpg", ".png", ".jpeg")):
        return process_single_image(args.input, args.output_dir, args.model)
    return process_video_to_3d_model(
        args.input, args.output_dir, args.model,
        frame_step=args.frame_step, max_frames=args.max_frames,
        single_frame=args.single_frame,
    )


def _terrain(args):
    """The terrain command; returns the analysis."""
    from rtvm_tpu_torch.io.imread import imread
    from rtvm_tpu_torch.io.png import imwrite
    from rtvm_tpu_torch.slam.terrain import TerrainSoilAnalyzer

    out = args.output or "terrain_analysis.jpg"
    img = imread(args.image)
    if img is None:
        sys.exit(f"cannot read image: {args.image}")
    analyzer = TerrainSoilAnalyzer()
    res = analyzer.analyze_image(img)
    print(analyzer.report(res))
    imwrite(out, analyzer.visualize(img, res))
    print(f"Визуализация: {out}")
    if args.reconstruct_3d:
        from rtvm_tpu_torch.depth3d.pipeline import ImageTerrainReconstructor

        r = ImageTerrainReconstructor(args.model, args.depth_scale, fast=args.fast)
        print(r.process(args.image, visualize=not args.no_vis))
    return res


def _stereo_demo(args):
    """The stereo-demo command; returns (left, right, disparity)."""
    import numpy as np

    from rtvm_tpu_torch.io.png import imwrite_png
    from rtvm_tpu_torch.stereo.depth import StereoDepthEstimator, demo_stereo_depth

    left, right, disp = demo_stereo_depth()
    os.makedirs(args.output_dir, exist_ok=True)
    imwrite_png(os.path.join(args.output_dir, "stereo_left.png"), left)
    imwrite_png(os.path.join(args.output_dir, "stereo_disparity.png"),
                StereoDepthEstimator.colorize_disparity(disp))
    v = disp[disp > 0]
    print(f"Диспаритет: медиана {float(np.median(v)):.1f}px, валидных {len(v)}")
    return left, right, disp


def _view(args, parser):
    """The view command; returns the path of the picture written."""
    from rtvm_tpu_torch.io.ply import read_obj_mesh, read_ply_points

    backend = args.backend
    if backend == "auto":
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            backend = "offscreen"
            print("view: matplotlib is not installed; rendering with the rasterizer")
        else:
            n = (len(read_obj_mesh(args.path)[0]) if args.path.endswith(".obj")
                 else len(read_ply_points(args.path)[0]))
            backend = "offscreen" if n > MATPLOTLIB_MAX_POINTS else "matplotlib"
    if backend == "offscreen":
        from rtvm_tpu_torch.viz.render import render_offscreen

        try:
            w, h = (int(x) for x in args.size.lower().split("x"))
        except ValueError:
            parser.error(f"--size must look like 1920x1080, got {args.size!r}")
        out = render_offscreen(args.path, args.out, width=w, height=h)
    else:
        from rtvm_tpu_torch.viz.pointcloud_viewer import view_matplotlib, view_mesh_matplotlib

        out = (view_mesh_matplotlib if args.path.endswith(".obj") else view_matplotlib)(
            args.path, args.out)
    print(out)
    return out
