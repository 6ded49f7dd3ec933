"""SLAM drivers (counterpart of ``rtvm_tpu/slam/runner.py``): SLAM over a
clip with the trajectory saved as ``.npy`` and ``.txt``, the webcam loop and
the 3-D trajectory plot.

The clip is read with ``io/video.py:VideoReader``, so a ``.npy`` file or a
uint8 array works everywhere (a video file needs cv2). ``show``, the webcam
loop and the plot need cv2 or matplotlib, imported on those routes only; the
card has neither, and those routes raise ImportError there.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from rtvm_tpu_torch.io.video import VideoReader
from rtvm_tpu_torch.slam.vo import SimpleSLAM, default_camera_matrix

NO_DISPLAY = "showing frames needs OpenCV (cv2), which is not installed here"


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(NO_DISPLAY) from e
    return cv2


DATA_DIR = "Data"  # the reference's clip folder, relative to the working directory


def get_video_files(data_dir: str = DATA_DIR) -> list:
    """The .mp4, .avi and .mov clips of `data_dir` (default ``Data/`` of the
    working directory), sorted."""
    vids = []
    for ext in ("*.mp4", "*.avi", "*.mov"):
        vids.extend(glob.glob(os.path.join(data_dir, ext)))
    return sorted(vids)


def run_slam_on_video(video, output_dir: str = "test_output", show: bool = False,
                      max_frames: Optional[int] = None, device=None):
    """SimpleSLAM over the clip's frames (at most `max_frames`), then
    ``slam_trajectory_final.npy`` and ``.txt`` (with the JAX version's
    header lines) in `output_dir`. Returns (slam, trajectory [N, 3])."""
    reader = VideoReader(video, window=16, max_frames=max_frames)
    h, w = reader.first_frame.shape[:2]
    slam = SimpleSLAM(default_camera_matrix(w, h), device=device)
    cv2 = _cv2() if show else None

    def frames():
        yield reader.first_frame
        for win, n_valid in reader.windows():
            yield from win[:n_valid]

    count = 0
    for frame in frames():
        slam.process_frame(frame)
        count += 1
        if count % 30 == 0:
            print(f"Кадр {count}: отслеживается {slam.vo.last_num_tracked}, "
                  f"инлайеров {slam.vo.last_num_inliers}, ключевых кадров {len(slam.keyframes)}")
        if show:
            cv2.imshow("SLAM", slam.vo.draw_trajectory_overlay(frame))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break

    os.makedirs(output_dir, exist_ok=True)
    traj = np.asarray(slam.vo.trajectory)
    np.save(os.path.join(output_dir, "slam_trajectory_final.npy"), traj)
    name = os.path.basename(os.fspath(video)) if isinstance(video, (str, os.PathLike)) else "frames"
    with open(os.path.join(output_dir, "slam_trajectory_final.txt"), "w") as f:
        f.write(f"# SLAM trajectory: {name}\n")
        f.write(f"# frames: {count}, keyframes: {len(slam.keyframes)}\n")
        f.write("# x y z\n")
        for p in traj:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    print(f"Траектория сохранена: {output_dir}/slam_trajectory_final.npy ({len(traj)} точек)")
    return slam, traj


def run_slam_webcam(camera_id: int = 0, width: int = 640, height: int = 480, device=None):
    """SLAM on a webcam with its overlay; 'q' quits, 'r' resets."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(camera_id)
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open camera {camera_id}")
    slam = None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if slam is None:
            h, w = frame.shape[:2]
            slam = SimpleSLAM(default_camera_matrix(w, h), device=device)
        slam.process_frame(frame)
        cv2.imshow("SLAM webcam", slam.vo.draw_trajectory_overlay(frame))
        k = cv2.waitKey(1) & 0xFF
        if k == ord("q"):
            break
        if k == ord("r"):
            slam = None
    cap.release()
    cv2.destroyAllWindows()


def visualize_trajectory_3d(npy_path: str, save_path: Optional[str] = None) -> str:
    """A 3-D plot of a saved trajectory with its start and end marked, as
    a PNG beside it (matplotlib; raises ImportError without it)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the 3-D trajectory plot needs matplotlib, which is not installed "
                          "here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    traj = np.load(npy_path)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "g-", linewidth=1)
    ax.scatter(*traj[0], color="blue", s=60, label="start")
    ax.scatter(*traj[-1], color="red", s=60, label="end")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend()
    out = save_path or npy_path.replace(".npy", "_3d.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
