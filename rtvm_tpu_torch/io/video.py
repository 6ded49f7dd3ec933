"""Host-side frame reader with background prefetch, the counterpart of
``rtvm_tpu/io/video.py``: a worker thread batches frames into [B, H, W, 3]
uint8 windows while the device stitches the previous one.

A source is one of:
- a video path, decoded with cv2 (imported on that route only; without cv2
  it raises ImportError: the card has no cv2, so a clip reaches it as an
  array or a ``.npy`` file);
- a uint8 array [N, H, W, 3] of BGR frames, or the path of a ``.npy`` file
  holding one (loaded with ``mmap_mode="r"``);
- any other iterable of [H, W, 3] uint8 BGR frames.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

NO_DECODER = (
    "decoding a video file needs OpenCV (cv2), which is not installed here; pass the "
    "frames as a uint8 array [N, H, W, 3], the path of a .npy file holding one, or an "
    "iterable of [H, W, 3] uint8 frames"
)


def _is_path(source) -> bool:
    return isinstance(source, (str, os.PathLike))


def open_frames(source) -> Tuple[Iterator[np.ndarray], float, int, Callable[[], None]]:
    """(frame iterator, fps, frame count or 0 when unknown, release) for
    any source this module reads."""
    if _is_path(source) and os.fspath(source).endswith(".npy"):
        source = np.load(os.fspath(source), mmap_mode="r")
    if isinstance(source, np.ndarray):
        if source.ndim != 4 or source.shape[-1] != 3 or source.dtype != np.uint8:
            raise ValueError(f"expected uint8 frames [N, H, W, 3], got {source.shape} "
                             f"{source.dtype}")
        return iter(source), 30.0, int(source.shape[0]), lambda: None
    if _is_path(source):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(NO_DECODER) from e
        path = os.fspath(source)
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")

        def decoded():
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield frame

        return (decoded(), cap.get(cv2.CAP_PROP_FPS) or 30.0,
                int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), cap.release)
    n = len(source) if hasattr(source, "__len__") else 0
    return (np.asarray(f, np.uint8) for f in source), 30.0, n, lambda: None


class VideoReader:
    """Threaded frame reader yielding [B, H, W, 3] uint8 windows.

    Frame 0 is held out as ``first_frame`` (it seeds the stitcher). The last
    window is padded by repeating the last frame; ``n_valid`` in the yielded
    tuple says how many leading frames are real. With ``max_frames``, at
    most that many frames are read, frame 0 included."""

    def __init__(self, source, window: int = 16, queue_depth: int = 4,
                 max_frames: Optional[int] = None):
        self.window = window
        self.max_frames = max_frames
        frames, self.fps, self.frame_count_hint, self._release = open_frames(source)
        first = next(frames, None)
        if first is None:
            self._release()
            raise ValueError(f"no frames in {source if _is_path(source) else 'the source'}")
        self.first_frame = np.array(first, dtype=np.uint8)  # a writable copy (an .npy maps read-only)
        self.frame_shape = self.first_frame.shape
        self._frames = frames
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _worker(self):
        b = self.window
        buf = []
        produced = 0
        last = self.first_frame
        try:
            for frame in self._frames:
                if self.max_frames is not None and produced + 1 >= self.max_frames:
                    break
                last = frame
                buf.append(frame)
                produced += 1
                if len(buf) == b:
                    self._q.put((np.stack(buf), b))
                    buf = []
            if buf:
                n = len(buf)
                buf.extend([last] * (b - n))
                self._q.put((np.stack(buf), n))
        except Exception as e:  # handed to the consumer, raised in windows()
            self._error = e
        finally:
            self._release()
            self._q.put(None)

    def windows(self) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (frames [B, H, W, 3] uint8, n_valid); frame 0 is not in them."""
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item


def read_video_windows(source, window: int = 16, max_frames: Optional[int] = None):
    """Returns (first_frame, iterator over (window, n_valid))."""
    r = VideoReader(source, window=window, max_frames=max_frames)
    return r.first_frame, r.windows()


class SeekableVideo:
    """Random access to a video file's frames, decoded with cv2 (imported
    here only; without cv2 the constructor raises ImportError, as on the
    card). ``frame_count`` is the container's count (0 when unknown)."""

    def __init__(self, path: str):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(NO_DECODER) from e
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(os.fspath(path))
        self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def read(self, index: int) -> Optional[np.ndarray]:
        """Frame `index` as [H, W, 3] uint8 BGR, or None when it cannot be read."""
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, index)
        ok, frame = self._cap.read()
        return frame if ok else None

    def close(self) -> None:
        self._cap.release()
