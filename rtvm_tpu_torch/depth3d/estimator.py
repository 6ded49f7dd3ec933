"""Monocular depth estimation (counterpart of ``rtvm_tpu/depth3d/estimator.py``):
the model registry, per-video frame sampling and depth normalised to [0, 1]
with 1 = near.

The JAX package first tries a HuggingFace hub model (``transformers``, after
a socket probe of huggingface.co). That needs a download, so the port has no
hub route: it goes straight to DepthNet (``models/depthnet.py``) from
``weights/depthnet.npz`` where the checkpoint is found, random weights
otherwise. The luminance-and-gradient heuristic is taken only when building
or loading the net fails, as in JAX. Nothing falls back at estimate time: an
error on the card raises.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device

# Registry mirroring the reference's model menu (depth_to_3d.py:81-93). The
# names are accepted as in JAX; every one of them runs DepthNet here.
MODEL_REGISTRY = {
    "glpn": "vinvino02/glpn-nyu",
    "dpt-large": "Intel/dpt-large",
    "midas": "Intel/dpt-hybrid-midas",
    "depth-anything-base": "LiheYoung/depth-anything-base-hf",
    "depth-anything-small": "LiheYoung/depth-anything-small-hf",
    "depth-anything-v2-base": "depth-anything/Depth-Anything-V2-Base-hf",
    "depth-anything-v2-large": "depth-anything/Depth-Anything-V2-Large-hf",
    "zoedepth": "Intel/zoedepth-nyu-kitti",
    "depthpro": "apple/DepthPro-hf",
}


class MonocularDepthEstimator:
    """``backend`` is ``"depthnet"`` (the JAX package's ``"flax"``) or, when
    the net could not be built, ``"heuristic"``. ``prefer_hub`` is accepted
    for the JAX signature and does nothing (no hub route)."""

    def __init__(self, model: str = "depth-anything-small", prefer_hub: bool = True,
                 device=None):
        self.model_name = model
        self.device = resolve_device(device)
        self.backend = "heuristic"
        self.checkpoint = None
        self.net = None
        try:  # built and loaded on the host: only this may fall back
            from rtvm_tpu_torch.models.depthnet import build_depthnet

            self.checkpoint = self._find_depth_weights()
            net = build_depthnet(self.checkpoint, device="cpu")
            if self.checkpoint is not None:
                print(f"Загружены веса глубины: {self.checkpoint}")
        except Exception as e:  # the JAX package's one fallback: no net, the heuristic
            print(f"Предупреждение: сеть глубины недоступна ({e}); эвристика")
            return
        self.net = net.to(self.device)  # an error on the card raises
        self.backend = "depthnet"

    @staticmethod
    def _find_depth_weights() -> Optional[str]:
        """weights/depthnet.npz in the working directory, its weights/ or
        the checkout's weights/."""
        repo_weights = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "weights"
        )
        for d in (".", "weights", repo_weights):
            p = os.path.join(d, "depthnet.npz")
            if os.path.exists(p):
                return p
        return None

    def estimate_depth(self, image_bgr: np.ndarray) -> np.ndarray:
        """[H, W, 3] BGR uint8 -> [H, W] float32 normalised depth in [0, 1]
        (1 = near). The net runs at the image's own size."""
        img = torch.from_numpy(np.ascontiguousarray(image_bgr)).to(self.device)
        if self.net is not None:
            x = img.flip(-1).permute(2, 0, 1)[None].to(torch.float32) / 255.0
            with torch.no_grad():
                d = self.net(x)[0, 0]
        else:
            d = self._heuristic_depth(img)
        d = d - d.min()
        return (d / torch.clamp(d.max(), min=1e-6)).cpu().numpy()

    @staticmethod
    def _heuristic_depth(image_bgr: torch.Tensor) -> torch.Tensor:
        """Deterministic proxy: brightness + vertical position prior + local
        detail (textured, bright and lower regions read as closer). Not a
        learned estimate. image_bgr [H, W, 3] uint8 on any device."""
        from rtvm_tpu_torch.ops import color, filters

        g = color.bgr2gray(image_bgr) / 255.0
        detail = filters.box_blur(torch.abs(g - filters.gaussian_blur(g, 3.0)), 15)
        hgt = torch.linspace(0.0, 1.0, image_bgr.shape[0], device=g.device)[:, None]
        d = (0.45 * g + 0.35 * hgt.expand(g.shape)
             + 0.2 * detail / torch.clamp(detail.max(), min=1e-6))
        return filters.gaussian_blur(d, 2.0)

    def estimate_depth_video(self, video_path, frame_step: int = 30,
                             max_frames: int = 10) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Sample every frame_step-th frame (reference depth_to_3d.py:178-222)
        of anything ``io/video.py`` reads (a ``.npy`` clip, an array, a video
        file where cv2 is installed). Yields (frame_bgr, depth)."""
        from rtvm_tpu_torch.io.video import open_frames

        frames, _, _, release = open_frames(video_path)
        taken = 0
        try:
            for idx, frame in enumerate(frames):
                if taken >= max_frames:
                    break
                if idx % frame_step == 0:
                    frame = np.array(frame, dtype=np.uint8)
                    yield frame, self.estimate_depth(frame)
                    taken += 1
        finally:
            release()
