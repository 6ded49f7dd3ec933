"""rtvm_tpu_torch — the PyTorch/CUDA port of rtvm_tpu, one slice at a time.

The port covers the streaming mosaic stitcher (``mosaic.stitcher.VideMosaic``)
with either detector, SIFT or ORB, the per-frame YOLO detection that
``process_clip(det_fn=...)`` runs after the stitch
(``detect.detector.ObjectDetector``, ``models.yolo``), the pipeline driver
(``pipelines.mosaic_pipeline``, ``cli``), the detection on the mosaic (the
open-vocabulary ``models.yolo.world``, CLAHE, tiles, ``detect.classical``) and
the navigation map (``navigate``), the image-directory route
(``pipelines.images_pipeline`` with the JPEG/PNG reader ``io.imread``), and
visual odometry, SLAM and the terrain analysis (``slam``), and the trainers
(``models.yolo.train_synth``, ``models.yolo.train_world``,
``models.train_depth``) with checkpoints in the JAX package's format. The two kernels the JAX package wrote in
Pallas for the TPU are hand-written CUDA here (``csrc/warp.cu``,
``csrc/patches.cu``), with two more for the paint (``csrc/union.cu``,
``csrc/weight.cu``); ``kernels.py`` builds them with ``nvcc`` at first use,
loads them with ctypes and launches them. The host algorithms the JAX package
borrows from cv2 and its A* router are C++ in ``csrc_host/``
(``navigate/native.py``, built by the same routine with ``g++``). Everything else
is plain PyTorch.

The package imports neither ``jax`` nor anything of ``rtvm_tpu``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; without a card and
without an explicit device they raise (``device.resolve_device``).
"""

import torch

__version__ = "0.1.0"

# Homographies and geometry must stay in full float32 (the JAX package forces
# Precision.HIGHEST for the same reason: rounded H entries move warped corners
# by pixels and compound along the H chain). Stated here rather than relied on
# as PyTorch's defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from rtvm_tpu_torch.config import MosaicConfig, PipelineConfig  # noqa: E402,F401
from rtvm_tpu_torch.mosaic.stitcher import VideMosaic  # noqa: E402,F401


def main(*args, **kwargs):
    """Reference-parity pipeline entry (see rtvm_tpu_torch.pipelines.mosaic_pipeline.main)."""
    from rtvm_tpu_torch.pipelines.mosaic_pipeline import main as _main

    return _main(*args, **kwargs)
