"""The image-directory route, the counterpart of
``rtvm_tpu/pipelines/images_pipeline.py``: detection and a navigation map for
each image of a directory, written to ``Detections/``.

Images are read with the port's own reader (``io/imread.py``: JPEG and PNG,
no cv2). Unlike the JAX route, a failure of the detection or of the
navigation map raises instead of printing a warning and going on, as the
port's ``main`` does (ROADMAP.md, Queue 3 item 18).
"""

from __future__ import annotations

import glob
import os

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.io.imread import imread
from rtvm_tpu_torch.io.jpeg import imwrite_jpg


def process_images_dir(images_dir: str, output_dir: str, config, device=None) -> list:
    """For each ``*.jpg``, ``*.png`` and ``*.jpeg`` of `images_dir` (the JAX
    route's patterns and order), ``ObjectDetector(model=config.detect.model)
    .detect_objects``, then ``{name}_detected.jpg`` (``draw_detections``) and
    ``{name}_navigation.jpg`` (``analyze_for_navigation``) in
    ``output_dir/Detections``. The detector is built once, at the first
    readable image. Returns [{"image": path, "detections": [...]}, ...]."""
    dev = resolve_device(device)
    det_dir = os.path.join(output_dir, "Detections")
    os.makedirs(det_dir, exist_ok=True)
    paths = sorted(
        glob.glob(os.path.join(images_dir, "*.jpg"))
        + glob.glob(os.path.join(images_dir, "*.png"))
        + glob.glob(os.path.join(images_dir, "*.jpeg"))
    )
    results = []
    detector = None
    for p in paths:
        img = imread(p)
        if img is None:
            continue
        name = os.path.splitext(os.path.basename(p))[0]
        if detector is None:
            from rtvm_tpu_torch.detect.detector import ObjectDetector

            detector = ObjectDetector(model=config.detect.model, device=dev)
        detections = detector.detect_objects(img)
        imwrite_jpg(os.path.join(det_dir, f"{name}_detected.jpg"),
                    detector.draw_detections(img, detections))
        from rtvm_tpu_torch.navigate.mapping import analyze_for_navigation

        nav = analyze_for_navigation(img, detections, device=dev)
        imwrite_jpg(os.path.join(det_dir, f"{name}_navigation.jpg"), nav)
        results.append({"image": p, "detections": detections})
        print(f"Обработано изображение {name}: {len(detections)} объектов")
    return results
