"""Class vocabularies and open-vocabulary name normalization: a copy of the
JAX package's ``detect/classes.py`` (pure Python; the port keeps its own copy
so that it imports nothing of ``rtvm_tpu``), plus the eight classes the
bundled aerial checkpoints were trained on (``SYNTH_AERIAL_CLASSES``, from
``rtvm_tpu/models/yolo/synth.py``).

Behavioral port of the reference's canonicalization table (_normalize_class_name,
reference main.py:351-411): open-vocab detector outputs are folded into a compact set
of canonical aerial classes, with 'building' absorbing the many structure synonyms.
"""

from __future__ import annotations

# COCO-80 names (order matters: class indices from standard YOLO checkpoints).
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck",
    "boat", "traffic light", "fire hydrant", "stop sign", "parking meter", "bench",
    "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "wine glass", "cup",
    "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

# Aerial open-vocabulary detection classes (reference main.py:53-64).
AERIAL_CLASSES = [
    "car", "truck", "bus", "van", "person", "dog", "cat",
    "building", "house", "roof", "shed", "barn", "garage",
    "greenhouse", "warehouse", "pool", "boat",
]

# The classes of the bundled checkpoints weights/*_aerial.npz, in their index
# order; the checkpoint's json names them too and wins where it exists.
SYNTH_AERIAL_CLASSES = ["person", "car", "truck", "bus", "building", "boat", "tent", "pool"]

# Canonical class -> every open-vocab name the reference folds into it
# (reference main.py:352-409, full enumeration; _REVERSE inverts at import).
# Beyond the reference list we keep a few extra synonyms (pickup/suv/ship/...)
# and substring fallbacks below — strict supersets that never change the
# mapping of any name the reference handles.
_SYNONYMS = {
    "car": ["car", "vehicle", "automobile", "van", "suv", "sedan"],
    "truck": ["truck", "pickup", "pickup truck", "lorry"],
    "bus": ["bus", "minibus"],
    "motorcycle": ["motorcycle", "motorbike"],
    "bicycle": ["bicycle"],
    "person": ["person", "people", "human", "pedestrian"],
    "fire": ["fire", "flame"],
    "smoke": ["smoke"],
    "explosion": ["explosion"],
    "dog": ["dog"],
    "cat": ["cat"],
    "bird": ["bird"],
    "animal": ["animal"],
    "building": [
        "building", "house", "roof", "structure", "shed", "barn", "garage",
        "greenhouse", "warehouse", "cottage", "cabin", "hut", "shelter",
        "rooftop", "construction", "facility", "residential building",
        "metal roof", "wooden building", "container", "storage", "outbuilding",
        "farmhouse", "pavilion", "canopy", "carport", "shack",
        # extras beyond the reference list
        "home", "residence", "apartment", "factory", "hangar", "silo", "tower",
        "chapel", "church", "station", "terminal", "kiosk", "booth",
    ],
    "boat": ["boat", "ship"],
    "airplane": ["airplane"],
    "helicopter": ["helicopter"],
    "drone": ["drone"],
    "pool": ["pool"],
    "tent": ["tent"],
    "solar_panel": ["solar panel", "solar_panel"],
    "fence": ["fence"],
    "garden_bed": ["garden bed", "garden_bed"],
    "horse": ["horse"],
    "sheep": ["sheep"],
    "cow": ["cow"],
}
_REVERSE = {syn: canon for canon, syns in _SYNONYMS.items() for syn in syns}
_CANONICAL = set(_SYNONYMS)


def normalize_class_name(name: str) -> str:
    """Canonicalize an open-vocabulary class name (reference main.py:351-411)."""
    n = name.strip().lower().replace("-", " ")
    if n in _REVERSE:
        return _REVERSE[n]
    if "fire" in n or "flame" in n:
        return "fire"
    if "smoke" in n:
        return "smoke"
    if "pool" in n or "swimming" in n:
        return "pool"
    if "solar" in n:
        return "solar_panel"
    if "tent" in n:
        return "tent"
    if any(k in n for k in ("build", "roof", "house")):
        return "building"
    return n.replace(" ", "_")


# Obstacle class groups used to build the navigation map (reference
# main.py:1073-1077: danger/vehicle/living exactly as below; static there is
# ['bicycle', 'building'] — we additionally treat explosion as danger and
# boat/pool/tent/solar_panel as static obstacles, classes the reference's nav
# stage silently ignores).
OBSTACLE_GROUPS = {
    "danger": {"fire", "smoke", "explosion"},  # 40 px buffer, weight 1.0
    "vehicle": {"car", "truck", "bus", "motorcycle"},  # 25 px, 0.9
    "living": {"person", "dog", "cat", "horse", "sheep", "cow", "bird"},  # 20 px, 0.85
    "static": {"bicycle", "building", "boat", "pool", "tent", "solar_panel"},  # 15 px, 0.7
}
