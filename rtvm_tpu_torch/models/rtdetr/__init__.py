"""RT-DETR, the NMS-free transformer detector (``model.py``), and its
post-process (``postprocess.py``)."""
