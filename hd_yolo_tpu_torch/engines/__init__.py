"""Validation, evaluation / export and checkpoints of the port (``hd_yolo_tpu/engines``)."""
