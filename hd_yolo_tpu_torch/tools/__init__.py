"""Command-line tools of the port (``python -m hd_yolo_tpu_torch.tools.<name>``)."""
