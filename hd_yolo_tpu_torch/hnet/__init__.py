"""hnet: Swin-T backbone + FPN, with Mask R-CNN, panoptic segmentation and
classification headers at per-task amplifications and the cross-header
confliction losses, for inference and training (port of
``hd_yolo_tpu/hnet/``)."""

from .fpn import FeaturePyramidNetwork, PanopticFeatureConnector  # noqa: F401
from .heads import ClassificationHead, PanopticSegHead  # noqa: F401
from .hnet import HNet  # noqa: F401
from .mask_rcnn import MaskRCNN  # noqa: F401
from .swin import SwinTransformer  # noqa: F401
