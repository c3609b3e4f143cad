"""hnet: a Swin-T or darknet backbone + FPN, with Mask R-CNN (masks and
keypoints), FCOS, panoptic segmentation and classification headers at
per-task amplifications and the cross-header confliction losses, for
inference and training, and the SRGAN aux (port of ``hd_yolo_tpu/hnet/``)."""

from .fcos import FCOS  # noqa: F401
from .fpn import FeaturePyramidNetwork, PanopticFeatureConnector  # noqa: F401
from .heads import ClassificationHead, PanopticSegHead  # noqa: F401
from .hnet import DarkNetBackbone, HNet  # noqa: F401
from .mask_rcnn import MaskRCNN  # noqa: F401
from .swin import SwinTransformer  # noqa: F401
