"""PyTorch port, the weight importers (``hd_yolo_tpu_torch/utils/import_swin.py``,
``import_maskrcnn.py``) against the JAX package's importers, f32 on the CPU.

* Swin: ``tests/fixtures/swin_tiny.pt`` (the upstream key layout) through
  the port's ``import_swin_state_dict`` and through JAX's, each model's
  two output levels on one input, atol 1e-4; a ``backbone.`` prefix, the
  recomputed buffers and unknown keys (reported), a missing key and a
  wrong shape (raised).
* Mask R-CNN and FPN: a torchvision-layout state dict made from a seed
  (as ``tests/test_import_swin.py`` makes swin's) through both importers:
  the FPN's levels atol 1e-4, the header's detections (validity and labels
  exact, boxes atol 1e-3 px, scores atol 1e-4, mask probabilities atol
  1e-3) and its box head's probabilities on fixed ROIs atol 1e-4, which
  holds the fc6 column order: the port keeps torch's (C, 7, 7), JAX
  permutes to (7, 7, C).  JAX's importer leaves the mask predictor's
  transposed-conv kernel unflipped, which flax needs flipped to compute
  torch's function; the test flips it on the JAX side (ROADMAP C.7).  The
  keypoint branch's keys load by name.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.hnet.fpn import FeaturePyramidNetwork as JaxFPN
from hd_yolo_tpu.hnet.mask_rcnn import MaskRCNN as JaxMaskRCNN
from hd_yolo_tpu.hnet.swin import SwinTransformer as JaxSwin
from hd_yolo_tpu.utils.import_maskrcnn import import_fpn_state_dict as jax_import_fpn
from hd_yolo_tpu.utils.import_maskrcnn import import_maskrcnn_state_dict as jax_import_mrcnn
from hd_yolo_tpu.utils.import_swin import import_swin_state_dict as jax_import_swin
from hd_yolo_tpu_torch.hnet import FeaturePyramidNetwork, MaskRCNN, SwinTransformer
from hd_yolo_tpu_torch.utils.import_maskrcnn import (import_fpn_state_dict,
                                                     import_maskrcnn_state_dict)
from hd_yolo_tpu_torch.utils.import_swin import import_swin_state_dict

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "swin_tiny.pt")
SWIN_KW = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 4), window_size=4, out_indices=(0, 1))
C, NC, CHANS = 32, 3, (16, 24, 32, 48)
MRCNN_KW = dict(num_classes=NC, anchor_sizes=(16.0, 32.0, 64.0, 128.0), pre_nms_topk=200,
                num_proposals=48, num_detections=16)


def swin_fixture():
    return torch.load(FIXTURE, map_location="cpu", weights_only=False)["state_dict"]


def test_swin_fixture_matches_jax_import(caplog):
    sd = swin_fixture()
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    want = JaxSwin(**SWIN_KW).apply({"params": jax_import_swin(sd, depths=(1, 1))}, jnp.asarray(x))
    m = SwinTransformer(**SWIN_KW)
    unused = import_swin_state_dict(sd, m)
    assert unused == []
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 8, 8, 32), (2, 4, 4, 64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)

    # mmdet's prefix, the buffers the port recomputes, and an unknown key
    extra = {f"backbone.{k}": v for k, v in sd.items()}
    extra["backbone.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16)
    extra["backbone.layers.0.blocks.0.attn_mask"] = torch.zeros(4, 16, 16)
    extra["backbone.head.weight"] = torch.zeros(3)
    m2 = SwinTransformer(**SWIN_KW)
    logger = logging.getLogger("hd_yolo_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="hd_yolo_tpu_torch"):
            assert import_swin_state_dict(extra, m2) == ["head.weight"]
    finally:
        logger.removeHandler(caplog.handler)
    assert "1 keys unused" in caplog.text
    for k, v in m2.state_dict().items():
        assert torch.equal(v, m.state_dict()[k]), k


def test_swin_import_raises_on_missing_or_misshapen_keys():
    sd = swin_fixture()
    missing = {k: v for k, v in sd.items() if k != "norm1.bias"}
    with pytest.raises(KeyError, match="norm1.bias"):
        import_swin_state_dict(missing, SwinTransformer(**SWIN_KW))
    bad = dict(sd)
    bad["patch_embed.proj.bias"] = torch.zeros(31)
    with pytest.raises(ValueError, match="patch_embed.proj.bias"):
        import_swin_state_dict(bad, SwinTransformer(**SWIN_KW))


def torchvision_sd(seed: int = 0, keypoints: int = 0):
    """A Mask R-CNN + FPN state dict in torchvision's key layout, with
    seeded weights: He-scaled kernels, small biases."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape, bias=True):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        sd[key + ".weight"] = torch.from_numpy(
            (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))
        if bias:
            out = shape[1] if key.endswith(("conv5_mask", "kps_score_lowres")) else shape[0]
            sd[key + ".bias"] = torch.from_numpy((rng.standard_normal(out) * 0.05)
                                                 .astype(np.float32))

    for i, c in enumerate(CHANS):
        put(f"fpn.inner_blocks.{i}", C, c, 1, 1)
        put(f"fpn.layer_blocks.{i}", C, C, 3, 3)
    put("fpn.extra_blocks.p6", C, C, 3, 3)
    put("fpn.extra_blocks.p7", C, C, 3, 3)
    put("rpn.head.conv", 256, C, 3, 3)
    put("rpn.head.cls_logits", 3, 256, 1, 1)
    put("rpn.head.bbox_pred", 12, 256, 1, 1)
    put("roi_heads.box_head.fc6", 1024, C * 49)
    put("roi_heads.box_head.fc7", 1024, 1024)
    put("roi_heads.box_predictor.cls_score", NC + 1, 1024)
    put("roi_heads.box_predictor.bbox_pred", 4 * (NC + 1), 1024)
    for i in range(4):
        put(f"roi_heads.mask_head.mask_fcn{i + 1}", 256, C if i == 0 else 256, 3, 3)
    put("roi_heads.mask_predictor.conv5_mask", 256, 256, 2, 2)
    put("roi_heads.mask_predictor.mask_fcn_logits", NC + 1, 256, 1, 1)
    for i in range(8 if keypoints else 0):
        put(f"roi_heads.keypoint_head.{2 * i}", 512, C if i == 0 else 512, 3, 3)
    if keypoints:
        put("roi_heads.keypoint_predictor.kps_score_lowres", 512, keypoints, 4, 4)
    return sd


@pytest.fixture(scope="module")
def imported():
    sd = torchvision_sd()
    rng = np.random.default_rng(1)
    raw = [rng.standard_normal((2, 16 >> i, 16 >> i, c)).astype(np.float32)
           for i, c in enumerate(CHANS)]
    fpn = FeaturePyramidNetwork(CHANS, C, extra_blocks=2)
    fpn.load_state_dict(import_fpn_state_dict(sd), strict=True)
    m = MaskRCNN(C, **MRCNN_KW)
    m.load_state_dict(import_maskrcnn_state_dict(sd), strict=True)
    jv = {"fpn": jax_import_fpn({k: v.numpy() for k, v in sd.items()}),
          "mrcnn": jax_import_mrcnn({k: v.numpy() for k, v in sd.items()}, in_channels=C)}
    # JAX's importer moves conv5_mask to flax's layout without the spatial
    # flip flax's ConvTranspose needs to compute torch's transposed conv
    # (ROADMAP C.7); flipped here, the JAX header computes torchvision's
    # function, which the port's torch-layout header computes as loaded
    deconv = jv["mrcnn"]["mask_head"]["deconv"]
    deconv["kernel"] = np.ascontiguousarray(deconv["kernel"][::-1, ::-1])
    return sd, raw, fpn.eval(), m.eval(), jv


def test_fpn_import_matches_jax(imported):
    _, raw, fpn, _, jv = imported
    want = JaxFPN(out_channels=C, extra_blocks=2).apply({"params": jv["fpn"]},
                                                        [jnp.asarray(f) for f in raw])
    with torch.no_grad():
        got = fpn([torch.from_numpy(f) for f in raw])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_maskrcnn_import_matches_jax(imported):
    _, raw, fpn, m, jv = imported
    with torch.no_grad():
        feats = fpn([torch.from_numpy(f) for f in raw])[:4]
        got = {k: v.numpy() for k, v in m.infer(feats, (64, 64)).items()}
        rois = torch.tensor([[[0.0, 0.0, 40.0, 40.0], [8.0, 4.0, 60.0, 30.0],
                              [20.0, 20.0, 28.0, 36.0]]] * 2)
        logits, _ = m.classify(feats, rois)
    jm = JaxMaskRCNN(**MRCNN_KW)
    jf = [jnp.asarray(f.numpy()) for f in feats]
    want = jax.tree.map(np.asarray, jm.apply({"params": jv["mrcnn"]}, jf, (64, 64),
                                             method=JaxMaskRCNN.infer))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert want["valid"].sum() >= 8
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-3)

    def box_head(mod, f, r):
        pooled, _ = mod._pool(f, r, 7)
        cls, _ = mod.box_head(pooled.reshape((-1,) + pooled.shape[2:]))
        return jax.nn.softmax(cls, -1)

    wl = jm.apply({"params": jv["mrcnn"]}, jf, jnp.asarray(rois.numpy()), method=box_head)
    np.testing.assert_allclose(logits.reshape(-1, NC + 1).numpy(), np.asarray(wl), rtol=0,
                               atol=1e-4)


def test_keypoint_keys_load_by_name():
    kp = torchvision_sd(keypoints=5)
    m = MaskRCNN(C, **MRCNN_KW, num_keypoints=5)
    m.load_state_dict(import_maskrcnn_state_dict(kp), strict=True)
    assert torch.equal(m.roi_heads.keypoint_predictor.kps_score_lowres.weight,
                       kp["roi_heads.keypoint_predictor.kps_score_lowres.weight"])
