"""PyTorch port: ``hd_yolo_tpu_torch/engines/val.py`` against the JAX
package's ``engines/val.py`` on the same seeded numpy weights and batches.

* ``flatten_onehot_objects`` and ``paste_for_mask_eval``: equal;
* the model-input resize (``data/preproc.model_input``) against
  ``jax.image.resize(..., 'bilinear')``, shrinking 800 → 640 and enlarging
  512 → 640: within 2e-6 (f32 values in [0, 1]; the two libraries weight the
  same taps in another order);
* ``val.run`` on ``yolov5s-test`` (2 batches of 2 x 128 px, ``iou_type``
  boxes and masks): the same stats as JAX ``val.run`` — mAP@.5, mAP@.5:.95
  and fitness to 1e-9 (they depend on the score order and the matches only:
  both sides f32, the detections agree to 1e-3 px, far from any IoU
  threshold of the jittered targets), precision / recall / F1 at the max-F1
  point to 1e-6 (read off curves interpolated in the scores, which agree to
  ~1e-7);
* a uint8 batch gives exactly the stats of the same batch as floats / 255.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.engines import val as jval
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.data.preproc import model_input
from hd_yolo_tpu_torch.engines import val as tval
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_common import random_variables

SIZE = 128
X_SHAPE = (2, SIZE, SIZE, 3)
KW = dict(max_masks=16, pre_nms_topk=256)
META = {"det": {"labels_text": {1: "tumor", 2: "stromal", 3: "sTILs", 4: "other"}}}


def small_hyp():
    """hyp-nuclei with max_det 16, so every detection has a mask slot."""
    hyp = jax_load_cfg("hyp-nuclei")
    for section in hyp.values():
        if isinstance(section, dict) and "conf_thres" in section:
            section["max_det"] = 16
    return hyp


@pytest.fixture(scope="module")
def models():
    """The JAX model and weights (built once: its jitted forward compiles
    once) and the port's model with the same weights, f32 on the CPU."""
    hyp = small_hyp()
    jm = JaxModel.from_cfg("yolov5s-test", hyp, **KW)
    variables = random_variables(jm, X_SHAPE, seed=1, obj_bias=1.0)
    tm = Model.from_cfg("yolov5s-test", hyp, **KW)
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec))
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False)[1])
    return jm, variables, tm.eval(), fwd


def batches(models, seed=0, n=2):
    """Seeded uint8 tiles and targets made from the JAX model's own
    detections: boxes jittered by a fraction of a pixel, 30% of the labels
    reassigned, some unlabeled (−100), 20% of the masks replaced by noise."""
    _, variables, _, fwd = models
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, 256, X_SHAPE, dtype=np.uint8)
        o = jax.tree.map(np.asarray, fwd(variables, jnp.asarray(x, jnp.float32) / 255.0))["det"]
        valid = o["valid"][:, :16]
        boxes = np.clip(o["boxes"][:, :16] + rng.normal(0, 0.3, (2, 16, 4)), 0, SIZE) / SIZE
        labels = np.where(rng.uniform(size=(2, 16)) < 0.3, rng.integers(1, 5, (2, 16)),
                          np.abs(o["labels"][:, :16]))
        labels[rng.uniform(size=(2, 16)) < 0.1] = -100
        masks = np.where(rng.uniform(size=(2, 16, 1, 1)) < 0.2,
                         rng.uniform(size=o["masks"].shape), o["masks"])
        tgt = {"det": {"boxes": boxes.astype(np.float32), "labels": labels.astype(np.int64),
                       "masks": masks.astype(np.float32), "valid": valid}}
        out.append((x, tgt))
    return out


def test_flatten_onehot_objects_equals_jax(rng):
    for n, nc in ((5, 3), (7, 5), (1, 2)):
        x = {"boxes": rng.uniform(0, 100, (n, 4)), "labels": (rng.uniform(size=(n, nc)) > 0.5) * 1.0,
             "scores": rng.uniform(size=(n, nc)), "masks": rng.uniform(size=(n, 6, 6))}
        got, want = tval.flatten_onehot_objects(x), jval.flatten_onehot_objects(x)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        tval.flatten_onehot_objects({"boxes": np.zeros((2, 4)), "labels": np.zeros(2)})


def test_paste_for_mask_eval_equals_jax(rng):
    n = 9
    xy = rng.uniform(0, 90, (n, 2))
    entry = {"boxes": np.concatenate([xy, xy + rng.uniform(3, 40, (n, 2))], 1).astype(np.float32),
             "masks": rng.uniform(size=(n, 28, 28)).astype(np.float32),
             "labels": np.arange(n)}
    got, want = tval.paste_for_mask_eval(entry, 100, 120), jval.paste_for_mask_eval(entry, 100, 120)
    assert got["masks"].dtype == bool and got["masks"].shape == (n, 100, 120)
    np.testing.assert_array_equal(got["masks"], want["masks"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    empty = {"boxes": np.zeros((0, 4), np.float32), "masks": np.zeros((0, 28, 28), np.float32)}
    assert tval.paste_for_mask_eval(empty, 10, 10)["masks"].shape == (0, 28, 28)


@pytest.mark.parametrize("src,dst", [(800, 640), (512, 640), (160, 128)])
def test_model_input_resize_matches_jax_image_resize(rng, src, dst):
    im = rng.integers(0, 256, (2, src, src, 3), dtype=np.uint8)
    want = jax.image.resize(jnp.asarray(im, jnp.float32) / 255.0, (2, dst, dst, 3), "bilinear")
    got = model_input(im, dst, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, dst, dst, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    same = model_input(im, src, "cpu")                 # no resize at the model's size
    np.testing.assert_array_equal(same.numpy(), im.astype(np.float32) / 255.0)


@pytest.mark.parametrize("iou_type", ["boxes", "masks"])
def test_val_run_matches_jax(models, iou_type):
    jm, variables, tm, _ = models
    data = batches(models)
    want = jval.run(jm, variables, iter(data), meta_info=META, compute_masks=True,
                    iou_type=iou_type, verbose=False)
    got = tval.run(tm, iter(data), meta_info=META, compute_masks=True, iou_type=iou_type,
                   verbose=False)
    assert got[0] == pytest.approx(want[0], abs=1e-9)
    assert set(got[1]) == set(want[1]) == {"det"}
    for k, v in want[1]["det"].items():
        tol = 1e-6 if k in ("mp", "mr", "f1") else 1e-9
        assert got[1]["det"][k] == pytest.approx(float(v), abs=tol), k
    assert want[1]["det"]["map50"] > 0.05                 # the targets make a real score
    assert len(got[2]) == 3 and all(t >= 0 for t in got[2])


def test_val_run_input_size_matches_jax(models):
    """The batch resized to the model's input on the way in (256 → 128)."""
    jm, variables, tm, _ = models
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    _, tgt = batches(models, seed=3, n=1)[0]
    want = jval.run(jm, variables, iter([(x, tgt)]), meta_info=META, input_size=SIZE,
                    verbose=False)
    got = tval.run(tm, iter([(x, tgt)]), meta_info=META, input_size=SIZE, verbose=False)
    for k, v in want[1]["det"].items():
        assert got[1]["det"][k] == pytest.approx(float(v), abs=1e-6), k
    assert want[1]["det"]["map50"] > 0.0


def test_val_run_uint8_matches_float(models):
    """The loader ships raw uint8 tiles; val divides them by 255 before the
    model, so they give exactly the stats of the float batch."""
    _, _, tm, _ = models
    data = batches(models, seed=1, n=1)
    x8, tgt = data[0]
    runs = [tval.run(tm, iter([(imgs, tgt)]), meta_info=META, verbose=False)
            for imgs in (x8, x8.astype(np.float32) / 255.0)]
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]
