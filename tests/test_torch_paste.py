"""PyTorch port, ``ops/paste.paste_masks_in_image`` against
``hd_yolo_tpu/ops/paste.py`` on the same numpy masks and boxes, chunked and
unchunked, f32 on both sides: atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.ops.paste import paste_masks_in_image as jax_paste
from hd_yolo_tpu_torch.ops import paste_masks_in_image


def _case(rng, K, H, W, M=28):
    masks = rng.uniform(0, 1, (K, M, M)).astype(np.float32)
    xy = rng.uniform(-20, max(H, W), (K, 2))
    wh = rng.uniform(0.5, 60, (K, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[0] = [5.0, 5.0, 5.0, 9.0]                      # zero width
    return masks, boxes


@pytest.mark.parametrize("K,H,W,chunk", [(7, 40, 40, 32), (70, 40, 52, 16), (33, 64, 31, 32),
                                         (5, 17, 90, 2)])
def test_paste_matches_jax(rng, K, H, W, chunk):
    masks, boxes = _case(rng, K, H, W)
    want = np.asarray(jax_paste(jnp.asarray(masks), jnp.asarray(boxes), H, W, chunk=chunk))
    got = paste_masks_in_image(torch.from_numpy(masks), torch.from_numpy(boxes), H, W, chunk=chunk)
    assert got.shape == (K, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_paste_chunked_equals_unchunked(rng):
    masks, boxes = _case(rng, 70, 40, 40)
    m, b = torch.from_numpy(masks), torch.from_numpy(boxes)
    torch.testing.assert_close(paste_masks_in_image(m, b, 40, 40, chunk=128),
                               paste_masks_in_image(m, b, 40, 40, chunk=16), rtol=0, atol=0)


def test_paste_box_interior():
    """A constant mask pastes ~1 inside its box and 0 far outside."""
    masks = torch.ones((1, 28, 28))
    boxes = torch.tensor([[10.0, 20.0, 30.0, 50.0]])
    out = paste_masks_in_image(masks, boxes, 64, 64)[0]
    assert float(out[25:45, 12:28].min()) > 0.99
    assert float(out[:15].max()) == 0.0 and float(out[:, 35:].max()) == 0.0
