"""The plain reference against the port on the CPU at a tiny size (the port's
``yolov5s-test`` model, 128 px): with the port in float32 every number the
judge compares reads at rounding, through the trunk, the decode, the NMS,
both mask branches and the slide's stitch; and the reference served in its
own place judges as exact."""

import json
import os

import pytest
import torch

import weights
from entries import common
from reference.judge import RefSlide, RefTiles, judge_slide, judge_tiles
from reference.serve import serve_slide, serve_tiles

from conftest import BENCH, TINY_TRAFFIC

CFG = json.load(open(os.path.join(BENCH, "tests", "data", "tiny.json")))
ROUNDING = 1e-4          # float32 against float32 in another op order


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    state = weights.seeded_state(CFG, 7, "cpu")
    x = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    ref = weights.ref_model(CFG, "cpu", state)
    weights.calibrate(ref, state, x, {"per_tile": 8, "topk": 256, "max_masks": 64})
    return state, x, ref


def port(state, extra, dtype="float32"):
    return common.detector(dict(CFG, dtype=dtype), extra, state, "cpu")


def test_trunk_features_match(setup):
    state, x, ref = setup
    det = port(state, {})
    got = det.model.trunk(x)
    want = ref.trunk(x)
    for j in ref.hspecs[0]["from"]:
        torch.testing.assert_close(got[j].float(), want[j], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("budget", [24, None], ids=["packed", "per_image"])
def test_port_f32_judges_at_rounding(setup, budget):
    state, x, ref = setup
    det = port(state, {"mask_budget": budget})
    out = det.tiles(x.numpy())["det"]
    r = RefTiles(ref, "det", x, CFG["detector"]["pre_nms_topk"])
    nums = judge_tiles(r, out, budget, CFG["detector"]["mask_window"])
    assert nums["n_reference_kept"] > 4 and nums["n_masks"] > 4
    # a candidate within float32 rounding of the threshold may fall either way
    assert abs(nums["n_served"] - nums["n_reference_kept"]) <= 0.1 * nums["n_reference_kept"] + 1
    for k in ("box_gap", "score_gap", "overlap", "mask_gap"):
        assert nums[k] <= ROUNDING, (k, nums)
    assert nums["mask_set"] == 0


def test_slide_port_f32_judges_at_rounding(setup):
    state, _, ref = setup
    s = TINY_TRAFFIC["tiny-slide"]["slide"]
    slide = torch.randint(0, 256, (1504, 1504, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(4))
    det = port(state, {})
    kw = {k: s[k] for k in TINY_TRAFFIC["tiny-slide"]["slide_args"]}
    out = det.slide(slide.numpy(), **kw).records[0]["det"]
    r = RefSlide(ref, "det", slide, s, CFG["detector"]["pre_nms_topk"])
    nums = judge_slide(r, out, s, CFG["detector"]["mask_window"])
    assert nums["n_reference_kept"] > 10
    assert abs(nums["n_served"] - nums["n_reference_kept"]) <= 0.1 * nums["n_reference_kept"] + 1
    assert nums["n_band"] > 0
    for k in ("box_gap", "score_gap", "overlap", "mask_gap"):
        assert nums[k] <= ROUNDING, (k, nums)
    assert nums["mask_set"] == 0


def test_reference_served_in_its_own_place_is_exact(setup):
    state, x, ref = setup
    out = serve_tiles(ref, "det", x, 256, 64, 24, 16)
    nums = judge_tiles(RefTiles(ref, "det", x, 256), out, 24, 16)
    assert all(nums[k] == 0 for k in ("box_gap", "score_gap", "mask_gap",
                                      "mask_set")), nums
    s = TINY_TRAFFIC["tiny-slide"]["slide"]
    slide = torch.randint(0, 256, (1504, 1504, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(5))
    out = serve_slide(ref, "det", slide, s, 256, 16)
    nums = judge_slide(RefSlide(ref, "det", slide, s, 256), out, s, 16)
    assert all(nums[k] == 0 for k in ("box_gap", "score_gap", "mask_gap",
                                      "mask_set")), nums


def test_bf16_port_reads_above_f32_and_below_the_fp8_control(setup):
    """The port at its stated bf16 reads well above rounding on the box and
    mask numbers, and the reference at float8 (the control) higher still."""
    from reference.model import Prec

    state, x, ref = setup
    det = port(state, {"mask_budget": 24}, "bfloat16")
    r = RefTiles(ref, "det", x, 256)
    bf16 = judge_tiles(r, det.tiles(x.numpy())["det"], 24, 16)
    fp8 = judge_tiles(r, serve_tiles(ref, "det", x, 256, 64, 24, 16, Prec(fp8=True)), 24, 16)
    assert bf16["box_gap"] > ROUNDING and bf16["mask_gap"] > ROUNDING
    assert fp8["box_gap"] > 3 * bf16["box_gap"], (bf16, fp8)
    assert fp8["mask_gap"] > 3 * bf16["mask_gap"], (bf16, fp8)
