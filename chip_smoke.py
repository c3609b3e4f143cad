#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``hd_yolo_tpu_torch``).

Run from the repo root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--only KERNEL,...]

(``--only``: build, run only the named kernels' phase-3 checks and timings
— for ``roi_align_bwd`` also phases 14 and 14b, for ``roi_align_single_bwd``
also phases 15 and 15b; ``device_augment`` runs phase 16 with its own
host-loader CLI, ``multihead``, ``anchor_free``, ``ensemble``,
``pretrained``, ``nucls_finetune``, ``hub``, ``hnet_darknet``, ``ddp``,
``occupancy`` and ``convergence`` phases 17–26 — and stop without the
result lines.
``--old-stem PATH``: an earlier ``kernels/stem.cu`` built and timed in
turns with the direct stem at phase 3's X1 and X2.
``--hnet-loss-trials N``: phase 15's loss check N times, from the fresh
model and 15 micro-steps in; ``--step-calls PATH``: both backwards timed at
hnet training calls saved in PATH, captured first where it is absent, so
that two trees time the same inputs.  Both stop without the result lines.)

Phases (any failure raises and the script exits non-zero):
  1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
  2. build: every kernel under ``hd_yolo_tpu_torch/kernels/`` compiled from
     the checkout by ``nvcc`` for sm_90a, one process per source, in parallel;
     ``nvcc -Xptxas -v``'s registers, shared memory and spills for the
     kernels redesigned for Hopper (``mask_head``, ``stem_tc``, ``nms``,
     ``roi_align``, ``roi_align_single``, ``stem_k108``, ``mask_head_f32``,
     ``stem_tf32``, ``stem``), the direct ``stem`` held to no spill, and its
     plans (form, N tile, ring step, shared bytes) at X1 and X2;
  3. kernels: each kernel against its plain PyTorch version on the same
     inputs, at the flagship path's shapes, with the stated tolerance (NMS
     bit-identical).  The direct stem (``stem.cu``, tensor-core products for
     the whole family) at yolov5x6's X1 (bf16 (16, 640, 640, 3) -> N 80)
     and X2 (f32 (4, 1280, 1280, 3) -> N 80), forced at the flagship stem in
     bf16 (atol 1e-2, rtol 2^-7) and f32 (atol 1e-5, also at (2, 128, 160,
     3)), and at the family's other shapes (``DIRECT_FAMILY``: C 1, 2, 4;
     k/s 2/2, 4/2, 4/4, 8/4) in both dtypes: two launches bit-identical,
     device time against its bound and cuDNN's call, X1 and X2 against the
     target of twice the bound, and in turns with the earlier direct
     kernel built from ``--old-stem``'s source (it must be faster).  Then median times (CUDA events, one call a window) of the
     kernel, the plain version and, where one exists, a PyTorch library
     call, and the kernel's time again over windows of 5 back-to-back calls
     (device time only, without the wrapper's host time).  The bf16 stem
     form ``stem_tc`` is held within one bf16 ulp also on pre-activations
     out to |v| ~ 15 and, its SiLU alone, over [-20, 20]; it is timed in
     turns with the direct kernel at bf16, ``stem_k108`` and cuDNN and must
     beat the direct kernel and cuDNN; the f32 stem form ``stem_tf32`` is
     held within 1e-5 of the plain f32 version (TF32 off) at the flagship
     shape, at the three f32 paths' shapes and, its SiLU alone, over
     [-20, 20], and timed in turns with the direct kernel at f32 and cuDNN's
     f32 chain (it must beat both), with its device time and the card's
     clock and power sampled beside it; the mask head with all 768 slots active and with a
     360-slot prefix (inactive slots exactly 0, two launches bit-identical)
     is timed in turns with cuDNN's chain and must beat it; the canvas
     ROI-align reads the four level maps in place (checked) at 768 ROIs and
     a 360 prefix, bit for bit its plain version (rows past the prefix
     exactly 0, two launches bit-identical, equal to the canvas-first
     form), with its device time from the profiler, its wrapper's host time
     a call (200 enqueues, no sync) and
     the whole ``multiscale_roi_align_packed`` (coordinates + kernel) timed
     in turns with PR 1–4's form that stacked the levels into a canvas
     first; NMS likewise with its device and host times;
  4. flagship: ``Detector("yolov5l6-mask", "hyp-nuclei", device="cuda",
     mask_budget=768)`` (the packed mask branch, as ``bench.py`` runs it) at
     full width in bf16 with seeded weights (objectness bias raised so NMS
     and the 768-ROI mask budget do real work): one batch of 16 x 640 px
     tiles with every launch count reset just before and read just after
     (``stem_tc`` 1, the direct stem 0; the active prefix printed, one
     device count handed to both the pooling and the mask head,
     ``level_canvas`` never called, the level maps contiguous), then
     tiles/s (median of >= 10 runs), then
     ``Detector.__call__`` on three images of different sizes;
 4b. defaults: ``Detector("yolov5l6-mask", "hyp-nuclei")`` at its defaults
     (the per-image mask branch, canvas pooling, 100 masks an image) on the
     same batch: launch counts of one batch (one each of ``stem_tc``, NMS,
     ROI-align, mask head), the 1600 ROIs pooled and the masks kept (every
     eligible top-100 slot) against the packed branch's 768; the canvas
     ROI-align (bit for bit) and the mask head at those 1600 ROIs against
     their plain versions (the mask head on the path's own head and ROIs as
     phase 5 holds masks, mean |d| <= 0.01, max <= 0.1, and with phase 3's
     synthetic head and inputs at 2e-2), timed both ways and by device time with
     bounds; tiles/s and a profiled step;
  5. reference: ``yolov5s-test`` on a small batch through the kernels
     (CUDA, bf16) against the plain PyTorch path on the CPU (bf16) — the CPU
     path is the one the repo's tests hold against the JAX package;
  6. hnet: ``HNet.from_cfg(load_cfg("hnet-nucls"), dtype=torch.bfloat16)``
     (Swin-T + FPN + Mask R-CNN, panoptic and cl headers) at full width with
     seeded weights on 4 x 640 px tiles: one forward with every launch count
     reset just before and read just after (the single-level ROI-align 1
     for the tile ROI's four levels,
     the canvas ROI-align 2, NMS 2, mask head 1, stem 0; ``level_canvas``
     never called), then tiles/s
     (median of >= 10 forwards) and a profiled forward;
  7. hnet reference: a small hnet (Swin embed 32, depths 1/1/1/1, window 4,
     FPN 256) on 2 x 128 px through the kernels (CUDA, bf16) against the
     port's plain path on the CPU (bf16), end to end and, for the detection
     path, stage by stage on the card's own inputs to each stage; and in f32
     end to end;
  8. stem lab: ``hd_yolo_tpu_torch.tools.stem_lab.main`` at its defaults
     (16 x 640, all ten formulations, one JSON line each) with every launch
     count reset just before and read just after (``stem_k108``,
     ``stem_dot108``, ``stem_tc`` and the direct ``stem`` each launched);
  9. slide: ``Detector("yolov5l6-mask", "hyp-nuclei")`` in bf16,
     ``Detector.slide`` on a synthetic 4096 x 4096 uint8 slide with tile 640,
     overlap 64 and batch 16 (49 tiles, 4 batches), the objectness
     calibrated to ~20 detections per tile: the launch counts of one slide
     (``stem_tc`` 4 and the direct stem 0, NMS 5 = 4 per-tile + 1 stitch,
     ROI-align 4, mask head 4, each with its active prefix printed and
     shared by pooling and head, no canvas built), the
     median wall time over >= 5 slides and tiles/s, the band population
     against ``max_band`` (and the saturation warning exactly when it is
     reached), the mask-carrying rows against ``mask_rows``, every box inside
     the slide, no two kept detections of one label at IoU > 0.45, and a
     paste of the top masks into a crop;
 10. slide reference: ``yolov5s-test`` on a 600 x 900 slide in f32, the card
     against the plain path on the CPU: >= 98% of the CPU's stitched
     detections found again (same label, IoU >= 0.9);
 11. val: ``engines/val.run`` on the flagship at ``Detector()``'s defaults
     (class biases raised and objectness calibrated to ~40 detections a
     tile) over 4 batches of 8 x 640 host uint8 tiles whose targets are the
     card's own first-pass detections (boxes, labels, 28x28 masks): box and
     mask mAP@0.5 >= 0.99, ms per image (data, inference, metrics), one
     launch of each flagship kernel a batch;
 12. evaluate and export: ``inference_on_loader`` at batch 16 (images/s),
     ``engines/evaluate.export`` of the same model at (16, 640, 640, 3)
     loaded back in this process: one call of each of the four kernels' custom
     ops in the graph, one launch each a run, outputs bit for bit the eager
     forward's, the program timed in turns with ``Detector.tiles`` and both
     profiled, and each custom op's host time a call beside the bare
     ``ctypes`` launch;
 13. serving: ``serving._respond`` on a 640 tile and a 1500 x 1500 slide
     (records equal a direct ``Detector`` call's), latency a request, and an
     HTTP round trip through ``ThreadingHTTPServer`` on 127.0.0.1 where
     ``cv2`` imports (whether it does is printed);
 14. training: a labelled set of 64 PNG tiles of 640 px (~80 polygons of
     10-40 px each, four classes) written to a temp dir;
     ``engines/train.main`` on ``yolov5l6-mask`` at full width and depth,
     bf16, masks, batch 16 (4 micro-steps an update), 2 epochs: ``last``,
     ``best``, ``final`` written, validation each epoch; ``--resume`` to a
     third epoch restores the saved step, parameters and EMA; ``final.pt``
     loads into ``Detector``.  Then the step on one fixed batch: the
     launches of one micro-step (ROI-align forward and backward one each,
     no stem, NMS or mask-head kernel), median / min / max of 10 timed
     micro-steps after 3 warm-ups, img/s, peak memory, a profiled step;
     before those, 8 updates on the batch from the fresh model through the
     kernel, each of its calls held against the plain version
     (``shadow_backwards``), the batch's loss after them below the loss
     before them and within a tenth of that fall of the loss after the same
     updates through the plain backward (``loss_runs``); every loss item
     finite;
     the ROI-align forward at the step's own 1024 whole-canvas bf16 ROIs bit
     for bit its plain version, the backward kernel within 2e-2 x max|g| a
     level of the plain version's autograd there and within 1e-5 on a
     ragged f32 case against the CPU's plain version, two launches
     bit-identical in both, at most two device launches a call (profiler
     kernel and memset events), its times and bound, and its time without
     passing over the ROIs whose output gradient is all zero;
 14b. training reference: one step of ``yolov5s-test`` at 256 px in f32 on
     the card and on the CPU from the same state (loss items, gradients of
     four tensors);
 15. hnet training: ``hnet-nucls`` at full width (Swin-T with drop path
     0.2, FPN 256, Mask R-CNN with masks, panoptic, cl and the mask-weighted
     constrain) with seeded weights, bf16, ``build_optimizer`` (lr0 0.005,
     warmup 3 epochs, grad-norm clip 10) and ``make_train_step`` on a fixed
     synthetic batch of 4 x 640 tiles (up to 64 nuclei a tile, 28x28 masks,
     a stride-16 seg map painted from them, a tile label): the launches of
     one micro-step (single-level ROI-align forward and backward 3 each,
     canvas ROI-align forward and backward 4 each, NMS 3, no mask-head or
     stem kernel), median / min / max of 10 timed micro-steps after 3
     warm-ups, img/s, peak memory, a profiled step (device busy, idle
     share); before those, from the fresh model, 8 updates as phase 14's
     (the batch's loss in eval mode, every backward call held, the kernels
     within a tenth of the fall of the plain backwards) with every loss
     item finite; the micro-step median and the
     profiled step's device launches printed beside those recorded before
     the two ROI-align backwards' redesign; the backward
     kernels on the step's own inputs (the canvas one at its four calls
     within 2e-2 x max|plain|, two launches bit-identical, at most two
     device launches a call, its time without the zero skip; both pyramids
     bit for bit the plain autograd, one device launch; the constrain's
     pooling within 1e-5 x max|g| of the CPU's plain version,
     deterministic, one device launch);
 15b. hnet training reference: the small hnet of ``tests/test_torch_hnet.py``
     in f32, one training forward and backward on the card and on the CPU
     from the same weights and batch (loss items, gradients by parameter
     group).
 16. device augmentation: ``yolov5l6-mask`` + ``hyp-nuclei`` at full width,
     bf16, batch 16 x 640, 256 targets with masks, on phase 14's 64-tile set
     in raw mode (``DetectionDataset(host_augment=False)``): the recipe
     (``data/device_augment.apply_augment``) on the card and on the CPU on the
     same draws at ``k_mosaic`` 2 and 1 and with mixup 0.5 and photometric
     1.0 (images and masks within 1e-4, boxes within 1e-3 px, labels and
     valid flags equal but where a box lies within 1e-3 of a cut); the
     recipe's time alone (draws, upload and recipe: CUDA events, median of
     20; profiler device time, launches and time by kernel; host enqueue
     time); the
     micro-step with the recipe inside in turns with phase 14's step on a
     host-augmented batch (launches, a profiled step); ``train.main
     --cache-device`` 2 epochs and ``--resume`` to a third (phase 14's checks,
     the upload's MB and seconds, img/s of each epoch's steps beside phase
     14's host-loader CLI); ``--batch-size -1``'s batch and fitted MiB an
     image.
 17. multihead: ``yolov5l6-multihead`` (``det`` nc 7 and ``detSC`` nc 4 on
     one P3-P6 trunk, both with masks) at full width, bf16, seeded weights,
     objectness calibrated as in phases 4 and 4b, batch 16 x 640 uint8:
     ``Detector.tiles`` on the packed branch (``stem_tc`` 1, NMS, ROI-align
     and mask head 2 each, one active count a header) and at
     ``Detector()``'s defaults, every NMS, canvas ROI-align and mask-head
     call of both headers held against its plain version on the path's own
     inputs (NMS and ROI-align bit for bit, the mask head as phase 5 holds
     masks), step median / min / max of 10 and a profiled step,
     ``Detector(..., task=)`` filtering; then training at batch 16 with
     both mask losses (``det`` on half the images, ``detSC`` on the other
     half): the loss over 8 updates from the fresh model as phase 14's, every
     backward call shadowed, then 10 timed micro-steps (launches: ROI-align
     and its backward 2 each), img/s, peak memory, a profiled step;
 18. anchor-free: ``yolov6s-af`` as published (depth 0.33, width 0.5),
     bf16, batch 16 x 640, seeded weights, objectness calibrated to 1% of
     each level's cells: launches of one batch (``stem_tc`` 1, NMS 1), the NMS
     call held bit for bit, ``stem_tc`` at N 32 on the path's own input
     against ``stem_conv_plain`` and timed against its bound and cuDNN, the
     step and a profiled step; 8 SimOTA updates from the fresh model on 16
     tiles of up to 256 nuclei (the loss falls), 10 timed micro-steps (no
     kernel launched), the assignment's time and device time on the step's
     inputs; a small f32 reference (2 x 256): the card's SimOTA assignment
     equal to the CPU's on the same inputs, loss items within 1e-3, >= 98% of
     the CPU's detections found again;
 19. ensemble: ``hd_yolo_tpu_torch.Ensemble`` of the flagship at
     ``Detector()``'s defaults and a multihead model, both merged on
     ``detSC`` (16 x 600 rows → 300) and ``det`` (the multihead alone):
     launches, the merge's NMS call held bit for bit against ``nms_padded``
     at (16, 600) and timed, the merge's time and the ensemble step's.
 20. pretrained: the serialized reference checkpoints
     ``tests/fixtures/{metayolo,ultralytics}_tiny.pt`` through
     ``utils/import_torch`` into ``tiny2l.yaml`` on the card (f32, masks):
     every tensor of the model loaded, launches (the f32 stem form
     ``stem_tf32``, NMS, the canvas ROI-align and the mask head's f32 form
     1 each, the direct ``stem`` and the bf16 mask head 0), each NMS, ROI-align and mask-head call held against its
     plain version on its own inputs (the f32 mask head within 1e-4), and
     the outputs against the fixture's ``expected`` (the reference torch
     model's own): the count within 10%, every expected box within 1 px,
     matched scores rtol 1e-3 / atol 1e-4, masks mean |d| <= 0.01 and max
     <= 0.1; then the
     flagship's seeded weights written as an ultralytics ``model.{i}`` .pt
     and a metayolo ``{'ema': ...}`` checkpoint, each resolved by bare name
     through ``$HD_YOLO_WEIGHTS_DIR``: every tensor loaded, a bf16 16 x 640
     batch bit for bit the outputs of the same weights loaded directly;
 21. NuCLS fine-tune: a synthetic NuCLS ``trainval`` layout (64 FOVs of 640
     px, ~80 polyline nuclei each, six training slides, a test slide and an
     excluded slide listed under training) converted by ``python -m
     hd_yolo_tpu_torch.data.nucls``; ``engines/train.main`` on the flagship
     from phase 20's ultralytics .pt (bf16, masks, batch 16, an update a
     micro-step, 3 epochs): every tensor loaded, >= 4 updates, each
     gradient read: a non-finite one fails the phase (naming its parameters,
     loss items and batch) unless a det-loss candidate's decoded height is
     0 or at most 1e-18 of its width, where CIoU's gradient is NaN in the
     JAX package too (ROADMAP C.2), finite loss,
     ``last``/``best``/``final`` written, EMA validation each epoch, img/s of
     each epoch's steps, the launches of a micro-step (canvas ROI-align
     forward and backward 1 each, no stem, NMS or mask head) and of an
     epoch's validation; then the first epoch again with every
     ``roi_align_bwd`` call held against its plain version (as phase 14);
 22. hub presets at their published widths, written inline row for row
     (ultralytics/yolov5 ``models/hub/yolov5s-ghost.yaml`` v6.0, v3.1's
     ``models/yolov5s.yaml`` and ``models/hub/yolov5x6.yaml`` v6.0, nc 80)
     and parsed through ``normalize_legacy_cfg``: seeded weights, objectness
     calibrated to 1% of the anchors (yolov5x6 10%); one bf16 16 x 640
     batch's launches (``stem_tc`` 1 for the ghost model's N-32 stem, 0
     behind v3.1's Focus; the direct ``stem`` 1 for yolov5x6's N-80 stem, X1;
     NMS 1), its NMS call held bit for bit and its direct stem call against
     the plain version, the step and a profiled step; yolov5x6 also in f32
     on 4 x 1280, its published input size (X2: the direct ``stem`` 1 at N
     80, W 1280); card vs CPU in f32 on 2 x 640 (>= 98% of the CPU's
     detections found again; yolov5x6's stem the direct kernel, X3); for
     yolov5s-ghost and v3.1 ``yolov5s``, 8 updates
     from the fresh model with masks off on 16 tiles (every loss item
     finite, the box and class losses falling: the objectness rises in the
     bias warmup, and with it the total, as JAX's own chain does on the
     same preset, ``tests/test_torch_hub_preset_train.py``); 8 updates
     in f32 on 2 x 256 on the card and on the CPU from one fresh model, each
     micro-step's loss within rtol 2e-3.
 23. hnet-darknet: ``hnet-nucls`` with the darknet backbone at its
     defaults, 17 keypoints on ``det40x`` and an FCOS header ``fcos40x``
     (``hnet_darknet_cfg``), bf16, seeded weights, 4 x 640 uint8 tiles: the
     launches of one forward (``stem_tc`` 1, NMS 3, canvas ROI-align 3,
     single-level ROI-align 2, mask head 1), every kernel call of it held
     against its plain version on its own inputs and timed beside its plain
     version and bound, the outputs (finite, keypoints inside their boxes
     with scores in [0, 1], FCOS boxes inside the tile), the forward's
     median / min / max and a profiled forward; training from the fresh
     model (keypoint and FCOS targets on ``hnet_batch``'s nuclei): the loss
     over 8 updates as phase 15's, every backward call shadowed, the
     launches of a micro-step, its times; a small f32 card vs CPU check
     (``stem_tf32`` 1 and the direct ``stem`` 0; both headers' detections,
     keypoints); ``SRGenerator`` and the WGAN
     ``SRDiscriminator`` at their defaults (16 x 320² → 640², one WGAN-GP
     step) and card vs CPU; ``tests/fixtures/swin_tiny.pt`` through
     ``utils/import_swin`` on the card against the CPU.
 24. ddp: the flagship across processes at world 1 on NCCL (``parallel/``):
     (a) a one-rank group from torchrun's environment
     (``parallel.maybe_initialize_distributed``); (b) the training
     micro-step (``yolov5l6-mask`` + ``hyp-nuclei``, bf16, 16 x 640, masks)
     through ``make_train_step(distributed=True)`` (BatchNorm on the
     card's global form, the gradients summed in buckets, the metrics
     summed) against the plain step from the same state: loss items,
     BatchNorm running statistics and the update, in f32 (TF32 off) within
     2x of what moving the BatchNorm scales by +/-2^-16 makes of the plain
     step, in bf16 within the bf16 plain step's distance from the f32 one;
     the largest differences and the worst tensors printed; both bf16
     steps timed in
     turns, a profiled step of each (the NCCL kernels' device time and
     launches, the launches the path adds) and its kernel launches; (c)
     ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
     hd_yolo_tpu_torch.engines.train`` for one epoch on 32 tiles of phase
     14's synthetic set, then ``--resume`` to a second (rank 0 writes
     ``last.pt``); (d) ``wsi.slide_inference_sharded`` at world 1 on phase
     9's 4096 px slide, bit for bit against ``Detector.slide``'s stitched
     result, with its launches; (e) ``utils/profiling.flops_of`` of the
     flagship's forward at 16 x 640 (the PyTorch ops it dispatches; the
     hand kernels' operations added from their formulas) and
     ``device_memory_stats`` after (b); (d) hnet-nucls's micro-step (phase
     15's model, batch and recipe: Swin-T, drop path 0.2, bf16, 4 x 640)
     through the distributed path: from the fresh model its first loss
     items against the plain step's (within twice the plain step's own
     spread, or 1e-4), 8 updates with every backward call held against its
     plain version and the loss falling as phase 15's, its kernel launches
     equal the plain step's, both steps timed in turns and profiled with
     their NCCL kernels.
 25. occupancy: ``tools/occupancy_check`` on the flagship in bf16 with
     seeded weights, 16 synthetic 640 px tiles at 40 and 80 nuclei a tile,
     the objectness calibrated to the nuclei a tile: the per-image branch
     (``max_masks`` 192) against the packed one (budget 768): each batch's
     drops max(0, eligible - 768) (none at 40, some at 80), every kept mask
     bit for bit the per-image branch's, both branches' mask mAP, launches.
 26. convergence (started before phase 24's torchrun CLI, collected
     here): ``tools/convergence_check`` at its defaults, the yolo
     check (``yolov5s-test``, 1000 steps, f32: box fitness >= 0.9, mask
     fitness >= 0.8) and ``--hnet`` (700 steps, FPN 256: the loss falls to a
     tenth; both squares found or not, recorded: the JAX tool's config
     misses it in the JAX package too, ROADMAP C.10), each a process of its
     own, the two side by side (host-bound steps), each run's kernel
     launches (the yolo run's validation: ``stem_tf32`` at least once, the
     direct ``stem`` never).

Phase 3 also holds the single-level ROI-align's backward kernel
(``roi_align_levels_bwd``) against its plain version at its two call sites:
hnet's pyramid (the four levels, bf16, one device launch, bit for bit) and
the confliction loss's pooling (f32, 5 channels, 100 boxes an image, output
28, against the CPU, one device launch by either path), with its times and
bound; it times the direct stem's f32 form beside cuDNN's f32 conv + bias +
SiLU (TF32 off); it holds the mask head's f32 form (an f32 model's
features) within 1e-4 of the plain version at the fixtures' 100 ROIs and
at 360 of 768, timed beside cuDNN's f32 chain; and it holds the single-level
ROI-align kernel bit for bit against
its plain version at the four hnet-nucls level shapes in one launch
(``roi_align_levels``; device time and wrapper host time, in turns with
four one-map launches; and a small f32 case with 5 channels), kernels 2–4 at the shapes hnet-nucls gives them (both NMS calls
and the canvas ROI-align at the box head's and the mask head's ROIs, each
timed; the mask head at 400 ROIs with five mask classes), the NMS kernel at
the slide stitch's shapes ((1, 1024) band, (1, 4096) full, IoU 0.45,
bit-identical, timed), and the K=108 stem kernels 6 and 7 at (16, 640,
640, 3), kernel 6 timed in turns with ``stem_tc``.

The last lines are the script's wall time, the per-kernel JSON record
(``launches_by_path`` with the paths of phases 17–26), the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from hd_yolo_tpu_torch import kernels, load_cfg, serving  # noqa: E402
from hd_yolo_tpu_torch.detector import Detector  # noqa: E402
from hd_yolo_tpu_torch.engines import evaluate, val  # noqa: E402
from hd_yolo_tpu_torch.hnet import HNet  # noqa: E402
from hd_yolo_tpu_torch.models import detect_head  # noqa: E402
from hd_yolo_tpu_torch.models.detect_head import MaskHead  # noqa: E402
from hd_yolo_tpu_torch.ops.boxes import box_iou, remove_small_boxes_mask, xywh2xyxy  # noqa: E402
from hd_yolo_tpu_torch.ops import pallas_mask_head, pallas_nms, pallas_roi_align, pallas_stem  # noqa: E402
from hd_yolo_tpu_torch.ops.nms import batched_nms_padded, class_offset_boxes, nms_padded  # noqa: E402
from hd_yolo_tpu_torch.ops.paste import paste_masks_in_image  # noqa: E402
from hd_yolo_tpu_torch.ops import roi_align as roi_ops  # noqa: E402
from hd_yolo_tpu_torch.ops.roi_align import (_multiscale_roi_align_canvas,  # noqa: E402
                                             level_canvas, multiscale_roi_align_canvas,
                                             multiscale_roi_align_packed, roi_align,
                                             sample_coords)
from hd_yolo_tpu_torch.tools import stem_lab  # noqa: E402
from hd_yolo_tpu_torch.utils.profiling import device_memory_stats, flops_of  # noqa: E402
from hd_yolo_tpu_torch.wsi import tiling  # noqa: E402

# H100 SXM published peaks (dense): HBM bytes/s, bf16 and TF32 tensor-core and
# f32 FLOP/s.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# the f32 mask head's error against its plain version at unit-variance features
# with the tensor-core partial promoted every 16 k-steps (~1.5e-6), far below a
# build that keeps one accumulator over a conv's K (~2e-5)
F32_HEAD_PROMOTED_ATOL = 5e-6

TPU_KERNEL = {
    "stem": "hd_yolo_tpu/ops/pallas_stem.py:79",
    "nms": "hd_yolo_tpu/ops/pallas_nms.py:32",
    "roi_align": "hd_yolo_tpu/ops/pallas_roi_align.py:195",
    "mask_head": "hd_yolo_tpu/ops/pallas_mask_head.py:51",
    # the same TPU kernel on an f32 model's features
    "mask_head_f32": "hd_yolo_tpu/ops/pallas_mask_head.py:51",
    "roi_align_single": "hd_yolo_tpu/ops/pallas_roi_align.py:31",
    "stem_k108": "tools/stem_lab.py:132",
    "stem_dot108": "tools/stem_lab.py:168",
    "stem_tc": "hd_yolo_tpu/ops/pallas_stem.py:79",
    # the same TPU kernel at f32 compute
    "stem_tf32": "hd_yolo_tpu/ops/pallas_stem.py:79",
    # the XLA vjp JAX's custom_vjp takes of the plain canvas form
    "roi_align_bwd": "hd_yolo_tpu/ops/pallas_roi_align.py:270",
    # the XLA vjp JAX's custom_vjp of the single-level kernel takes
    "roi_align_single_bwd": "hd_yolo_tpu/ops/pallas_roi_align.py:117",
}
FLAGSHIP_KERNELS = ("stem_tc", "nms", "roi_align", "mask_head")
LAB_KERNELS = ("stem", "stem_k108", "stem_dot108", "stem_tc")
# the kernels redesigned for Hopper: their ptxas report is printed at build
REDESIGNED = ("mask_head", "stem_tc", "nms", "roi_align", "roi_align_single", "stem_k108",
              "mask_head_f32", "stem_tf32", "stem")


def slide_launches(n_batches: int) -> dict:
    """Launches of one flagship slide: per tile batch one stem (the bf16
    tensor-core form, never the direct one), one per-tile NMS, one ROI-align
    and one mask head; one stitch NMS."""
    return {"stem": 0, "stem_tc": n_batches, "nms": n_batches + 1, "roi_align": n_batches,
            "mask_head": n_batches, "roi_align_single": 0, "stem_k108": 0, "stem_dot108": 0}
# launches of one hnet-nucls forward: the tile ROI's 4 pyramid levels in one
# launch, the box-head and mask pooling, the RPN and class-aware NMS, one
# mask head
HNET_LAUNCHES = {"stem": 0, "stem_tc": 0, "nms": 2, "roi_align": 2, "mask_head": 1,
                 "roi_align_single": 1}
# hnet-nucls at 640 px: the tile ROI's pyramid levels (size, stride)
HNET_LEVELS = ((160, 4.0), (80, 8.0), (40, 16.0), (20, 32.0))
# launches of one hnet-nucls training micro-step: the ROI pyramid of pass 1
# and of pass 2 and the constrain's pooling of the seg probabilities, each
# forward and backward; the canvas ROI-align at the box head's and the mask
# head's ROIs in both passes, forward and backward; the RPN NMS of both
# passes and the class-aware NMS of pass 1; the cuDNN mask-head chain
HNET_TRAIN_LAUNCHES = {"stem": 0, "stem_tc": 0, "nms": 3, "roi_align": 4, "roi_align_bwd": 4,
                       "mask_head": 0, "roi_align_single": 3, "roi_align_single_bwd": 3,
                       "stem_k108": 0, "stem_dot108": 0}
# device launches a call the two ROI-align backward kernels may take (the
# canvas one: its tables and gather, whatever the number of levels; the
# single-level one: one for every map at once, one at the constrain)
BWD_LAUNCHES = {"roi_align_bwd": 2, "roi_align_single_bwd": 1}
# the hnet-nucls training micro-step recorded before the two ROI-align
# backwards were redesigned (NVIDIA H100 80GB HBM3, 700 W): median ms and
# device launches of a profiled step
EARLIER_HNET_STEP = {"median_ms": 146.26, "device_launches": 4842}
# hnet training recipe of tools/hnet_train_check.py (lr, warmup, clip; 48
# tiles at batch 4 for 80 epochs)
HNET_HYP = {"lr0": 0.005, "warmup_epochs": 3.0, "clip_grad_norm": 10.0}


T0 = time.perf_counter()


def log(*a):
    """Print; a phase's heading (a line starting "[") also gets the seconds
    since the script started."""
    if a and isinstance(a[0], str) and a[0].startswith("["):
        a = (f"{a[0]} (at {time.perf_counter() - T0:.0f} s)",) + a[1:]
    print(*a, flush=True)


B2B = 5   # calls in a back-to-back timing window


def cuda_ms_turns(fns: dict, iters: int = 20, warmup: int = 3, reps: int = 1) -> dict:
    """Median milliseconds of one call of each ``fns[name]()``: CUDA events
    around ``iters`` windows per function, the functions' windows taken in
    turns.  ``reps`` 1 (the ``ms`` of the kernel record): one call a window,
    so a window also holds whatever host work of the wrapper the card waits
    for.  ``reps`` > 1 (``ms_back_to_back``): that many calls back to back, so
    where the card is slower than the host's enqueue a window holds device
    time only."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(iters):
        for k, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b) / reps)
    return {k: statistics.median(v) for k, v in times.items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 1) -> float:
    """Median milliseconds of one ``fn()`` (``cuda_ms_turns`` of one function)."""
    return cuda_ms_turns({"fn": fn}, iters, warmup, reps)["fn"]


def kernel_ms(fn, iters: int) -> dict:
    """A kernel's two readings: one call a window and ``B2B`` back to back."""
    return dict(ms=cuda_ms(fn, iters), ms_back_to_back=cuda_ms(fn, iters, reps=B2B))


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn``: the host clock around ``n``
    enqueues after a warm-up, no synchronisation inside the window."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return t * 1e6


def device_ms(fn, n: int = 10, tries: int = 6) -> float:
    """Device milliseconds per call of ``fn``: the profiler's summed time of
    everything ``fn`` runs on the card, over ``n`` calls after a warm-up.
    Unlike ``ms`` and ``ms_back_to_back`` it holds no host time.  The
    profiler can lose a window's device events (a reading of 0 was seen
    on the card's machine, once in every window of a call), so a window
    with no device time is taken again, up to ``tries`` times; after that
    the reading is CUDA events around ``n`` back-to-back calls (which holds
    host time where the host is the slower side), and says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / n / 1e3
    t = cuda_ms(fn, 5, reps=n)
    log(f"  (the profiler recorded no device time in {tries} windows of {n} calls; this "
        f"device time is CUDA events around {n} back-to-back calls: {t:.4f} ms a call)")
    return t


def device_launches(fn, n: int = 5, tries: int = 6) -> dict:
    """Device launches of one call of ``fn`` by name: the kernel and memset
    events the profiler records on the card over ``n`` calls (copies not
    counted), divided by ``n``, after a warm-up call.  The profiler can lose a window's
    device events, so a window whose count of some kernel is not a multiple
    of ``n`` is taken again, up to ``tries`` times; after that each kernel
    counts ``ceil(count / n)`` in the fullest window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.key.startswith("Memcpy")}
        if counts and all(c % n == 0 for c in counts.values()):
            return {k: c // n for k, c in counts.items()}
        seen.append(counts)
    counts = max(seen, key=lambda c: sum(c.values()))
    need(bool(counts), f"the profiler recorded no device event over {n} calls in {tries} windows")
    log(f"  (the profiler lost device events in {tries} windows; counted as ceil(count / {n}) "
        f"per kernel: {counts})")
    return {k: -(-c // n) for k, c in counts.items()}


def bwd_launches(kernel: str, fn, what: str) -> int:
    """A backward kernel's device launches for one call of ``fn`` (every
    kernel and memset its wrapper starts), held to ``BWD_LAUNCHES``."""
    counts = device_launches(fn)
    n = sum(counts.values())
    log(f"  {kernel} {what}: {n} device launches a call (at most {BWD_LAUNCHES[kernel]}): "
        f"{({k[:60]: c for k, c in counts.items()})}")
    need(n <= BWD_LAUNCHES[kernel], f"{kernel} {what}: {n} device launches a call, more than "
                                    f"{BWD_LAUNCHES[kernel]}")
    return n


def bound(nbytes: float, flops: float, peak_flops: float):
    tb, tf = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check_close(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    worst = float((err - lim).max())
    mx = float(err.max())
    log(f"  {name}: max_abs_err {mx:.3g} (tolerance |d| <= {atol} + {rtol}*|plain|)")
    if not math.isfinite(mx) or worst > 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max_abs_err {mx})")
    return mx


def check_equal(name, got, want) -> float:
    """Hold a kernel bit for bit to its plain version; returns max |d| (0)."""
    mx = float((got.float() - want.float()).abs().max())
    log(f"  {name}: bit-identical {torch.equal(got, want)}, max_abs_err {mx:.3g} "
        f"(tolerance: exact)")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max_abs_err {mx})")
    return mx


def need(cond, msg: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- kernels
# the direct kernel's path shapes, yolov5x6's stem Conv(3, 80, 6, 2, 2) in
# phase 22: X1 bf16 16 x 640 (its batch there), X2 f32 4 x 1280 (its
# published input size)
DIRECT_PATHS = {"x1": ((16, 640, 640, 3), 80, torch.bfloat16),
                "x2": ((4, 1280, 1280, 3), 80, torch.float32)}
# the family's other shapes, 16 x 640 to N 64 in both dtypes: (C, k, s, p) —
# 1, 2 and 4 channels at 6x6/s2/p2, and k/s 2/2, 4/2, 4/4, 8/4 over 3
DIRECT_FAMILY = ((1, 6, 2, 2), (2, 6, 2, 2), (4, 6, 2, 2), (3, 2, 2, 0), (3, 4, 2, 1),
                 (3, 4, 4, 0), (3, 8, 4, 2))
# the earlier direct kernel (f32 FMAs on the CUDA cores), built from the
# source ``--old-stem`` names, timed in turns with the redesign at X1 and X2
OLD_STEM = {"src": None}


def old_direct_stem(src: str):
    """The earlier direct kernel's launch, built by ``nvcc`` from ``src``
    (that commit's ``kernels/stem.cu``, its own C signature: a ``round_in``
    flag and the weights rounded by the caller) into the build directory."""
    import hashlib

    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(kernels.BUILD_DIR, f"old_stem-{digest}.so")
    if not os.path.isfile(out):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        subprocess.run([kernels.nvcc()] + kernels.ARCH_FLAGS + kernels.BASE_FLAGS +
                       ["-I", os.path.dirname(kernels.__file__), "-o", out, src], check=True)
    fn = ctypes.CDLL(out).stem_conv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, w, scale, bias, stride, padding, out_dtype):
        B, H, W, C = x.shape
        K, N = w.shape[0], w.shape[-1]
        Ho, Wo = (H + 2 * padding - K) // stride + 1, (W + 2 * padding - K) // stride + 1
        bf16 = int(out_dtype == torch.bfloat16)
        wk = (w.to(torch.bfloat16).float() if bf16 else w).contiguous()
        y = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=x.device)
        dev, stream = kernels.device_and_stream(x)
        kernels.check(fn(x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                         y.data_ptr(), B, H, W, C, K, stride, padding, N, Ho, Wo, bf16, bf16,
                         dev, stream), "old stem_conv")
        return y

    return call


def stem_bound(x, w, y):
    """A stem's bound: x, w, scale and bias read and y written once, against
    its products of K = k·k·C per output value — bf16 at bf16 compute, the
    three TF32 products of split TF32 at f32."""
    K, N = w.shape[0] * w.shape[1] * w.shape[2], w.shape[-1]
    if y.dtype == torch.bfloat16:
        return bound(nbytes(x, w, y) + 2 * N * 4, 2.0 * y.numel() * K, BF16_FLOPS)
    return bound(nbytes(x, w, y) + 2 * N * 4, 3 * 2.0 * y.numel() * K, TF32_FLOPS)


def direct_case(name, gen, x_shape, N, k, s, p, od, iters, w_scale=None, old=None):
    """One shape of the direct kernel: one launch, against the plain version
    (bf16 within one bf16 ulp: |d| <= 1e-2 + 2^-7·|plain|; f32 within 1e-5,
    TF32 off), two launches bit-identical, then timed in turns with cuDNN's
    conv + bias + SiLU (and the earlier direct kernel, ``old``) one call a
    window and back to back, by its profiler device time, and against its
    bound.  Returns the record and the inputs."""
    dev = "cuda"
    C = x_shape[-1]
    x = torch.rand(x_shape, generator=gen, device=dev)
    w = torch.randn((k, k, C, N), generator=gen, device=dev) * (
        w_scale if w_scale is not None else 0.9 / (k * C ** 0.5))
    scale = torch.rand(N, generator=gen, device=dev) + 0.5
    bias = torch.randn(N, generator=gen, device=dev) * 0.1
    kw = dict(stride=s, padding=p, out_dtype=od)
    fn = lambda: pallas_stem.stem_conv(x, w, scale, bias, form="direct", **kw)  # noqa: E731
    n0 = kernels.LAUNCHES["stem"]
    got = fn()
    torch.cuda.synchronize()
    need(kernels.LAUNCHES["stem"] == n0 + 1, f"stem {name}: not one launch of the direct kernel")
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    tol = dict(atol=1e-2, rtol=2 ** -7) if od == torch.bfloat16 else dict(atol=1e-5, rtol=0.0)
    what = f"stem (direct) {name} {x_shape} k{k}/s{s}/p{p} N {N} {str(od)[6:]}"
    err = check_close(what, got, want, **tol)
    del want
    need(torch.equal(got, fn()), f"{what}: two launches differ")
    fns = {"direct": fn, "cuDNN": stem_library(x, w, scale, bias, od, s, p)}
    if old is not None:
        fns["old"] = lambda: old(x, w, scale, bias, s, p, od)
    ms = cuda_ms_turns(fns, iters)
    b2b = cuda_ms_turns(fns, iters, reps=B2B)
    b_ms, by = stem_bound(x, w, got)
    rec = dict(shape=list(x_shape), N=N, k=k, s=s, p=p, dtype=str(od)[6:], max_abs_err=err,
               ms=ms["direct"], ms_back_to_back=b2b["direct"], device_ms=device_ms(fn),
               bound_ms=b_ms, bound_by=by, library_ms=ms["cuDNN"],
               library_ms_back_to_back=b2b["cuDNN"])
    extra = ""
    if old is not None:
        rec.update(old_ms=ms["old"], old_ms_back_to_back=b2b["old"])
        extra = f" | the earlier direct kernel {ms['old']:.4f} ({b2b['old']:.4f})"
    log(f"  {what}: {rec['ms']:.4f} ms a call ({rec['ms_back_to_back']:.4f} back to back, device "
        f"{rec['device_ms']:.4f}) | cuDNN {ms['cuDNN']:.4f} ({b2b['cuDNN']:.4f}){extra} | bound "
        f"{b_ms:.4f} ({by}), {rec['device_ms'] / b_ms:.2f}x")
    return rec, (x, w, scale, bias, kw)


def phase_stem(gen, iters):
    """The direct kernel (stem.cu, tensor-core products for every shape of
    the family): yolov5x6's stem at X1 (bf16 (16, 640, 640, 3) -> N 80) and
    X2 (f32 (4, 1280, 1280, 3) -> N 80), each also in turns with the
    earlier direct kernel where ``--old-stem`` names its source; forced at
    the flagship stem (16, 640, 640, 3) -> N 64 in bf16 and f32 (where
    ``stem_form`` picks ``stem_tc`` and ``stem_tf32``), f32 also at (2,
    128, 160, 3); the family's other shapes (``DIRECT_FAMILY``) in both
    dtypes.  Each against the plain version, two launches bit-identical,
    timed against its bound and cuDNN (``direct_case``); X1 and X2 against
    the target of twice the bound and faster than cuDNN."""
    need(not torch.backends.cudnn.allow_tf32, "the f32 stem's plain version runs with TF32 off")
    old = old_direct_stem(OLD_STEM["src"]) if OLD_STEM["src"] else None
    if old is None:
        log("  (no --old-stem: the earlier direct kernel is not timed)")
    res = {}
    for key, (shape, N, od) in DIRECT_PATHS.items():
        res[key], args = direct_case(key, gen, shape, N, 6, 2, 2, od, iters, w_scale=0.15,
                                     old=old)
        r = res[key]
        r["target_met"] = r["ms_back_to_back"] <= 2 * r["bound_ms"] and r["ms"] < r["library_ms"]
        log(f"  {key}: target (at most twice the bound {2 * r['bound_ms']:.4f} ms back to back, "
            f"faster than cuDNN): {'met' if r['target_met'] else 'missed'}")
        if old is not None:
            need(r["ms"] < r["old_ms"] and r["ms_back_to_back"] < r["old_ms_back_to_back"],
                 f"stem {key}: not faster than the earlier direct kernel: {r}")
        if key == "x1":
            x, w, scale, bias, kw = args
            res["plain_ms"] = cuda_ms(lambda: pallas_stem.stem_conv_plain(x, w, scale, bias, **kw),
                                      iters)
        del args
    # the flagship stem, forced: the two checks and tolerances the earlier kernel was held to
    for key, od in (("flagship_bf16", torch.bfloat16), ("flagship_f32", torch.float32)):
        res[key], args = direct_case(key, gen, (16, 640, 640, 3), 64, 6, 2, 2, od, iters,
                                     w_scale=0.15)
        if od == torch.float32:
            x, w, scale, bias, kw = args
            x32 = x[:2, :128, :160].contiguous()
            check_close("stem (direct, f32) (2, 128, 160, 3)",
                        pallas_stem.stem_conv(x32, w, scale, bias, form="direct", **kw),
                        pallas_stem.stem_conv_plain(x32, w, scale, bias, **kw), atol=1e-5,
                        rtol=0.0)
        del args
    res["family"] = []
    for (C, k, s, p) in DIRECT_FAMILY:
        for od in (torch.bfloat16, torch.float32):
            r, args = direct_case("family", gen, (16, 640, 640, C), 64, k, s, p, od, iters)
            res["family"].append(r)
            del args
    torch.cuda.empty_cache()
    x1 = res["x1"]
    return dict(max_abs_err=max([x1["max_abs_err"], res["x2"]["max_abs_err"]]
                                + [r["max_abs_err"] for r in res["family"]]),
                ms=x1["ms"], ms_back_to_back=x1["ms_back_to_back"], device_ms=x1["device_ms"],
                plain_ms=res.pop("plain_ms"), bound_ms=x1["bound_ms"], bound_by=x1["bound_by"],
                library_ms=x1["library_ms"], shapes=res)


# the f32 stem paths' own shapes: the reference fixtures (phase 20), the f32
# hnet-darknet check (phase 23), the convergence check's validation (phase 26)
TF32_PATH_SHAPES = {"fixtures": ((1, 64, 64, 3), 8), "hnet_darknet": ((2, 128, 128, 3), 16),
                    "convergence": ((4, 128, 128, 3), 32)}
# its time at the flagship shape, one call a window: at most half its bound
# of bytes (0.1487 ms), the redesign's target
TF32_TARGET_MS = 0.297


def clocks_under(fn, seconds: float = 1.5, samples: int = 3) -> list:
    """``nvidia-smi``'s SM clock, power draw and active throttle reasons,
    sampled while ``fn`` runs back to back on a second thread."""
    import threading

    stop = []

    def spin():
        while not stop:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()

    th = threading.Thread(target=spin)
    th.start()
    out = []
    try:
        time.sleep(seconds / (samples + 1))
        for _ in range(samples):
            out.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit,"
                 "clocks_throttle_reasons.active", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
            time.sleep(seconds / (samples + 1))
    finally:
        stop.append(True)
        th.join()
    return out


def check_stem_silu_f32():
    """``stem_tf32``'s SiLU alone over v in [-20, 20]: a one-hot centre tap
    makes each output silu(x + bias) (x split into hi and lo, summed back by
    the products), 65,536 pre-activations against the plain f32 version
    within 1e-5."""
    x = torch.zeros((1, 64, 64, 3), device="cuda")
    x[0, :, :, 0] = torch.linspace(-20.0, 20.0, 64 * 64, device="cuda").view(64, 64)
    w = torch.zeros((6, 6, 3, 64), device="cuda")
    w[2, 2, 0] = 1.0
    scale, bias = torch.ones(64, device="cuda"), torch.linspace(0.0, 0.04, 64, device="cuda")
    kw = dict(stride=2, padding=2, out_dtype=torch.float32)
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    need(float(want[0, 0, 0, 0]) < 0 and float(want.max()) > 19.0, "the sweep missed [-20, 20]")
    return check_close("stem_tf32 SiLU alone over [-20, 20]",
                       pallas_stem.stem_conv(x, w, scale, bias, **kw), want, atol=1e-5, rtol=0.0)


def phase_stem_tf32(gen, iters):
    """The f32 stem form (stem_tf32.cu, split-TF32 tensor-core products) at
    (16, 640, 640, 3) -> N 64: within 1e-5 of the plain f32 version (TF32
    off) there, at the three f32 paths' own shapes and, its SiLU alone,
    over [-20, 20]; two launches bit-identical; pre-activations out to
    |v| ~ 20 through the conv recorded beside the direct kernel's error
    there; timed in turns with the direct kernel at f32 and cuDNN's f32
    chain, by both methods, and by its profiler device time, against its
    bound, with the card's clock and power sampled while it runs back to
    back; each path shape timed with its bound and cuDNN's f32 chain."""
    dev = "cuda"
    kw = dict(stride=2, padding=2, out_dtype=torch.float32)
    need(not torch.backends.cudnn.allow_tf32, "the f32 stem's plain version runs with TF32 off")
    x = torch.rand((16, 640, 640, 3), generator=gen, device=dev)
    w = torch.randn((6, 6, 3, 64), generator=gen, device=dev) * 0.15
    scale = torch.rand(64, generator=gen, device=dev) + 0.5
    bias = torch.randn(64, generator=gen, device=dev) * 0.1
    need(pallas_stem.stem_form(x.shape, w.shape, 2, 2, torch.float32) == "tf32",
         "stem_form does not pick stem_tf32 for the flagship stem at f32")
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    torch.cuda.synchronize()
    err = check_close("stem_tf32 (16, 640, 640, 3)", got,
                      pallas_stem.stem_conv_plain(x, w, scale, bias, **kw), atol=1e-5, rtol=0.0)
    need(torch.equal(got, pallas_stem.stem_conv(x, w, scale, bias, **kw)),
         "stem_tf32: two launches differ")
    paths = {}
    for name, (shape, n) in TF32_PATH_SHAPES.items():
        xp = torch.rand(shape, generator=gen, device=dev)
        wp = torch.randn((6, 6, 3, n), generator=gen, device=dev) * 0.15
        sp = torch.rand(n, generator=gen, device=dev) + 0.5
        bp = torch.randn(n, generator=gen, device=dev) * 0.1
        yp = pallas_stem.stem_conv(xp, wp, sp, bp, **kw)
        e = check_close(f"stem_tf32 {name} {shape} N {n}", yp,
                        pallas_stem.stem_conv_plain(xp, wp, sp, bp, **kw), atol=1e-5, rtol=0.0)
        fns = {"stem_tf32": lambda: pallas_stem.stem_conv(xp, wp, sp, bp, **kw),
               "cuDNN": stem_library(xp, wp, sp, bp, torch.float32)}
        ms = cuda_ms_turns(fns, iters)
        b_ms, by = stem_bound(xp, wp, yp)
        paths[name] = dict(shape=shape, n=n, max_abs_err=e, ms=ms["stem_tf32"],
                           ms_back_to_back=cuda_ms(fns["stem_tf32"], iters, reps=B2B),
                           bound_ms=b_ms, bound_by=by, library_ms=ms["cuDNN"])
        log(f"  stem_tf32 {name}: {paths[name]['ms']:.4f} ms a call "
            f"({paths[name]['ms_back_to_back']:.4f} back to back) | cuDNN f32 {ms['cuDNN']:.4f} | "
            f"bound {b_ms:.4f} ({by})")
    err = max(err, *(p["max_abs_err"] for p in paths.values()), check_stem_silu_f32())
    # pre-activations out to |v| ~ 20 through the whole conv: recorded beside
    # the direct kernel's own distance from the plain version there
    wt, bt = w * 4, bias * 30
    want_t = pallas_stem.stem_conv_plain(x, wt, scale, bt, **kw)
    tail = dict(max_abs_err=float((pallas_stem.stem_conv(x, wt, scale, bt, **kw) - want_t)
                                  .abs().max()),
                direct_max_abs_err=float((pallas_stem.stem_conv(x, wt, scale, bt, form="direct",
                                                                **kw) - want_t).abs().max()))
    log(f"  stem_tf32, pre-activations out to |v| ~ 20 through the conv: max_abs_err "
        f"{tail['max_abs_err']:.3g} (the direct kernel {tail['direct_max_abs_err']:.3g}); recorded")
    del want_t
    fns = {"stem_tf32": lambda: pallas_stem.stem_conv(x, w, scale, bias, **kw),
           "direct": lambda: pallas_stem.stem_conv(x, w, scale, bias, form="direct", **kw),
           "cuDNN": stem_library(x, w, scale, bias, torch.float32)}
    ms = cuda_ms_turns(fns, iters)
    b2b = cuda_ms_turns(fns, iters, reps=B2B)
    plain_ms = cuda_ms(lambda: pallas_stem.stem_conv_plain(x, w, scale, bias, **kw), iters)
    b_ms, by = stem_bound(x, w, got)
    for name, t in (("one call a window", ms), (f"{B2B} back to back", b2b)):
        log(f"  stem at (16, 640, 640, 3) f32, in turns, {name}: stem_tf32 {t['stem_tf32']:.4f} ms "
            f"| direct {t['direct']:.4f} | cuDNN {t['cuDNN']:.4f} | bound {b_ms:.4f} ({by}); "
            f"target {TF32_TARGET_MS}: {'met' if t['stem_tf32'] <= TF32_TARGET_MS else 'missed'}")
    need(ms["stem_tf32"] < ms["direct"] and ms["stem_tf32"] < ms["cuDNN"],
         f"stem_tf32 is not faster than both the direct kernel and cuDNN's f32 chain: {ms}")
    dev_ms = device_ms(fns["stem_tf32"])
    clocks = clocks_under(fns["stem_tf32"])
    log(f"  stem_tf32 device time {dev_ms:.4f} ms a call; back to back, SM clock, max, power, "
        f"limit, throttle reasons: {clocks}")
    return dict(max_abs_err=err, ms=ms["stem_tf32"], ms_back_to_back=b2b["stem_tf32"],
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=ms["cuDNN"], turns={"one_call": ms, "back_to_back": b2b}, paths=paths,
                tail=tail, clocks=clocks)


def check_stem_tc_silu():
    """``stem_tc``'s SiLU alone over v in [-20, 20]: a one-hot centre tap
    makes each output silu(bf16(x) + bias), 65,536 pre-activations against
    the f32 SiLU of the plain version; within one bf16 ulp (|d| <=
    2^-7·|plain|, no absolute slack, so the tail's tiny values count)."""
    x = torch.zeros((1, 64, 64, 3), device="cuda")
    x[0, :, :, 0] = torch.linspace(-20.0, 20.0, 64 * 64, device="cuda").view(64, 64)
    w = torch.zeros((6, 6, 3, 64), device="cuda")
    w[2, 2, 0] = 1.0
    scale, bias = torch.ones(64, device="cuda"), torch.linspace(0.0, 0.04, 64, device="cuda")
    kw = dict(stride=2, padding=2, out_dtype=torch.bfloat16)
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    need(float(want[0, 0, 0, 0]) < 0 and float(want.max()) > 19.0, "the sweep missed [-20, 20]")
    rel = ((got.float() - want.float()).abs() / want.float().abs().clamp_min(1e-30)).max()
    log(f"  stem_tc SiLU alone over v in [-20, 20]: max relative error {float(rel):.3g}")
    check_close("stem_tc SiLU alone", got, want, atol=0.0, rtol=2 ** -7)


def phase_stem_tc(gen, iters):
    """The trunk's bf16 stem form (stem_tc.cu) at (16, 640, 640, 3): within
    one bf16 ulp of the plain version on the common stem inputs, on inputs
    whose pre-activations reach |v| ~ 15 (SiLU's negative tail) and, SiLU
    alone, over [-20, 20]; timed in turns with the direct kernel at bf16,
    ``stem_k108`` and cuDNN on the same inputs, by both timing methods."""
    x, w, scale, bias = stem_inputs(gen)
    kw = dict(stride=2, padding=2, out_dtype=torch.bfloat16)
    need(pallas_stem.stem_form(x.shape, w.shape, 2, 2, torch.bfloat16) == "tc",
         "stem_form does not pick stem_tc for the flagship stem")
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    torch.cuda.synchronize()
    err = check_close("stem_tc", got, want, atol=1e-3, rtol=2 ** -7)
    again = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    need(torch.equal(got, again), "stem_tc: two launches differ")
    wt, bt = w * 12, bias * 30                        # pre-activations out to |v| ~ 15
    v = F.conv2d(x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                 wt.to(torch.bfloat16).float().permute(3, 2, 0, 1), stride=2, padding=2)
    v = v * scale[:, None, None] + bt[:, None, None]
    log(f"  stem_tc tail inputs: pre-activations in [{float(v.min()):.2f}, {float(v.max()):.2f}], "
        f"{float((v < -4).float().mean()):.3f} of them below -4")
    del v
    err = max(err, check_close("stem_tc, tail inputs",
                               pallas_stem.stem_conv(x, wt, scale, bt, **kw),
                               pallas_stem.stem_conv_plain(x, wt, scale, bt, **kw),
                               atol=1e-3, rtol=2 ** -7))
    check_stem_tc_silu()
    fns = {"stem_tc": lambda: pallas_stem.stem_conv(x, w, scale, bias, **kw),
           "direct": lambda: pallas_stem.stem_conv(x, w, scale, bias, form="direct", **kw),
           "stem_k108": lambda: stem_lab.stem_k108(x, w, scale, bias),
           "cuDNN": stem_library(x, w, scale, bias)}
    ms = cuda_ms_turns(fns, iters)
    b2b = cuda_ms_turns(fns, iters, reps=B2B)
    plain_ms = cuda_ms(lambda: pallas_stem.stem_conv_plain(x, w, scale, bias, **kw), iters)
    dev = {k: device_ms(fns[k]) for k in ("stem_tc", "direct")}
    flops = 2.0 * got.numel() * stem_lab.KDIM
    b_ms, by = bound(nbytes(x, got, scale, bias) + stem_lab.KDIM * 64 * 2, flops, BF16_FLOPS)
    for name, t in (("one call a window", ms), (f"{B2B} back to back", b2b)):
        log(f"  stem at (16, 640, 640, 3) bf16, in turns, {name}: stem_tc {t['stem_tc']:.4f} ms | "
            f"direct {t['direct']:.4f} | stem_k108 {t['stem_k108']:.4f} | cuDNN {t['cuDNN']:.4f} | "
            f"bound {b_ms:.4f} ({by}); target 2 x bound {2 * b_ms:.4f}: "
            f"{'met' if t['stem_tc'] <= 2 * b_ms else 'missed'}")
    log(f"  stem_tc device time {dev['stem_tc']:.4f} ms (direct {dev['direct']:.4f}), "
        f"{dev['stem_tc'] / b_ms:.2f}x its bound")
    # what a window's predecessor costs: the same turns with the direct
    # kernel's window first, so that it follows cuDNN's instead of stem_tc's
    swapped = cuda_ms_turns({k: fns[k] for k in ("direct", "stem_tc", "stem_k108", "cuDNN")},
                            iters)
    log(f"  the same, one call a window, direct's window after cuDNN's: stem_tc "
        f"{swapped['stem_tc']:.4f} ms | direct {swapped['direct']:.4f} (not a check)")
    need(ms["stem_tc"] < ms["direct"] and ms["stem_tc"] < ms["cuDNN"],
         f"stem_tc is not faster than both the direct kernel and cuDNN: {ms}")
    return dict(max_abs_err=err, ms=ms["stem_tc"], ms_back_to_back=b2b["stem_tc"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=ms["cuDNN"],
                device_ms=dev["stem_tc"], turns={"one_call": ms, "back_to_back": b2b,
                                                 "direct_first": swapped, "device": dev})


def clustered_boxes(gen, B, K, dev, thr=0.45, extent=600.0, pairs_at=700.0):
    """Clustered boxes per image (centres in [0, extent)), with pairs at IoU
    exactly ``thr`` (f32) from ``pairs_at`` on, and tied scores."""
    centers = torch.rand((B, K // 8, 2), generator=gen, device=dev) * extent
    c = centers.repeat_interleave(8, 1) + torch.randn((B, K, 2), generator=gen, device=dev) * 6
    wh = torch.rand((B, K, 2), generator=gen, device=dev) * 40 + 8
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    # pairs [x, y, x+10, y+10] and [x, y, x+10, y+10·thr]: 32 on an 8 x 4 grid
    for i in range(0, 64, 2):
        x, y = pairs_at + 20.0 * (i // 2 % 8), pairs_at + 20.0 * (i // 16)
        boxes[:, i] = torch.tensor([x, y, x + 10.0, y + 10.0], device=dev)
        boxes[:, i + 1] = torch.tensor([x, y, x + 10.0, y + 10.0 * thr], device=dev)
    scores = torch.rand((B, K), generator=gen, device=dev)
    scores[:, 100:200] = 0.5                          # ties: resolved by index
    valid = torch.rand((B, K), generator=gen, device=dev) > 0.1
    return boxes, scores, valid


def phase_nms(gen, iters):
    dev = "cuda"
    B, K, max_det, thr = 16, 1024, 300, 0.45
    boxes, scores, valid = clustered_boxes(gen, B, K, dev)
    i1, k1 = pallas_nms.nms_padded_pallas(boxes, scores, valid, thr, max_det)
    i2, k2 = nms_padded(boxes, scores, valid, thr, max_det)
    torch.cuda.synchronize()
    same = torch.equal(i1.to(torch.int64), i2.to(torch.int64)) and torch.equal(k1, k2)
    log(f"  nms: bit-identical {same} (tolerance: exact), kept/image "
        f"{k1.sum(1).float().mean().item():.1f}")
    if not same:
        raise AssertionError("nms: kernel disagrees with its plain version")
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -math.inf)), dim=-1,
                       descending=True, stable=True).indices
    sb = torch.gather(boxes, 1, order[..., None].expand_as(boxes)).contiguous()
    sv = torch.gather(valid, 1, order)
    need(sv.dtype == torch.bool, "the sorted valid mask is not bool")
    t = kernel_ms(lambda: pallas_nms.nms_keep_sorted(sb, sv, thr, max_det), iters)
    plain_ms = cuda_ms(lambda: pallas_nms.nms_keep_sorted_plain(sb, sv, thr, max_det),
                       max(3, iters // 4), warmup=1)
    host = host_us(lambda: pallas_nms.nms_keep_sorted(sb, sv, thr, max_det))
    dev_ms = device_ms(lambda: pallas_nms.nms_keep_sorted(sb, sv, thr, max_det))
    # work this data needs: the IoU of every valid upper-triangle pair (~20 f32 ops)
    nv = sv.sum(1).double()
    flops = float((nv * (nv - 1) / 2).sum()) * 20
    b_ms, by = bound(nbytes(sb, sv, i1, k1), flops, F32_FLOPS)
    log(f"  nms (16, 1024) -> 300: kernel {t['ms']:.4f} ms, {t['ms_back_to_back']:.4f} back to "
        f"back (target 0.08: {'met' if t['ms_back_to_back'] <= 0.08 else 'missed'}); device "
        f"time {dev_ms:.4f} ms (profiler); wrapper host time {host:.1f} us a call")
    return dict(max_abs_err=0.0, **t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=None, device_ms=dev_ms, host_us_per_call=host)


def flagship_rois(gen, K, dev):
    boxes = torch.rand((K, 2), generator=gen, device=dev) * 600
    wh = torch.rand((K, 2), generator=gen, device=dev) * 60 + 4
    wide = torch.rand(K, generator=gen, device=dev) < 0.1
    wh[wide] *= 6                                     # wider than the 16-px window at P3
    levels = torch.randint(0, 4, (K,), generator=gen, device=dev)
    b_idx = torch.randint(0, 16, (K,), generator=gen, device=dev)
    return torch.cat([boxes, boxes + wh], -1), levels, b_idx


def touched_cells(levels, meta, ys, xs, bounds, window, first=None):
    """Distinct level cells the ROIs (the ``first`` ones, if given) read:
    the bytes their data needs.  Cells are named in canvas coordinates
    (canvas row oy + iy is one level's row), which is one name per cell."""
    k = meta.shape[0] if first is None else first
    meta, ys, xs, bounds = meta[:k], ys[:k], xs[:k], bounds[:k]

    def taps(c, lo, hi, size):
        cc = torch.minimum(torch.maximum(c, lo[:, None]), hi[:, None] - 1)
        low = cc.floor()
        idx = torch.stack([low, torch.minimum(low + 1, hi[:, None] - 1)], -1).reshape(c.shape[0], -1)
        ok = (c > lo[:, None] - 1) & (c < hi[:, None])
        ok = ok[..., None].expand(-1, -1, 2).reshape(c.shape[0], -1) & (idx >= 0) & (idx < size)
        return idx.long(), ok
    iy, oky = taps(ys, bounds[:, 0], bounds[:, 1], window[0])
    ix, okx = taps(xs, bounds[:, 2], bounds[:, 3], window[1])
    Ht, W0 = sum(f.shape[1] for f in levels), levels[0].shape[2]
    rows = meta[:, 0:1].long() * Ht + meta[:, 1:2].long() + iy
    cols = meta[:, 2:3].long() + ix
    cell = rows[:, :, None] * W0 + cols[:, None, :]
    ok = oky[:, :, None] & okx[:, None, :]
    return int(torch.unique(cell[ok]).numel())


def roi_bound(args, out, first=None):
    """The pooling's bound: the touched cells once, the coordinates, the
    whole output once; n x n samples of 4 taps, one multiply-add each."""
    levels, meta, ys, xs, bnds, window, M, n = args[:8]
    k = meta.shape[0] if first is None else first
    C = levels[0].shape[-1]
    cells = touched_cells(levels, meta, ys, xs, bnds, window, first)
    need_bytes = cells * C * levels[0].element_size() + nbytes(meta, ys, xs, bnds, out)
    return bound(need_bytes, k * M * M * n * n * 4 * 2 * C, F32_FLOPS)


def capture_bounded(fn):
    """Run ``fn()`` and return (its result, the arguments of its one
    ``roi_align_bounded`` call)."""
    captured = {}
    orig = pallas_roi_align.roi_align_bounded

    def spy(*a):
        captured["args"] = a
        return orig(*a)

    pallas_roi_align.roi_align_bounded = spy
    try:
        out = fn()
    finally:
        pallas_roi_align.roi_align_bounded = orig
    return out, captured["args"]


def packed_via_canvas(feats, boxes, levels, b_idx, strides, M, window):
    """The packed pooling as PR 1–4 ran it: the levels padded and stacked into
    one canvas (``level_canvas``), then the kernel over that canvas as a
    single level.  The "before" of the whole-pooling timing."""
    canvas, meta = level_canvas(feats, strides)
    B, Ht, W0, _ = canvas.shape
    win = min(window, Ht, W0)
    ys, xs, moff, mh, mw = sample_coords(boxes, levels, meta, M * 2, False)
    oy = torch.floor(ys[:, 0]).clamp(0, Ht - win).to(torch.int32)
    ox = torch.floor(xs[:, 0]).clamp(0, W0 - win).to(torch.int32)
    oyf, oxf = oy.to(torch.float32), ox.to(torch.float32)
    bounds = torch.stack([moff - oyf, moff + mh - oyf, -oxf, mw - oxf], -1)
    b = b_idx.to(torch.int32).clamp(0, B - 1)
    meta1 = torch.stack([b, oy, ox, torch.zeros_like(oy)], -1)
    return pallas_roi_align.roi_align_bounded([canvas], meta1, ys - oyf[:, None],
                                              xs - oxf[:, None], bounds, (win, win), M, 2)


def phase_roi(gen, iters):
    """The packed pooling at the flagship's shape (768 ROIs, 14x14, n 2, 256
    bf16 channels, window 16, levels read in place): all active and with a
    360-of-768 prefix (rows past it exactly 0), two launches bit-identical;
    the kernel's two readings, its host time per call, and the whole
    ``multiscale_roi_align_packed`` (coordinates + kernel) timed in turns
    with PR 1–4's form that built the canvas first."""
    dev = "cuda"
    C, K, used = 256, 768, 360
    feats = [torch.randn((16, 640 // s, 640 // s, C), generator=gen, device=dev).to(torch.bfloat16)
             for s in (8, 16, 32, 64)]
    strides = (8.0, 16.0, 32.0, 64.0)
    boxes, levels, b_idx = flagship_rois(gen, K, dev)
    got, args = capture_bounded(
        lambda: multiscale_roi_align_packed(feats, boxes, levels, b_idx, strides, 14, window=16))
    need([f.data_ptr() for f in args[0]] == [f.data_ptr() for f in feats],
         "the pooling did not get the level maps in place")
    rab, plain = pallas_roi_align.roi_align_bounded, pallas_roi_align.roi_align_bounded_plain
    want = plain(*args)
    torch.cuda.synchronize()
    # the same rounding points (matrices and row intermediate in bf16) and merge order
    err = check_equal("roi_align", got, want)
    need(torch.equal(got, rab(*args)), "roi_align: two launches differ")
    args_p = args[:8] + (torch.tensor(used, device=dev),)
    got_p = rab(*args_p)
    check_equal(f"roi_align, active {used} of {K}", got_p, plain(*args_p))
    need(bool((got_p[used:] == 0).all()), "roi_align: a row past the active prefix is not 0")
    need(torch.equal(got_p[:used], got[:used]), "roi_align: the prefix changed active rows")
    need(torch.equal(packed_via_canvas(feats, boxes, levels, b_idx, strides, 14, 16), got),
         "roi_align: the level maps and the stacked canvas give different rows")
    fns = {"kernel": lambda: rab(*args), f"kernel_{used}": lambda: rab(*args_p)}
    ms = cuda_ms_turns(fns, iters)
    b2b = cuda_ms_turns(fns, iters, reps=B2B)
    plain_ms = cuda_ms(lambda: plain(*args), iters)
    host = host_us(lambda: rab(*args))
    dev = {"all": device_ms(lambda: rab(*args)), "prefix": device_ms(lambda: rab(*args_p))}
    whole = {"levels in place": lambda: multiscale_roi_align_packed(feats, boxes, levels, b_idx,
                                                                    strides, 14, window=16),
             "canvas first": lambda: packed_via_canvas(feats, boxes, levels, b_idx, strides, 14,
                                                       16)}
    w_ms = cuda_ms_turns(whole, iters)
    w_b2b = cuda_ms_turns(whole, iters, reps=B2B)
    b_ms, by = roi_bound(args, got)
    b_ms_p, _ = roi_bound(args_p, got_p, first=used)
    for name, t in (("one call a window", ms), (f"{B2B} back to back", b2b)):
        log(f"  roi_align {name}: all {K} {t['kernel']:.4f} ms (target 0.10 back to back) | "
            f"active {used} {t[f'kernel_{used}']:.4f} ms (target 0.06) | bound {b_ms:.4f} "
            f"({by}), {b_ms_p:.4f} at {used}")
    log(f"  roi_align targets back to back: all {'met' if b2b['kernel'] <= 0.10 else 'missed'}, "
        f"prefix {'met' if b2b[f'kernel_{used}'] <= 0.06 else 'missed'}; device time "
        f"(profiler) all {dev['all']:.4f} ms, active {used} {dev['prefix']:.4f} ms; wrapper host "
        f"time {host:.1f} us a call")
    for name, t in (("one call a window", w_ms), (f"{B2B} back to back", w_b2b)):
        log(f"  multiscale_roi_align_packed whole (coordinates + kernel), in turns, {name}: "
            f"levels in place {t['levels in place']:.4f} ms | canvas first (PR 1-4) "
            f"{t['canvas first']:.4f} ms")
    return dict(max_abs_err=err, ms=ms["kernel"], ms_back_to_back=b2b["kernel"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                device_ms=dev["all"], host_us_per_call=host,
                active_360=dict(ms=ms[f"kernel_{used}"], ms_back_to_back=b2b[f"kernel_{used}"],
                                device_ms=dev["prefix"], bound_ms=b_ms_p),
                whole_pooling={"one_call": w_ms, "back_to_back": w_b2b})


def mask_head_flops(n: int, C: int = 256) -> float:
    return float(n) * (4 * 196 * 9 * C * C * 2 + 4 * 196 * C * C * 2 + 4 * 196 * C * 2)


@torch.no_grad()
def seeded_mask_head(nc: int, C: int, seed: int) -> MaskHead:
    """A mask head on the card with He-normal weights and small biases from
    ``seed``: the synthetic head of the mask-head checks."""
    head = MaskHead(nc, C, C)
    g = torch.Generator().manual_seed(seed)
    for p in head.parameters():
        fan = p[0].numel() if p.dim() > 1 else 1
        p.copy_(torch.randn(p.shape, generator=g) * (math.sqrt(2.0 / fan) if p.dim() > 1 else 0.05))
    return head.to("cuda")


def mask_head_library(head: MaskHead, dtype=torch.bfloat16):
    """The mask head as cuDNN's chain in ``dtype`` (4 convs, deconv, 1x1,
    sigmoid on NCHW input): the library yardstick of the mask-head kernels."""
    bf = lambda t: t.to(dtype)
    convs = [(bf(c.weight), bf(c.bias)) for c in head.fcn]
    preds = head.maskrcnn_preds
    dw, db = bf(preds.conv5_mask.weight), bf(preds.conv5_mask.bias)
    lw, lb = bf(preds.mask_fcn_logits.weight), bf(preds.mask_fcn_logits.bias)

    def library(xb):
        y = xb
        for w, b in convs:
            y = F.relu(F.conv2d(y, w, b, padding=1))
        y = F.relu(F.conv_transpose2d(y, dw, db, stride=2))
        return torch.sigmoid(F.conv2d(y, lw, lb))

    return library


def phase_mask_head(gen, iters):
    """The mask head at the flagship's 768-ROI budget, all slots active and
    with a 360-of-768 prefix (``active``, as the slide's packed branch gives
    it): within 2e-2 of the plain version, inactive slots exactly 0, two
    launches bit-identical; timed beside cuDNN's chain on all 768 and on the
    360 used ROIs."""
    dev = "cuda"
    N, C, nc, used = 768, 256, 2, 360
    head = seeded_mask_head(nc, C, 1)
    pooled = torch.randn((N, 14, 14, C), generator=gen, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, nc, (N,), generator=gen, device=dev)
    act = torch.tensor(used, dtype=torch.int32, device=dev)
    with torch.no_grad():
        got = pallas_mask_head.fused_mask_probs(head, pooled, labels)
        want = pallas_mask_head.fused_mask_probs_plain(head, pooled, labels)
        torch.cuda.synchronize()
        # same rounding points; a bf16 intermediate may round the other way
        err = check_close("mask_head", got, want, atol=2e-2, rtol=0.0)
        need(torch.equal(got, pallas_mask_head.fused_mask_probs(head, pooled, labels)),
             "mask_head: two launches differ")
        got_p = pallas_mask_head.fused_mask_probs(head, pooled, labels, act)
        check_close(f"mask_head, active {used} of {N}", got_p,
                    pallas_mask_head.fused_mask_probs_plain(head, pooled, labels, act),
                    atol=2e-2, rtol=0.0)
        need(bool((got_p[used:] == 0).all()), "mask_head: an inactive slot is not 0")
        need(torch.equal(got_p[:used], got[:used]), "mask_head: the prefix changed active slots")
        plain_ms = cuda_ms(lambda: pallas_mask_head.fused_mask_probs_plain(head, pooled, labels),
                           iters)
        library = mask_head_library(head)
        xb = pooled.permute(0, 3, 1, 2)
        # one reading per side, the kernel's and cuDNN's windows in turns
        fns = {"kernel": lambda: pallas_mask_head.fused_mask_probs(head, pooled, labels),
               "cuDNN": lambda: library(xb),
               "kernel_360": lambda: pallas_mask_head.fused_mask_probs(head, pooled, labels, act),
               "cuDNN_360": lambda: library(xb[:used])}
        ms = cuda_ms_turns(fns, iters)
        b2b = cuda_ms_turns(fns, iters, reps=B2B)
    wbytes = (4 * 9 * C * C + 4 * C + 4 * C * C + C) * 2
    b_ms, by = bound(nbytes(pooled, got) + wbytes + N * C * 2 + N * 4, mask_head_flops(N),
                     BF16_FLOPS)
    b_ms_p, _ = bound(nbytes(pooled[:used], got) + wbytes + used * (C * 2 + 4),
                      mask_head_flops(used), BF16_FLOPS)
    for name, t in (("one call a window", ms), (f"{B2B} back to back", b2b)):
        log(f"  mask_head in turns, {name}: at {N} kernel {t['kernel']:.4f} ms | cuDNN chain "
            f"{t['cuDNN']:.4f} | bound {b_ms:.4f} ({by}), target 2 x bound {2 * b_ms:.4f} "
            f"{'met' if t['kernel'] <= 2 * b_ms else 'missed'}; active {used}: kernel "
            f"{t['kernel_360']:.4f} ms | cuDNN chain on {used} {t['cuDNN_360']:.4f} | bound "
            f"{b_ms_p:.4f}")
    need(ms["kernel"] < ms["cuDNN"], f"mask_head ({ms['kernel']:.4f} ms) is not faster than "
                                     f"cuDNN's chain ({ms['cuDNN']:.4f} ms)")
    return dict(max_abs_err=err, ms=ms["kernel"], ms_back_to_back=b2b["kernel"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=ms["cuDNN"],
                active_360=dict(ms=ms["kernel_360"], ms_back_to_back=b2b["kernel_360"],
                                bound_ms=b_ms_p, library_ms=ms["cuDNN_360"]))


def phase_mask_head_f32(gen, iters):
    """The f32 form at the pretrained fixtures' path (an f32 model, one
    image's 100 mask slots) and at the flagship's 768-ROI budget with a 360
    prefix: within 1e-4 of the plain version in f32 (TF32 off), inactive
    slots exactly 0, two launches bit-identical, the bf16 kernel not
    launched; timed in turns with cuDNN's f32 chain, which it must beat at
    both shapes.  Its bound is split TF32's (three tensor-core products a
    product at 495 TFLOP/s), the CUDA cores' f32 bound printed beside it."""
    dev = "cuda"
    C, nc = 256, 2
    head = seeded_mask_head(nc, C, 5)
    library = mask_head_library(head, torch.float32)
    res = {}
    for N, used in ((100, None), (768, 360)):
        pooled = torch.randn((N, 14, 14, C), generator=gen, device=dev)
        labels = torch.randint(0, nc, (N,), generator=gen, device=dev)
        act = None if used is None else torch.tensor(used, dtype=torch.int32, device=dev)
        with torch.no_grad():
            bf16_launches = kernels.LAUNCHES["mask_head"]
            got = pallas_mask_head.fused_mask_probs(head, pooled, labels, act)
            want = pallas_mask_head.fused_mask_probs_plain(head, pooled, labels, act)
            torch.cuda.synchronize()
            need(kernels.LAUNCHES["mask_head"] == bf16_launches,
                 "mask_head_f32: f32 features launched the bf16 kernel")
            err = check_close(f"mask_head_f32 N {N}, active {used or N}", got, want, atol=1e-4,
                              rtol=0.0)
            need(err <= F32_HEAD_PROMOTED_ATOL,
                 f"mask_head_f32 N {N}: max_abs_err {err:.3g} > {F32_HEAD_PROMOTED_ATOL} (the "
                 f"tensor-core partial is not promoted often enough)")
            need(torch.equal(got, pallas_mask_head.fused_mask_probs(head, pooled, labels, act)),
                 "mask_head_f32: two launches differ")
            if used is not None:
                need(bool((got[used:] == 0).all()), "mask_head_f32: an inactive slot is not 0")
            plain_ms = cuda_ms(lambda: pallas_mask_head.fused_mask_probs_plain(
                head, pooled, labels, act), iters)
            xb = pooled.permute(0, 3, 1, 2)[:used]
            fns = {"kernel": lambda: pallas_mask_head.fused_mask_probs(head, pooled, labels, act),
                   "cuDNN": lambda: library(xb)}
            ms = cuda_ms_turns(fns, iters)
            b2b = cuda_ms_turns(fns, iters, reps=B2B)
            dev_t = {name: device_ms(fn) for name, fn in fns.items()}
        k = used or N
        wbytes = (4 * 9 * C * C + 4 * C + 4 * C * C + C) * 4
        moved = nbytes(pooled[:k], got) + wbytes + k * (C * 4 + 8)
        b_ms, by = bound(moved, 3 * mask_head_flops(k), TF32_FLOPS)
        f32_ms, _ = bound(moved, mask_head_flops(k), F32_FLOPS)
        res[N] = dict(max_abs_err=err, ms=ms["kernel"], ms_back_to_back=b2b["kernel"],
                      device_ms=dev_t["kernel"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                      cuda_core_bound_ms=f32_ms, library_ms=ms["cuDNN"],
                      library_ms_back_to_back=b2b["cuDNN"], library_device_ms=dev_t["cuDNN"])
        log(f"  mask_head_f32 at {N} ROIs, {k} active: kernel {ms['kernel']:.4f} ms "
            f"({b2b['kernel']:.4f} back to back, device {dev_t['kernel']:.4f}) | cuDNN f32 chain on "
            f"{k} {ms['cuDNN']:.4f} ({b2b['cuDNN']:.4f}, device {dev_t['cuDNN']:.4f}) | plain "
            f"{plain_ms:.4f} | bound {b_ms:.4f} ({by}, split TF32; CUDA-core f32 {f32_ms:.4f}) | "
            f"max_abs_err {err:.3g}")
        need(ms["kernel"] < ms["cuDNN"], f"mask_head_f32 at {N} ROIs, {k} active "
                                         f"({ms['kernel']:.4f} ms) is not faster than cuDNN's "
                                         f"f32 chain ({ms['cuDNN']:.4f} ms)")
    return {**res[100], "flagship_768_active_360": res[768]}


def phase_roi_single(gen, iters):
    """hnet's ROI pyramid: the single-level kernel on the four hnet-nucls
    level shapes (one 640 px tile ROI per image, M = S, sampling 2) in ONE
    launch (``roi_align_levels``), bit for bit the four plain ``roi_align``
    calls; its two readings, device time and wrapper host time a forward,
    in turns with the same four levels as four ``roi_align_single``
    launches; then a small f32 case with 5 channels (the scalar path) and
    boxes partly off the map."""
    dev = "cuda"
    feats = [torch.randn((4, s, s, 256), generator=gen, device=dev).to(torch.bfloat16)
             for s, _ in HNET_LEVELS]
    tile = torch.tensor([0.0, 0.0, 640.0, 640.0], device=dev).expand(4, 1, 4).contiguous()
    sizes, scales = [s for s, _ in HNET_LEVELS], [1.0 / st for _, st in HNET_LEVELS]

    def forward():
        return pallas_roi_align.roi_align_levels(feats, tile, sizes, scales, 2)

    def four_launches():
        return [pallas_roi_align.roi_align_single(f, tile, s, sc, 2)
                for f, s, sc in zip(feats, sizes, scales)]

    n0 = kernels.LAUNCHES["roi_align_single"]
    got = forward()
    need(kernels.LAUNCHES["roi_align_single"] == n0 + 1,
         "roi_align_levels: the four levels took more than one launch")
    want = pallas_roi_align.roi_align_levels_plain(feats, tile, sizes, scales, 2)
    torch.cuda.synchronize()
    # the plain version's rounding points and merge order; every bin sums
    # two exact bf16 products a step, so the sums cannot differ
    err = max(check_equal(f"roi_align_single {tuple(f.shape)}", g, w)
              for f, g, w in zip(feats, got, want))
    need(all(torch.equal(a, b) for a, b in zip(four_launches(), got)),
         "roi_align_single: the one-map entry and the one-launch pyramid differ")
    f5 = torch.randn((2, 37, 23, 5), generator=gen, device=dev)
    xy = torch.rand((2, 9, 2), generator=gen, device=dev) * 110 - 10
    b5 = torch.cat([xy, xy + torch.rand((2, 9, 2), generator=gen, device=dev) * 70], -1)
    check_close("roi_align_single f32 (2, 37, 23, 5), 9 ROIs, M 7",
                pallas_roi_align.roi_align_single(f5, b5, 7, 0.25, 2),
                roi_align(f5, b5, 7, 0.25, 2), atol=1e-5, rtol=0.0)
    fns = {"one launch": forward, "four launches": four_launches}
    ms = cuda_ms_turns(fns, iters)
    b2b = cuda_ms_turns(fns, iters, reps=B2B)
    dev_ms = {k: device_ms(fn) for k, fn in fns.items()}
    host = {k: host_us(fn) for k, fn in fns.items()}
    plain_ms = cuda_ms(lambda: pallas_roi_align.roi_align_levels_plain(feats, tile, sizes, scales,
                                                                        2), iters)
    # per output element: n x n samples of 4 taps, one multiply-add each
    flops = sum(o.numel() for o in got) * 4 * 4 * 2
    b_ms, by = bound(nbytes(*feats, *got) + 4 * tile.numel() * 4, flops, F32_FLOPS)
    for name, t in (("one call a window", ms), (f"{B2B} back to back", b2b),
                    ("device time (profiler)", dev_ms)):
        log(f"  roi_align_single, the four hnet levels, in turns, {name}: one launch "
            f"{t['one launch']:.4f} ms | four launches {t['four launches']:.4f} | bound "
            f"{b_ms:.4f} ({by})")
    log(f"  roi_align_single wrapper host time a forward: one launch {host['one launch']:.1f} us | "
        f"four launches {host['four launches']:.1f} us; targets: device time <= 0.083 ms "
        f"{'met' if dev_ms['one launch'] <= 0.083 else 'missed'}, one call a window <= 0.12 ms "
        f"{'met' if ms['one launch'] <= 0.12 else 'missed'}")
    return dict(max_abs_err=err, ms=ms["one launch"], ms_back_to_back=b2b["one launch"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                device_ms=dev_ms["one launch"], host_us=host["one launch"],
                four_launches=dict(ms=ms["four launches"], ms_back_to_back=b2b["four launches"],
                                   device_ms=dev_ms["four launches"],
                                   host_us=host["four launches"]))


def levels_bwd_bound(grads, outs, rois):
    """The single-level backward's bound: each output gradient read once,
    each map gradient written once, the boxes read; per output-gradient
    element n x n samples of 4 taps, a multiply-add each (n = 2)."""
    flops = sum(g.numel() for g in grads) * 4 * 4 * 2
    return bound(nbytes(*grads, *outs, rois), flops, F32_FLOPS)


def constrain_pooling(gen, B: int = 4, K: int = 100):
    """The confliction loss's pooling at hnet-nucls' shapes: seg
    probabilities (B, 40, 40, 5) f32 at stride 16, K boxes an image of 10-40
    px over the 640 px tile, output 28 (the masks' size)."""
    probs = torch.softmax(torch.randn((B, 40, 40, 5), generator=gen, device="cuda"), -1)
    wh = torch.rand((B, K, 2), generator=gen, device="cuda") * 30 + 10
    xy = torch.rand((B, K, 2), generator=gen, device="cuda") * (640 - wh)
    return probs, torch.cat([xy, xy + wh], -1)


class backward_path:
    """``with backward_path("gather"):`` the single-level backward takes its
    gather path for every call (the per-ROI path off); ``"per_roi"``: its
    own choice.  The cached plans are dropped on entry and exit."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.saved = pallas_roi_align.PER_ROI_MIN_K
        if self.path == "gather":
            pallas_roi_align.PER_ROI_MIN_K = 1 << 30
        pallas_roi_align._BWD_PLANS.clear()

    def __exit__(self, *exc):
        pallas_roi_align.PER_ROI_MIN_K = self.saved
        pallas_roi_align._BWD_PLANS.clear()
        return False


def constrain_bwd_paths(cargs, iters: int, what: str) -> dict:
    """The single-level backward at a confliction-loss call, by both paths:
    each within 1e-5 x max|g| of the CPU's plain version (ROADMAP C.4) and
    deterministic (two launches bit-identical), its times; the per-ROI
    path's (the one the call takes) at the top level, the gather's under
    ``"gather"``."""
    bwd = pallas_roi_align.roi_align_levels_bwd
    want = pallas_roi_align.roi_align_levels_bwd_plain(*cpu_tree(cargs))
    res = {}
    for path in ("gather", "per_roi"):
        with backward_path(path):
            need(pallas_roi_align._bwd_plan(cargs[1], cargs[2], cargs[3], 2)[1]
                 == (path == "per_roi"), f"roi_align_single_bwd did not take its {path} path")
            got = bwd(*cargs)
            err = check_bwd(f"roi_align_single_bwd ({path} path), {what} (card vs the CPU's "
                            f"plain version)", [x.cpu() for x in got], want, 1e-5)
            need(torch.equal(got[0], bwd(*cargs)[0]),
                 f"roi_align_single_bwd ({path} path): two launches differ")
            t = kernel_ms(lambda: bwd(*cargs), iters)
            t["device_ms"] = device_ms(lambda: bwd(*cargs))
            t["device_launches"] = bwd_launches("roi_align_single_bwd", lambda: bwd(*cargs),
                                                f"({path} path), {what}")
        res[path] = dict(t, max_abs_err=err)
    return dict(res.pop("per_roi"), **res)


def phase_roi_single_bwd(gen, iters):
    """The single-level ROI-align's backward at its two call sites: hnet's
    ROI pyramid (the four hnet-nucls levels, bf16, 256 channels, one
    whole-tile ROI an image, one launch) bit for bit the plain version's
    autograd on the card; the confliction loss's pooling (f32, 5 channels,
    100 boxes an image, output 28, scale 1/16) within 1e-5 x max|g| of the
    plain version on the CPU (ROADMAP C.4).  Times of both, the pyramid's as
    the record."""
    dev = "cuda"
    bwd, plain = pallas_roi_align.roi_align_levels_bwd, pallas_roi_align.roi_align_levels_bwd_plain
    feats = [torch.randn((4, s, s, 256), generator=gen, device=dev).to(torch.bfloat16)
             for s, _ in HNET_LEVELS]
    tile = torch.tensor([0.0, 0.0, 640.0, 640.0], device=dev).expand(4, 1, 4).contiguous()
    sizes, scales = [s for s, _ in HNET_LEVELS], [1.0 / st for _, st in HNET_LEVELS]
    gs = [torch.randn((4, 1, s, s, 256), generator=gen, device=dev).to(torch.bfloat16)
          for s in sizes]
    args = (gs, feats, tile, sizes, scales, 2)
    n0 = kernels.LAUNCHES["roi_align_single_bwd"]
    got = bwd(*args)
    need(kernels.LAUNCHES["roi_align_single_bwd"] == n0 + 1,
         "roi_align_levels_bwd: the four levels took more than one launch")
    torch.cuda.synchronize()
    # each level cell sums two exact bf16 terms a step, on both sides
    err = max(check_equal(f"roi_align_single_bwd pyramid {tuple(f.shape)}", g, w)
              for f, g, w in zip(feats, got, plain(*args)))
    t = kernel_ms(lambda: bwd(*args), iters)
    t["device_ms"] = device_ms(lambda: bwd(*args))
    t["device_launches"] = bwd_launches("roi_align_single_bwd", lambda: bwd(*args),
                                        "at the pyramid's four levels")
    plain_ms = cuda_ms(lambda: plain(*args), 5)
    b_ms, by = levels_bwd_bound(gs, got, tile)
    log(f"  roi_align_single_bwd, the four hnet levels: {t['ms']:.4f} ms a call "
        f"({t['ms_back_to_back']:.4f} back to back, device {t['device_ms']:.4f}) | plain "
        f"{plain_ms:.4f} ms | bound {b_ms:.4f} ms ({by})")

    probs, boxes = constrain_pooling(gen)
    gc = [torch.randn((4, 100, 28, 28, 5), generator=gen, device=dev)]
    cargs = (gc, [probs], boxes, [28], [1.0 / 16], 2)
    tc = constrain_bwd_paths(cargs, iters, "the confliction loss's pooling (4, 40, 40, 5) f32, "
                                           "100 boxes of 10-40 px an image, output 28")
    tc["plain_ms"] = cuda_ms(lambda: plain(*cargs), 5)
    tc["bound_ms"], tc["bound_by"] = levels_bwd_bound(gc, bwd(*cargs), boxes)
    log(f"  roi_align_single_bwd, the confliction loss's pooling: {tc['ms']:.4f} ms a call "
        f"({tc['ms_back_to_back']:.4f} back to back, device {tc['device_ms']:.4f}) | gather "
        f"path {tc['gather']['ms']:.4f} ({tc['gather']['ms_back_to_back']:.4f}, device "
        f"{tc['gather']['device_ms']:.4f}) | plain {tc['plain_ms']:.4f} ms | bound "
        f"{tc['bound_ms']:.4f} ms ({tc['bound_by']})")
    return dict(max_abs_err=err, ms=t["ms"], ms_back_to_back=t["ms_back_to_back"],
                device_ms=t["device_ms"], device_launches=t["device_launches"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None, constrain=tc)


def check_hnet_shapes(gen, iters):
    """Kernels 2–4 at the shapes hnet-nucls gives them, with the tolerances
    of their flagship checks, and the times of NMS and the canvas ROI-align
    there (both readings):
      * NMS bit-identical: the RPN's (4, 1024) boxes → 512 at IoU 0.7, and
        the class-aware (4, 512) → 100 at IoU 0.5 through
        ``batched_nms_padded`` (labels 0–4, each image offset by its own span);
      * the canvas ROI-align on the (4, 300, 160, 256) bf16 canvas: the box
        head's 4 x 512 ROIs at 7x7 and the mask head's 4 x 100 at 14x14, each
        on the level torchvision's LevelMapper gives it;
      * the mask head at N = 400 with hnet's five mask classes."""
    dev = "cuda"
    boxes, scores, valid = clustered_boxes(gen, 4, 1024, dev, thr=0.7, extent=640.0,
                                           pairs_at=400.0)
    boxes = boxes.clamp(0.0, 640.0)                   # the RPN clips to the tile
    i1, k1 = pallas_nms.nms_padded_pallas(boxes, scores, valid, 0.7, 512)
    i2, k2 = nms_padded(boxes, scores, valid, 0.7, 512)
    same = torch.equal(i1.to(torch.int64), i2.to(torch.int64)) and torch.equal(k1, k2)
    times = {"nms_4x1024": kernel_ms(
        lambda: pallas_nms.nms_padded_pallas(boxes, scores, valid, 0.7, 512), iters)}
    log(f"  nms (4, 1024) -> 512 at IoU 0.7: bit-identical {same}, kept/image "
        f"{k1.sum(1).tolist()}; with its sort {times['nms_4x1024']}")
    boxes, scores, valid = clustered_boxes(gen, 4, 512, dev, thr=0.5, extent=640.0,
                                           pairs_at=400.0)
    boxes = boxes.clamp(0.0, 640.0)
    labels = torch.randint(0, 5, (4, 512), generator=gen, device=dev)
    labels[:, 1:64:2] = labels[:, 0:64:2]             # each exact-IoU pair shares a class
    valid &= scores > 0.05
    i1, k1 = batched_nms_padded(boxes, scores, labels, valid, 0.5, 100)
    i2, k2 = nms_padded(class_offset_boxes(boxes, labels, valid), scores, valid, 0.5, 100)
    same_c = torch.equal(i1.to(torch.int64), i2.to(torch.int64)) and torch.equal(k1, k2)
    times["nms_class_aware_4x512"] = kernel_ms(
        lambda: batched_nms_padded(boxes, scores, labels, valid, 0.5, 100), iters)
    log(f"  class-aware nms (4, 512) -> 100 at IoU 0.5: bit-identical {same_c}, kept/image "
        f"{k1.sum(1).tolist()}; with its offsets and sort {times['nms_class_aware_4x512']}")
    if not (same and same_c):
        raise AssertionError("nms: kernel disagrees with its plain version at the hnet shapes")

    feats = [torch.randn((4, s, s, 256), generator=gen, device=dev).to(torch.bfloat16)
             for s, _ in HNET_LEVELS]
    strides = tuple(st for _, st in HNET_LEVELS)
    for K, M in ((512, 7), (100, 14)):
        xy = torch.rand((4, K, 2), generator=gen, device=dev) * 660 - 10
        wh = torch.exp(torch.rand((4, K, 2), generator=gen, device=dev) * math.log(100.0)) * 4
        rois = torch.cat([xy, xy + wh], -1)
        area = torch.sqrt((wh[..., 0] * wh[..., 1]).clamp(min=1e-6))
        levels = (torch.floor(4.0 + torch.log2(area / 224.0) + 1e-6) - 2).clamp(0, 3)
        levels = levels.to(torch.int32)
        got, args = capture_bounded(
            lambda: multiscale_roi_align_canvas(feats, rois, levels, strides, M))
        want = _multiscale_roi_align_canvas(feats, rois, levels, strides, M)
        check_equal(f"roi_align canvas (4, 300, 160, 256), {4 * K} ROIs at {M}x{M}, levels "
                    f"{torch.bincount(levels.flatten().long(), minlength=4).tolist()}",
                    got, want)
        t = kernel_ms(lambda: pallas_roi_align.roi_align_bounded(*args), iters)
        t["device_ms"] = device_ms(lambda: pallas_roi_align.roi_align_bounded(*args))
        b_ms, by = roi_bound(args, got.reshape(4 * K, M, M, -1))
        times[f"roi_align_canvas_{4 * K}x{M}"] = dict(**t, bound_ms=b_ms, bound_by=by)
        log(f"    kernel {t['ms']:.4f} ms, {t['ms_back_to_back']:.4f} back to back, device "
            f"{t['device_ms']:.4f} | bound {b_ms:.4f} ({by})")

    head = seeded_mask_head(5, 256, 2)                # hnet: 4 classes + background
    with torch.no_grad():
        pooled = torch.randn((400, 14, 14, 256), generator=gen, device=dev).to(torch.bfloat16)
        labels = torch.randint(0, 5, (400,), generator=gen, device=dev)
        check_close("mask_head N 400, 5 mask classes",
                    pallas_mask_head.fused_mask_probs(head, pooled, labels),
                    pallas_mask_head.fused_mask_probs_plain(head, pooled, labels),
                    atol=2e-2, rtol=0.0)
    return times



def stem_inputs(gen):
    dev = "cuda"
    x = torch.rand((16, 640, 640, 3), generator=gen, device=dev)
    w = torch.randn((6, 6, 3, 64), generator=gen, device=dev) * 0.05
    scale = torch.rand(64, generator=gen, device=dev) + 0.5
    bias = torch.randn(64, generator=gen, device=dev) * 0.1
    return x, w, scale, bias


def stem_library(x, w, scale, bias, dtype=torch.bfloat16, stride=2, padding=2):
    """cuDNN conv in ``dtype`` (bf16, or f32 with TF32 as the caller set it)
    with the scale folded into the weights + bias, then SiLU."""
    xl = x.to(dtype).permute(0, 3, 1, 2)
    wl = (w.permute(3, 2, 0, 1) * scale[:, None, None, None]).to(dtype)
    bl = bias.to(dtype)
    return lambda: F.silu(F.conv2d(xl, wl, bl, stride, padding))


def stem_library_ms(x, w, scale, bias, iters):
    return cuda_ms(stem_library(x, w, scale, bias), iters)


def phase_stem_k108(gen, iters):
    """Kernel 6 at (16, 640, 640, 3): it reads the f32 image rows into its
    ring itself (K in the s2d tap-major order).  Timed in turns with
    ``stem_tc``, whose data flow it shares, by both methods.  Bound: x +
    weights + the bf16 output."""
    x, w, scale, bias = stem_inputs(gen)
    got = stem_lab.stem_k108(x, w, scale, bias)
    want = stem_lab.stem_k108_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    # the same bf16 operands and f32 accumulation in another order: one bf16 ulp
    err = check_close("stem_k108", got, want, atol=1e-3, rtol=2 ** -7)
    need(torch.equal(got, stem_lab.stem_k108(x, w, scale, bias)), "stem_k108: two launches differ")
    kw = dict(stride=2, padding=2, out_dtype=torch.bfloat16)
    fns = {"stem_k108": lambda: stem_lab.stem_k108(x, w, scale, bias),
           "stem_tc": lambda: pallas_stem.stem_conv(x, w, scale, bias, **kw)}
    ms = cuda_ms_turns(fns, iters)
    b2b = cuda_ms_turns(fns, iters, reps=B2B)
    plain_ms = cuda_ms(lambda: stem_lab.stem_k108_plain(x, w, scale, bias), iters)
    flops = 2.0 * got.numel() * stem_lab.KDIM
    b_ms, by = bound(nbytes(x, got, scale, bias) + stem_lab.KDIM * 64 * 2, flops, BF16_FLOPS)
    for name, t in (("one call a window", ms), (f"{B2B} back to back", b2b)):
        log(f"  stem_k108 in turns with stem_tc, {name}: stem_k108 {t['stem_k108']:.4f} ms | "
            f"stem_tc {t['stem_tc']:.4f} ({t['stem_k108'] / t['stem_tc']:.3f}x) | bound "
            f"{b_ms:.4f} ({by})")
    log(f"  stem_k108 targets back to back: <= 0.19 ms "
        f"{'met' if b2b['stem_k108'] <= 0.19 else 'missed'}, within 10% of stem_tc "
        f"{'met' if b2b['stem_k108'] <= 1.1 * b2b['stem_tc'] else 'missed'}; max error <= 2^-8 "
        f"(one bf16 ulp below 1) {'met' if err <= 2 ** -8 else 'missed'}")
    return dict(max_abs_err=err, ms=ms["stem_k108"], ms_back_to_back=b2b["stem_k108"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=stem_library_ms(x, w, scale, bias, iters),
                turns={"one_call": ms, "back_to_back": b2b})


def phase_stem_dot108(gen, iters):
    """Kernel 7 at (16, 640, 640, 3): the wrapper (torch im2col + kernel)
    against the shared plain version; timed as the kernel alone on the
    (1,638,400, 108) bf16 im2col against the plain product on the same
    im2col.  Bound: the im2col + weights + the bf16 output."""
    x, w, scale, bias = stem_inputs(gen)
    got = stem_lab.stem_dot108(x, w, scale, bias)
    want = stem_lab.stem_k108_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    err = check_close("stem_dot108", got, want, atol=1e-3, rtol=2 ** -7)
    cols = stem_lab.im2col108(stem_lab.s2d(x), 320, 320).contiguous()
    w108 = stem_lab.w_108(w)
    t = kernel_ms(lambda: stem_lab.dot108(cols, w108, scale, bias), iters)
    plain_ms = cuda_ms(lambda: stem_lab.dot108_plain(cols, w108, scale, bias), iters)
    wrapper_ms = cuda_ms(lambda: stem_lab.stem_dot108(x, w, scale, bias), iters)
    log(f"  stem_dot108 with its torch im2col (the wrapper, x -> y): {wrapper_ms:.4f} ms")
    flops = 2.0 * got.numel() * stem_lab.KDIM
    b_ms, by = bound(nbytes(cols, got, scale, bias, w108), flops, BF16_FLOPS)
    return dict(max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=stem_library_ms(x, w, scale, bias, iters))


def check_stitch_nms(gen, iters):
    """The NMS kernel at the slide stitch's shapes: the band form (1, 1024)
    and the full form (1, 4096), IoU 0.45, bit-identical to the plain
    version, with times (plain: few runs, its sweep is a host loop)."""
    dev = "cuda"
    out = {}
    for K in (1024, 4096):
        boxes, scores, valid = clustered_boxes(gen, 1, K, dev, extent=4000.0, pairs_at=4100.0)
        i1, k1 = pallas_nms.nms_padded_pallas(boxes, scores, valid, 0.45, K)
        i2, k2 = nms_padded(boxes, scores, valid, 0.45, K)
        same = torch.equal(i1.to(torch.int64), i2.to(torch.int64)) and torch.equal(k1, k2)
        order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -math.inf)), dim=-1,
                           descending=True, stable=True).indices
        sb = torch.gather(boxes, 1, order[..., None].expand_as(boxes)).contiguous()
        sv = torch.gather(valid, 1, order)
        t = kernel_ms(lambda: pallas_nms.nms_keep_sorted(sb, sv, 0.45, K), iters)
        t["device_ms"] = device_ms(lambda: pallas_nms.nms_keep_sorted(sb, sv, 0.45, K))
        target = 0.06 if K == 1024 else 0.30
        log(f"  nms stitch (1, {K}) back to back {t['ms_back_to_back']:.4f} ms: target {target} "
            f"{'met' if t['ms_back_to_back'] <= target else 'missed'}; device time "
            f"{t['device_ms']:.4f} ms (profiler)")
        plain_ms = cuda_ms(lambda: pallas_nms.nms_keep_sorted_plain(sb, sv, 0.45, K), 3, warmup=1)
        nv = sv.sum(1).double()
        b_ms, by = bound(nbytes(sb, sv, i1, k1), float((nv * (nv - 1) / 2).sum()) * 20, F32_FLOPS)
        log(f"  nms stitch (1, {K}) -> {K} at IoU 0.45: bit-identical {same}, kept "
            f"{int(k1.sum())}; kernel {t['ms']:.4f} ms ({t['ms_back_to_back']:.4f} back to back) | plain {plain_ms:.4f} ms | bound {b_ms:.4f} ms "
            f"({by})")
        need(same, f"nms: kernel disagrees with its plain version at the stitch shape (1, {K})")
        out[f"1x{K}"] = dict(**t, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
    return out


# ---------------------------------------------------------------- flagship
@torch.no_grad()
def calibrate_objectness(det: Detector, x, frac: float):
    """Set every Detect objectness bias so that a fraction ``frac`` of the
    anchors on ``x`` clears ``conf_thres`` with a box of at least the
    2-px minimum side (random weights put the raw logits anywhere).
    Deterministic given the seeded weights and ``x``."""
    feats = det.model.trunk(torch.as_tensor(x).to(det.device))
    for h in det.model.headers.values():
        dets = []
        for conv, j in zip(h.m, h.spec.from_idx):
            f = feats[j]
            d = F.conv2d(f, conv.weight.to(f.dtype), conv.bias.to(f.dtype))
            B, _, ny, nx = d.shape
            dets.append(d.permute(0, 2, 3, 1).reshape(B, ny, nx, h.na, h.no))
        rows = h.decode_proposals(dets)
        big = remove_small_boxes_mask(xywh2xyxy(rows[..., :4]), 2.0).flatten()
        obj = torch.cat([d[..., 4].float().flatten() for d in dets])
        obj = obj - torch.cat([c.bias.view(h.na, h.no)[:, 4].float().expand(d.shape[:4]).flatten()
                               for c, d in zip(h.m, dets)])
        q = torch.quantile(obj[big], 1.0 - min(1.0, frac * obj.numel() / max(int(big.sum()), 1)))
        conf = h.nms_params["conf_thres"]
        for conv in h.m:
            conv.bias.view(h.na, h.no)[:, 4] = math.log(conf / (1 - conf)) - float(q)


class MaskPrefix:
    """Records, on the packed mask branch, the ``active`` count the mask head
    and the pooling each get (one device tensor, handed to both), whether
    the pooling's level maps arrive contiguous, and the calls of
    ``level_canvas`` (none off the plain einsum form): ``with MaskPrefix() as
    p: ...``; ``p.counts``, ``p.check()`` after."""

    def __enter__(self):
        self.counts, self.head_active, self.pool_active = [], [], []
        self.contiguous, self.canvas_calls = [], 0
        self._orig = (detect_head.fused_mask_probs, detect_head.multiscale_roi_align_packed,
                      pallas_roi_align.roi_align_bounded, roi_ops.level_canvas)
        head, pool, bounded, canvas = self._orig

        def spy_head(h, pooled, labels, active=None):
            self.counts.append((None if active is None else active.clone(), pooled.shape[0]))
            self.head_active.append(active)
            return head(h, pooled, labels, active)

        def spy_pool(*a, **k):
            self.pool_active.append(k.get("active"))
            return pool(*a, **k)

        def spy_bounded(levels, *a):
            self.contiguous.append(all(f.is_contiguous() for f in levels))
            return bounded(levels, *a)

        def spy_canvas(*a):
            self.canvas_calls += 1
            return canvas(*a)

        detect_head.fused_mask_probs, detect_head.multiscale_roi_align_packed = spy_head, spy_pool
        pallas_roi_align.roi_align_bounded, roi_ops.level_canvas = spy_bounded, spy_canvas
        return self

    def __exit__(self, *exc):
        (detect_head.fused_mask_probs, detect_head.multiscale_roi_align_packed,
         pallas_roi_align.roi_align_bounded, roi_ops.level_canvas) = self._orig

    def text(self) -> str:
        return ", ".join(f"{'all' if a is None else int(a)} of {n}" for a, n in self.counts)

    def check(self, packed: bool = True) -> str:
        """Hold the probe's findings; ``packed`` paths also hand one active
        count to pooling and head, and their level maps arrive contiguous."""
        need(self.canvas_calls == 0, f"level_canvas ran {self.canvas_calls} times on the path")
        if packed:
            need(len(self.pool_active) == len(self.head_active) >= 1
                 and all(p is h and p is not None
                         for p, h in zip(self.pool_active, self.head_active)),
                 "the pooling and the mask head did not get the same active count")
            need(all(self.contiguous), "a level map reached the pooling non-contiguous")
        return (f"level_canvas calls {self.canvas_calls}, pooling launches with contiguous "
                f"level maps {sum(self.contiguous)} of {len(self.contiguous)}")


def profile_step(step):
    """One profiled ``step()``: device time by kernel, and the device idle
    share (1 - summed kernel time / wall time of the step), also returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"  profiled step: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
        f"(idle share {max(0.0, 1 - busy / wall):.3f}), {sum(r[1] for r in rows)} kernel "
        f"launches; device time by kernel:")
    for us, n, key in rows[:30]:
        log(f"    {us / 1e3:8.3f} ms {n:4d}x  {key[:100]}")
    return {"profiled_wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "idle_share": max(0.0, 1 - busy / wall), "device_launches": sum(r[1] for r in rows)}


def phase_flagship(iters: int):
    det = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0, pre_nms_topk=1024,
                   max_masks=100, mask_budget=768, mask_window=16)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 256, (16, 640, 640, 3), generator=gen, device="cuda", dtype=torch.uint8)
    calibrate_objectness(det, x, 0.02)                # ~500 candidates, ~90 detections per tile
    det.tiles(x)                                      # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()
    with MaskPrefix() as prefix:
        kernels.reset_launches()
        out = det.tiles(x)["detSC"]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    log(f"  launches on the main path (one batch): {launches}; mask-head and pooling slots "
        f"computed (the active prefix): {prefix.text()}; {prefix.check()}")
    for k in FLAGSHIP_KERNELS:
        if launches[k] < 1:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    need(launches["stem_tc"] == 1 and launches["stem"] == 0,
         "the flagship batch must launch the bf16 stem form once and the direct form never")
    v = out["valid"]
    need(out["boxes"].shape == (16, 300, 4) and out["masks"].shape == (16, 100, 28, 28),
         f"unexpected output shapes {tuple(out['boxes'].shape)} {tuple(out['masks'].shape)}")
    for k in ("boxes", "scores", "masks"):
        need(bool(torch.isfinite(out[k].float()).all()), f"non-finite {k}")
    n_valid = int(v.sum())
    n_masks = int(out["mask_valid"].sum())
    eligible = int(v[:, :100].sum())
    log(f"  valid detections/tile {n_valid / 16:.2f}, mask ROIs used {n_masks} of budget 768 "
        f"({eligible} eligible)")
    need(n_valid >= 1 and n_masks >= 1, "no detections or masks")
    masks = out["masks"][out["mask_valid"]]
    need(0 < float(masks.max()) <= 1 and float(masks.min()) >= 0, "mask probabilities out of [0, 1]")

    times = []
    for _ in range(2):
        det.tiles(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()              # the steps' own peak, not phase 3's
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.tiles(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = statistics.median(times)
    log(f"  batch-16 step median {step * 1e3:.2f} ms over {iters} runs "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); "
        f"tiles/s {16 / step:.1f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_step(lambda: det.tiles(x))

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((640, 640, 3), (480, 700, 3),
                                                                 (1000, 777, 3))]
    res = det(images)
    for im, rec in zip(images, res.records):
        o = rec["detSC"]
        h, w = im.shape[:2]
        need(np.isfinite(o["boxes"]).all() and o["masks"].shape[1:] == (28, 28),
             f"bad Detector.__call__ output for {im.shape}")
        need((o["boxes"][:, [0, 2]] <= w + 1e-3).all() and (o["boxes"][:, [1, 3]] <= h + 1e-3).all(),
             f"boxes outside the {im.shape} image")
        log(f"  Detector.__call__ image {im.shape}: {len(o['boxes'])} detections, "
            f"{int(o['has_mask'].sum())} masks")
    need(sum(len(r["detSC"]["boxes"]) for r in res.records) >= 1, "Detector.__call__ found nothing")
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        det(images[1])
        lat.append(time.perf_counter() - t0)
    log(f"  Detector.__call__ latency, one 480x700 image: median {statistics.median(lat) * 1e3:.2f} ms "
        f"over 10 calls (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f})")
    return launches


@torch.no_grad()
def phase_defaults(iters: int):
    """``Detector("yolov5l6-mask", "hyp-nuclei")`` at its defaults (no
    ``mask_budget``: the per-image mask branch, canvas pooling, 100 masks an
    image) on the flagship's batch: launch counts of one batch, the ROIs
    pooled and the masks kept (every eligible top-100 slot) against the
    768 the packed branch would keep; the canvas ROI-align (bit for bit) and
    the mask head (on the path's head and ROIs as phase 5 holds masks, and
    with phase 3's synthetic head at 2e-2) held against their plain versions
    at the 1600 ROIs the batch gives them, each timed one call a window, back to back and by
    device time, with bounds; then tiles/s and a profiled step."""
    det = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0)
    head = det.model.headers["detSC"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    need(head.mask_budget is None and head.mask_window is None and head.max_masks == 100,
         "Detector() does not default to the per-image mask branch")
    x = torch.randint(0, 256, (16, 640, 640, 3), generator=gen, device="cuda", dtype=torch.uint8)
    calibrate_objectness(det, x, 0.02)
    det.tiles(x)                                      # warm-up
    torch.cuda.synchronize()
    seen = {}
    pool, probs = detect_head.multiscale_roi_align_canvas, detect_head.fused_mask_probs

    def spy_pool(*a):
        seen["pool"] = a
        return pool(*a)

    def spy_probs(h, pooled, labels, active=None):
        seen["probs"] = (h, pooled, labels, active)
        return probs(h, pooled, labels, active)

    detect_head.multiscale_roi_align_canvas, detect_head.fused_mask_probs = spy_pool, spy_probs
    try:
        kernels.reset_launches()
        out = det.tiles(x)["detSC"]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        detect_head.multiscale_roi_align_canvas, detect_head.fused_mask_probs = pool, probs
    log(f"  launches on the default path (one batch): {launches}")
    for k, n in (("stem_tc", 1), ("stem", 0), ("nms", 1), ("roi_align", 1), ("mask_head", 1),
                 ("roi_align_single", 0)):
        need(launches[k] == n, f"kernel {k}: {launches[k]} launches at the defaults, expected {n}")
    need(out["boxes"].shape == (16, 300, 4) and out["masks"].shape == (16, 100, 28, 28),
         f"unexpected output shapes {tuple(out['boxes'].shape)} {tuple(out['masks'].shape)}")
    for k in ("boxes", "scores", "masks"):
        need(bool(torch.isfinite(out[k].float()).all()), f"non-finite {k}")
    _, pooled, labels, active = seen["probs"]
    need(active is None and pooled.shape[0] == 16 * 100, "the per-image branch pooled "
         f"{pooled.shape[0]} ROIs with active {active}, expected all 1600")
    mask_idx = torch.tensor(head.mask_indices_list, device="cuda")
    eligible = out["valid"][:, :100] & (mask_idx[out["labels"][:, :100].clamp(0, head.nc)] >= 0)
    kept = int(out["mask_valid"].sum())
    need(torch.equal(out["mask_valid"], eligible), "a mask-eligible top-100 slot lost its mask")
    m = out["masks"][out["mask_valid"]]
    need(kept >= 1 and float(m.min()) >= 0 and 0 < float(m.max()) <= 1,
         "no masks, or mask probabilities out of [0, 1]")
    need(bool((out["masks"][~out["mask_valid"]] == 0).all()), "a slot without a mask is not 0")
    log(f"  ROIs pooled {pooled.shape[0]}; masks kept {kept} = every eligible top-100 slot "
        f"({int(eligible.sum())}); the packed branch's budget would keep {min(768, kept)}")

    # the two kernels at the shapes this batch gives them
    rab = pallas_roi_align.roi_align_bounded
    got_r, args = capture_bounded(lambda: multiscale_roi_align_canvas(*seen["pool"]))
    err_r = check_equal(f"roi_align canvas (16, 150, 80, 256), {pooled.shape[0]} ROIs at 14x14",
                        got_r, _multiscale_roi_align_canvas(*seen["pool"]))
    t_r = kernel_ms(lambda: rab(*args), iters)
    t_r["device_ms"] = device_ms(lambda: rab(*args))
    b_r, by_r = roi_bound(args, got_r.reshape(-1, *got_r.shape[2:]))
    sh = head.seg_h
    got_m = pallas_mask_head.fused_mask_probs(sh, pooled, labels)
    # the path's own head and ROIs: bf16 intermediates that round the other
    # way compound through five layers of seeded weights, so they are held
    # as phase 5 holds the path's masks (mean |d| <= 0.01, max <= 0.1) ...
    d = (got_m - pallas_mask_head.fused_mask_probs_plain(sh, pooled, labels)).abs()
    err_m = float(d.max())
    log(f"  mask_head N {pooled.shape[0]}, the path's head and ROIs: mean |d| "
        f"{float(d.mean()):.5f} (need <= 0.01), max {err_m:.4f} (need <= 0.1)")
    need(float(d.mean()) <= 0.01 and err_m <= 0.1, "mask_head at the per-image shape disagrees")
    # ... and at the same 1600 ROIs with phase 3's synthetic head and inputs
    synth = seeded_mask_head(head.nc_masks, pooled.shape[-1], 1)
    rnd = torch.randn(pooled.shape, generator=gen, device="cuda").to(torch.bfloat16)
    check_close(f"mask_head N {pooled.shape[0]}, phase 3's synthetic head and inputs",
                pallas_mask_head.fused_mask_probs(synth, rnd, labels),
                pallas_mask_head.fused_mask_probs_plain(synth, rnd, labels), atol=2e-2, rtol=0.0)
    t_m = kernel_ms(lambda: pallas_mask_head.fused_mask_probs(sh, pooled, labels), iters)
    t_m["device_ms"] = device_ms(lambda: pallas_mask_head.fused_mask_probs(sh, pooled, labels))
    library, xb = mask_head_library(sh), pooled.permute(0, 3, 1, 2)
    t_m["library_ms"] = cuda_ms(lambda: library(xb), iters)
    N, C = pooled.shape[0], pooled.shape[-1]
    wbytes = (4 * 9 * C * C + 4 * C + 4 * C * C + C) * 2
    b_m, by_m = bound(nbytes(pooled, got_m) + wbytes + N * 8, mask_head_flops(N, C), BF16_FLOPS)
    for name, t, b_ms, by in (("roi_align", t_r, b_r, by_r), ("mask_head", t_m, b_m, by_m)):
        log(f"  {name} at the per-image shapes: {t['ms']:.4f} ms one call a window, "
            f"{t['ms_back_to_back']:.4f} back to back, device time {t['device_ms']:.4f} | bound "
            f"{b_ms:.4f} ({by})" + (f" | cuDNN chain {t['library_ms']:.4f} ms"
                                    if "library_ms" in t else ""))

    for _ in range(2):
        det.tiles(x)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.tiles(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = statistics.median(times)
    log(f"  batch-16 step at the defaults: median {step * 1e3:.2f} ms over {iters} runs "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); tiles/s {16 / step:.1f}")
    profile_step(lambda: det.tiles(x))
    per_image = {
        "roi_align": dict(max_abs_err=err_r, **t_r, bound_ms=b_r, bound_by=by_r, rois=N),
        "mask_head": dict(max_abs_err=err_m, **t_m, bound_ms=b_m, bound_by=by_m, rois=N)}
    return launches, per_image


def match_detections(a, b):
    """b's valid detections that a finds again (same label, IoU >= 0.9):
    (matched, total, mean |mask difference| over the matched pairs)."""
    matched = total = 0
    diffs = []
    for i in range(len(b["valid"])):
        va, vb = a["valid"][i], b["valid"][i]
        total += int(vb.sum())
        if vb.any() and va.any():
            best, j = box_iou(b["boxes"][i][vb].float(), a["boxes"][i][va].float()).max(1)
            ok = (best >= 0.9) & (a["labels"][i][va][j] == b["labels"][i][vb])
            matched += int(ok.sum())
            if "masks" in a and "masks" in b:
                ma, mb = a["masks"][i][va][j[ok]], b["masks"][i][vb][ok]
                diffs += (ma - mb).abs().mean((1, 2)).tolist()
    return matched, total, (statistics.mean(diffs) if diffs else float("nan"))


@torch.no_grad()
def phase_reference():
    """yolov5s-test on a small batch, the card against the plain path on the
    CPU (the path the repo's tests hold against the JAX package):
      * f32 detections (stem and NMS kernels, cuDNN without TF32): >= 98% of
        the CPU's detections found again (same label, IoU >= 0.9);
      * bf16 masks (ROI-align and mask-head kernels) on the card's own
        features and detections against the plain packed mask branch run on
        the CPU from the same inputs: the same ``mask_valid``, and mean
        |difference| <= 0.01, max <= 0.1."""
    kw = dict(cfg="yolov5s-test", hyp="hyp-nuclei", input_size=256, seed=5, pre_nms_topk=512,
              max_masks=32, mask_budget=48, mask_window=16)
    x = np.random.default_rng(1).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)

    gpu = Detector(device="cuda", dtype=torch.float32, **kw)
    gpu.model.headers["det"].seg_h.maskrcnn_preds.mask_fcn_logits.weight.mul_(0.05)
    calibrate_objectness(gpu, x, 0.02)
    cpu = Detector(device="cpu", dtype=torch.float32, **kw)
    cpu.model.load_state_dict(gpu.model.state_dict())
    a = {k: t.cpu() for k, t in gpu.tiles(x, compute_masks=False)["det"].items()}
    matched, total, _ = match_detections(a, cpu.tiles(x, compute_masks=False)["det"])
    msg = f"  f32 detections: {total} on the CPU, {matched / max(total, 1):.3f} matched (need >= 0.98)"
    log(msg)
    if total < 10 or matched < 0.98 * total:
        raise AssertionError(msg)

    gpu.model.dtype = cpu.model.dtype = torch.bfloat16
    h, hc = gpu.model.headers["det"], cpu.model.headers["det"]
    feats = gpu.model.trunk(torch.as_tensor(x).cuda())
    fs = [feats[j] for j in h.spec.from_idx]
    out = h(fs)
    seg = [h.seg_conv(i)(f).permute(0, 2, 3, 1).cpu() for i, f in enumerate(fs)]
    R = out["masks"].shape[1]
    lab = out["labels"][:, :R].cpu()
    mask_labels = torch.tensor(hc.mask_indices_list)[lab.clamp(0, hc.nc)]
    ref = hc._packed_masks(seg, out["valid"].cpu(), out["boxes"][:, :R].cpu(),
                           out["levels"][:, :R].cpu(), mask_labels, out["scores"][:, :R].cpu(),
                           hc.mask_output_size // 2)
    got_v, got_m = out["mask_valid"].cpu(), out["masks"].cpu()
    diff = (got_m - ref["masks"])[ref["mask_valid"]].abs()
    mv = ref["masks"][ref["mask_valid"]]
    soft = float(((mv > 0.05) & (mv < 0.95)).float().mean()) if len(mv) else 0.0
    msg = (f"  bf16 masks: {int(ref['mask_valid'].sum())} on the card's detections, mean |diff| "
           f"{float(diff.mean()):.5f} (need <= 0.01), max {float(diff.max()):.4f} (need <= 0.1); "
           f"{soft:.2f} of mask pixels in (0.05, 0.95)")
    log(msg)
    if (not torch.equal(got_v, ref["mask_valid"]) or int(got_v.sum()) < 10
            or float(diff.mean()) > 0.01 or float(diff.max()) > 0.1):
        raise AssertionError(msg)


# ---------------------------------------------------------------- hnet
def phase_hnet(iters: int):
    """hnet-nucls at full width, bf16, seeded weights, 4 x 640 px tiles."""
    model = HNet.from_cfg(load_cfg("hnet-nucls"), dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randint(0, 256, (4, 640, 640, 3), generator=gen, device="cuda", dtype=torch.uint8)
    det = model.headers["det40x"]
    model(x)                                          # warm-up (cuDNN/cuBLAS algorithm choice)
    torch.cuda.synchronize()
    captured = {}
    propose = det.propose
    det.propose = lambda *a: captured.setdefault("proposals", propose(*a))
    try:
        with MaskPrefix() as probe:
            kernels.reset_launches()
            losses, out = model(x)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    finally:
        del det.propose
    log(f"  launches in one forward: {launches}; {probe.check(packed=False)}")
    for k, n in HNET_LAUNCHES.items():
        if launches[k] != n:
            raise AssertionError(f"kernel {k}: {launches[k]} launches in one hnet forward, "
                                 f"expected {n}")
    need(losses == {"seg10x": {}, "det40x": {}, "cl5x": {}}, f"unexpected losses {losses}")
    d, seg, cl = out["det40x"], out["seg10x"], out["cl5x"]
    need(d["boxes"].shape == (4, 100, 4) and d["masks"].shape == (4, 100, 28, 28)
         and seg["probs"].shape == (4, 40, 40, 5) and cl["probs"].shape == (4, 3),
         f"unexpected shapes {[tuple(t.shape) for t in (d['boxes'], d['masks'], seg['probs'], cl['probs'])]}")
    for name, t in (("boxes", d["boxes"]), ("masks", d["masks"]), ("seg", seg["probs"]),
                    ("cl", cl["probs"])):
        need(bool(torch.isfinite(t.float()).all()), f"non-finite hnet {name}")
    need(bool(((seg["probs"].sum(-1) - 1).abs() < 1e-4).all()), "seg probabilities do not sum to 1")
    v = d["valid"]
    m = d["masks"][v]
    need(int(v.sum()) >= 4 and float(m.min()) >= 0 and 0 < float(m.max()) <= 1,
         "no hnet detections, or mask probabilities out of [0, 1]")
    need(bool((d["boxes"][v] <= 640 + 1e-3).all() and (d["boxes"][v] >= 0).all()),
         "hnet boxes outside the tile")
    log(f"  RPN proposals kept per image {captured['proposals'][1].sum(1).tolist()} (of 512); "
        f"valid detections per image {v.sum(1).tolist()} (of 100); labels "
        f"{torch.bincount(d['labels'][v].long(), minlength=5)[1:].tolist()}; mean mask prob "
        f"{float(m.mean()):.3f}")

    for _ in range(2):
        model(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = statistics.median(times)
    log(f"  batch-4 forward median {step * 1e3:.2f} ms over {iters} runs "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); tiles/s {4 / step:.1f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_step(lambda: model(x))
    return launches


def spy(obj, name: str, store: dict) -> None:
    """Record ``obj.name``'s arguments and result in ``store[name]`` on each
    call (an instance attribute; ``delattr(obj, name)`` removes it)."""
    fn = getattr(obj, name)

    def wrapped(*a):
        store[name] = (a, fn(*a))
        return store[name][1]

    setattr(obj, name, wrapped)


def cpu_tree(t):
    if isinstance(t, torch.Tensor):
        return t.cpu()
    if isinstance(t, dict):
        return {k: cpu_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(cpu_tree(v) for v in t)
    return t


@torch.no_grad()
def phase_hnet_reference():
    """A small hnet (Swin embed 32, depths 1/1/1/1, window 4, FPN 256 so the
    mask-head kernel takes its (14, 14, 256) ROIs) on 2 x 128 px, through
    the kernels on the card against the port's plain path on the CPU, same
    weights and input:
      * bf16 end to end: seg and cl probabilities mean |d| <= 0.01, max <= 0.1;
      * the bf16 detection path stage by stage, each stage of the CPU's
        Mask R-CNN header run on the card's own inputs to that stage (its ROI
        pyramid, RPN outputs, proposals, box-head outputs): RPN logits and
        deltas mean |d| <= 0.05, max <= 0.5 (values up to ~14); the proposals
        (top-K and the NMS kernel) the same validity, boxes within 1e-3; class
        probabilities mean |d| <= 0.01, max <= 0.1 and box deltas mean |d| <=
        0.05, max <= 0.5 (single-level and canvas ROI-align kernels, box
        head); the detections (class-aware NMS kernel) >= 98% of the CPU's
        found again (same label, IoU >= 0.9); the masks (canvas ROI-align and
        mask-head kernels) mean |d| <= 0.01, max <= 0.1;
      * f32 end to end (the det header without masks; cuDNN/cuBLAS without
        TF32): >= 98% of the CPU's valid detections found again.
    bf16 end to end, detections are printed only: random weights put the
    RPN logits within bf16 rounding of each other (the printed gaps), so a
    rounding step reorders NMS."""
    cfg = {
        "backbone": {"type": "swin", "embed_dim": 32, "depths": [1, 1, 1, 1],
                     "num_heads": [1, 2, 4, 8], "window_size": 4},
        "fpn": {"out_channels": 256},
        "headers": {
            "seg": {"type": "panoptic", "num_classes": 5, "channels": 64, "amplification": 0.25},
            "det": {"type": "maskrcnn", "num_classes": 4, "pre_nms_topk": 256,
                    "num_proposals": 64, "num_detections": 24,
                    "anchor_sizes": [16.0, 32.0, 64.0, 128.0]},
            "cl": {"type": "cl", "num_classes": 3, "hidden": 64, "amplification": 0.125},
        },
    }
    x = torch.randint(0, 256, (2, 128, 128, 3), generator=torch.Generator().manual_seed(8),
                      dtype=torch.uint8)
    gpu = HNet.from_cfg(cfg, dtype=torch.bfloat16, seed=7)
    cpu = HNet(cfg, dtype=torch.bfloat16, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    det, hc = gpu.headers["det"], cpu.headers["det"]
    stages = ("infer", "proposals", "classify", "select", "masks")
    st = {}
    for name in stages:
        spy(det, name, st)
    spy(det.rpn.head, "forward", st)
    try:
        _, a = gpu(x.cuda())
    finally:
        for name in stages:
            delattr(det, name)
        del det.rpn.head.forward
    st = cpu_tree(st)
    _, b = cpu(x)
    a = cpu_tree(a)
    ok = True

    def report(name, d, mean_lim, max_lim):
        good = float(d.mean()) <= mean_lim and float(d.max()) <= max_lim
        log(f"  {name}: mean |d| {float(d.mean()):.5f} (need <= {mean_lim}), max "
            f"{float(d.max()):.4f} (need <= {max_lim})")
        return good

    for t in ("seg", "cl"):
        ok &= report(f"bf16 {t} probabilities {tuple(a[t]['probs'].shape)}",
                     (a[t]["probs"] - b[t]["probs"]).abs(), 0.01, 0.1)

    pyr, size = st["infer"][0]
    lg, dl = st["forward"][1]
    lg_c, dl_c = hc.rpn.head(pyr)
    ok &= report(f"bf16 RPN logits {tuple(lg.shape)} (max |logit| {float(lg.abs().max()):.2f})",
                 (lg.float() - lg_c.float()).abs(), 0.05, 0.5)
    ok &= report("bf16 RPN deltas", (dl.float() - dl_c.float()).abs(), 0.05, 0.5)
    (props, pv) = st["proposals"][1]
    props_c, pv_c = hc.proposals(*st["proposals"][0])
    good = torch.equal(pv, pv_c) and float((props - props_c)[pv].abs().max()) <= 1e-3
    log(f"  proposals from the card's RPN outputs: {int(pv.sum())} valid, the same on the CPU "
        f"{torch.equal(pv, pv_c)}, max |box d| {float((props - props_c)[pv].abs().max()):.2e} "
        f"(need the same validity, <= 1e-3)")
    ok &= good
    probs, bd = st["classify"][1]
    probs_c, bd_c = hc.classify(pyr, props)
    ok &= report("bf16 class probabilities on the card's proposals", (probs - probs_c).abs(),
                 0.01, 0.1)
    ok &= report("bf16 box deltas", (bd - bd_c).abs(), 0.05, 0.5)
    o = st["select"][1]
    matched, total, _ = match_detections(o, hc.select(*st["select"][0]))
    good = total >= 10 and matched >= 0.98 * total
    log(f"  detections from the card's box-head outputs: {total} valid on the CPU, "
        f"{matched / max(total, 1):.3f} found again on the card (need >= 0.98)")
    ok &= good
    (_, boxes, labels, v), masks = st["masks"]
    ok &= int(v.sum()) >= 10 and report(f"bf16 masks of the card's {int(v.sum())} detections",
                                        (masks - hc.masks(pyr, boxes, labels, v))[v].abs(),
                                        0.01, 0.1)
    m16, t16, _ = match_detections(a["det"], b["det"])
    top = torch.sort(lg_c.float(), dim=-1, descending=True).values[:, :det.pre_nms_topk]
    gaps = top[:, :-1] - top[:, 1:]
    dmax = float((lg.float() - lg_c.float()).abs().max())
    log(f"  bf16 end to end (for information): {m16} of the CPU's {t16} detections found again; "
        f"adjacent gaps among the top-{det.pre_nms_topk} RPN logits: median "
        f"{float(gaps.median()):.4f}, {float((gaps == 0).float().mean()):.3f} exact ties, "
        f"{float((gaps < dmax).float().mean()):.3f} below the card-vs-CPU max |d| {dmax:.4f}")

    cfg32 = {**cfg, "headers": {**cfg["headers"], "det": {**cfg["headers"]["det"],
                                                          "with_masks": False}}}
    sd = {k: t for k, t in cpu.state_dict().items() if ".mask_head." not in k}
    gpu32, cpu32 = HNet(cfg32), HNet(cfg32, device="cpu")
    gpu32.load_state_dict(sd)
    cpu32.load_state_dict(sd)
    _, a32 = gpu32(x.cuda())
    _, b32 = cpu32(x)
    matched, total, _ = match_detections(cpu_tree(a32["det"]), b32["det"])
    good = total >= 10 and matched >= 0.98 * total
    ok &= good
    log(f"  f32 detections: {total} valid on the CPU, {matched / max(total, 1):.3f} found again "
        f"on the card (need >= 0.98)")
    if not ok:
        raise AssertionError("hnet reference check failed")


# ---------------------------------------------------------------- lab and slide
def phase_lab():
    """The stem lab at its defaults; every launch count reset just before
    and read just after."""
    kernels.reset_launches()
    recs = stem_lab.main([])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  launches in the lab run: {launches}")
    need([r["name"] for r in recs] == list(stem_lab.CANDIDATES), "the lab skipped a candidate")
    for r in recs:
        need(math.isfinite(r["ms_per_batch"]) and r["max_abs_err"] <= 0.05,
             f"lab candidate {r['name']}: {r}")
    for k in LAB_KERNELS:
        need(launches[k] >= 1, f"kernel {k} was not launched by the stem lab")
    return launches


def pairwise_violations(boxes, labels, thr):
    """Pairs of one label with IoU > thr among (K, 4) boxes (on the card)."""
    iou = box_iou(boxes, boxes)
    same = labels[:, None] == labels[None, :]
    upper = torch.ones_like(same).triu(1)
    return int(((iou > thr) & same & upper).sum())


@torch.no_grad()
def calibrate_detections(det: Detector, x, per_tile: float):
    """Calibrate the objectness (``calibrate_objectness``) so that ``x``
    gives about ``per_tile`` valid detections per tile: a bisection over
    the fraction of anchors that clear ``conf_thres``."""
    lo, hi = 1e-5, 0.05
    for _ in range(12):
        frac = math.sqrt(lo * hi)
        calibrate_objectness(det, x, frac)
        out = det.tiles(x, compute_masks=False)
        n = float(next(iter(out.values()))["valid"].sum()) / x.shape[0]
        if n < per_tile:
            lo = frac
        else:
            hi = frac
        if abs(n - per_tile) <= 1.5:
            break
    return frac, n


def phase_slide(iters: int):
    """The flagship on a 4096 x 4096 slide through ``Detector.slide``."""
    det = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0, pre_nms_topk=1024,
                   max_masks=100, mask_budget=768, mask_window=16)
    dev, task, tile, batch = det.device, "detSC", 640, 16
    slide = np.random.default_rng(9).integers(0, 256, (4096, 4096, 3), dtype=np.uint8)
    H, W = slide.shape[:2]
    kw = dict(tile=tile, overlap=64, batch=batch)
    grid = tiling.sliding_window_grid(H, W, tile, 64)
    n_tiles = len(grid)
    x = tiling.extract_tiles(torch.from_numpy(slide).to(dev), torch.from_numpy(grid[:batch]),
                             tile)
    frac, per_tile = calibrate_detections(det, x, 20.0)
    log(f"  objectness calibrated: {frac:.2e} of anchors clear conf_thres, "
        f"{per_tile:.1f} valid detections per tile on the first batch")
    det.slide(slide, **kw)                            # warm-up
    torch.cuda.synchronize()

    captured = {}
    orig_si = tiling.slide_inference

    def spy_si(*a, **k):
        captured["out"] = orig_si(*a, **k)
        return captured["out"]

    tiling.slide_inference = spy_si
    try:
        with warnings.catch_warnings(record=True) as caught, MaskPrefix() as prefix:
            warnings.simplefilter("always")
            kernels.reset_launches()
            res = det.slide(slide, **kw)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
    finally:
        tiling.slide_inference = orig_si
    log(f"  launches in one slide of {n_tiles} tiles: {launches}; mask-head and pooling slots "
        f"computed per batch (the active prefix): {prefix.text()}; {prefix.check()}")
    need(len(prefix.counts) == launches["mask_head"]
         and all(a is not None for a, _ in prefix.counts),
         "the slide's mask head did not get its active prefix")
    for k, n in slide_launches(-(-n_tiles // batch)).items():
        need(launches[k] == n, f"kernel {k}: {launches[k]} launches in one slide, expected {n}")
    o = res[0][task]
    raw = captured["out"]
    n_det = len(o["boxes"])
    need(n_det >= n_tiles and np.isfinite(o["boxes"]).all() and np.isfinite(o["scores"]).all(),
         f"slide: {n_det} detections or non-finite values")
    need(o["masks"].shape[1:] == (28, 28), f"slide masks {o['masks'].shape}")
    b = o["boxes"]
    inside = ((b[:, 0] < W) & (b[:, 1] < H) & (b[:, 2] <= W) & (b[:, 3] <= H)
              & (b[:, 2] >= 0) & (b[:, 3] >= 0))
    need(bool(inside.all()), f"{int((~inside).sum())} slide boxes outside the slide")
    log(f"  {n_det} detections ({n_det / n_tiles:.1f} per tile), {int(o['has_mask'].sum())} with "
        f"masks; all boxes inside the {W} x {H} slide ({int(((b[:, 0] < 0) | (b[:, 1] < 0)).sum())} "
        f"reach past its left or top edge, as the reference keeps them)")

    # the invariants, on the stitched rows before the slide clip
    v = raw["valid"] & (raw["boxes"][:, 0] < W) & (raw["boxes"][:, 1] < H)
    bx = torch.from_numpy(raw["boxes"][v]).to(dev)
    viol = pairwise_violations(bx, torch.from_numpy(raw["labels"][v]).to(dev), 0.45)
    log(f"  pairs of one label at IoU > 0.45 among the {int(v.sum())} kept: {viol}")
    need(viol == 0, f"{viol} kept pairs of one label overlap at IoU > 0.45")

    # band population and mask-carrying rows: one more slide with the stitch
    # also run without compaction (its own NMS launch, outside the count)
    stitched = {}
    orig_stitch = tiling._global_stitch_nms

    def spy_stitch(flat, labels, *a, **k):
        dense = orig_stitch(dict(flat), labels, *a, **{**k, "max_mask_rows": None})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_stitch(flat, labels, *a, **k)
        torch.cuda.synchronize()
        stitched.update(ms=(time.perf_counter() - t0) * 1e3, rows=int(flat["boxes"].shape[0]),
                        band=int(dense["band_count"][0]),
                        mask_rows=int((dense["mask_valid"] & dense["valid"]).sum()),
                        kept=int(out["valid"].sum()), kept_masks=int(out["mask_valid"].sum()))
        return out

    tiling._global_stitch_nms = spy_stitch
    try:
        det.slide(slide, **kw)
    finally:
        tiling._global_stitch_nms = orig_stitch
    saturated = [w for w in caught if "max_band" in str(w.message)]
    log(f"  stitch: {stitched['rows']} stitched rows, band population {stitched['band']} of "
        f"max_band 1024, mask-carrying rows {stitched['mask_rows']} of mask_rows 1024 "
        f"({stitched['mask_rows'] - stitched['kept_masks']} lose their mask to the cap, without a "
        f"warning, as in the reference), {stitched['kept']} kept; the stitch (band NMS + gathers "
        f"+ compaction) {stitched['ms']:.3f} ms wall")
    need(bool(saturated) == (stitched["band"] >= 1024),
         f"band population {stitched['band']} but {len(saturated)} saturation warnings")
    need(stitched["kept_masks"] == min(stitched["mask_rows"], 1024),
         f"the compaction kept {stitched['kept_masks']} of {stitched['mask_rows']} mask rows")

    # a paste of the top masks into a 640 x 640 crop around the best one
    top = np.argsort(-np.where(o["has_mask"], o["scores"], -np.inf), kind="stable")[:32]
    top = top[o["has_mask"][top]]
    cx, cy = (o["boxes"][top[0], 0] + o["boxes"][top[0], 2]) / 2, \
        (o["boxes"][top[0], 1] + o["boxes"][top[0], 3]) / 2
    x0, y0 = int(np.clip(cx - tile / 2, 0, W - tile)), int(np.clip(cy - tile / 2, 0, H - tile))
    boxes_c = torch.from_numpy((o["boxes"][top] - [x0, y0, x0, y0]).astype(np.float32)).to(dev)
    pasted = paste_masks_in_image(torch.from_numpy(o["masks"][top]).to(dev), boxes_c, tile, tile)
    torch.cuda.synchronize()
    need(pasted.shape == (len(top), tile, tile) and bool(torch.isfinite(pasted).all())
         and float(pasted.min()) >= 0 and float(pasted.max()) <= 1 + 1e-6,
         "pasted masks out of [0, 1]")
    need(float(pasted[0].sum()) > 0, "the best mask pasted nothing")
    log(f"  pasted the top {len(top)} masks into the crop at ({x0}, {y0}): "
        f"{int((pasted > 0.5).sum())} mask pixels above 0.5")

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.slide(slide, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"  slide median {med * 1e3:.2f} ms over {iters} runs (min {min(times) * 1e3:.2f}, "
        f"max {max(times) * 1e3:.2f}); {n_tiles / med:.1f} tiles/s")
    profile_step(lambda: det.slide(slide, **kw))
    return launches


@torch.no_grad()
def phase_slide_reference():
    """``yolov5s-test`` on a 600 x 900 slide in f32, 256 px tiles: the card
    (stem and NMS kernels, cuDNN without TF32) against the plain path on the
    CPU, >= 98% of the CPU's stitched detections found again (same label,
    IoU >= 0.9)."""
    kw = dict(cfg="yolov5s-test", hyp="hyp-nuclei", input_size=256, seed=5, pre_nms_topk=512,
              max_masks=32, mask_budget=48, mask_window=16)
    slide = np.random.default_rng(2).integers(0, 256, (600, 900, 3), dtype=np.uint8)
    gpu = Detector(device="cuda", dtype=torch.float32, **kw)
    x = tiling.extract_tiles(torch.from_numpy(slide).cuda(),
                             torch.from_numpy(tiling.sliding_window_grid(600, 900, 256, 64)[:4]),
                             256)
    calibrate_objectness(gpu, x, 0.01)
    cpu = Detector(device="cpu", dtype=torch.float32, **kw)
    cpu.model.load_state_dict(gpu.model.state_dict())
    a = gpu.slide(slide, compute_masks=False)[0]["det"]
    b = cpu.slide(slide, compute_masks=False)[0]["det"]
    total = len(b["boxes"])
    matched = 0
    if total and len(a["boxes"]):
        iou = box_iou(torch.from_numpy(b["boxes"]).float(), torch.from_numpy(a["boxes"]).float())
        best, j = iou.max(1)
        matched = int(((best >= 0.9) & torch.from_numpy(a["labels"][j.numpy()] == b["labels"]))
                      .sum())
    msg = (f"  f32 slide detections: {total} on the CPU, {len(a['boxes'])} on the card, "
           f"{matched / max(total, 1):.3f} of the CPU's found again (need >= 0.98)")
    log(msg)
    need(total >= 10 and matched >= 0.98 * total, msg)


# ---------------------------------------------------------------- val, export, serving
VAL_BATCHES, VAL_BATCH = 4, 8


def flagship_defaults(seed_input: int, batch: int, per_tile: float):
    """``Detector()`` at its defaults (per-image mask branch) with seeded
    weights calibrated on a seeded uint8 batch: the class biases raised by 6
    (random weights put the class logits near their prior, so the
    hierarchical class score, class x objectness, stays under
    ``conf_thres`` and nearly every label would be −100, which the meter
    ignores), the objectness to ~``per_tile`` detections a tile, and the
    mask logits so 95% of the mask pixels clear 0.5."""
    det = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(seed_input)
    x = torch.randint(0, 256, (batch, 640, 640, 3), generator=gen, device="cuda",
                      dtype=torch.uint8)
    with torch.no_grad():
        for h in det.model.headers.values():
            for conv in h.m:
                conv.bias.view(h.na, h.no)[:, 5:] += 6.0
    frac, n = calibrate_detections(det, x, per_tile)
    # random weights put the mask logits around 0: a small box's pasted mask
    # can round to nothing at 0.5, and an empty mask matches nothing (IoU 0);
    # shift the logits so 95% of the mask pixels clear 0.5
    out = det.tiles(x)["detSC"]
    p = out["masks"][out["mask_valid"]].float().clamp(1e-6, 1 - 1e-6)
    q = float(torch.quantile(torch.logit(p).flatten()[:2 ** 24], 0.05))
    for h in det.model.headers.values():
        h.seg_h.maskrcnn_preds.mask_fcn_logits.bias.sub_(q)
    log(f"  objectness calibrated: {frac:.2e} of anchors clear conf_thres, {n:.1f} valid "
        f"detections a tile on the first batch; mask logits shifted by {-q:.3f}")
    return det, gen, x


def val_targets(out, size: int = 640):
    """The card's detections of one batch as padded val targets: boxes
    normalized to [0, 1], labels, ``valid``, and the 28x28 masks of the
    first 100 slots (zeros past them: an image with more detections than
    mask slots gets no masks from the model, and ``val.run`` scores it by
    box IoU, as the JAX loop does)."""
    masks = torch.zeros(out["boxes"].shape[:2] + out["masks"].shape[2:], device=out["masks"].device)
    masks[:, :out["masks"].shape[1]] = out["masks"]
    return {"boxes": (out["boxes"].float() / size).cpu().numpy(),
            "labels": out["labels"].cpu().numpy().astype(np.int64),
            "masks": masks.cpu().numpy(), "valid": out["valid"].cpu().numpy()}


@torch.no_grad()
def phase_val():
    """``engines/val.run`` on the flagship at its defaults: 4 batches of 8 x
    640 seeded noise tiles (host uint8, as a loader ships them) whose targets
    are the card's own first-pass detections; box and mask mAP@0.5 >= 0.99
    (101-point AP of a perfect curve is 0.995: its last grid point reads the
    envelope's closing 0), launches a batch 1 of each kernel."""
    det, gen, x0 = flagship_defaults(11, VAL_BATCH, 40.0)
    data = []
    for b in range(VAL_BATCHES):
        x = x0 if b == 0 else torch.randint(0, 256, x0.shape, generator=gen, device="cuda",
                                            dtype=torch.uint8)
        data.append((x.cpu().numpy(), {"detSC": val_targets(det.tiles(x)["detSC"])}))
    labels = np.concatenate([t["detSC"]["labels"][t["detSC"]["valid"]] for _, t in data])
    classes = {int(c): int(n) for c, n in zip(*np.unique(labels, return_counts=True))}
    over = sum(int((t["detSC"]["valid"].sum(1) > 100).sum()) for _, t in data)
    log(f"  targets: {len(labels)} detections in {VAL_BATCHES * VAL_BATCH} tiles, labels {classes}; "
        f"{over} tiles with more than 100 (no masks: scored by box IoU in the masks run)")
    need(sum(n for c, n in classes.items() if c > 0) >= 100, "too few labelled targets")
    val.run(det.model, iter(data[:1]), compute_masks=True, verbose=False)       # warm-up
    torch.cuda.synchronize()
    res, launches = {}, None
    for iou_type in ("boxes", "masks"):
        kernels.reset_launches()
        fit, stats, times = val.run(det.model, iter(data), compute_masks=True, iou_type=iou_type,
                                    input_size=640, verbose=False)
        torch.cuda.synchronize()
        if launches is None:
            launches = dict(kernels.LAUNCHES)
        s = stats["detSC"]
        res[iou_type] = dict(map50=float(s["map50"]), map=float(s["map"]),
                             fitness=float(fit), ms_per_image=dict(zip(
                                 ("data", "inference", "metrics"), times)))
        log(f"  val.run iou_type={iou_type}: mAP@0.5 {s['map50']:.4f} (need >= 0.99), "
            f"mAP@.5:.95 {s['map']:.4f}, fitness {fit:.4f}; ms per image: data {times[0]:.2f}, "
            f"inference {times[1]:.2f}, metrics {times[2]:.2f}")
        need(s["map50"] >= 0.99, f"val {iou_type} mAP@0.5 {s['map50']} on its own detections")
    per_batch = {k: launches[k] / VAL_BATCHES for k in FLAGSHIP_KERNELS + ("stem",)}
    log(f"  launches a batch (iou_type boxes, {VAL_BATCHES} batches): {per_batch}")
    for k, n in (("stem_tc", 1), ("stem", 0), ("nms", 1), ("roi_align", 1), ("mask_head", 1)):
        need(per_batch[k] == n, f"val: kernel {k} launched {per_batch[k]} times a batch, not {n}")
    return launches, res


def op_host_times(det, x) -> dict:
    """Host microseconds a call of each flagship kernel, at the shapes one
    ``Detector.tiles`` batch gives it: the ``torch.library`` op (what the
    wrappers call) and the bare ``ctypes`` launch function it wraps (what
    they called before), in turns, 200 enqueues each, no sync inside."""
    pairs = {"stem_tc": (pallas_stem, "stem_tc_op", pallas_stem._launch_tc),
             "nms": (pallas_nms, "nms_keep_op", pallas_nms._launch),
             "roi_align": (pallas_roi_align, "roi_align_bounded_op",
                           pallas_roi_align._launch_bounded),
             "mask_head": (pallas_mask_head, "mask_head_op", pallas_mask_head._launch)}
    args, orig = {}, {}
    for k, (mod, name, _) in pairs.items():
        orig[k] = getattr(mod, name)

        def spy(*a, _k=k):
            args[_k] = a
            return orig[_k](*a)

        setattr(mod, name, spy)
    try:
        det.tiles(x)
    finally:
        for k, (mod, name, _) in pairs.items():
            setattr(mod, name, orig[k])
    torch.cuda.synchronize()
    out = {}
    for k, (_, _, launch) in pairs.items():
        a, op = args[k], orig[k]
        t = {"op": [], "ctypes": []}
        for _ in range(3):
            t["op"].append(host_us(lambda: op(*a)))
            t["ctypes"].append(host_us(lambda: launch(*a)))
        out[k] = {"op_us": statistics.median(t["op"]), "ctypes_us": statistics.median(t["ctypes"])}
    return out


@torch.no_grad()
def phase_export():
    """``evaluate.inference_on_loader`` at batch 16 (images/s); ``export``
    of the same model at (16, 640, 640, 3), loaded in this process: the
    graph calls each of the four kernels once, one run of the program
    launches each once, its outputs equal the eager forward's bit for bit;
    the program and ``Detector.tiles`` timed in turns and each profiled;
    each custom op's host time a call beside the bare ``ctypes`` launch."""
    import tempfile

    det, gen, x = flagship_defaults(12, 16, 40.0)
    fwd = lambda t, compute_masks=True: det.model(t, compute_masks=compute_masks)  # noqa: E731
    host = [torch.randint(0, 256, x.shape, generator=gen, device="cuda", dtype=torch.uint8)
            .cpu().numpy() for _ in range(4)]
    loader = lambda: ((b, [(640, 640)] * 16) for b in host)  # noqa: E731
    evaluate.inference_on_loader(fwd, loader(), device="cuda")                    # warm-up
    kernels.reset_launches()
    res = evaluate.inference_on_loader(fwd, loader(), device="cuda")
    loader_launches = dict(kernels.LAUNCHES)
    n_det = sum(len(r["detSC"]["boxes"]) for r in res["outputs"])
    ips = 1.0 / res["time_per_image"]
    log(f"  inference_on_loader, 4 batches of 16 (host uint8 in, host records out): "
        f"{ips:.1f} images/s ({res['time_per_image'] * 1e3:.3f} ms an image), {n_det} "
        f"detections; launches {loader_launches}")
    need(len(res["outputs"]) == 64 and n_det > 0, "inference_on_loader returned no detections")

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = evaluate.export(det.model, tuple(x.shape), os.path.join(d, "flagship.pt2"))
        t_export = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        program = evaluate.load_exported(path)
        t_load = time.perf_counter() - t0
    calls = evaluate.kernel_calls(program)
    log(f"  export at {tuple(x.shape)}: {t_export:.1f} s (eager warm-up, trace, save), "
        f"{size / 2**20:.1f} MiB; load {t_load:.1f} s; custom-op calls in the graph {calls}")
    need(calls == {"stem_tc": 1, "nms_keep": 1, "roi_align_bounded": 1, "mask_head": 1},
         f"the exported graph does not call each flagship kernel once: {calls}")
    want = det.tiles(x)
    program(x)                                                                     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = program(x)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  launches of one exported-program run: {launches}")
    for k, n in (("stem_tc", 1), ("stem", 0), ("nms", 1), ("roi_align", 1), ("mask_head", 1)):
        need(launches[k] == n, f"exported program: kernel {k} launched {launches[k]} times, not {n}")
    diffs = {k: float((got["detSC"][k].float() - v.float()).abs().max())
             for k, v in want["detSC"].items()}
    same = all(torch.equal(got["detSC"][k], v) for k, v in want["detSC"].items())
    log(f"  exported outputs vs eager: bit-identical {same}; max |d| {diffs}; "
        f"{int(want['detSC']['valid'].sum())} detections, {int(want['detSC']['mask_valid'].sum())} masks")
    need(same, "the exported program's outputs differ from the eager forward's")

    times = {"exported": [], "eager": []}
    for _ in range(2):
        program(x)
        det.tiles(x)
    for _ in range(10):
        for name, step in (("exported", lambda: program(x)), ("eager", lambda: det.tiles(x))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    step = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    log(f"  batch-16 step in turns, median of 10: exported {step['exported']:.2f} ms "
        f"(min {min(times['exported']) * 1e3:.2f}, max {max(times['exported']) * 1e3:.2f}), eager "
        f"Detector.tiles {step['eager']:.2f} ms (min {min(times['eager']) * 1e3:.2f}, max "
        f"{max(times['eager']) * 1e3:.2f})")
    log("  profiled exported-program step:")
    profile_step(lambda: program(x))
    log("  profiled eager Detector.tiles step (same model and batch):")
    profile_step(lambda: det.tiles(x))
    hosts = op_host_times(det, x)
    added = sum(v["op_us"] - v["ctypes_us"] for v in hosts.values())
    for k, v in hosts.items():
        log(f"  host time a call, {k}: custom op {v['op_us']:.1f} us, bare ctypes launch "
            f"{v['ctypes_us']:.1f} us (+{v['op_us'] - v['ctypes_us']:.1f})")
    log(f"  the registration adds {added:.1f} us of host time a flagship step "
        f"({added / 1e3 / step['eager'] * 100:.2f}% of the eager step)")
    info = dict(images_per_s=ips, export_s=t_export, load_s=t_load, file_mib=size / 2**20,
                exported_ms=step["exported"], eager_ms=step["eager"], host_us=hosts)
    return launches, loader_launches, info


@torch.no_grad()
def phase_serving():
    """``serving._respond`` on a 640 tile and a 1500 x 1500 slide: records
    equal a direct ``Detector`` call's; an HTTP round trip through
    ``ThreadingHTTPServer`` on 127.0.0.1 where ``cv2`` imports; latency a
    request."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    det, _, _ = flagship_defaults(13, 1, 40.0)
    serving._detector = det
    rng = np.random.default_rng(13)
    tile = rng.integers(0, 256, (640, 640, 3), dtype=np.uint8)
    slide = rng.integers(0, 256, (1500, 1500, 3), dtype=np.uint8)
    serving._respond(tile, False, None)                                           # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    code, rows = serving._respond(tile, False, None)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    need(code == 200 and rows == det(tile).to_records() and len(rows) > 0,
         "serving: the tile's records differ from a direct Detector call's")
    code_s, rows_s = serving._respond(slide, True, None)
    need(code_s == 200 and rows_s == det.slide(slide, mask_uint8=True).to_records()
         and len(rows_s) > 0, "serving: the slide's records differ from a direct Detector.slide's")
    log(f"  _respond: tile {len(rows)} records, slide {len(rows_s)} records, both equal a direct "
        f"call's; launches of one tile request {launches}")
    lat = {"tile": [], "slide": []}
    for _ in range(5):
        for name, (img, is_slide) in (("tile", (tile, False)), ("slide", (slide, True))):
            t0 = time.perf_counter()
            serving._respond(img, is_slide, None)
            lat[name].append(time.perf_counter() - t0)
    info = {f"{k}_ms": statistics.median(v) * 1e3 for k, v in lat.items()}
    log(f"  _respond latency, median of 5: tile {info['tile_ms']:.2f} ms, 1500x1500 slide "
        f"{info['slide_ms']:.2f} ms")
    try:
        import cv2
    except ImportError:
        cv2 = None
    log(f"  cv2 importable: {cv2 is not None}")
    if cv2 is not None:
        server = ThreadingHTTPServer(("127.0.0.1", 0), serving.Handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}"
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                need(json.load(r) == {"status": "ok"}, "serving: /healthz")
            body = cv2.imencode(".png", cv2.cvtColor(tile, cv2.COLOR_RGB2BGR))[1].tobytes()
            http_lat = []
            for _ in range(6):
                req = urllib.request.Request(url + "/v1/object-detection/hd_yolo", data=body,
                                             headers={"Content-Type": "image/png"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as r:
                    payload = json.load(r)
                http_lat.append(time.perf_counter() - t0)
            need(payload == json.loads(json.dumps(rows)), "serving: HTTP records differ")
            info["http_tile_ms"] = statistics.median(http_lat[1:]) * 1e3
            log(f"  HTTP round trip (PNG tile, {len(payload)} records, equal to _respond's): "
                f"median {info['http_tile_ms']:.2f} ms over 5 requests after a warm-up")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    return launches, info


# ---------------------------------------------------------------- training
TRAIN_CLI = ["--cfg", "yolov5l6-mask", "--hyp", "hyp-nuclei", "--masks", "--batch-size", "16",
             "--img-size", "640", "--max-targets", "256", "--mask-rois", "64", "--workers", "8"]


def make_train_set(root: str, n: int = 64, size: int = 640, per_tile: int = 80,
                   seed: int = 0) -> str:
    """A labelled set written to ``root``: ``n`` PNG tiles of ``size`` px with
    about ``per_tile`` nuclei-sized polygons each (10-40 px ellipses, four
    classes, drawn darker on a textured background); returns the data yaml."""
    import cv2
    import yaml

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        img = rng.integers(150, 230, (size, size, 3), dtype=np.uint8)
        k = int(rng.integers(per_tile - 10, per_tile + 11))
        c = rng.uniform(20, size - 20, (k, 2))
        ax = rng.uniform(5, 20, (k, 2))
        ang = rng.uniform(0, np.pi, k)
        t = np.linspace(0, 2 * np.pi, 13)[:-1]
        polys, boxes = np.empty(k, object), np.zeros((k, 4), np.float32)
        for j in range(k):
            px = ax[j, 0] * np.cos(t) * np.cos(ang[j]) - ax[j, 1] * np.sin(t) * np.sin(ang[j])
            py = ax[j, 0] * np.cos(t) * np.sin(ang[j]) + ax[j, 1] * np.sin(t) * np.cos(ang[j])
            pts = np.clip(np.stack([px + c[j, 0], py + c[j, 1]], 1), 0, size - 1).astype(np.float32)
            polys[j] = [pts]
            boxes[j] = [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()]
            cv2.fillPoly(img, [pts.astype(np.int32)], tuple(int(v) for v in rng.integers(40, 120, 3)))
        cv2.imwrite(os.path.join(root, f"img{i}.png"), img)
        np.savez(os.path.join(root, f"ann{i}.npz"), boxes=boxes, labels=rng.integers(1, 5, k),
                 masks=polys, size=np.array([size, size]))
        rows.append(f"img{i}.png,im{i},a{i},ann{i}.npz,detSC,poly")
    csv = os.path.join(root, "index.csv")
    with open(csv, "w") as f:
        f.write("image_path,image_id,ann_id,ann_path,task_id,mask_mode\n" + "\n".join(rows) + "\n")
    data = os.path.join(root, "data.yaml")
    meta = {"detSC": {"labels_text": {1: "tumor", 2: "stromal", 3: "sTILs", 4: "other"}}}
    with open(data, "w") as f:
        yaml.safe_dump({"train": csv, "val": csv, "tasks": ["detSC"], "meta_info": meta}, f)
    return data


class EpochClock:
    """Training callbacks that time each epoch's steps: from
    ``on_train_epoch_start`` to ``on_train_epoch_end`` (which follows the
    epoch's one fetch of its metrics, so the card has finished its steps),
    and count them (``on_train_batch_end``)."""

    def __init__(self, batch: int):
        from hd_yolo_tpu_torch.engines.callbacks import Callbacks

        self.batch, self.img_per_s = batch, []
        self.callbacks = Callbacks()
        self.callbacks.register_action("on_train_epoch_start", "clock", self.start)
        self.callbacks.register_action("on_train_batch_end", "clock", self.step)
        self.callbacks.register_action("on_train_epoch_end", "clock", self.end)

    def start(self):
        self.t0, self.steps = time.perf_counter(), 0

    def step(self):
        self.steps += 1

    def end(self, epoch):
        self.img_per_s.append(self.steps * self.batch / (time.perf_counter() - self.t0))


def phase_train_cli(data: str, save_dir: str, extra=()) -> dict:
    """``engines/train.main``'s flags (``extra`` added) at full width and
    depth in bf16, 2 epochs (4 micro-steps an update, 2 updates); then a
    ``--resume`` to a third epoch (the restored step, parameters and EMA
    are the saved ones); then ``final.pt`` in a ``Detector``.  Each
    epoch's steps are timed (``EpochClock``)."""
    from hd_yolo_tpu_torch.engines import train as train_mod

    def run(*argv):
        clock = EpochClock(16)
        res = train_mod.train(train_mod.argument_parser().parse_args(
            ["--data", data, "--save-dir", save_dir, *argv, *TRAIN_CLI, *extra]), clock.callbacks)
        return res, clock.img_per_s

    t0 = time.perf_counter()
    res, img_per_s = run("--epochs", "2")
    t_cli = time.perf_counter() - t0
    for name in ("last.pt", "last.json", "best.pt", "best.json", "final.pt"):
        need(os.path.isfile(os.path.join(save_dir, name)), f"train did not write {name}")
    rows = [json.loads(l) for l in open(os.path.join(save_dir, "results.json"))]
    need([r["epoch"] for r in rows] == [0, 1] and all("detSC/map50" in r for r in rows),
         f"validation did not run each epoch: {rows}")
    saved = torch.load(os.path.join(save_dir, "last.pt"), map_location="cpu", weights_only=False)
    need(int(saved["step"]) == 8 and int(saved["opt"]["count"]) == 2,
         f"2 epochs of 4 steps at accumulate 4: step {int(saved['step'])}, updates "
         f"{int(saved['opt']['count'])}")
    log(f"  train.main{''.join(' ' + x for x in extra)} 2 epochs: {t_cli:.1f} s; loss by epoch "
        f"{[round(r['loss'], 4) for r in rows]}, fitness {[round(r['fitness'], 4) for r in rows]}; "
        f"img/s of each epoch's steps {[round(v, 2) for v in img_per_s]}"
        + (f"; resident upload {res['resident_upload']}" if "resident_upload" in res else ""))
    seen = {}
    orig = train_mod.restore_train_state

    def spy(path, state):
        state, meta = orig(path, state)
        seen.update(step=int(state.step),
                    params={n: p.detach().cpu() for n, p in state.model.named_parameters()},
                    ema=[e.cpu() for e in state.ema.params])
        return state, meta

    train_mod.restore_train_state = spy
    try:
        t0 = time.perf_counter()
        _, resumed_img_per_s = run("--epochs", "3", "--resume")
        t_resume = time.perf_counter() - t0
    finally:
        train_mod.restore_train_state = orig
    need(seen.get("step") == 8, "--resume did not restore the saved step")
    need(all(torch.equal(p, saved["model"][n]) for n, p in seen["params"].items()),
         "--resume restored other parameters than were saved")
    need(all(torch.equal(e, s) for e, s in zip(seen["ema"], saved["ema"])),
         "--resume restored another EMA than was saved")
    rows = [json.loads(l) for l in open(os.path.join(save_dir, "results.json"))]
    need([r["epoch"] for r in rows] == [0, 1, 2], f"the resumed run logged {rows}")
    det = Detector("yolov5l6-mask", "hyp-nuclei", weights=os.path.join(save_dir, "final.pt"),
                   device="cuda")
    x = np.random.default_rng(2).integers(0, 256, (4, 640, 640, 3), dtype=np.uint8)
    out = det.tiles(x)["detSC"]
    need(out["boxes"].shape == (4, 300, 4) and bool(torch.isfinite(out["boxes"]).all()),
         "final.pt: bad Detector outputs")
    log(f"  --resume to epoch 3: {t_resume:.1f} s (its steps {resumed_img_per_s[0]:.2f} img/s), "
        f"step/params/EMA as saved; final.pt in Detector: {int(out['valid'].sum())} detections "
        f"on 4 tiles")
    info = {"cli_2_epochs_s": t_cli, "resume_epoch_s": t_resume,
            "img_per_s_by_epoch": img_per_s + resumed_img_per_s,
            "loss_by_epoch": [r["loss"] for r in rows],
            "fitness_by_epoch": [r["fitness"] for r in rows]}
    if "resident_upload" in res:
        info["resident_upload"] = res["resident_upload"]
    return info


# the ROI-align wrappers a training step calls, by name in ops/pallas_roi_align
STEP_CALLS = ("roi_align_bounded", "roi_align_bounded_bwd", "roi_align_levels_bwd")


def capture_step_calls(step, state, batch) -> dict:
    """One training micro-step, returning the arguments of each call it made
    to the wrappers of ``STEP_CALLS``, by name in call order (the backward
    calls' output gradients cloned)."""
    calls = {name: [] for name in STEP_CALLS}
    orig = {name: getattr(pallas_roi_align, name) for name in STEP_CALLS}

    def spy(name):
        def wrapped(*a):
            g = a[0]
            first = ([t.detach().clone() for t in g] if isinstance(g, (list, tuple))
                     else g.detach().clone()) if name.endswith("_bwd") else g
            calls[name].append((first,) + a[1:])
            return orig[name](*a)
        return wrapped

    for name in STEP_CALLS:
        setattr(pallas_roi_align, name, spy(name))
    try:
        step(state, batch)
    finally:
        for name, fn in orig.items():
            setattr(pallas_roi_align, name, fn)
    return calls


def whole_canvas(bargs) -> bool:
    """Whether a ``roi_align_bounded_bwd`` call pools whole canvases (the
    window the stacked levels, every origin 0, no active count): the form
    ``canvas_bwd_plain`` takes."""
    levels, meta, window = bargs[1], bargs[2], bargs[6]
    return ((len(bargs) < 10 or bargs[9] is None)
            and tuple(window) == (sum(f.shape[1] for f in levels), max(f.shape[2] for f in levels))
            and not bool(meta[:, 1:3].any()))


def bounded_bwd_reference(bargs) -> list:
    """The plain level gradients of a ``roi_align_bounded_bwd`` call: the
    per-image canvas form's autograd (f32) for whole-canvas calls, else
    ``roi_align_bounded_bwd_plain``."""
    if whole_canvas(bargs):
        return canvas_bwd_plain(bargs)
    return pallas_roi_align.roi_align_bounded_bwd_plain(*bargs)


def bwd_rel_err(got, want) -> float:
    """The largest over the levels of max|got - want| / max|want|."""
    worst = 0.0
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max())
        worst = max(worst, err / max(float(b.float().abs().max()), 1e-30)
                    if math.isfinite(err) else math.inf)
    return worst


class shadow_backwards:
    """``with shadow_backwards() as worst:`` every call of the two ROI-align
    backward wrappers (the kernels) also runs the plain version on the same
    inputs and is held to it as the step's captured calls are held: the
    canvas one within 2e-2 x max|plain| a level, a single-level call over
    several maps (the pyramid) bit for bit the plain version on the card, one
    over a single map (the constrain's pooling) within 1e-5 x max|plain| of
    the CPU's plain version.  ``worst`` keeps each one's largest relative
    error (bit for bit: 0) and the number of calls held."""

    TOL = {"roi_align_bwd": 2e-2, "pyramid": 0.0, "constrain": 1e-5}

    def __enter__(self):
        self.orig = (pallas_roi_align.roi_align_bounded_bwd, pallas_roi_align.roi_align_levels_bwd)
        kb, kl = self.orig
        self.worst = dict.fromkeys(self.TOL, 0.0)
        self.worst["calls"] = 0

        def bounded(*a):
            got = kb(*a)
            with torch.no_grad():
                self.hold("roi_align_bwd", bwd_rel_err(got, bounded_bwd_reference(a)))
            return got

        def levels(*a):
            got = kl(*a)
            plain = pallas_roi_align.roi_align_levels_bwd_plain
            with torch.no_grad():
                if len(a[1]) == 1:
                    self.hold("constrain", bwd_rel_err([x.cpu() for x in got], plain(*cpu_tree(a))))
                else:
                    same = all(torch.equal(x, y) for x, y in zip(got, plain(*a)))
                    self.hold("pyramid", 0.0 if same else math.inf)
            return got

        pallas_roi_align.roi_align_bounded_bwd, pallas_roi_align.roi_align_levels_bwd = bounded, levels
        return self.worst

    def hold(self, name: str, rel: float) -> None:
        self.worst[name] = max(self.worst[name], rel)
        self.worst["calls"] += 1
        need(rel <= self.TOL[name], f"{name} at a training call: |kernel - plain| / max|plain| "
                                    f"{rel:.3g}, over its tolerance {self.TOL[name]}")

    def __exit__(self, *exc):
        pallas_roi_align.roi_align_bounded_bwd, pallas_roi_align.roi_align_levels_bwd = self.orig
        return False


class plain_backwards:
    """``with plain_backwards():`` the two ROI-align backward wrappers run
    their plain versions on the card (the canvas one as
    ``bounded_bwd_reference``, cast to the levels' dtype): the reference
    a training run through the kernels is compared with."""

    def __enter__(self):
        self.orig = (pallas_roi_align.roi_align_bounded_bwd, pallas_roi_align.roi_align_levels_bwd)
        pallas_roi_align.roi_align_bounded_bwd = lambda *a: [
            x.to(f.dtype) for x, f in zip(bounded_bwd_reference(a), a[1])]
        pallas_roi_align.roi_align_levels_bwd = pallas_roi_align.roi_align_levels_bwd_plain

    def __exit__(self, *exc):
        pallas_roi_align.roi_align_bounded_bwd, pallas_roi_align.roi_align_levels_bwd = self.orig
        return False


def train_snapshot(state) -> tuple:
    """A copy of a train state's model (parameters and buffers), optimizer
    state and step count, for ``train_restore``."""
    clone = lambda v: v.detach().clone() if torch.is_tensor(v) else [clone(t) for t in v]
    return ({k: clone(v) for k, v in state.model.state_dict().items()},
            {k: clone(v) for k, v in state.opt.state_dict().items()}, state.step.clone())


def train_restore(state, snap) -> None:
    model_sd, opt_sd, count = snap
    state.model.load_state_dict(model_sd)
    state.opt.load_state_dict(opt_sd)
    state.step = count.clone()


def loss_runs(step, state, batch, batch_loss, micro: int = 1, updates: int = 8) -> dict:
    """From the state as it is: the batch's loss (``batch_loss()``), then
    ``updates`` updates of ``micro`` micro-steps through the kernels, each
    backward call held against its plain version (``shadow_backwards``),
    and the loss after them; then, from the same state, the same updates
    through the plain backwards (``plain_backwards``) and through the
    kernels again (how far two runs through the same code drift apart: the
    step's other kernels are not deterministic).  The state is left after
    the first run's updates.  Returns the losses before and after each run,
    each run's mean micro-step loss per update and the held errors."""
    before = batch_loss()
    snap = train_snapshot(state)

    def run():
        per, ms = [], []
        for _ in range(updates):
            m = [step(state, batch)[1] for _ in range(micro)]
            ms += m
            per.append(float(torch.stack([x["loss"] for x in m]).mean()))
        return batch_loss(), per, ms

    res = {"before": before}
    for name, ctx in (("plain", plain_backwards), ("kernel_again", shadow_backwards),
                      ("kernel", shadow_backwards)):
        train_restore(state, snap)
        with ctx() as worst:
            res[name], res[f"{name}_per_update"], ms = run()
        if name == "kernel":
            res["held"], res["metrics"] = worst, ms
    return res


def bwd_skips(bargs) -> dict:
    """``roi_align_bwd`` at a call with and without the ROIs its gather
    passes over (those whose output gradient is all zero): their number,
    its device time as it is and with every zero of the output gradient
    set to the dtype's least normal value (nothing to pass over)."""
    bk = pallas_roi_align.roi_align_bounded_bwd
    g = bargs[0]
    dense = (torch.where(g == 0, torch.finfo(g.dtype).tiny, g),) + tuple(bargs[1:])
    return {"zero_output_gradient": int((g.flatten(1) == 0).all(1).sum()),
            "device_ms": device_ms(lambda: bk(*bargs)),
            "device_ms_no_zero_skip": device_ms(lambda: bk(*dense))}


def bwd_bound(bargs, grads):
    """The backward's bound: the output gradient read once, each level's
    gradient written once, the coordinates read; M²·n² samples of 4 taps a
    ROI, a multiply-add each per channel."""
    g, levels, meta, ys, xs, bnds, window, M, n = bargs[:9]
    K, C = meta.shape[0], g.shape[-1]
    return bound(nbytes(g, meta, ys, xs, bnds, *grads), K * M * M * n * n * 4 * 2 * C, F32_FLOPS)


def check_bwd(name, got, want, rel):
    """Hold per-level gradients within ``rel``·max|plain| of each level."""
    worst = 0.0
    for lvl, (a, b) in enumerate(zip(got, want)):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        worst = max(worst, err)
        if not math.isfinite(err) or err > rel * max(scale, 1e-30):
            raise AssertionError(f"{name}: level {lvl} max |d| {err:.3g} > {rel} x {scale:.3g}")
    log(f"  {name}: max_abs_err {worst:.3g} (tolerance per level |d| <= {rel} x max|plain|)")
    return worst


def phase_train(iters: int):
    """Phase 14: yolov5l6-mask training at full width, batch 16 x 640, bf16."""
    import tempfile

    from hd_yolo_tpu_torch.data.dataset import DataLoader, DetectionDataset
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train import scale_task_hyp
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.models.builder import parse_model_cfg
    from hd_yolo_tpu_torch.models.yolo import Model

    torch.cuda.empty_cache()
    info = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = make_train_set(tmp)
        log(f"  labelled set: 64 tiles of 640 px, ~80 polygons each, written in "
            f"{time.perf_counter() - t0:.1f} s")
        info["cli"] = phase_train_cli(data, os.path.join(tmp, "run"))
        torch.cuda.empty_cache()

        # the step on one fixed batch, as the CLI builds it
        hyp = scale_task_hyp(load_cfg("hyp-nuclei"), parse_model_cfg("yolov5l6-mask",
                                                                     "hyp-nuclei"), 640)
        model = Model.from_cfg("yolov5l6-mask", hyp, dtype=torch.bfloat16, mask_rois=64)
        model.init_weights(torch.Generator().manual_seed(0))
        model.cuda()
        opt = build_optimizer(model, hyp, 2, 4, accumulate=4)
        state = TrainState.create(model, opt)
        step = make_train_step()
        ds = DetectionDataset(os.path.join(tmp, "index.csv"), {**hyp, "img_size": 640},
                              train=True, max_targets=256, seed=1)
        # one worker: the batch's augmentation draws come in one order, so
        # every run trains on the same batch
        batch = to_device(next(iter(DataLoader(ds, 16, workers=1))), "cuda")
        n_obj = int(batch["targets"]["detSC"]["valid"].sum())
        # 8 updates (32 micro-steps) on the batch from the fresh model: the
        # loss after them (one more forward, no update) is below the loss
        # before them, and within a tenth of that fall of the loss after the
        # same updates through the plain backward.  (A few updates later the
        # warmup's bias learning rate, 0.1, holds the loss on a plateau where
        # the sign of its 8-update change follows rounding-level differences
        # in the gradient, whichever backward computes it.)
        def batch_loss():
            with torch.no_grad():
                losses_, _ = state.model.losses(batch["image"], batch["targets"])
                return float(state.model.total_loss(losses_))

        r = loss_runs(step, state, batch, batch_loss, micro=4)
        losses = r.pop("metrics")
        log(f"  loss on the batch before 8 updates (the fresh model) {r['before']:.4f}; after "
            f"them through the kernel {r['kernel']:.4f} (its {r['held']['calls']} calls each "
            f"held against the plain version: worst |d| / max|plain| "
            f"{r['held']['roi_align_bwd']:.3g}), through the plain backward {r['plain']:.4f}, "
            f"through the kernel again {r['kernel_again']:.4f}; mean loss of each update's "
            f"micro-steps {[round(v, 4) for v in r['kernel_per_update']]}")
        need(r["kernel"] < r["before"], "the loss did not fall over 8 updates")
        fall = r["before"] - r["plain"]
        need(fall > 0 and abs(r["kernel"] - r["plain"]) <= 0.1 * fall,
             f"the loss after 8 updates through the kernel, {r['kernel']:.4f}, is not within a "
             f"tenth of the fall of the plain backward's {r['plain']:.4f}")
        info["loss_runs"] = r
        for _ in range(3):
            losses.append(step(state, batch)[1])
        torch.cuda.synchronize()
        kernels.reset_launches()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        losses.append(m)
        log(f"  launches of one training micro-step: {launches}")
        need(launches["roi_align"] == 1 and launches["roi_align_bwd"] == 1,
             "the training step must pool once and launch the ROI-align backward once")
        need(launches["stem_tc"] == launches["stem"] == launches["mask_head"] == 0,
             "the training forward runs the plain stem conv and the cuDNN mask-head chain")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m)
        med = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  train step (batch 16 x 640, bf16, masks, {n_obj} objects, mask_rois 64): median "
            f"{med * 1e3:.2f} ms over {iters} (min {min(times) * 1e3:.2f}, max "
            f"{max(times) * 1e3:.2f}); {16 / med:.1f} img/s; peak memory {peak:.2f} GiB")
        profile_step(lambda: step(state, batch))
        info["step"] = {"median_ms": med * 1e3, "min_ms": min(times) * 1e3,
                        "max_ms": max(times) * 1e3, "img_per_s": 16 / med, "peak_gib": peak,
                        "objects": n_obj}

        items = {k: torch.stack([x[k] for x in losses]).float().cpu() for k in losses[0]}
        for k, v in items.items():
            need(bool(torch.isfinite(v).all()), f"non-finite {k} in a training step")
        log(f"  every loss item finite over {len(losses)} micro-steps; last items "
            f"{({k: round(float(v[-1]), 4) for k, v in items.items()})}")

        # the kernels of this path at its shapes
        calls = capture_step_calls(step, state, batch)
        need(len(calls["roi_align_bounded"]) == len(calls["roi_align_bounded_bwd"]) == 1,
             "the training step must pool once and run the ROI-align backward once")
        fargs, bargs = calls["roi_align_bounded"][0], calls["roi_align_bounded_bwd"][0]
        K = fargs[1].shape[0]
        need(K == 16 * 64 and fargs[0][0].dtype == torch.bfloat16,
             f"expected 1024 bf16 ROIs, got {K}")
        rab, plain = pallas_roi_align.roi_align_bounded, pallas_roi_align.roi_align_bounded_plain
        check_equal(f"roi_align forward at the training shapes ({K} whole-canvas ROIs, bf16)",
                    rab(*fargs), plain(*fargs))
        bk = pallas_roi_align.roi_align_bounded_bwd
        bp = pallas_roi_align.roi_align_bounded_bwd_plain
        got = bk(*bargs)
        torch.cuda.synchronize()
        err = check_bwd(f"roi_align_bwd at the training shapes ({K} ROIs, bf16) vs the plain "
                        f"version's autograd", got, bp(*bargs), 2e-2)
        need(all(torch.equal(a, b) for a, b in zip(got, bk(*bargs))),
             "roi_align_bwd at the training shapes: two launches differ")
        log("  roi_align_bwd at the training shapes: two launches bit-identical")
        ragged = ragged_bwd_case()
        t = kernel_ms(lambda: bk(*bargs), 20)
        t["device_launches"] = bwd_launches("roi_align_bwd", lambda: bk(*bargs),
                                            f"at the training shapes ({K} ROIs)")
        t["skips"] = bwd_skips(bargs)
        t["device_ms"] = t["skips"]["device_ms"]
        log(f"  roi_align_bwd at the training shapes, the ROIs its gather passes over: "
            f"{t['skips']}")
        plain_ms = cuda_ms(lambda: bp(*bargs), 5)
        b_ms, by = bwd_bound(bargs, got)
        log(f"  roi_align_bwd: {t['ms']:.4f} ms a call ({t['ms_back_to_back']:.4f} back to back, "
            f"device {t['device_ms']:.4f}) | plain {plain_ms:.4f} ms | bound {b_ms:.4f} ms ({by})")
        result = dict(max_abs_err=err, ms=t["ms"], ms_back_to_back=t["ms_back_to_back"],
                      device_ms=t["device_ms"], device_launches=t["device_launches"],
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                      ragged_f32_max_abs_err=ragged)
    del model, state, opt, batch
    torch.cuda.empty_cache()
    return launches, result, info


def ragged_bwd_case() -> float:
    """The backward on a ragged f32 case (odd level sizes, 12 channels, boxes
    across level borders, an active prefix) against the plain version on the
    CPU."""
    gen = torch.Generator().manual_seed(11)
    feats = [torch.randn((2, h, w, 12), generator=gen) for h, w in ((37, 29), (19, 15), (10, 8))]
    strides = (8.0, 16.0, 32.0)
    K, M, n = 9, 7, 2
    xy = torch.rand((2, K, 2), generator=gen) * 250 - 10
    boxes = torch.cat([xy, xy + torch.rand((2, K, 2), generator=gen) * 120 + 1], -1)
    levels = torch.randint(0, 3, (2, K), generator=gen)
    meta = roi_ops.level_meta(feats, strides)
    lv = levels.reshape(-1).to(torch.int32)
    ys, xs, moff, mh, mw = sample_coords(boxes.reshape(-1, 4), lv, meta, M * n, False)
    bnds = torch.stack([moff, moff + mh, torch.zeros_like(mw), mw], -1)
    b_idx = torch.arange(2, dtype=torch.int32).repeat_interleave(K)
    z = torch.zeros_like(b_idx)
    rmeta = torch.stack([b_idx, z, z, lv], -1)
    g = torch.randn((2 * K, M, M, 12), generator=gen)
    window = (sum(f.shape[1] for f in feats), feats[0].shape[2])
    args = (g, feats, rmeta, ys, xs, bnds, window, M, n, torch.tensor(13))
    want = pallas_roi_align.roi_align_bounded_bwd_plain(*args)
    cuda = lambda t: t.cuda() if torch.is_tensor(t) else [x.cuda() for x in t] \
        if isinstance(t, list) else t
    cargs = [cuda(a) for a in args]
    got = pallas_roi_align.roi_align_bounded_bwd(*cargs)
    need(all(torch.equal(a, b) for a, b in zip(got, pallas_roi_align.roi_align_bounded_bwd(*cargs))),
         "roi_align_bwd, ragged f32: two launches differ")
    return check_bwd("roi_align_bwd, ragged f32 (card vs the CPU's plain version)",
                     [x.cpu() for x in got], want, 1e-5)


def phase_train_reference():
    """One training step of yolov5s-test at 256 px in f32 (no TF32) on the
    card and on the CPU from the same state: the loss items (rtol 1e-4) and
    the gradients of the stem conv, a BatchNorm scale and a det conv bias
    (1e-3 x max|g|) and of the mask head's first conv (2e-2 x max|g|: its
    gradient is a sum of cancelling terms behind five ReLUs, which rounding
    moves that far)."""
    from hd_yolo_tpu_torch.models.yolo import Model

    cfg = load_cfg("hyp-nuclei")
    cfg["det"]["mask_iou_t"] = 0.05
    rng = np.random.default_rng(4)
    B, T = 2, 24
    x = torch.from_numpy(rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8))
    xy = rng.uniform(0.05, 0.8, (B, T, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(0.04, 0.15, (B, T, 2)), 1)], -1)
    yy, xx = np.mgrid[0:28, 0:28] + 0.5
    rad = rng.uniform(6, 13, (B, T, 1, 1))
    tg = {"boxes": torch.tensor(boxes, dtype=torch.float32),
          "labels": torch.from_numpy(rng.integers(0, 5, (B, T))),
          "masks": torch.from_numpy((((yy - 14) ** 2 + (xx - 14) ** 2) < rad ** 2).astype(np.float32)),
          "valid": torch.from_numpy(rng.uniform(size=(B, T)) < 0.8)}
    m0 = Model.from_cfg("yolov5s-test", cfg, mask_rois=8)
    m0.init_weights(torch.Generator().manual_seed(3))
    models, res = {}, {}
    for dev in ("cuda", "cpu"):
        m = Model.from_cfg("yolov5s-test", cfg, mask_rois=8)
        m.load_state_dict(m0.state_dict())
        m.to(dev).train()
        losses, _ = m.losses(x.to(dev), {"det": {k: v.to(dev) for k, v in tg.items()}})
        m.total_loss(losses).backward()
        models[dev] = m
        res[dev] = {k: float(v) for k, v in losses["det"]["loss_items"].items()}
    for k in res["cpu"]:
        need(abs(res["cuda"][k] - res["cpu"][k]) <= 1e-4 * abs(res["cpu"][k]) + 1e-7,
             f"train reference: loss {k} {res['cuda'][k]} on the card vs {res['cpu'][k]}")
    need(res["cpu"]["mask"] > 0, "train reference: no mask loss")
    names = {"backbone.0.conv.weight": 1e-3, "backbone.1.bn.weight": 1e-3,
             "headers.det.m.0.bias": 1e-3,
             "headers.det.seg_h.maskrcnn_heads.mask_fcn1.weight": 2e-2}
    pc = dict(models["cpu"].named_parameters())
    worst = {}
    for n, p in models["cuda"].named_parameters():
        if n in names:
            want = pc[n].grad
            err = float((p.grad.cpu() - want).abs().max())
            worst[n] = err / float(want.abs().max())
            need(err <= names[n] * float(want.abs().max()),
                 f"train reference: gradient of {n} differs by {err:.3g}")
    log(f"  yolov5s-test 256 px f32 step, card vs CPU: loss items {res['cuda']} vs {res['cpu']}; "
        f"gradient |d| / max|g|: {({k.split('.', 1)[1]: f'{v:.2e}' for k, v in worst.items()})}")


def hnet_batch(seed: int, B: int = 4, size: int = 640, max_t: int = 64, seg_stride: int = 16):
    """A labelled hnet batch from ``seed``: B tiles of ``size`` px with
    3/4·max_t to max_t nuclei each (10-40 px ellipses of classes 1-4, drawn
    darker by class on a textured background), for ``det40x`` their boxes,
    labels and 28x28 in-box masks; for ``seg10x`` a (B, size/seg_stride,
    size/seg_stride) seg map painted from them (a cell whose centre lies in
    a nucleus takes its class); for ``cl5x`` each tile's dominant class,
    capped to 3 classes.  Numpy arrays."""
    rng = np.random.default_rng(seed)
    S = size // seg_stride
    img = rng.integers(150, 230, (B, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((B, max_t, 4), np.float32)
    labels = np.zeros((B, max_t), np.int64)
    valid = np.zeros((B, max_t), bool)
    masks = np.zeros((B, max_t, 28, 28), np.float32)
    seg = np.zeros((B, S, S), np.int64)
    cl = np.zeros((B,), np.int64)
    u = (np.arange(28) + 0.5) / 28
    disk = ((u[:, None] - 0.5) ** 2 + (u[None, :] - 0.5) ** 2 <= 0.25).astype(np.float32)
    centres = np.arange(S) * seg_stride + seg_stride / 2
    for b in range(B):
        k = int(rng.integers(max_t * 3 // 4, max_t + 1))
        wh = rng.uniform(10, min(40, size / 2), (k, 2))
        xy = rng.uniform(0, size - wh)
        lab = rng.integers(1, 5, k)
        for j in range(k):
            (x1, y1), (x2, y2) = xy[j], xy[j] + wh[j]
            cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, wh[j, 0] / 2, wh[j, 1] / 2
            r0, r1, c0, c1 = int(y1), int(np.ceil(y2)), int(x1), int(np.ceil(x2))
            yy, xx = np.mgrid[r0:r1, c0:c1] + 0.5
            inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
            img[b, r0:r1, c0:c1][inside] = 30 + 25 * lab[j]
            boxes[b, j] = [x1 / size, y1 / size, x2 / size, y2 / size]
            labels[b, j], valid[b, j], masks[b, j] = lab[j], True, disk
            cell = (((centres[None, :] - cx) / rx) ** 2 + ((centres[:, None] - cy) / ry) ** 2) <= 1
            seg[b][cell] = lab[j]
        cl[b] = min(int(np.argmax(np.bincount(lab, minlength=5)[1:])), 2)
    return img, {"det40x": {"boxes": boxes, "labels": labels, "valid": valid, "masks": masks},
                 "seg10x": {"seg_map": seg}, "cl5x": {"label": cl}}


def canvas_plain_parts(args, levels):
    """A whole-canvas ``roi_align_bounded`` call (the window the stacked
    canvas, every origin 0: ``multiscale_roi_align_canvas``) in the plain
    canvas form, per image as ``_multiscale_roi_align_canvas`` contracts
    (the same interpolation matrices and rounding points as
    ``roi_align_bounded_plain``, without its per-ROI copies of the
    window): [(that image's ROI indices, their output)] over the images.
    ``levels`` stand in for the call's own (leaves for a gradient)."""
    _, meta, ys, xs, bnds, window, M, n = args[:8]
    Ht, W0 = window
    need((len(args) < 9 or args[8] is None) and Ht == sum(f.shape[1] for f in levels)
         and W0 == max(f.shape[2] for f in levels) and not bool(meta[:, 1:3].any()),
         "the check takes whole-canvas ROI-align calls")
    cd = torch.bfloat16 if levels[0].dtype == torch.bfloat16 else torch.float32
    canvas = torch.cat([F.pad(f, (0, 0, 0, W0 - f.shape[2])) for f in levels], 1)
    Wy = roi_ops._bounded_interp_matrix(ys, bnds[:, 0], bnds[:, 1], Ht, M, n).to(cd).float()
    Wx = roi_ops._bounded_interp_matrix(xs, bnds[:, 2], bnds[:, 3], W0, M, n).to(cd).float()
    parts = []
    for b in range(levels[0].shape[0]):
        idx = (meta[:, 0] == b).nonzero()[:, 0]
        r = torch.einsum("ksh,hwc->kswc", Wy[idx], canvas[b].to(cd).float()).to(cd).float()
        parts.append((idx, torch.einsum("ktw,kswc->kstc", Wx[idx], r).to(levels[0].dtype)))
    return parts


def canvas_plain(args) -> torch.Tensor:
    """The plain output of a whole-canvas ``roi_align_bounded`` call."""
    K, M, C = args[1].shape[0], args[6], args[0][0].shape[-1]
    out = torch.empty((K, M, M, C), dtype=args[0][0].dtype, device=args[1].device)
    for idx, o in canvas_plain_parts(args, [f.detach() for f in args[0]]):
        out[idx] = o
    return out


def canvas_bwd_plain(bargs) -> list:
    """The plain level gradients of a whole-canvas call's backward: the
    autograd of ``canvas_plain_parts``, each image's in f32, summed."""
    g, levels = bargs[0], bargs[1]
    leaves = [f.detach().requires_grad_() for f in levels]
    acc = [torch.zeros(f.shape, dtype=torch.float32, device=f.device) for f in levels]
    with torch.enable_grad():
        for idx, o in canvas_plain_parts(bargs[1:], leaves):
            got = torch.autograd.grad(o, leaves, g[idx].to(o.dtype), allow_unused=True)
            for x, y in zip(acc, got):
                if y is not None:
                    x += y.float()
    return acc


@torch.no_grad()
def check_step_canvas(calls) -> dict:
    """The canvas ROI-align's calls of an hnet training step (the box head's
    and the mask head's pooling of pass 1 and pass 2), each on its own
    captured inputs: the forward bit for bit the plain canvas form, the
    backward (``roi_align_bwd``) within 2e-2 x max|plain| of each level's
    gradient by that form's autograd, as phase 14 holds it, two launches
    bit-identical and at most two device launches a call; times and bounds
    of each."""
    rab, bk = pallas_roi_align.roi_align_bounded, pallas_roi_align.roi_align_bounded_bwd
    res = {}
    for i, fa in enumerate(calls["roi_align_bounded"]):
        K, M = fa[1].shape[0], fa[6]
        got = rab(*fa)
        check_equal(f"roi_align forward at the hnet step's call {i} ({K} whole-canvas ROIs at "
                    f"{M}x{M}, {fa[0][0].dtype})", got, canvas_plain(fa))
        t = kernel_ms(lambda: rab(*fa), 20)
        t["bound_ms"], t["bound_by"] = roi_bound(fa, got)
        res[f"fwd_{i}_{K}x{M}"] = t
    for i, ba in enumerate(calls["roi_align_bounded_bwd"]):
        K, M = ba[2].shape[0], ba[7]
        got = bk(*ba)
        check_bwd(f"roi_align_bwd at the hnet step's call {i} ({K} ROIs at {M}x{M}, "
                  f"{ba[0].dtype}) vs the plain version's autograd", got,
                  canvas_bwd_plain(ba), 2e-2)
        need(all(torch.equal(a, b) for a, b in zip(got, bk(*ba))),
             f"roi_align_bwd at the hnet step's call {i}: two launches differ")
        t = kernel_ms(lambda: bk(*ba), 20)
        t["device_launches"] = bwd_launches("roi_align_bwd", lambda: bk(*ba),
                                            f"at the hnet step's call {i} ({K} ROIs at {M}x{M})")
        t["skips"] = bwd_skips(ba)
        t["device_ms"] = t["skips"]["device_ms"]
        t["bound_ms"], t["bound_by"] = bwd_bound(ba, got)
        res[f"bwd_{i}_{K}x{M}"] = t
    log(f"  the canvas ROI-align on the hnet step's inputs: {json.dumps(res)}")
    return res


def hnet_train_state():
    """Phase 15's model (hnet-nucls, bf16, seeded weights), its train state
    and step."""
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step

    model = HNet.from_cfg(load_cfg("hnet-nucls"), dtype=torch.bfloat16, seed=0)
    need(model.stochastic, "hnet-nucls trains with drop path on")
    return model, TrainState.create(model, build_optimizer(model, HNET_HYP, 80, 12)), \
        make_train_step()


def hnet_train_batch():
    """Phase 15's batch on the card (``hnet_batch(0)``) and its object count."""
    from hd_yolo_tpu_torch.engines.train_step import to_device

    x, t = hnet_batch(0)
    return to_device({"image": x, "targets": t}, "cuda"), int(t["det40x"]["valid"].sum())


def hnet_batch_loss(model, batch):
    """The batch's hnet loss in eval mode (no drop path), as a function."""
    def batch_loss():
        model.eval()
        with torch.no_grad():
            losses, _ = model(batch["image"], batch["targets"])
        return float(model.total_loss(losses))
    return batch_loss


def phase_hnet_train(iters: int):
    """Phase 15: hnet-nucls training at full width (Swin-T with drop path
    0.2, FPN 256, Mask R-CNN, panoptic, cl and the mask-weighted
    constrain), bf16, batch 4 x 640, through ``build_optimizer`` and
    ``make_train_step``."""
    torch.cuda.empty_cache()
    model, state, step = hnet_train_state()
    batch, n_obj = hnet_train_batch()
    # 8 updates on the fixed batch from the fresh model: the batch's loss in
    # eval mode (no drop path) after them is below the loss before them, and
    # within a tenth of that fall of the loss after the same updates through
    # the plain backwards (as phase 14).  (Fifteen micro-steps in, the 8
    # updates' change of this loss is within the spread of two runs through
    # the same code, and the check failed by chance through every backward:
    # ``--hnet-loss-trials``.)
    r = loss_runs(step, state, batch, hnet_batch_loss(model, batch))
    metrics = r.pop("metrics")
    log(f"  loss on the batch (eval mode) before 8 updates (the fresh model) {r['before']:.4f}; "
        f"after them through the kernels {r['kernel']:.4f} (their {r['held']['calls']} calls "
        f"each held against the plain version, worst |d| / max|plain|: {r['held']}), through "
        f"the plain backwards {r['plain']:.4f}, through the kernels again "
        f"{r['kernel_again']:.4f}; the updates' losses "
        f"{[round(v, 4) for v in r['kernel_per_update']]}")
    need(r["kernel"] < r["before"], "the hnet loss did not fall over 8 updates")
    fall = r["before"] - r["plain"]
    need(fall > 0 and abs(r["kernel"] - r["plain"]) <= 0.1 * fall,
         f"the hnet loss after 8 updates through the kernels, {r['kernel']:.4f}, is not within a "
         f"tenth of the fall of the plain backwards' {r['plain']:.4f}")
    metrics += [step(state, batch)[1] for _ in range(3)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    _, m = step(state, batch)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    metrics.append(m)
    log(f"  launches of one hnet training micro-step: {launches}")
    for k, n in HNET_TRAIN_LAUNCHES.items():
        need(launches[k] == n, f"kernel {k}: {launches[k]} launches in one hnet training "
                               f"micro-step, expected {n}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  hnet train step (batch 4 x 640, bf16, drop path 0.2, {n_obj} objects): median "
        f"{med * 1e3:.2f} ms over {iters} (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}); {4 / med:.1f} img/s; peak memory {peak:.2f} GiB")
    busy = profile_step(lambda: step(state, batch))
    info = {"median_ms": med * 1e3, "min_ms": min(times) * 1e3, "max_ms": max(times) * 1e3,
            "img_per_s": 4 / med, "peak_gib": peak, "objects": n_obj, **busy,
            "before_redesign": EARLIER_HNET_STEP}
    log(f"  hnet micro-step median {med * 1e3:.2f} ms, {busy['device_launches']} device launches "
        f"a profiled step (before the backwards' redesign: {EARLIER_HNET_STEP['median_ms']} ms, "
        f"{EARLIER_HNET_STEP['device_launches']} launches, another call: host speed differs)")

    items = {k: torch.stack([mm[k] for mm in metrics]).float().cpu() for k in metrics[0]}
    for k, v in items.items():
        need(bool(torch.isfinite(v).all()), f"non-finite {k} in an hnet training step")
    log(f"  every loss item finite over {len(metrics)} micro-steps; last items "
        f"{({k: round(float(v[-1]), 4) for k, v in items.items()})}")
    info.update(loss_runs=r, last_items={k: float(v[-1]) for k, v in items.items()})

    # the step's ROI-align kernels on the step's own inputs: the canvas
    # ROI-align bit for bit and its backward (phase 14's kernel) within
    # phase 14's tolerance of the plain autograd, at each of the step's
    # calls; the single-level backward's two pyramids bit for bit the plain
    # autograd on the card, the constrain's pooling against the CPU's plain
    # version
    calls = capture_step_calls(step, state, batch)
    need(len(calls["roi_align_bounded"]) == len(calls["roi_align_bounded_bwd"]) == 4,
         f"expected 4 roi_align_bounded and 4 roi_align_bounded_bwd calls a step, got "
         f"{len(calls['roi_align_bounded'])} and {len(calls['roi_align_bounded_bwd'])}")
    info["canvas_at_step"] = check_step_canvas(calls)
    calls = calls["roi_align_levels_bwd"]
    need(len(calls) == 3, f"expected 3 roi_align_levels_bwd calls a step, got {len(calls)}")
    bwd, plain = pallas_roi_align.roi_align_levels_bwd, pallas_roi_align.roi_align_levels_bwd_plain
    step_bwd = {}
    for i, args in enumerate(calls):
        if len(args[1]) == 4:
            for f, g, w in zip(args[1], bwd(*args), plain(*args)):
                check_equal(f"roi_align_single_bwd at the step's pyramid {i} {tuple(f.shape)} "
                            f"{f.dtype}", g, w)
            step_bwd[f"pyramid_{i}"] = kernel_ms(lambda: bwd(*args), 20)
            step_bwd[f"pyramid_{i}"]["device_ms"] = device_ms(lambda: bwd(*args))
            step_bwd[f"pyramid_{i}"]["device_launches"] = bwd_launches(
                "roi_align_single_bwd", lambda: bwd(*args), f"at the step's pyramid {i}")
        else:
            step_bwd["constrain"] = constrain_bwd_paths(
                args, 20, f"the step's constrain pooling {tuple(args[1][0].shape)}, "
                          f"{args[2].shape[1]} boxes an image")
            wh = (args[2][..., 2:] - args[2][..., :2]).flatten()
            step_bwd["constrain_box_side_px_median"] = float(wh.median())
    log(f"  roi_align_single_bwd on the step's inputs: {json.dumps(step_bwd)}")
    info["roi_align_single_bwd_at_step"] = step_bwd
    del model, state, batch
    torch.cuda.empty_cache()
    return launches, info


def hnet_loss_trials(n: int) -> None:
    """``--hnet-loss-trials N``: phase 15's loss check N times, each on a
    fresh seeded model and phase 15's batch: ``loss_runs`` from the fresh
    model, then, 15 micro-steps in (where phase 15 takes it), again.  One
    JSON line a trial, then the number of runs whose loss did not fall, by
    start and backward."""
    batch, _ = hnet_train_batch()
    rose = {}
    for i in range(n):
        model, state, step = hnet_train_state()
        bl = hnet_batch_loss(model, batch)
        rec = {}
        for start in ("fresh", "15 in"):
            if start == "15 in":
                for _ in range(15 - state.count):
                    step(state, batch)
            r = loss_runs(step, state, batch, bl)
            rec[start] = {k: r[k] for k in ("before", "kernel", "plain", "kernel_again", "held")}
            for k in ("kernel", "plain", "kernel_again"):
                rose.setdefault(f"{start}/{k}", 0)
                rose[f"{start}/{k}"] += r[k] >= r["before"]
        log(f"  trial {i}: {json.dumps(rec)}")
        del model, state
        torch.cuda.empty_cache()
    log(f"  runs whose loss did not fall over 8 updates, of {n} each: {json.dumps(rose)}")


def step_call_times(path: str) -> None:
    """``--step-calls PATH``: the two backwards timed (profiler device time)
    at hnet training calls saved in PATH, captured there first where it does
    not exist, so that two trees time the same inputs: one step's calls 15
    micro-steps into phase 15's training, and the constrain's pooling every
    third micro-step of that run up to 36 (its detections, and so its
    boxes, change as it trains).  For each canvas call also its time
    without the ROIs its gather passes over (``bwd_skips``); for the
    pyramids their output gradients' strides; for each constrain call its
    boxes of 150 px or more by image, and the kernel held within 1e-5 x
    max|plain| of the CPU's plain version."""
    if not os.path.exists(path):
        model, state, step = hnet_train_state()
        batch, _ = hnet_train_batch()
        calls, constrains = {}, []
        for i in range(1, 37):
            step(state, batch)
            if i % 3 == 0:
                c = capture_step_calls(step, state, batch)
                constrains += [a for a in c["roi_align_levels_bwd"] if len(a[1]) == 1]
                if i == 15:
                    calls = c
        calls["constrains"] = constrains
        torch.save(calls, path)
        del model, state
        torch.cuda.empty_cache()
    calls = torch.load(path, map_location="cuda", weights_only=False)
    bl = pallas_roi_align.roi_align_levels_bwd
    res = {}
    for i, ba in enumerate(calls["roi_align_bounded_bwd"]):
        res[f"canvas_{i}_{ba[2].shape[0]}x{ba[7]}"] = bwd_skips(ba)
    for i, la in enumerate(calls["roi_align_levels_bwd"]):
        if len(la[1]) > 1:
            res[f"pyramid_{i}"] = {"device_ms": device_ms(lambda: bl(*la)),
                                   "grad_strides": [list(g.stride()) for g in la[0]],
                                   "grad_shapes": [list(g.shape) for g in la[0]]}
    res["constrain_along_the_run"] = []
    for la in calls["constrains"]:
        side = (la[2][..., 2:] - la[2][..., :2]).amax(-1)
        err = bwd_rel_err([x.cpu() for x in bl(*la)],
                          pallas_roi_align.roi_align_levels_bwd_plain(*cpu_tree(la)))
        need(err <= 1e-5, f"roi_align_single_bwd at a captured constrain call: |kernel - plain| "
                          f"/ max|plain| {err:.3g} > 1e-5")
        res["constrain_along_the_run"].append({
            "device_ms": device_ms(lambda: bl(*la)), "rel_err": err,
            "boxes_150px_or_more": (side >= 150).sum(1).tolist()})
    log(f"  step calls ({path}): {json.dumps(res)}")


# tests/test_torch_hnet.py's small hnet, with hnet-nucls' mask-weighted
# constrain and a box-mean one
HNET_TINY = {
    "backbone": {"type": "swin", "embed_dim": 32, "depths": [1, 1, 1, 1],
                 "num_heads": [1, 2, 4, 8], "window_size": 4},
    "fpn": {"out_channels": 32},
    "headers": {
        "det40x": {"type": "maskrcnn", "num_classes": 4, "pre_nms_topk": 128,
                   "num_proposals": 32, "num_detections": 16,
                   "anchor_sizes": [16.0, 32.0, 64.0, 128.0]},
        "seg10x": {"type": "panoptic", "num_classes": 5, "channels": 32},
        "cl5x": {"type": "cl", "num_classes": 3, "hidden": 32, "amplification": 0.5},
    },
    "constrains": {
        "c0": {"seg_task": "seg10x", "det_task": "det40x", "weighting": "mask",
               "edges": [[1, 1], [2, 2], [3, 3]], "values": [1.0, 1.0, 1.0]},
        "c1": {"seg_task": "seg10x", "det_task": "det40x", "edges": [[1, 1], [2, 2], [3, 3]]},
    },
}


def phase_hnet_train_reference():
    """Phase 15b: the small hnet in f32 (no TF32), one training forward and
    backward on the card and on the CPU from the same weights and batch (2
    x 64 px): every loss item within rtol 1e-4, and per parameter group
    (``label_params``) each tensor's gradient within 1e-3 x its max|g| —
    the mask head's within 2e-2 (its gradients are sums of cancelling terms
    behind five ReLUs, as phase 14b states).  The seg map is at stride 8, so
    the probabilities are resized to it; the weights (seed 0) give valid
    detections, so both constrain losses are held too."""
    from hd_yolo_tpu_torch.engines.optim import label_params

    x, t = hnet_batch(5, B=2, size=64, max_t=6, seg_stride=8)
    m0 = HNet.from_cfg(HNET_TINY, device="cpu", seed=0)
    res, grads = {}, {}
    for dev in ("cuda", "cpu"):
        m = HNet(HNET_TINY, device=dev)
        m.load_state_dict(m0.state_dict())
        m.train()
        tt = {task: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
              for task, d in t.items()}
        losses, _ = m(torch.from_numpy(x).to(dev), tt)
        m.total_loss(losses).backward()
        res[dev] = {f"{task}/{k}": float(v.detach()) for task, d in losses.items()
                    for k, v in d.items()}
        grads[dev] = {n: p.grad.cpu() for n, p in m.named_parameters()}
    for k, v in res["cpu"].items():
        need(math.isfinite(v) and abs(res["cuda"][k] - v) <= 1e-4 * abs(v) + 1e-6,
             f"hnet train reference: loss {k} {res['cuda'][k]} on the card vs {v}")
    need(res["cpu"]["constrains/c0"] > 0 and res["cpu"]["constrains/c1"] > 0,
         "hnet train reference: no valid detections, so no constrain loss to hold")
    worst = {}
    for name, group in label_params(m0).items():
        want, got = grads["cpu"][name], grads["cuda"][name]
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / max(scale, 1e-30)
        lim = 2e-2 if ".mask_head." in name else 1e-3
        need(rel <= lim or scale < 1e-7, f"hnet train reference: gradient of {name} ({group}) "
                                         f"|d| / max|g| {rel:.3g} > {lim}")
        worst[group] = max(worst.get(group, 0.0), rel if scale >= 1e-7 else 0.0)
    log(f"  small hnet f32 training step, card vs CPU: loss items {res['cuda']} vs "
        f"{res['cpu']}; worst gradient |d| / max|g| by group {worst}")


# ---------------------------------------------------------- device augmentation
AUG_TOL = {"image": 1e-4, "masks": 1e-4, "boxes_px": 1e-3}


def near_threshold(boxes_px: torch.Tensor, tol: float) -> torch.Tensor:
    """Boxes whose width, height or aspect ratio lies within ``tol`` of one of
    the recipe's cuts (the 10 px small-object rule, the 2 px candidate and
    visibility rules, the aspect ratio 20)."""
    w, h = boxes_px[:, 2] - boxes_px[:, 0], boxes_px[:, 3] - boxes_px[:, 1]
    ar = torch.maximum(w / (h + 1e-16), h / (w + 1e-16))
    near = lambda v, c: (v - c).abs() <= tol                             # noqa: E731
    return near(w, 10) | near(h, 10) | near(w, 2) | near(h, 2) | near(ar, 20)


def compare_recipe(name: str, got: dict, want: dict, S: int) -> dict:
    """The recipe's output on the card against the CPU's on the same draws:
    images and masks within ``AUG_TOL``, boxes within 1e-3 px, labels and
    valid flags equal.  An image whose valid flags differ is accepted only
    where each box valid on one side alone lies within 1e-3 of a cut
    (``near_threshold``); its slots are not compared further."""
    img_err = float((got["image"].cpu() - want["image"]).abs().max())
    need(img_err <= AUG_TOL["image"] and bool(torch.isfinite(got["image"]).all()),
         f"device recipe {name}: image max |card - cpu| {img_err:.3g} > {AUG_TOL['image']}")
    res = {"image_max_abs_err": img_err}
    for task, tw in want["targets"].items():
        tg = {k: v.cpu() for k, v in got["targets"][task].items()}
        flips = (tg["valid"] != tw["valid"]).any(1)
        for b in flips.nonzero().flatten().tolist():
            gb = tg["boxes"][b][tg["valid"][b]] * S
            cb = tw["boxes"][b][tw["valid"][b]] * S
            d = (gb[:, None] - cb[None]).abs().amax(-1) <= AUG_TOL["boxes_px"]
            lone = torch.cat([gb[~d.any(1)], cb[~d.any(0)]])
            need(bool(near_threshold(lone, AUG_TOL["boxes_px"]).all()),
                 f"device recipe {name}: image {b}'s valid flags differ card vs cpu at boxes "
                 f"{lone.tolist()} not within 1e-3 of a cut")
        same = ~flips
        maxabs = lambda x: float(x.abs().max()) if x.numel() else 0.0        # noqa: E731
        box_err = maxabs(((tg["boxes"] - tw["boxes"]) * S)[same])
        mask_err = maxabs((tg["masks"] - tw["masks"])[same])
        need(box_err <= AUG_TOL["boxes_px"] and mask_err <= AUG_TOL["masks"]
             and torch.equal(tg["labels"][same], tw["labels"][same]),
             f"device recipe {name}: boxes {box_err:.3g} px, masks {mask_err:.3g}, or labels "
             f"differ card vs cpu")
        res[task] = {"valid_card": int(tg["valid"].sum()), "valid_cpu": int(tw["valid"].sum()),
                     "images_with_flag_flips": int(flips.sum()), "boxes_px_max_abs_err": box_err,
                     "masks_max_abs_err": mask_err}
    log(f"  recipe {name}, card vs CPU on the same draws: {res}")
    return res


def step_turns(steps: dict, iters: int) -> dict:
    """Median / min / max milliseconds of each ``steps[name]()``, ending in a
    synchronise, the steps taken in turns after 2 warm-ups each."""
    for fn in steps.values():
        for _ in range(2):
            fn()
    times = {k: [] for k in steps}
    for _ in range(iters):
        for k, fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: {"median_ms": statistics.median(v), "min_ms": min(v), "max_ms": max(v)}
            for k, v in times.items()}


def phase_device_augment(iters: int, host_cli=None):
    """Phase 16: the device recipe at full width: yolov5l6-mask + hyp-nuclei,
    bf16, batch 16 x 640, 256 targets with masks, on the 64-tile set in raw
    mode."""
    import tempfile

    from hd_yolo_tpu_torch.data.dataset import DataLoader, DetectionDataset, collate_padded
    from hd_yolo_tpu_torch.data.device_augment import (apply_augment, draw_augment,
                                                       make_device_augment, upload_draws)
    from hd_yolo_tpu_torch.engines import train as train_mod
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.models.builder import parse_model_cfg
    from hd_yolo_tpu_torch.models.yolo import Model

    torch.cuda.empty_cache()
    info = {}
    hyp = train_mod.scale_task_hyp(load_cfg("hyp-nuclei"),
                                   parse_model_cfg("yolov5l6-mask", "hyp-nuclei"), 640)
    with tempfile.TemporaryDirectory() as tmp:
        data = make_train_set(tmp)
        csv = os.path.join(tmp, "index.csv")
        raw_ds = DetectionDataset(csv, {**hyp, "img_size": 640}, train=True, max_targets=256,
                                  host_augment=False, cache_images=True)
        raw = collate_padded([raw_ds[i] for i in range(16)])
        batch, batch_cpu = to_device(raw, "cuda"), to_device(raw, "cpu")

        # the card against the CPU on the same draws
        info["card_vs_cpu"] = {}
        for seed, (name, k, h) in enumerate((
                ("k_mosaic 2", 2, hyp), ("k_mosaic 1", 1, hyp),
                ("k_mosaic 2 + mixup 0.5 + photometric 1.0", 2,
                 {**hyp, "mixup": 0.5, "photometric": 1.0}))):
            draws = draw_augment(np.random.default_rng(seed), 16, 640, h, k)
            got = apply_augment(batch, upload_draws(draws, "cuda"))
            want = apply_augment(batch_cpu, upload_draws(draws, "cpu"))
            need(got["image"].shape == (16, 640, 640, 3)
                 and got["targets"]["detSC"]["masks"].shape == (16, 256, 28, 28),
                 f"device recipe {name}: shapes {got['image'].shape}")
            info["card_vs_cpu"][name] = compare_recipe(name, got, want, 640)
        del got, want, batch_cpu

        # the recipe's cost alone: host draws, one upload, the recipe on the card
        aug = make_device_augment(hyp, k_mosaic=2)
        rng = np.random.default_rng(0)
        recipe = lambda: aug(batch, aug.draw(rng, 16, 640))                  # noqa: E731
        launches = device_launches(recipe)
        info["recipe"] = {"ms": cuda_ms(recipe, 20), "device_ms": device_ms(recipe),
                          "host_ms": host_us(recipe, 20) / 1e3,
                          "device_launches": sum(launches.values())}
        log(f"  recipe alone (k_mosaic 2, batch 16 x 640): {info['recipe']}")
        info["recipe"]["profile"] = profile_step(recipe)

        # the micro-step with the recipe inside next to phase 14's step on a
        # host-augmented batch, in turns on one state
        model = Model.from_cfg("yolov5l6-mask", hyp, dtype=torch.bfloat16, mask_rois=64)
        model.init_weights(torch.Generator().manual_seed(0))
        model.cuda()
        state = TrainState.create(model, build_optimizer(model, hyp, 2, 4, accumulate=4))
        host_ds = DetectionDataset(csv, {**hyp, "img_size": 640}, train=True, max_targets=256,
                                   seed=1)
        host_batch = to_device(next(iter(DataLoader(host_ds, 16, workers=1))), "cuda")
        step_host, step_aug = make_train_step(), make_train_step(augment_fn=aug)
        turns = step_turns({"host_augmented": lambda: step_host(state, host_batch),
                            "device_recipe": lambda: step_aug(state, batch)}, iters)
        torch.cuda.synchronize()
        kernels.reset_launches()
        _, m = step_aug(state, batch)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        need(launches["roi_align"] == 1 and launches["roi_align_bwd"] == 1
             and bool(torch.isfinite(m["loss"])),
             f"a micro-step with the recipe: launches {launches}, loss {float(m['loss'])}")
        for k, v in turns.items():
            v["img_per_s"] = 16e3 / v["median_ms"]
        info["step"] = turns
        log(f"  micro-step in turns (batch 16 x 640, bf16, masks): {turns}; launches of the "
            f"step with the recipe {launches}")
        info["step"]["device_recipe"].update(profile_step(lambda: step_aug(state, batch)))
        del model, state, step_host, step_aug, host_batch
        torch.cuda.empty_cache()

        # the CLI with the set resident on the card, and the host loader's
        if host_cli is None:
            host_cli = phase_train_cli(data, os.path.join(tmp, "run_host"))
        info["cli_cache_device"] = phase_train_cli(data, os.path.join(tmp, "run_resident"),
                                                   ["--cache-device"])
        up = info["cli_cache_device"]["resident_upload"]
        need(up["images"] == 64, f"the resident set holds {up['images']} images, not 64")
        info["cli_host_img_per_s_by_epoch"] = host_cli["img_per_s_by_epoch"]
        log(f"  CLI img/s by epoch: --cache-device "
            f"{[round(v, 2) for v in info['cli_cache_device']['img_per_s_by_epoch']]} (upload "
            f"{up['mb']:.1f} MB in {up['s']:.2f} s) | host loader "
            f"{[round(v, 2) for v in host_cli['img_per_s_by_epoch']]}")
        torch.cuda.empty_cache()

        # --batch-size -1 on the card
        opt = train_mod.argument_parser().parse_args(["--data", data, *TRAIN_CLI,
                                                      "--batch-size", "-1"])
        model = Model.from_cfg("yolov5l6-mask", hyp, dtype=torch.bfloat16, mask_rois=64)
        model.init_weights(torch.Generator().manual_seed(0))
        model.cuda()
        fit = {}
        b = train_mod.autobatch_size(model, hyp, opt, torch.device("cuda"), fit)
        need(b >= 16 and fit["per_image"] > 0,
             f"autobatch picked {b} (fit {fit}) where batch 16 runs")
        info["autobatch"] = {"batch": b, "mib_per_image": fit["per_image"] / 2 ** 20,
                             "base_gib": fit["base"] / 2 ** 30, "limit_gib": fit["limit"] / 2 ** 30}
        log(f"  --batch-size -1: autobatch picks {b} ({info['autobatch']})")
        del model
    torch.cuda.empty_cache()
    return launches, info


# ------------------------------------------- multihead, anchor-free, ensemble
class capture_calls:
    """``with capture_calls((module, name), ...) as seen:`` each listed
    function records the arguments of every call (``seen[name]``, a list of
    (args, kwargs)) and runs as it is."""

    def __init__(self, *targets):
        self.targets = targets

    def __enter__(self):
        self.seen = {name: [] for _, name in self.targets}
        self.orig = [(m, n, getattr(m, n)) for m, n in self.targets]
        for m, n, fn in self.orig:
            def spy(*a, _fn=fn, _n=n, **k):
                self.seen[_n].append((a, k))
                return _fn(*a, **k)
            setattr(m, n, spy)
        return self.seen

    def __exit__(self, *exc):
        for m, n, fn in self.orig:
            setattr(m, n, fn)
        return False


PATH_CALLS = ((pallas_nms, "nms_padded_pallas"), (pallas_roi_align, "roi_align_bounded"),
              (detect_head, "fused_mask_probs"))


@torch.no_grad()
def hold_path_calls(seen: dict, what: str) -> dict:
    """Each NMS, canvas ROI-align and mask-head call a path made, on its own
    inputs, against the plain version: NMS and the ROI-align bit for bit,
    the mask head as phase 5 holds masks (mean |d| <= 0.01, max <= 0.1).
    Returns the largest error of each and the calls held."""
    res = {}
    for (a, k) in seen.get("nms_padded_pallas", []):
        got = pallas_nms.nms_padded_pallas(*a, **k)
        want = nms_padded(*a, **k)
        need(all(torch.equal(x.to(torch.int64), y.to(torch.int64)) for x, y in zip(got, want)),
             f"{what}: nms at {tuple(a[0].shape)} disagrees with nms_padded")
        res.setdefault("nms", []).append(tuple(a[0].shape))
    for (a, k) in seen.get("roi_align_bounded", []):
        check_equal(f"{what}: roi_align at {a[1].shape[0]} ROIs", pallas_roi_align.roi_align_bounded(*a),
                    pallas_roi_align.roi_align_bounded_plain(*a))
        res.setdefault("roi_align", []).append(int(a[1].shape[0]))
    worst = {}
    for (a, k) in seen.get("fused_mask_probs", []):
        d = (pallas_mask_head.fused_mask_probs(*a, **k)
             - pallas_mask_head.fused_mask_probs_plain(*a, **k)).abs()
        name = "mask_head_f32" if a[1].dtype == torch.float32 else "mask_head"
        if name == "mask_head_f32":     # the f32 form: f32 rounding only
            need(float(d.max()) <= 1e-4, f"{what}: f32 mask head at {a[1].shape[0]} ROIs: max "
                                         f"|d| {float(d.max()):.4g}")
        else:
            need(float(d.mean()) <= 0.01 and float(d.max()) <= 0.1,
                 f"{what}: mask head at {a[1].shape[0]} ROIs: mean |d| {float(d.mean()):.4g}, "
                 f"max {float(d.max()):.4g}")
        worst[name] = max(worst.get(name, 0.0), float(d.max()))
        res.setdefault(name, []).append(int(a[1].shape[0]))
    for name, v in worst.items():
        res[f"{name}_max_abs_err"] = v
    log(f"  {what}: every kernel call held against its plain version on the path's inputs: "
        f"{res}")
    return res


def timed_steps(fn, iters: int) -> dict:
    """Median, min and max host-clock ms of ``iters`` synchronised calls of
    ``fn`` after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times)}


def path_launches(fn) -> dict:
    """The kernels' launch counts of one ``fn()``: every count set to 0 just
    before and read just after."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return dict(kernels.LAUNCHES), out


def two_task_batch(seed: int, B: int = 16, max_t: int = 64):
    """``hnet_batch``'s tiles and nuclei as targets of both multihead tasks,
    ``det`` on the first half of the images and ``detSC`` on the second."""
    x, t = hnet_batch(seed, B=B, max_t=max_t)
    d = t["det40x"]
    first = np.arange(B) < B // 2
    return x, {task: {**d, "valid": d["valid"] & rows[:, None]}
               for task, rows in (("det", first), ("detSC", ~first))}


def train_phase_state(cfg: str, seed: int = 0, dtype=torch.bfloat16):
    """``cfg`` at full width for training as the CLI builds it (hyp scaled
    for 640 px, flax-default init from ``seed``), in ``dtype`` (bf16), on
    the card, with its optimizer (an update a micro-step) and step."""
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train import scale_task_hyp
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step
    from hd_yolo_tpu_torch.models.builder import parse_model_cfg
    from hd_yolo_tpu_torch.models.yolo import Model

    hyp = scale_task_hyp(load_cfg("hyp-nuclei"), parse_model_cfg(cfg, "hyp-nuclei"), 640)
    model = Model.from_cfg(cfg, hyp, dtype=dtype, mask_rois=64)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.cuda()
    return TrainState.create(model, build_optimizer(model, hyp, 2, 4)), make_train_step()


def train_timing(step, state, batch, iters: int, masks: bool = True) -> tuple:
    """Launches of one micro-step, then the median / min / max of ``iters``
    timed micro-steps after 3 warm-ups, img/s, peak memory and a profiled
    step; every loss item finite."""
    ms = [step(state, batch)[1] for _ in range(3)]
    launches, (_, m) = path_launches(lambda: step(state, batch))
    ms.append(m)
    torch.cuda.reset_peak_memory_stats()
    t = timed_steps(lambda: ms.append(step(state, batch)[1]), iters)
    B = batch["image"].shape[0]
    t.update(img_per_s=B / t["median_ms"] * 1e3,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    t.update(profile_step(lambda: step(state, batch)))
    items = {k: torch.stack([x[k] for x in ms]).float().cpu() for k in ms[0]}
    for k, v in items.items():
        need(bool(torch.isfinite(v).all()), f"non-finite {k} in a training step")
    t["last_items"] = {k: float(v[-1]) for k, v in items.items()}
    return launches, t


def phase_multihead(iters: int):
    """Phase 17: yolov5l6-multihead (``det`` nc 7 and ``detSC`` nc 4, both
    with masks) at full width, bf16, batch 16 x 640, seeded weights."""
    from hd_yolo_tpu_torch.engines.train_step import to_device

    info = {}
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randint(0, 256, (16, 640, 640, 3), generator=gen, device="cuda", dtype=torch.uint8)
    det = Detector("yolov5l6-multihead", "hyp-nuclei", device="cuda", seed=0, pre_nms_topk=1024,
                   max_masks=100, mask_budget=768, mask_window=16)
    calibrate_objectness(det, x, 0.02)
    det.tiles(x)
    with capture_calls(*PATH_CALLS) as seen, MaskPrefix() as prefix:
        launches, out = path_launches(lambda: det.tiles(x))
    log(f"  launches of one batch, packed branch, both headers: {launches}; mask slots "
        f"computed {prefix.text()}; {prefix.check()}")
    for k, n in (("stem_tc", 1), ("stem", 0), ("nms", 2), ("roi_align", 2), ("mask_head", 2)):
        need(launches[k] == n, f"multihead: {k} launched {launches[k]} times, expected {n}")
    need(set(out) == {"det", "detSC"}, f"multihead outputs {sorted(out)}")
    for t, o in out.items():
        need(o["masks"].shape == (16, 100, 28, 28) and o["score_vector"].shape[-1] ==
             det.model.headers[t].nc + 1, f"multihead {t}: unexpected output shapes")
        for k in ("boxes", "scores", "masks"):
            need(bool(torch.isfinite(o[k].float()).all()), f"multihead {t}: non-finite {k}")
        need(int(o["valid"].sum()) >= 16 and int(o["mask_valid"].sum()) >= 16,
             f"multihead {t}: too few detections or masks")
        log(f"  {t}: valid detections/tile {float(o['valid'].sum()) / 16:.2f}, masks kept "
            f"{int(o['mask_valid'].sum())}")
    info["held_packed"] = hold_path_calls(seen, "multihead, packed")
    info["packed"] = timed_steps(lambda: det.tiles(x), iters)
    log(f"  packed branch step: median {info['packed']['median_ms']:.2f} ms over {iters} "
        f"(min {info['packed']['min_ms']:.2f}, max {info['packed']['max_ms']:.2f}); tiles/s "
        f"{16e3 / info['packed']['median_ms']:.1f}")
    info["packed"].update(profile_step(lambda: det.tiles(x)))

    dflt = Detector("yolov5l6-multihead", "hyp-nuclei", device="cuda", seed=0)
    dflt.model.load_state_dict(det.model.state_dict())
    dflt.tiles(x)
    with capture_calls(*PATH_CALLS) as seen:
        d_launches, d_out = path_launches(lambda: dflt.tiles(x))
    log(f"  launches of one batch at Detector()'s defaults: {d_launches}")
    for k, n in (("stem_tc", 1), ("nms", 2), ("roi_align", 2), ("mask_head", 2)):
        need(d_launches[k] == n, f"multihead defaults: {k} launched {d_launches[k]} times")
    for t, o in d_out.items():
        need(int(o["mask_valid"].sum()) >= int(out[t]["mask_valid"].sum()),
             f"multihead defaults {t}: fewer masks than the packed branch")
    info["held_defaults"] = hold_path_calls(seen, "multihead, defaults")
    info["defaults"] = timed_steps(lambda: dflt.tiles(x), iters)
    log(f"  defaults step: median {info['defaults']['median_ms']:.2f} ms (min "
        f"{info['defaults']['min_ms']:.2f}, max {info['defaults']['max_ms']:.2f})")
    images = [np.asarray(x[i].cpu()) for i in range(2)]
    recs = dflt(images).records
    for t in ("det", "detSC"):
        only = dflt(images, task=t).records
        need(all(set(r) == {t} for r in only), f"task={t} kept other tasks")
        need(all(np.array_equal(a[t]["labels"], b[t]["labels"]) for a, b in zip(only, recs)),
             f"task={t} records differ from the unfiltered call's")
    log("  Detector(..., task=) keeps that header's records only, equal to the unfiltered call's")
    del det, dflt
    torch.cuda.empty_cache()

    # training: both mask losses, one task an image
    state, step = train_phase_state("yolov5l6-multihead")
    xb, tb = two_task_batch(1)
    batch = to_device({"image": xb, "targets": tb}, "cuda")

    def batch_loss():
        state.model.train()
        with torch.no_grad():
            losses_, _ = state.model.losses(batch["image"], batch["targets"])
            return float(state.model.total_loss(losses_))

    r = loss_runs(step, state, batch, batch_loss)
    r.pop("metrics")
    log(f"  loss on the batch before 8 updates (the fresh model) {r['before']:.4f}; after them "
        f"through the kernels {r['kernel']:.4f} ({r['held']['calls']} backward calls held, worst "
        f"{r['held']['roi_align_bwd']:.3g}), plain {r['plain']:.4f}, kernels again "
        f"{r['kernel_again']:.4f}")
    need(r["kernel"] < r["before"], "multihead: the loss did not fall over 8 updates")
    fall = r["before"] - r["plain"]
    need(fall > 0 and abs(r["kernel"] - r["plain"]) <= 0.1 * fall,
         f"multihead: the loss through the kernels {r['kernel']:.4f} is not within a tenth of the "
         f"plain backward's fall to {r['plain']:.4f}")
    t_launches, info["train"] = train_timing(step, state, batch, iters)
    need(t_launches["roi_align"] == 2 and t_launches["roi_align_bwd"] == 2,
         f"multihead training: {t_launches}")
    need(all(info["train"]["last_items"].get(f"{t}/mask", 0) > 0 for t in ("det", "detSC")),
         "multihead training: a task's mask loss is 0")
    info["train"]["loss_runs"] = r
    log(f"  train micro-step (batch 16 x 640, bf16, both mask losses): median "
        f"{info['train']['median_ms']:.2f} ms over {iters} (min {info['train']['min_ms']:.2f}, "
        f"max {info['train']['max_ms']:.2f}); {info['train']['img_per_s']:.1f} img/s; peak "
        f"memory {info['train']['peak_gib']:.2f} GiB; launches {t_launches}")
    del state, step, batch
    torch.cuda.empty_cache()
    return launches, d_launches, t_launches, info


@torch.no_grad()
def calibrate_af(model, x, frac: float):
    """Set each level's objectness bias of the anchor-free header so that a
    fraction ``frac`` of that level's cells of ``x`` clears ``conf_thres``
    (random weights put the raw logits anywhere, and apart by level)."""
    h = model.headers["det"]
    feats = [model.trunk(x)[j] for j in h.spec.from_idx]
    _, _, obj, shapes = h._branches(feats)
    conf = h.nms_params["conf_thres"]
    start = 0
    for c, (ny, nx) in zip(h.obj_preds, shapes):
        raw = obj[:, start:start + ny * nx] - c.bias.float()
        start += ny * nx
        c.bias.fill_(math.log(conf / (1 - conf)) - float(torch.quantile(raw.flatten(), 1 - frac)))


def af_batch(seed: int, B: int = 16, max_t: int = 256, size: int = 640):
    """``hnet_batch``'s tiles with up to ``max_t`` nuclei each as ``det`` targets."""
    x, t = hnet_batch(seed, B=B, size=size, max_t=max_t)
    d = t["det40x"]
    return x, {"det": {k: d[k] for k in ("boxes", "labels", "valid")}}


def phase_anchor_free(iters: int):
    """Phase 18: yolov6s-af (depth 0.33, width 0.5) at batch 16 x 640, bf16."""
    from hd_yolo_tpu_torch.engines.train_step import to_device
    from hd_yolo_tpu_torch.models import anchor_free_head, layers

    info = {}
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randint(0, 256, (16, 640, 640, 3), generator=gen, device="cuda", dtype=torch.uint8)
    det = Detector("yolov6s-af", "hyp-nuclei", device="cuda", seed=0)
    calibrate_af(det.model, x, 0.01)
    det.tiles(x)
    with capture_calls((pallas_nms, "nms_padded_pallas"), (layers, "stem_conv")) as seen:
        launches, out = path_launches(lambda: det.tiles(x))
    log(f"  launches of one batch: {launches}")
    for k, n in (("stem_tc", 1), ("stem", 0), ("nms", 1), ("roi_align", 0), ("mask_head", 0)):
        need(launches[k] == n, f"anchor-free: {k} launched {launches[k]} times, expected {n}")
    o = out["det"]
    need(set(o) == {"boxes", "scores", "labels", "levels", "valid"}, f"AF outputs {sorted(o)}")
    need(bool(torch.isfinite(o["boxes"]).all() & torch.isfinite(o["scores"]).all()),
         "anchor-free: non-finite outputs")
    n_valid = int(o["valid"].sum())
    need(n_valid >= 16, "anchor-free: too few detections")
    log(f"  valid detections/tile {n_valid / 16:.2f}; levels {torch.bincount(o['levels'][o['valid']]).tolist()}")
    info["held"] = hold_path_calls(seen, "anchor-free")

    # the stem at N = 32 on the path's own input: kernel 1's new shape
    (a, k), = seen["stem_conv"]
    xs, w, scale, bias = a
    need(w.shape == (6, 6, 3, 32) and pallas_stem.stem_form(xs.shape, w.shape, 2, 2,
                                                            torch.bfloat16) == "tc",
         f"the yolov6s-af stem is not stem_tc at N 32: {tuple(w.shape)}")
    got = pallas_stem.stem_conv(*a, **k)
    err = check_close("stem_tc at N 32 (yolov6s-af, the path's input)", got,
                      pallas_stem.stem_conv_plain(*a, **k), atol=1e-3, rtol=2 ** -7)
    fns = {"stem_tc": lambda: pallas_stem.stem_conv(*a, **k),
           "cuDNN": stem_library(xs, w, scale, bias)}
    ms = cuda_ms_turns(fns, 20)
    b2b = cuda_ms_turns(fns, 20, reps=B2B)
    dev = device_ms(lambda: pallas_stem.stem_conv(*a, **k))
    plain_ms = cuda_ms(lambda: pallas_stem.stem_conv_plain(*a, **k), 5)
    b_ms, by = bound(nbytes(xs, got, scale, bias) + stem_lab.KDIM * 32 * 2,
                     2.0 * got.numel() * stem_lab.KDIM, BF16_FLOPS)
    info["stem_tc_n32"] = dict(max_abs_err=err, ms=ms["stem_tc"], ms_back_to_back=b2b["stem_tc"],
                               device_ms=dev, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                               library_ms=ms["cuDNN"], library_ms_back_to_back=b2b["cuDNN"])
    log(f"  stem_tc at (16, 640, 640, 3) N 32: {ms['stem_tc']:.4f} ms one call a window, "
        f"{b2b['stem_tc']:.4f} back to back, device {dev:.4f} | cuDNN {ms['cuDNN']:.4f} "
        f"({b2b['cuDNN']:.4f}) | plain {plain_ms:.4f} | bound {b_ms:.4f} ({by})")
    info["infer"] = timed_steps(lambda: det.tiles(x), iters)
    log(f"  batch-16 step: median {info['infer']['median_ms']:.2f} ms over {iters} (min "
        f"{info['infer']['min_ms']:.2f}, max {info['infer']['max_ms']:.2f}); tiles/s "
        f"{16e3 / info['infer']['median_ms']:.1f}")
    info["infer"].update(profile_step(lambda: det.tiles(x)))
    del det
    torch.cuda.empty_cache()

    # SimOTA training
    state, step = train_phase_state("yolov6s-af")
    xb, tb = af_batch(2)
    batch = to_device({"image": xb, "targets": tb}, "cuda")
    n_obj = int(tb["det"]["valid"].sum())

    def batch_loss():
        state.model.train()
        with torch.no_grad():
            losses_, _ = state.model.losses(batch["image"], batch["targets"], compute_masks=False)
            return float(state.model.total_loss(losses_))

    before = batch_loss()
    for _ in range(8):
        step(state, batch)
    after = batch_loss()
    log(f"  loss on the batch ({n_obj} objects) before 8 updates (the fresh model) {before:.4f}, "
        f"after {after:.4f}")
    need(after < before, "anchor-free: the loss did not fall over 8 updates")
    t_launches, info["train"] = train_timing(step, state, batch, iters)
    need(sum(t_launches.values()) == 0, f"anchor-free training launched a kernel: {t_launches}")
    info["train"].update(loss_before=before, loss_after=after, objects=n_obj)
    with capture_calls((anchor_free_head, "simota_assign")) as seen:
        step(state, batch)
    (a, k), = seen["simota_assign"]
    info["train"]["simota_device_ms"] = device_ms(lambda: anchor_free_head.simota_assign(*a, **k))
    info["train"]["simota_ms"] = cuda_ms(lambda: anchor_free_head.simota_assign(*a, **k), 10)
    log(f"  train micro-step (batch 16 x 640, bf16, SimOTA over {a[0].shape[1]} cells x "
        f"{a[5].shape[1]} targets): median {info['train']['median_ms']:.2f} ms over {iters} (min "
        f"{info['train']['min_ms']:.2f}, max {info['train']['max_ms']:.2f}); "
        f"{info['train']['img_per_s']:.1f} img/s; peak {info['train']['peak_gib']:.2f} GiB; the "
        f"assignment {info['train']['simota_ms']:.3f} ms a call, device "
        f"{info['train']['simota_device_ms']:.3f} ms; launches {t_launches}")
    del state, step, batch
    torch.cuda.empty_cache()
    info["reference"] = af_reference()
    return launches, t_launches, info


def af_reference() -> dict:
    """yolov6s-af in f32 at 2 x 256 px from the same seeded weights on the
    card and on the CPU: the SimOTA assignment on the same inputs (matched
    targets and foreground equal, IoU within 1e-5), the training loss items
    (rtol 1e-3) and the detections (>= 98% of the CPU's found again, same
    label, IoU >= 0.9, as phase 5 holds them)."""
    from hd_yolo_tpu_torch.models import anchor_free_head
    from hd_yolo_tpu_torch.models.yolo import Model

    cpu = Model.from_cfg("yolov6s-af", "hyp-nuclei", pre_nms_topk=256)
    cpu.reset_parameters(torch.Generator().manual_seed(4))
    gpu = Model.from_cfg("yolov6s-af", "hyp-nuclei", pre_nms_topk=256).cuda()
    gpu.load_state_dict(cpu.state_dict())
    xb, tb = af_batch(3, B=2, max_t=48, size=256)
    x = torch.from_numpy(xb)
    calibrate_af(gpu, x.cuda(), 0.02)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    res = {}
    with torch.no_grad():
        a = {k: v.cpu() for k, v in gpu(x.cuda())["det"].items()}
        b = cpu(x)["det"]
    matched, total, _ = match_detections(a, b)
    res["detections_cpu"], res["matched"] = total, matched
    need(total >= 10 and matched >= 0.98 * total,
         f"anchor-free reference: {matched} of the CPU's {total} detections found again")
    t_cpu = {k: torch.from_numpy(v) for k, v in tb["det"].items()}
    items = {}
    for name, m, dev in (("cuda", gpu, "cuda"), ("cpu", cpu, "cpu")):
        m.train()
        with capture_calls((anchor_free_head, "simota_assign")) as seen, torch.no_grad():
            losses, _ = m.losses(x.to(dev), {"det": {k: v.to(dev) for k, v in t_cpu.items()}},
                                 compute_masks=False)
        m.eval()
        items[name] = {k: float(v) for k, v in losses["det"]["loss_items"].items()}
        if name == "cuda":
            (sa, sk), = seen["simota_assign"]
    for k, v in items["cpu"].items():
        need(abs(items["cuda"][k] - v) <= 1e-3 * abs(v) + 1e-6,
             f"anchor-free reference loss {k}: card {items['cuda'][k]} vs CPU {v}")
    g = anchor_free_head.simota_assign(*sa, **sk)
    c = anchor_free_head.simota_assign(*[t.cpu() for t in sa], **sk)
    need(torch.equal(g[0].cpu(), c[0]) and torch.equal(g[1].cpu(), c[1]),
         "anchor-free reference: the card's SimOTA assignment differs from the CPU's")
    res["assign_iou_max_abs_err"] = float((g[2].cpu() - c[2]).abs().max())
    need(res["assign_iou_max_abs_err"] <= 1e-5, f"anchor-free reference IoU: {res}")
    res.update(foreground=int(c[1].sum()), losses=items)
    log(f"  reference (f32, 2 x 256): {matched} of the CPU's {total} detections found again; "
        f"SimOTA on the card equal to the CPU's ({res['foreground']} foreground cells); {res}")
    return res


def phase_ensemble(iters: int):
    """Phase 19: the flagship (yolov5l6-mask, Detector()'s defaults) and the
    multihead model merged on task detSC by ``hd_yolo_tpu_torch.Ensemble``,
    bf16, batch 16 x 640, seeded weights."""
    import hd_yolo_tpu_torch
    from hd_yolo_tpu_torch.models import ensemble

    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randint(0, 256, (16, 640, 640, 3), generator=gen, device="cuda", dtype=torch.uint8)
    flag = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0)
    mh = Detector("yolov5l6-multihead", "hyp-nuclei", device="cuda", seed=1)
    for d in (flag, mh):
        calibrate_objectness(d, x, 0.02)
    ens = hd_yolo_tpu_torch.Ensemble([flag.model, mh.model])
    ens(x)
    with capture_calls((pallas_nms, "nms_padded_pallas"), (ensemble, "merge_outputs")) as seen:
        launches, out = path_launches(lambda: ens(x))
    log(f"  launches of one ensemble batch (two members, two merged tasks): {launches}")
    for k, n in (("stem_tc", 2), ("nms", 1 + 2 + 2), ("roi_align", 3), ("mask_head", 3)):
        need(launches[k] == n, f"ensemble: {k} launched {launches[k]} times, expected {n}")
    o = out["detSC"]
    need(set(out) == {"det", "detSC"} and o["boxes"].shape == (16, 300, 4)
         and o["masks"].shape == (16, 300, 28, 28), "ensemble: unexpected outputs")
    need(int(o["valid"].sum()) >= 16 and int(o["mask_valid"].sum()) >= 16,
         "ensemble: too few merged detections or masks")
    merge_args = [(a, k) for a, k in seen["merge_outputs"] if len(a[0]) == 2]
    need(len(merge_args) == 1, "ensemble: detSC was not merged from both members")
    (ma, mk), = merge_args
    merge_nms = [c for c in seen["nms_padded_pallas"] if c[0][0].shape == (16, 600, 4)]
    need(len(merge_nms) == 1, "ensemble: no NMS call at the merge's (16, 600) shape")
    held = hold_path_calls({"nms_padded_pallas": merge_nms}, "ensemble merge")
    a = merge_nms[0][0]
    t = kernel_ms(lambda: pallas_nms.nms_padded_pallas(*a), 20)
    t["device_ms"] = device_ms(lambda: pallas_nms.nms_padded_pallas(*a))
    plain_ms = cuda_ms(lambda: nms_padded(*a), 3, warmup=1)
    merge_ms = cuda_ms(lambda: ensemble.merge_outputs(*ma, **mk), 20)
    step = timed_steps(lambda: ens(x), iters)
    log(f"  detSC merged: {int(o['valid'].sum()) / 16:.2f} detections/tile from "
        f"{sum(int(m['valid'].sum()) for m in ma[0]) / 16:.2f} in; merge {merge_ms:.4f} ms a "
        f"call; its NMS (16, 600) -> 300 with the sort and gathers {t['ms']:.4f} ms "
        f"({t['ms_back_to_back']:.4f} back to back, device {t['device_ms']:.4f}), plain "
        f"{plain_ms:.4f}; ensemble step median {step['median_ms']:.2f} ms (min "
        f"{step['min_ms']:.2f}, max {step['max_ms']:.2f})")
    del flag, mh, ens
    torch.cuda.empty_cache()
    return launches, {"held": held, "merge_ms": merge_ms, "nms_16x600": {**t, "plain_ms": plain_ms},
                      "step": step}


# ------------------------------------------- reference checkpoints, NuCLS, hub
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
# the card's name and power limit as nvidia-smi gives them, set by main and
# written beside the numbers of phases 20-22
CARD: dict = {}
# the flagship's seeded weights written by phase 20 (and by phase 21 when it
# runs alone): {"dir": TemporaryDirectory, "ultralytics": path, "metayolo": path}
FLAGSHIP_CKPTS: dict = {}


def match_fixture(o: dict, exp: dict, what: str) -> dict:
    """One image's outputs ``o`` (numpy) against a fixture's ``expected``,
    the reference torch model's own: the detection count within 10%, every
    expected box within 1 px of one of ``o``'s, those matched scores within
    rtol 1e-3 / atol 1e-4, their masks mean |d| <= 0.01 and max <= 0.1."""
    v = o["valid"][0].astype(bool)
    n_exp = len(exp["boxes"])
    need(abs(int(v.sum()) - n_exp) <= max(1, n_exp // 10),
         f"{what}: {int(v.sum())} detections, the reference {n_exp}")
    idx, box_d = [], 0.0
    for j in range(n_exp):
        d = np.abs(o["boxes"][0] - exp["boxes"][j]).max(-1)
        d[~v] = np.inf
        i = int(d.argmin())
        need(d[i] < 1.0, f"{what}: expected box {exp['boxes'][j]} is {d[i]:.3g} px from any")
        idx.append(i)
        box_d = max(box_d, float(d[i]))
    ds = np.abs(o["scores"][0][idx] - exp["scores"])
    need(bool((ds <= 1e-4 + 1e-3 * np.abs(exp["scores"])).all()), f"{what}: scores off by {ds.max()}")
    need(all(o["mask_valid"][0][i] for i in idx), f"{what}: a matched detection has no mask")
    dm = np.abs(o["masks"][0][idx] - exp["masks"][:, 0])
    need(dm.mean() <= 0.01 and dm.max() <= 0.1,
         f"{what}: masks mean |d| {dm.mean():.4g}, max {dm.max():.4g}")
    return {"detections": int(v.sum()), "expected": n_exp, "box_max_px": box_d,
            "score_max_abs_err": float(ds.max()), "mask_mean_abs_err": float(dm.mean()),
            "mask_max_abs_err": float(dm.max())}


def ultralytics_keys(sd: dict, spec) -> dict:
    """The port's keys → an ultralytics checkpoint's ``model.{i}.*`` (the
    neck after the backbone, the header at its row's index)."""
    out = {}
    for k, v in sd.items():
        part, rest = k.split(".", 1)
        head, tail = rest.split(".", 1)
        i = {"backbone": lambda: int(head), "neck": lambda: spec.n_backbone + int(head),
             "headers": lambda: spec.headers[0].index}[part]()
        out[f"model.{i}.{tail}"] = v
    return out


@torch.no_grad()
def flagship_checkpoints() -> dict:
    """The flagship at full width and depth with seeded weights (objectness
    calibrated on noise tiles as phase 4 does), written to a temporary
    directory as an ultralytics ``model.{i}`` state_dict (``yolo_u.pt``) and
    a metayolo ``{'ema': state_dict}`` checkpoint (``yolo_m.pt``)."""
    import tempfile

    if not FLAGSHIP_CKPTS:
        torch.cuda.synchronize()
        det = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=20)
        gen = torch.Generator(device="cuda").manual_seed(20)
        x = torch.randint(0, 256, (16, 640, 640, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
        calibrate_objectness(det, x, 0.02)
        sd = {k: v.detach().cpu().clone() for k, v in det.model.state_dict().items()}
        d = tempfile.TemporaryDirectory()
        u, m = os.path.join(d.name, "yolo_u.pt"), os.path.join(d.name, "yolo_m.pt")
        torch.save(ultralytics_keys(sd, det.model.spec), u)
        torch.save({"ema": sd, "model": None, "epoch": 299}, m)
        FLAGSHIP_CKPTS.update(dir=d, ultralytics=u, metayolo=m, state_dict=sd, x=x)
        del det
        torch.cuda.empty_cache()
    return FLAGSHIP_CKPTS


@torch.no_grad()
def phase_pretrained(iters: int):
    """Phase 20: reference checkpoints into the port.  The serialized
    fixtures (metayolo and ultralytics layouts of the reference torch model,
    with its own outputs) through ``utils/import_torch`` into ``tiny2l.yaml``
    on the card in f32 with masks, against the fixtures' ``expected``; then
    the flagship's seeded weights in both layouts, resolved by bare name
    through ``$HD_YOLO_WEIGHTS_DIR``: every tensor loaded, a bf16 16 x 640
    batch bit for bit the outputs of the same weights loaded directly."""
    from hd_yolo_tpu_torch.models.yolo import Model
    from hd_yolo_tpu_torch.utils import import_torch
    from hd_yolo_tpu_torch.utils.downloads import attempt_download

    info = {}
    cfg = os.path.join(FIXTURES, "tiny2l.yaml")
    launches = {}
    for name in ("metayolo_tiny", "ultralytics_tiny"):
        fix = torch.load(os.path.join(FIXTURES, f"{name}.pt"), map_location="cpu",
                         weights_only=False)
        m = Model.from_cfg(cfg, "hyp-nuclei")
        n, left = import_torch.import_state_dict(m, fix["state_dict"])
        need(n == len(m.state_dict()), f"{name}: {n} of {len(m.state_dict())} tensors loaded")
        m.cuda()
        x = fix["input_nhwc"].cuda()
        m(x)
        with capture_calls(*PATH_CALLS) as seen:
            launches[name], out = path_launches(lambda: m(x))
        for k, want in (("stem_tf32", 1), ("stem", 0), ("stem_tc", 0), ("nms", 1),
                        ("roi_align", 1), ("mask_head", 0), ("mask_head_f32", 1)):
            need(launches[name][k] == want,
                 f"{name}: {k} launched {launches[name][k]} times, expected {want}")
        o = {k: v.cpu().numpy() for k, v in out["det"].items()}
        info[name] = {"tensors": n, "left_over": len(left),
                      **match_fixture(o, {k: t.numpy() for k, t in fix["expected"].items()}, name),
                      "held": hold_path_calls(seen, name)}
        log(f"  {name}: {n} tensors loaded ({len(left)} reference keys left over: anchors, "
            f"mask_indices, loss buffers); launches {launches[name]}; against the reference's "
            f"outputs: {info[name]}")
    t0 = time.perf_counter()
    ck = flagship_checkpoints()
    info["flagship_seed_and_write_s"] = time.perf_counter() - t0
    x = ck["x"]
    direct = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0)
    direct.model.load_state_dict(ck["state_dict"])
    want = direct.tiles(x)["detSC"]
    need(int(want["valid"].sum()) >= 16 and int(want["mask_valid"].sum()) >= 16,
         "flagship: too few detections to compare")
    old = os.environ.get("HD_YOLO_WEIGHTS_DIR")
    os.environ["HD_YOLO_WEIGHTS_DIR"] = ck["dir"].name
    try:
        for layout, path in (("ultralytics", "yolo_u.pt"), ("metayolo", "yolo_m.pt")):
            det = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=1)
            t0 = time.perf_counter()
            resolved = str(attempt_download(path))
            n, left = import_torch.load_torch_weights(det.model, resolved)
            t_load = time.perf_counter() - t0
            need(resolved == ck[layout] and n == len(det.model.state_dict()) and not left,
                 f"flagship {layout}: {n} of {len(det.model.state_dict())} tensors from "
                 f"{resolved}, left over {left[:5]}")
            got = det.tiles(x)["detSC"]
            need(all(torch.equal(got[k], want[k]) for k in want),
                 f"flagship {layout}: outputs differ from the directly loaded weights'")
            info[f"flagship_{layout}"] = {"tensors": n, "load_s": t_load,
                                          "detections": int(got["valid"].sum()),
                                          "masks": int(got["mask_valid"].sum())}
            log(f"  flagship from the {layout} layout, by bare name {path!r} through "
                f"$HD_YOLO_WEIGHTS_DIR: {n} tensors, every one of the model, in {t_load:.2f} s; "
                f"bf16 16 x 640 outputs bit for bit the directly loaded weights' "
                f"({int(got['valid'].sum())} detections, {int(got['mask_valid'].sum())} masks)")
            del det
    finally:
        if old is None:
            os.environ.pop("HD_YOLO_WEIGHTS_DIR", None)
        else:
            os.environ["HD_YOLO_WEIGHTS_DIR"] = old
    del direct
    torch.cuda.empty_cache()
    info["card"] = CARD.get("smi")
    return launches, info


NUCLS_TRAIN_SLIDES = ["TCGA-A2-A0CM-DX1", "TCGA-AR-A1AQ-DX1", "TCGA-BH-A0BG-DX1",
                      "TCGA-E2-A1B6-DX1", "TCGA-OL-A5D6-DX1", "TCGA-S3-AA10-DX1"]
NUCLS_TEST_SLIDE = "TCGA-A7-A4SE-DX1"
NUCLS_GROUPS = ["tumor", "fibroblast", "lymphocyte", "plasma_cell", "macrophage",
                "mitotic_figure", "apoptotic_body", "vascular_endothelium", "unlabeled",
                "correction_tumor"]


def write_nucls_layout(root: str, size: int = 640, per_fov: int = 80, fovs: int = 8,
                       seed: int = 21) -> str:
    """A synthetic NuCLS ``trainval`` layout in the real schema under
    ``root``: ``rgb/<fov>.png`` (``size`` px, written with cv2), ``csv/<fov>.csv``
    (about ``per_fov`` nuclei a FOV: group, type, box, ``coords_x`` /
    ``coords_y`` polylines), ``train_test_splits/fold_1_{train,test}.csv``.
    ``fovs`` FOVs for each of six training slides, one test slide and one
    slide of ``EXCLUDE_SLIDE_IDS`` listed under training."""
    import cv2
    import pandas as pd

    from hd_yolo_tpu_torch.data.nucls import EXCLUDE_SLIDE_IDS

    rng = np.random.default_rng(seed)
    excluded = EXCLUDE_SLIDE_IDS[0]
    for d in ("rgb", "csv", "train_test_splits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    t = np.linspace(0, 2 * np.pi, 13)[:-1]
    for slide in NUCLS_TRAIN_SLIDES + [NUCLS_TEST_SLIDE, excluded]:
        for f in range(fovs):
            fov = f"{slide}_id-{rng.integers(1 << 48):012x}_left-{640 * f}_top-{1280 * f}"
            img = rng.integers(150, 230, (size, size, 3), dtype=np.uint8)
            k = int(rng.integers(per_fov - 10, per_fov + 11))
            rows = []
            for _ in range(k):
                c = rng.uniform(20, size - 20, 2)
                ax, ang = rng.uniform(5, 20, 2), rng.uniform(0, np.pi)
                px = ax[0] * np.cos(t) * np.cos(ang) - ax[1] * np.sin(t) * np.sin(ang) + c[0]
                py = ax[0] * np.cos(t) * np.sin(ang) + ax[1] * np.sin(t) * np.cos(ang) + c[1]
                pts = np.clip(np.stack([px, py], 1), 0, size - 1).astype(np.int32)
                g = NUCLS_GROUPS[int(rng.integers(len(NUCLS_GROUPS)))]
                cv2.fillPoly(img, [pts], tuple(int(v) for v in rng.integers(40, 120, 3)))
                rows.append({"raw_classification": g, "main_classification": g,
                             "super_classification": g, "group": g, "type": "polyline",
                             "xmin": int(pts[:, 0].min()), "ymin": int(pts[:, 1].min()),
                             "xmax": int(pts[:, 0].max()), "ymax": int(pts[:, 1].max()),
                             "coords_x": ",".join(map(str, pts[:, 0])),
                             "coords_y": ",".join(map(str, pts[:, 1]))})
            cv2.imwrite(os.path.join(root, "rgb", f"{fov}.png"), img)
            pd.DataFrame(rows).to_csv(os.path.join(root, "csv", f"{fov}.csv"))
    for split, slides in (("train", NUCLS_TRAIN_SLIDES + [excluded]), ("test", [NUCLS_TEST_SLIDE])):
        pd.DataFrame({"slide_name": slides}).to_csv(
            os.path.join(root, "train_test_splits", f"fold_1_{split}.csv"))
    return root


class LaunchLedger:
    """Training callbacks that read the kernels' launch counts of each
    epoch's micro-steps (reset at ``on_train_epoch_start``, read at
    ``on_train_epoch_end``) and of its validation (read at
    ``on_fit_epoch_end``), beside ``EpochClock``'s timing."""

    def __init__(self, clock: "EpochClock"):
        self.steps, self.val = [], []
        cb = clock.callbacks
        cb.register_action("on_train_epoch_start", "launches", kernels.reset_launches)
        cb.register_action("on_train_epoch_end", "launches", self.end_steps)
        cb.register_action("on_fit_epoch_end", "launches", self.end_val)
        self.clock = clock

    def end_steps(self, epoch):
        self.steps.append((self.clock.steps, dict(kernels.LAUNCHES)))
        kernels.reset_launches()

    def end_val(self, *a):
        self.val.append(dict(kernels.LAUNCHES))


class GradWatch:
    """``with GradWatch() as bad:`` each optimizer micro-step also reads its
    gradient (a host sync a step).  A gradient holding inf or NaN appends
    to ``bad`` the micro-step, its loss items, the parameters whose gradient
    is non-finite (model order, with how many elements), the five largest
    finite max|g| of the rest, the batch's target count and smallest box
    side, and ``zero_side_candidates``: the det loss's candidates whose
    decoded predicted height is 0 or at most 1e-18 of their width in f32
    (an h logit below about -22 with the w logit near 0).  CIoU's
    ``arctan(w1 / h1)`` (``ops/boxes.bbox_iou``, as JAX's) has a NaN
    gradient once (w1 / h1)² overflows (an h logit below about -23):
    arctan's derivative 0 times the quotient's -(w1 / h1) / h1 = -inf,
    padded slots included, whatever the weights of the mean."""

    def __enter__(self):
        from hd_yolo_tpu_torch.engines import optim
        from hd_yolo_tpu_torch.models import losses as losses_mod
        from hd_yolo_tpu_torch.models import yolo

        self.bad, self.steps, self.last = [], 0, {}
        self.orig = (optim.Optimizer.update, yolo.Model.losses, losses_mod.bbox_iou)
        upd, losses, iou = self.orig

        def watched_losses(model, x, targets, *a, **k):
            self.last = {"zero_side": []}
            out = losses(model, x, targets, *a, **k)
            self.last.update(targets=targets, losses=out[0])
            return out

        def watched_iou(box1, box2, *a, **k):
            if box1.requires_grad:
                self.last.setdefault("zero_side", []).append(
                    (box1[..., 3] <= box1[..., 2] * 1e-18).sum())
            return iou(box1, box2, *a, **k)

        def watched_update(opt, grads):
            finite = upd(opt, grads)
            self.steps += 1
            if not bool(finite):
                self.bad.append(self.describe(opt, grads))
            return finite

        optim.Optimizer.update, yolo.Model.losses = watched_update, watched_losses
        losses_mod.bbox_iou = watched_iou
        return self.bad

    @torch.no_grad()
    def describe(self, opt, grads) -> dict:
        rows, big = [], []
        for n, g in zip(opt.names, grads):
            if g is None:
                continue
            k = int((~torch.isfinite(g)).sum())
            if k:
                rows.append((n, k))
            else:
                big.append((float(g.float().abs().max()), n))
        items = {}
        for task, lt in self.last.get("losses", {}).items():
            if isinstance(lt, dict) and "loss_items" in lt:
                items[task] = {k: float(v) for k, v in lt["loss_items"].items()}
        t = {}
        for task, tt in self.last.get("targets", {}).items():
            v = tt["valid"].bool()
            b = tt["boxes"][v].float()
            t[task] = {"targets": int(v.sum()),
                       "min_side": float((b[:, 2:] - b[:, :2]).min()) if len(b) else None}
        return {"micro_step": self.steps, "loss_items": items, "nonfinite": rows[:20],
                "n_nonfinite_params": len(rows), "largest_finite": sorted(big)[-5:],
                "batch": t, "zero_side_candidates": int(sum(self.last.get("zero_side", [])))}

    def __exit__(self, *exc):
        from hd_yolo_tpu_torch.engines import optim
        from hd_yolo_tpu_torch.models import losses as losses_mod
        from hd_yolo_tpu_torch.models import yolo

        optim.Optimizer.update, yolo.Model.losses, losses_mod.bbox_iou = self.orig
        return False


# 3 micro-steps an epoch (48 training FOVs at batch 16), an update each.
# CIoU's NaN gradient (ROADMAP C.2) skipped 8 of 54 micro-steps over nine
# 2-epoch runs from these seeded weights, and 2 of 6 in one: 3 epochs keep
# ">= 4 updates" from failing on that known skip.
NUCLS_EPOCHS = 3


def phase_nucls_finetune(iters: int):
    """Phase 21: a synthetic NuCLS layout converted by ``python -m
    hd_yolo_tpu_torch.data.nucls``, then ``engines/train.main`` fine-tunes
    the flagship from phase 20's ultralytics ``.pt`` on it (bf16, masks,
    batch 16 x 640, ``NUCLS_EPOCHS`` epochs)."""
    import tempfile

    from hd_yolo_tpu_torch.engines import train as train_mod

    info = {}
    ck = flagship_checkpoints()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        layout = write_nucls_layout(os.path.join(d, "trainval"))
        info["layout_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "hd_yolo_tpu_torch.data.nucls", "--data_dir",
                            layout, "--output_dir", os.path.join(d, "native")],
                           capture_output=True, text=True, timeout=300,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        info["convert_s"] = time.perf_counter() - t0
        need(r.returncode == 0, f"the NuCLS converter failed: {r.stderr[-2000:]}")
        paths = json.loads(r.stdout.strip().splitlines()[-1])["native"]
        n_split = {s: sum(1 for _ in open(paths[s])) - 1 for s in ("train", "val")}
        need(n_split["train"] >= 48 and n_split["val"] >= 1,
             f"NuCLS splits: {n_split} (the excluded slide's FOVs must be gone)")
        log(f"  NuCLS layout of {8 * 8} FOVs written in {info['layout_s']:.1f} s, converted in "
            f"{info['convert_s']:.1f} s: {n_split['train']} training and {n_split['val']} "
            f"validation FOVs (the excluded slide's 8 dropped)")
        info["splits"] = n_split

        loaded = []
        orig = train_mod.load_pretrained

        def spy(model, name):
            n = orig(model, name)
            loaded.append((n, len(model.state_dict())))
            return n

        clock = EpochClock(16)
        ledger = LaunchLedger(clock)
        save_dir = os.path.join(d, "run")
        argv = lambda epochs, out: train_mod.argument_parser().parse_args([
            "--cfg", "yolov5l6-mask", "--hyp", "hyp-nuclei", "--data", paths["data"],
            "--weights", ck["ultralytics"], "--masks", "--batch-size", "16",
            "--nominal-batch-size", "16", "--img-size", "640", "--epochs", str(epochs),
            "--save-dir", out, "--workers", "8"])
        train_mod.load_pretrained = spy
        try:
            with GradWatch() as bad:
                t0 = time.perf_counter()
                train_mod.train(argv(NUCLS_EPOCHS, save_dir), clock.callbacks)
                info["train_s"] = time.perf_counter() - t0
            # the first epoch again, each roi_align_bwd call held against its
            # plain version on the same inputs (untimed: the plain backward
            # costs seconds a call)
            with shadow_backwards() as held, GradWatch() as bad_shadowed:
                train_mod.train(argv(1, save_dir + "_shadowed"), EpochClock(16).callbacks)
        finally:
            train_mod.load_pretrained = orig
        info["backwards_held"] = held
        log(f"  the first epoch again, every roi_align_bwd call held against its plain version: "
            f"{held}")
        # a skipped micro-step passes only where CIoU's zero-side NaN (the
        # JAX package's, ROADMAP C.2) explains it
        for what, b in (("the fine-tune", bad), ("its shadowed first epoch", bad_shadowed)):
            need(all(x["zero_side_candidates"] > 0 for x in b),
                 f"{what}: a non-finite gradient without a zero-side CIoU candidate: "
                 f"{json.dumps(b, default=str)}")
        info["skipped"] = [{k: x[k] for k in ("micro_step", "zero_side_candidates",
                                              "n_nonfinite_params")} for x in bad]
        info["skipped_shadowed"] = len(bad_shadowed)
        if bad or bad_shadowed:
            log(f"  skipped micro-steps, each with a zero-side CIoU candidate: {info['skipped']} "
                f"(the fine-tune), {len(bad_shadowed)} (the shadowed epoch); the first: "
                f"{json.dumps((bad or bad_shadowed)[0], default=str)}")
        need(len(loaded) == 2 and all(n == total for n, total in loaded),
             f"--weights loaded {loaded} (tensors, of the model's)")
        for name in ("last.pt", "final.pt", "best.pt"):
            need(os.path.isfile(os.path.join(save_dir, name)), f"train did not write {name}")
        rows = [json.loads(l) for l in open(os.path.join(save_dir, "results.json"))]
        need([r["epoch"] for r in rows] == list(range(NUCLS_EPOCHS))
             and all("detSC/map50" in r for r in rows),
             f"EMA validation did not run each epoch: {rows}")
        need(all(np.isfinite(r["loss"]) for r in rows), f"non-finite loss: {rows}")
        saved = torch.load(os.path.join(save_dir, "last.pt"), map_location="cpu",
                           weights_only=False)
        steps, updates = int(saved["step"]), int(saved["opt"]["count"])
        need(updates >= 4 and updates == steps - len(bad),
             f"{updates} optimizer updates in {steps} micro-steps with {len(bad)} skipped, "
             f"need >= 4 and every other one")
        n0, micro = ledger.steps[0]
        per = {k: v / max(n0, 1) for k, v in micro.items() if v}
        need(per.get("roi_align") == 1 and per.get("roi_align_bwd") == 1
             and micro["stem_tc"] == 0 and micro["nms"] == 0 and micro["mask_head"] == 0,
             f"a micro-step's launches: {per} ({micro} over {n0} steps)")
        val_l = ledger.val[0]
        need(val_l["stem_tc"] >= 1 and val_l["nms"] >= 1 and val_l["mask_head"] >= 1,
             f"validation's launches: {val_l}")
        info.update(tensors_loaded=loaded[0][0], steps=steps, updates=updates,
                    skipped_nonfinite=steps - updates,
                    loss_by_epoch=[r["loss"] for r in rows],
                    fitness_by_epoch=[r["fitness"] for r in rows],
                    img_per_s_by_epoch=clock.img_per_s, micro_step_launches=per,
                    val_launches=val_l)
        log(f"  train.main --weights <the ultralytics .pt>: {loaded[0][0]} tensors loaded, every "
            f"one of the model's; {steps} micro-steps, {updates} updates (apply-if-finite "
            f"skipped {steps - updates}) in {info['train_s']:.1f} s; loss by epoch "
            f"{[round(v, 4) for v in info['loss_by_epoch']]}, EMA fitness "
            f"{[round(v, 4) for v in info['fitness_by_epoch']]}; img/s of each epoch's steps "
            f"{[round(v, 2) for v in clock.img_per_s]}; launches a micro-step {per}, in one "
            f"epoch's validation {val_l}")
    info["card"] = CARD.get("smi")
    return {"micro_step": {k: v // max(n0, 1) for k, v in micro.items()}, "val": val_l}, info


# ultralytics/yolov5 models/hub/yolov5s-ghost.yaml (v6.0), v3.1's
# models/yolov5s.yaml and models/hub/yolov5x6.yaml (v6.0), row for row
HUB_PRESETS = {
    "yolov5s-ghost": {
        "nc": 80, "depth_multiple": 0.33, "width_multiple": 0.50,
        "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                    [116, 90, 156, 198, 373, 326]],
        "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "GhostConv", [128, 3, 2]],
                     [-1, 3, "C3Ghost", [128]], [-1, 1, "GhostConv", [256, 3, 2]],
                     [-1, 6, "C3Ghost", [256]], [-1, 1, "GhostConv", [512, 3, 2]],
                     [-1, 9, "C3Ghost", [512]], [-1, 1, "GhostConv", [1024, 3, 2]],
                     [-1, 3, "C3Ghost", [1024]], [-1, 1, "SPPF", [1024, 5]]],
        "head": [[-1, 1, "GhostConv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 6], 1, "Concat", [1]], [-1, 3, "C3Ghost", [512, False]],
                 [-1, 1, "GhostConv", [256, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 4], 1, "Concat", [1]], [-1, 3, "C3Ghost", [256, False]],
                 [-1, 1, "GhostConv", [256, 3, 2]], [[-1, 14], 1, "Concat", [1]],
                 [-1, 3, "C3Ghost", [512, False]], [-1, 1, "GhostConv", [512, 3, 2]],
                 [[-1, 10], 1, "Concat", [1]], [-1, 3, "C3Ghost", [1024, False]],
                 [[17, 20, 23], 1, "Detect", ["nc", "anchors"]]]},
    "yolov5s-v3.1": {
        "nc": 80, "depth_multiple": 0.33, "width_multiple": 0.50,
        "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                    [116, 90, 156, 198, 373, 326]],
        "backbone": [[-1, 1, "Focus", [64, 3]], [-1, 1, "Conv", [128, 3, 2]],
                     [-1, 3, "BottleneckCSP", [128]], [-1, 1, "Conv", [256, 3, 2]],
                     [-1, 9, "BottleneckCSP", [256]], [-1, 1, "Conv", [512, 3, 2]],
                     [-1, 9, "BottleneckCSP", [512]], [-1, 1, "Conv", [1024, 3, 2]],
                     [-1, 1, "SPP", [1024, [5, 9, 13]]], [-1, 3, "BottleneckCSP", [1024, False]]],
        "head": [[-1, 1, "Conv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 6], 1, "Concat", [1]], [-1, 3, "BottleneckCSP", [512, False]],
                 [-1, 1, "Conv", [256, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 4], 1, "Concat", [1]], [-1, 3, "BottleneckCSP", [256, False]],
                 [-1, 1, "Conv", [256, 3, 2]], [[-1, 14], 1, "Concat", [1]],
                 [-1, 3, "BottleneckCSP", [512, False]], [-1, 1, "Conv", [512, 3, 2]],
                 [[-1, 10], 1, "Concat", [1]], [-1, 3, "BottleneckCSP", [1024, False]],
                 [[17, 20, 23], 1, "Detect", ["nc", "anchors"]]]},
    # the rows of configs/yolov5l6-mask.yaml (backbone and fpn, 0-32: the
    # published yolov5l6 layout) with one Detect header and the x6 multiples
    "yolov5x6": {
        "nc": 80, "depth_multiple": 1.33, "width_multiple": 1.25,
        "anchors": [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
                    [140, 301, 303, 264, 238, 542], [436, 615, 739, 380, 925, 792]],
        "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]],
                     [-1, 3, "C3", [128]], [-1, 1, "Conv", [256, 3, 2]], [-1, 6, "C3", [256]],
                     [-1, 1, "Conv", [512, 3, 2]], [-1, 9, "C3", [512]],
                     [-1, 1, "Conv", [768, 3, 2]], [-1, 3, "C3", [768]],
                     [-1, 1, "Conv", [1024, 3, 2]], [-1, 3, "C3", [1024]],
                     [-1, 1, "SPPF", [1024, 5]]],
        "head": [[-1, 1, "Conv", [768, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 8], 1, "Concat", [1]], [-1, 3, "C3", [768, False]],
                 [-1, 1, "Conv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 6], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
                 [-1, 1, "Conv", [256, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 4], 1, "Concat", [1]], [-1, 3, "C3", [256, False]],
                 [-1, 1, "Conv", [256, 3, 2]], [[-1, 20], 1, "Concat", [1]],
                 [-1, 3, "C3", [512, False]], [-1, 1, "Conv", [512, 3, 2]],
                 [[-1, 16], 1, "Concat", [1]], [-1, 3, "C3", [768, False]],
                 [-1, 1, "Conv", [768, 3, 2]], [[-1, 12], 1, "Concat", [1]],
                 [-1, 3, "C3", [1024, False]],
                 [[23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]]]},
}
# the stem kernels one bf16 16 x 640 batch of each preset launches:
# yolov5s-ghost's Conv(3, 32, 6, 2, 2) the bf16 ring form, v3.1's Focus none,
# yolov5x6's Conv(3, 80, 6, 2, 2) the direct kernel (N 80 is not a multiple of
# 16 that stem_tc takes)
HUB_STEM = {"yolov5s-ghost": {"stem_tc": 1, "stem": 0, "stem_tf32": 0},
            "yolov5s-v3.1": {"stem_tc": 0, "stem": 0, "stem_tf32": 0},
            "yolov5x6": {"stem_tc": 0, "stem": 1, "stem_tf32": 0}}
# the presets phase 22 trains (training never reaches a stem kernel)
HUB_TRAIN = ("yolov5s-ghost", "yolov5s-v3.1")
# the share of anchors whose objectness the calibration lifts over the
# threshold: 1%, but 10% for yolov5x6, whose seeded P3-P6 boxes cluster so
# that NMS keeps ~2 a tile of its 1% (255 candidates an image at 640 px)
HUB_OBJ = {"yolov5x6": 0.1}
# yolov5x6 in f32 at its published input size: one batch of 4 tiles of 1280 px
X6_F32 = (4, 1280)


def hub_train_reference(cfg, B: int = 2, size: int = 256, updates: int = 8) -> dict:
    """``updates`` training updates of ``cfg`` in f32 from one fresh model
    (flax-default init, seed 0) on the card and on the CPU, the same batch:
    the loss of each micro-step within rtol 2e-3 of the CPU's (the CPU's
    threaded reductions alone move the loss between two runs there)."""
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train import scale_task_hyp
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.models.builder import parse_model_cfg
    from hd_yolo_tpu_torch.models.yolo import Model

    hyp = scale_task_hyp(load_cfg("hyp-nuclei"), parse_model_cfg(cfg, "hyp-nuclei"), size)
    xb, tb = af_batch(5, B=B, max_t=32, size=size)
    losses = {}
    for dev in ("cuda", "cpu"):
        m = Model.from_cfg(cfg, hyp)
        m.init_weights(torch.Generator().manual_seed(0))
        m.to(dev)
        state = TrainState.create(m, build_optimizer(m, hyp, 2, 4))
        step = make_train_step(mask_weight=0.0)
        batch = to_device({"image": xb, "targets": tb}, dev)
        with torch.enable_grad():
            losses[dev] = [float(step(state, batch)[1]["loss"]) for _ in range(updates)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    need(rel <= 2e-3, f"f32 training card vs CPU: {losses}")
    log(f"  f32 training, {B} x {size}, {updates} updates from the fresh model: the card's losses "
        f"{[round(v, 5) for v in losses['cuda']]} within {rel:.2e} (relative) of the CPU's")
    return {"losses_card": losses["cuda"], "losses_cpu": losses["cpu"], "max_rel_err": rel}


@torch.no_grad()
def hold_stem_calls(seen: dict, what: str) -> list:
    """Each direct stem call a path made (``stem_op``'s arguments), on its
    own inputs, against the plain version: bf16 within one bf16 ulp (atol
    1e-2, rtol 2^-7), f32 within 1e-5 (TF32 off)."""
    shapes = []
    for (a, k) in seen.get("stem_op", []):
        x, w, scale, bias, stride, padding, out_bf16 = a
        od = torch.bfloat16 if out_bf16 else torch.float32
        want = pallas_stem.stem_conv_plain(x, w, scale, bias, stride=stride, padding=padding,
                                           out_dtype=od)
        tol = dict(atol=1e-2, rtol=2 ** -7) if out_bf16 else dict(atol=1e-5, rtol=0.0)
        check_close(f"{what}: stem at {tuple(x.shape)} -> N {w.shape[-1]}",
                    pallas_stem.stem_op(*a), want, **tol)
        shapes.append((tuple(x.shape), int(w.shape[-1]), str(od)))
    return shapes


def hub_path(name: str, det: Detector, x, iters: int, what: str) -> tuple:
    """One batch of a hub preset through ``Detector.tiles``: its launches
    (every count reset just before), the stem kernels it must launch
    (``HUB_STEM``), one NMS, no mask kernel; the NMS and direct stem calls
    held against their plain versions on the path's own inputs; the step's
    median and a profiled step."""
    calibrate_objectness(det, x, HUB_OBJ.get(name, 0.01))
    det.tiles(x)
    with capture_calls((pallas_nms, "nms_padded_pallas"), (pallas_stem, "stem_op")) as seen:
        launches, out = path_launches(lambda: det.tiles(x))
    for k, n in (*HUB_STEM[name].items(), ("nms", 1), ("roi_align", 0), ("mask_head", 0)):
        need(launches[k] == n, f"{what}: {k} launched {launches[k]} times, expected {n}")
    o = out["det"]
    need(bool(torch.isfinite(o["boxes"]).all()) and int(o["valid"].sum()) >= x.shape[0],
         f"{what}: non-finite boxes or too few detections")
    r = {"detections_per_tile": int(o["valid"].sum()) / x.shape[0],
         "held": hold_path_calls(seen, what), "stem_calls": hold_stem_calls(seen, what),
         "step": timed_steps(lambda: det.tiles(x), iters)}
    log(f"  {what}: launches {launches}; {r['detections_per_tile']:.2f} detections a tile; "
        f"direct stem calls {r['stem_calls']}; step median {r['step']['median_ms']:.2f} ms over "
        f"{iters} (min {r['step']['min_ms']:.2f}, max {r['step']['max_ms']:.2f}), "
        f"{x.shape[0] * 1e3 / r['step']['median_ms']:.1f} tiles/s")
    r["step"].update(profile_step(lambda: det.tiles(x)))
    return launches, r


def phase_hub(iters: int):
    """Phase 22: three hub presets at their published widths, parsed by
    ``normalize_legacy_cfg`` (tag ``det``, no mask branch), seeded weights
    with the objectness calibrated: one bf16 16 x 640 batch's launches (the
    stem kernels of ``HUB_STEM``) and its NMS and direct stem calls held
    against their plain versions (``hub_path``); yolov5x6 also in f32 at its
    published 4 x 1280 (the direct kernel at N 80 and W 1280); card vs CPU
    in f32 on 2 x 640; for the two small presets, 8 updates from the fresh
    model, masks off, and the f32 training card vs CPU
    (``hub_train_reference``)."""
    from hd_yolo_tpu_torch.engines.train_step import make_train_step, to_device
    from hd_yolo_tpu_torch.models.builder import normalize_legacy_cfg
    from hd_yolo_tpu_torch.models.layers import ConvBnAct

    launches, info = {}, {}
    for p, (name, cfg) in enumerate(HUB_PRESETS.items()):
        spec_cfg = normalize_legacy_cfg(cfg)
        need(len(spec_cfg["headers"]) == 1 and spec_cfg["headers"][0][4] == "det",
             f"{name}: legacy layout not normalised")
        r = info[name] = {}
        gen = torch.Generator(device="cuda").manual_seed(22 + p)
        x = torch.randint(0, 256, (16, 640, 640, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
        det = Detector(cfg, "hyp-nuclei", input_size=640, device="cuda", seed=p)
        r["params"] = sum(q.numel() for q in det.model.parameters())
        stem = next(m for m in det.model.modules() if isinstance(m, ConvBnAct))
        r["stem"] = [stem.conv.in_channels, stem.conv.out_channels, stem.conv.kernel_size[0],
                     stem.conv.stride[0], stem.conv.padding[0]]
        log(f"  {name}: {r['params']:,} parameters, first conv (C, N, k, s, p) {r['stem']}")
        launches[name], r["bf16_16x640"] = hub_path(name, det, x, iters, f"{name} bf16 16 x 640")
        del det
        torch.cuda.empty_cache()
        if name == "yolov5x6":
            need(r["stem"] == [3, 80, 6, 2, 2], f"yolov5x6's stem is {r['stem']}")
            B2, S2 = X6_F32
            x2 = torch.randint(0, 256, (B2, S2, S2, 3), generator=gen, device="cuda",
                               dtype=torch.uint8)
            det = Detector(cfg, "hyp-nuclei", input_size=S2, device="cuda",
                           dtype=torch.float32, seed=p)
            launches[f"{name}-f32"], r[f"f32_{B2}x{S2}"] = hub_path(
                name, det, x2, iters, f"{name} f32 {B2} x {S2}")
            del det, x2
            torch.cuda.empty_cache()

        # the card against the CPU in f32
        xs = np.random.default_rng(22 + p).integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
        gpu = Detector(cfg, "hyp-nuclei", device="cuda", dtype=torch.float32, seed=p)
        calibrate_objectness(gpu, xs, HUB_OBJ.get(name, 0.01))
        cpu = Detector(cfg, "hyp-nuclei", device="cpu", dtype=torch.float32, seed=p)
        cpu.model.load_state_dict(gpu.model.state_dict())
        kernels.reset_launches()
        a = {k: t.cpu() for k, t in gpu.tiles(xs)["det"].items()}
        ref_launches = {k: kernels.LAUNCHES[k] for k in ("stem", "stem_tc", "stem_tf32", "nms")}
        t0 = time.perf_counter()
        b = cpu.tiles(xs)["det"]
        cpu_s = time.perf_counter() - t0
        matched, total, _ = match_detections(a, b)
        need(total >= 10 and matched >= 0.98 * total,
             f"{name}: {matched} of the CPU's {total} detections found again on the card")
        r["reference"] = {"detections_cpu": total, "matched": matched, "launches": ref_launches,
                          "cpu_forward_s": cpu_s}
        log(f"  {name} f32 2 x 640: {matched} of the CPU's {total} detections found again "
            f"(the card's launches {ref_launches}; the CPU forward {cpu_s:.1f} s)")
        del gpu, cpu
        if name == "yolov5x6":
            need(ref_launches["stem"] == 1 and ref_launches["stem_tc"] == 0
                 and ref_launches["stem_tf32"] == 0,
                 f"yolov5x6 f32 2 x 640: stem launches {ref_launches}, expected the direct one")
        if name not in HUB_TRAIN:
            continue

        # training from the fresh model, masks off
        state, _ = train_phase_state(cfg)
        step = make_train_step(mask_weight=0.0)
        xb, tb = af_batch(22 + p, B=16, max_t=64)
        batch = to_device({"image": xb, "targets": tb}, "cuda")

        def batch_items():
            state.model.train()
            with torch.no_grad():
                losses_, _ = state.model.losses(batch["image"], batch["targets"],
                                                compute_masks=False)
            items = {k: float(v) for k, v in losses_["det"]["loss_items"].items()}
            return float(state.model.total_loss(losses_, 0.0)), items

        before, items0 = batch_items()
        with torch.enable_grad():
            for _ in range(8):
                step(state, batch)
        after, items1 = batch_items()
        need(all(np.isfinite(v) for v in (before, after, *items1.values())),
             f"{name}: non-finite loss after 8 updates: {after} {items1}")
        need(items1["box"] < items0["box"] and items1["cls"] < items0["cls"],
             f"{name}: box or cls loss did not fall over 8 updates: {items0} -> {items1}")
        r["train"] = {"loss_before": before, "loss_after": after, "items_before": items0,
                      "items_after": items1, "reference": hub_train_reference(cfg)}
        log(f"  {name} training, masks off, bf16 16 x 640: loss on the batch before 8 updates "
            f"(the fresh model) {before:.4f}, after {after:.4f}; items {items0} -> {items1}")
        del state, step, batch
        torch.cuda.empty_cache()
    info["card"] = CARD.get("smi")
    return launches, info


# ------------------------------------------------- hnet's remaining parts
# launches of one bf16 forward of hnet-darknet: the stem of the darknet trunk
# (the bf16 tensor-core form at N 32); the tile ROI's three levels once for
# the Mask R-CNN header and once for FCOS; the canvas ROI-align at the box
# head's, the mask head's and the keypoint head's ROIs; the RPN and
# class-aware NMS and FCOS's class-aware NMS; one mask head
HNET_DARKNET_LAUNCHES = {"stem": 0, "stem_tc": 1, "nms": 3, "roi_align": 3, "mask_head": 1,
                         "roi_align_single": 2, "mask_head_f32": 0, "roi_align_bwd": 0,
                         "roi_align_single_bwd": 0, "stem_k108": 0, "stem_dot108": 0}
# launches of one hnet-darknet training micro-step (BatchNorm on the batch's
# statistics: no stem kernel): the ROI pyramids of both passes of both
# detection headers and the constrain's pooling (5), the backward of each
# whose output reaches a loss (FCOS's pass 1 feeds none: 4); the canvas
# ROI-align at the box, mask and keypoint ROIs of both passes (6), each
# backward but pass 1's keypoints' (5); the Mask R-CNN header's RPN NMS in
# both passes and its class-aware NMS and FCOS's in pass 1 (4); the cuDNN
# mask-head chain
HNET_DARKNET_TRAIN_LAUNCHES = {"stem": 0, "stem_tc": 0, "nms": 4, "roi_align": 6,
                               "roi_align_bwd": 5, "mask_head": 0, "roi_align_single": 5,
                               "roi_align_single_bwd": 4, "stem_k108": 0, "stem_dot108": 0,
                               "mask_head_f32": 0}
# the swin fixture's model (``tests/test_import_swin.py``'s synthetic layout)
SWIN_FIXTURE_KW = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 4), window_size=4,
                       out_indices=(0, 1))


def hnet_darknet_cfg() -> dict:
    """hnet-nucls with the darknet backbone at its defaults (width 0.5,
    depth 0.33), 17 keypoints on ``det40x`` (torchvision's KeypointRCNN
    default) and an FCOS header ``fcos40x`` at its defaults; ``seg10x``,
    ``cl5x`` and the mask-weighted constrain as shipped."""
    cfg = load_cfg("hnet-nucls")
    cfg["backbone"] = {"type": "darknet"}
    cfg["headers"]["det40x"]["num_keypoints"] = 17
    cfg["headers"]["fcos40x"] = {"type": "fcos", "num_classes": 4, "amplification": 1.0,
                                 "roi_size": 640}
    return cfg


def keypoint_targets(boxes: np.ndarray, valid: np.ndarray, nk: int = 17) -> np.ndarray:
    """(B, T, nk, 3) normalised keypoints of each box's inscribed ellipse:
    its centre and nk - 1 points on its boundary, every fourth hidden."""
    c = (boxes[..., :2] + boxes[..., 2:]) / 2
    r = (boxes[..., 2:] - boxes[..., :2]) / 2
    ang = np.linspace(0, 2 * np.pi, nk - 1, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], -1)                        # (nk - 1, 2)
    xy = np.concatenate([c[:, :, None], c[:, :, None] + 0.9 * r[:, :, None] * ring], 2)
    vis = np.ones(boxes.shape[:2] + (nk,), np.float32)
    vis[..., 3::4] = 0.0
    return np.concatenate([xy, (vis * valid[..., None])[..., None]], -1).astype(np.float32)


def hnet_darknet_batch(seed: int):
    """``hnet_batch``'s 4 x 640 tiles with the seg map at the darknet
    pyramid's stride 32, keypoints on ``det40x``'s nuclei and the same
    nuclei as ``fcos40x``'s targets; on the card, with the object count."""
    from hd_yolo_tpu_torch.engines.train_step import to_device

    x, t = hnet_batch(seed, seg_stride=32)
    d = t["det40x"]
    d["keypoints"] = keypoint_targets(d["boxes"], d["valid"])
    t["fcos40x"] = {k: d[k] for k in ("boxes", "labels", "valid")}
    return to_device({"image": x, "targets": t}, "cuda"), int(d["valid"].sum())


def time_call(name: str, fn, plain, b_ms: float, by: str, iters: int) -> dict:
    """A kernel call's two readings, device time, its plain version's time
    and the bound, logged."""
    t = kernel_ms(fn, iters)
    t.update(device_ms=device_ms(fn), plain_ms=cuda_ms(plain, 5), bound_ms=b_ms, bound_by=by)
    log(f"    {name}: kernel {t['ms']:.4f} ms, {t['ms_back_to_back']:.4f} back to back, device "
        f"{t['device_ms']:.4f} | plain {t['plain_ms']:.4f} | bound {b_ms:.4f} ({by})")
    return t


@torch.no_grad()
def hold_hnet_darknet_calls(seen: dict, iters: int) -> dict:
    """Every kernel call of one hnet-darknet forward on its own inputs
    against the plain version: NMS, both ROI-aligns bit for bit, the mask
    head as phase 5 holds masks (``hold_path_calls``), the stem within one
    bf16 ulp; each call's times beside its plain version's and its bound."""
    res = hold_path_calls(seen, "hnet-darknet")
    times = {}
    (a, k), = seen["stem_conv"]
    xs, w, scale, bias = a
    need(w.shape == (6, 6, 3, 32) and pallas_stem.stem_form(xs.shape, w.shape, 2, 2,
                                                            torch.bfloat16) == "tc",
         f"the darknet stem is not stem_tc at N 32: {tuple(w.shape)}")
    got = pallas_stem.stem_conv(*a, **k)
    res["stem_tc_max_abs_err"] = check_close(
        "hnet-darknet: stem_tc at N 32 on the path's input", got,
        pallas_stem.stem_conv_plain(*a, **k), atol=1e-3, rtol=2 ** -7)
    times["stem_tc"] = time_call(
        f"stem_tc {tuple(xs.shape)} N 32", lambda: pallas_stem.stem_conv(*a, **k),
        lambda: pallas_stem.stem_conv_plain(*a, **k),
        *bound(nbytes(xs, got, scale, bias) + stem_lab.KDIM * 32 * 2,
               2.0 * got.numel() * stem_lab.KDIM, BF16_FLOPS), iters)
    calls = seen["_levels_forward"]
    need(len(calls) == 2, f"hnet-darknet: {len(calls)} ROI pyramids, expected 2")
    res["roi_align_single"] = []
    for i, (a, k) in enumerate(calls):
        got = pallas_roi_align._levels_forward(*a, **k)
        want = pallas_roi_align.roi_align_levels_plain(*a, **k)
        for f, g, wt in zip(a[0], got, want):
            check_equal(f"hnet-darknet: roi_align_single pyramid {i}, level {tuple(f.shape)}",
                        g, wt)
        res["roi_align_single"].append([tuple(f.shape) for f in a[0]])
    a, k = calls[0]
    outs = pallas_roi_align._levels_forward(*a, **k)
    times["roi_align_single"] = time_call(
        "roi_align_single, the three darknet levels in one launch",
        lambda: pallas_roi_align._levels_forward(*a, **k),
        lambda: pallas_roi_align.roi_align_levels_plain(*a, **k),
        *bound(nbytes(*a[0], *outs, a[1]), sum(o.numel() for o in outs) * 4 * 4 * 2,
               F32_FLOPS), iters)
    for i, (a, k) in enumerate(seen["roi_align_bounded"]):
        out = pallas_roi_align.roi_align_bounded(*a)
        times[f"roi_align_{a[1].shape[0]}x{a[6]}"] = time_call(
            f"roi_align canvas, {a[1].shape[0]} ROIs at {a[6]}x{a[6]}",
            lambda: pallas_roi_align.roi_align_bounded(*a),
            lambda: pallas_roi_align.roi_align_bounded_plain(*a),
            *roi_bound(a, out), iters)
    for i, (a, k) in enumerate(seen["nms_padded_pallas"]):
        # the IoU of every valid upper-triangle pair (~20 f32 ops), as phase 3
        nv = a[2].sum(1).double()
        times[f"nms_{i}_{tuple(a[0].shape)}"] = time_call(
            f"nms {tuple(a[0].shape)} -> {a[4]} at IoU {a[3]}, with its sort",
            lambda: pallas_nms.nms_padded_pallas(*a, **k), lambda: nms_padded(*a, **k),
            *bound(nbytes(*a[:3]), float((nv * (nv - 1) / 2).sum()) * 20, F32_FLOPS), iters)
    (a, k), = seen["fused_mask_probs"]
    probs = pallas_mask_head.fused_mask_probs(*a, **k)
    wbytes = sum(p.numel() for p in a[0].parameters()) * 2
    times["mask_head"] = time_call(
        f"mask_head N {a[1].shape[0]}", lambda: pallas_mask_head.fused_mask_probs(*a, **k),
        lambda: pallas_mask_head.fused_mask_probs_plain(*a, **k),
        *bound(nbytes(a[1], probs) + wbytes, mask_head_flops(a[1].shape[0]), BF16_FLOPS), iters)
    res["times"] = times
    return res


def check_hnet_darknet_outputs(out: dict, size: int = 640) -> dict:
    """Finite outputs of the expected shapes; keypoints inside their boxes
    with scores in [0, 1]; FCOS detections inside the tile."""
    d, f, seg, cl = out["det40x"], out["fcos40x"], out["seg10x"], out["cl5x"]
    need(d["boxes"].shape == (4, 100, 4) and d["masks"].shape == (4, 100, 28, 28)
         and d["keypoints"].shape == (4, 100, 17, 3) and f["boxes"].shape == (4, 100, 4)
         and seg["probs"].shape == (4, 20, 20, 5) and cl["probs"].shape == (4, 3),
         f"unexpected hnet-darknet shapes "
         f"{[tuple(t.shape) for t in (d['boxes'], d['keypoints'], f['boxes'], seg['probs'])]}")
    for name, t in (("det boxes", d["boxes"]), ("masks", d["masks"]), ("keypoints", d["keypoints"]),
                    ("fcos boxes", f["boxes"]), ("fcos scores", f["scores"]),
                    ("seg", seg["probs"]), ("cl", cl["probs"])):
        need(bool(torch.isfinite(t.float()).all()), f"non-finite hnet-darknet {name}")
    v, fv = d["valid"], f["valid"]
    need(int(v.sum()) >= 4 and int(fv.sum()) >= 4, "hnet-darknet: too few detections")
    kp, bx = d["keypoints"][v], d["boxes"][v]
    inside = ((kp[..., 0] >= bx[:, None, 0]) & (kp[..., 0] <= bx[:, None, 2])
              & (kp[..., 1] >= bx[:, None, 1]) & (kp[..., 1] <= bx[:, None, 3]))
    need(bool(inside.all()), f"hnet-darknet: {int((~inside).sum())} keypoints outside their box")
    need(bool(((kp[..., 2] >= 0) & (kp[..., 2] <= 1)).all()), "keypoint scores outside [0, 1]")
    need(bool((d["keypoints"][~v] == 0).all()), "keypoints of invalid detections not 0")
    fb = f["boxes"][fv]
    need(bool(((fb >= 0) & (fb <= size)).all() and (fb[:, 2:] >= fb[:, :2]).all()),
         "hnet-darknet: FCOS detections outside the tile")
    need(bool((f["labels"][fv] >= 1).all() & (f["labels"][fv] <= 4).all()
              & (f["labels"][~fv] == -100).all()), "hnet-darknet: FCOS labels")
    info = {"det_per_image": v.sum(1).tolist(), "fcos_per_image": fv.sum(1).tolist(),
            "keypoint_score_mean": float(kp[..., 2].mean()),
            "fcos_score_max": float(f["scores"][fv].max())}
    log(f"  outputs: Mask R-CNN detections per image {info['det_per_image']}, FCOS "
        f"{info['fcos_per_image']}; every keypoint inside its box, scores mean "
        f"{info['keypoint_score_mean']:.4f}; FCOS boxes inside the tile, max score "
        f"{info['fcos_score_max']:.4f}")
    return info


def match_keypoints(a: dict, b: dict):
    """b's valid detections that a finds again (same label, IoU >= 0.9) and,
    for those, the largest |keypoint x, y difference| of each (px)."""
    diffs = []
    for i in range(len(b["valid"])):
        va, vb = a["valid"][i], b["valid"][i]
        if vb.any() and va.any():
            best, j = box_iou(b["boxes"][i][vb].float(), a["boxes"][i][va].float()).max(1)
            ok = (best >= 0.9) & (a["labels"][i][va][j] == b["labels"][i][vb])
            ka, kb = a["keypoints"][i][va][j[ok]], b["keypoints"][i][vb][ok]
            diffs += (ka[..., :2] - kb[..., :2]).abs().amax((1, 2)).tolist()
    return diffs


@torch.no_grad()
def hnet_darknet_reference() -> dict:
    """A small hnet-darknet (width 0.25, FPN 256, Mask R-CNN with masks and 5
    keypoints, FCOS, panoptic) in f32 on 2 x 128 px, the card (the direct
    f32 stem, the mask head's f32 form; cuDNN without TF32) against the
    port's plain path on the CPU from the same weights: >= 98% of the CPU's
    detections of each header found again (same label, IoU >= 0.9), and of
    those the keypoints within 0.05 px for >= 98%.  FCOS's own init
    (N(0, 0.01) convs) scores every location within rounding of the same
    value, so any rounding step reorders its top-k, and half its random
    ltrb regressions are cut to 0 by the ReLU, which leaves boxes of no
    height that match nothing; here its convs are He-normal, which spreads
    the scores, and its regression bias 3, which opens the boxes."""
    cfg = {"backbone": {"type": "darknet", "width": 0.25, "depth": 0.33},
           "fpn": {"out_channels": 256},
           "headers": {
               "det": {"type": "maskrcnn", "num_classes": 4, "pre_nms_topk": 256,
                       "num_proposals": 64, "num_detections": 24, "num_keypoints": 5,
                       "anchor_sizes": [16.0, 32.0, 64.0]},
               "fcos": {"type": "fcos", "num_classes": 3, "pre_nms_topk": 256,
                        "num_detections": 24},
               "seg": {"type": "panoptic", "num_classes": 5, "channels": 64,
                       "amplification": 0.25}}}
    x = torch.randint(0, 256, (2, 128, 128, 3), generator=torch.Generator().manual_seed(9),
                      dtype=torch.uint8)
    gpu = HNet.from_cfg(cfg, seed=11)
    g = torch.Generator().manual_seed(12)
    for mod in gpu.headers["fcos"].modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                             * math.sqrt(2.0 / mod.weight[0].numel()))
    gpu.headers["fcos"].bbox_pred.bias.fill_(3.0)
    cpu = HNet(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    kernels.reset_launches()
    _, a = gpu(x.cuda())
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    need(launches["stem_tf32"] == 1 and launches["stem"] == 0 and launches["mask_head_f32"] == 1,
         f"f32 hnet-darknet: expected the f32 stem form and the f32 mask head, got {launches}")
    a = cpu_tree(a)
    _, b = cpu(x)
    res = {}
    for task in ("det", "fcos"):
        matched, total, mask_d = match_detections(a[task], b[task])
        res[task] = {"matched": matched, "total": total}
        log(f"  f32 {task}: {total} valid on the CPU, {matched / max(total, 1):.3f} found again on "
            f"the card (need >= 0.98)" + (f"; masks mean |d| {mask_d:.2e}" if task == "det" else ""))
        need(total >= 8 and matched >= 0.98 * total, f"f32 hnet-darknet {task}: card vs CPU")
    kd = match_keypoints(a["det"], b["det"])
    close = sum(d <= 0.05 for d in kd) / max(len(kd), 1)
    res["keypoints_within_0.05px"] = close
    log(f"  f32 keypoints of the matched detections: {close:.3f} of {len(kd)} within 0.05 px "
        f"(need >= 0.98), largest |d| {max(kd):.3g} px")
    need(close >= 0.98, "f32 hnet-darknet keypoints: card vs CPU")
    res["seg_max_abs_d"] = float((a["seg"]["probs"] - b["seg"]["probs"]).abs().max())
    need(res["seg_max_abs_d"] <= 1e-4, f"f32 seg probabilities card vs CPU {res['seg_max_abs_d']}")
    return res


@torch.no_grad()
def he_normal(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded He-normal conv weights and zero biases.  (torch's default
    init shrinks the signal through the critic's eight layers until its
    score no longer depends on its input at f32 resolution.)"""
    for mod in module.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                             * math.sqrt(2.0 / mod.weight[0].numel()))
            mod.bias.zero_()


def srgan_check(iters: int) -> dict:
    """``SRGenerator`` and ``SRDiscriminator(wgan=True)`` at their defaults
    on the card in f32 (cuDNN, TF32 off) with seeded He-normal weights: the
    generator on 16 x 320² → 640² (finite, in [0, 1], timed), one WGAN-GP
    critic step on its output against 16 real 640² tiles (Adam 1e-4; the
    critic objective on the same batch and α before and after, finite, and
    falling), and a small card vs CPU check of both modules (2 x 24², 2 x
    48²): the generator within 2e-4 (the CPU's own f32 output is 3.8e-5
    off its f64 one at these weights, so two f32 results may differ by
    some multiple of that), the critic's scores within 1e-4 of their
    size."""
    from hd_yolo_tpu_torch.hnet import srgan

    g, d = srgan.SRGenerator(), srgan.SRDiscriminator(wgan=True)
    he_normal(g, torch.Generator().manual_seed(23))
    he_normal(d, torch.Generator().manual_seed(24))
    gen = torch.Generator(device="cuda").manual_seed(23)
    lr = torch.rand((16, 320, 320, 3), generator=gen, device="cuda")
    hr = torch.rand((16, 640, 640, 3), generator=gen, device="cuda")
    g.eval()
    with torch.no_grad():
        fake = g(lr)
    need(fake.shape == (16, 640, 640, 3) and bool(torch.isfinite(fake).all())
         and float(fake.min()) >= 0 and float(fake.max()) <= 1, "SRGAN generator output")
    with torch.no_grad():
        t = timed_steps(lambda: g(lr), iters)
    log(f"  SRGenerator 16 x 320² -> 640² f32: median {t['median_ms']:.2f} ms (min "
        f"{t['min_ms']:.2f}, max {t['max_ms']:.2f})")
    opt = torch.optim.Adam(d.parameters(), 1e-4)

    def critic_loss():
        gp = srgan.gradient_penalty(d, hr, fake, torch.Generator(device="cuda").manual_seed(1))
        return d(fake).mean() - d(hr).mean() + 10.0 * gp

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = critic_loss()
    opt.zero_grad()
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    before = float(loss.detach())
    after = float(critic_loss().detach())
    log(f"  WGAN-GP critic step (16 x 640², f32, Adam 1e-4): {step_ms:.1f} ms; objective "
        f"{before:.4f} -> {after:.4f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    need(math.isfinite(before) and math.isfinite(after) and after < before,
         "the WGAN-GP critic objective did not fall over one step")
    gc, dc = srgan.SRGenerator(device="cpu"), srgan.SRDiscriminator(wgan=True, device="cpu")
    gc.load_state_dict(g.state_dict())
    dc.load_state_dict(d.state_dict())
    gc.eval()
    xs = torch.rand((2, 24, 24, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        eg = float((g(xs.cuda()).cpu() - gc(xs)).abs().max())
        xd = torch.rand((2, 48, 48, 3), generator=torch.Generator().manual_seed(3))
        sd_cpu = dc(xd)
        ed = float((d(xd.cuda()).cpu() - sd_cpu).abs().max())
    scale = max(1.0, float(sd_cpu.abs().max()))
    log(f"  SRGAN card vs CPU: generator max |d| {eg:.2e} (need <= 2e-4), critic {ed:.2e} on "
        f"scores {[round(v, 4) for v in sd_cpu.tolist()]} (need <= 1e-4 x {scale:.3g})")
    need(eg <= 2e-4 and ed <= 1e-4 * scale, "SRGAN card vs CPU")
    del g, d, opt
    torch.cuda.empty_cache()
    return {"generator": t, "critic_step_ms": step_ms, "critic_before": before,
            "critic_after": after, "card_vs_cpu": {"generator": eg, "critic": ed}}


@torch.no_grad()
def swin_import_check() -> dict:
    """``tests/fixtures/swin_tiny.pt`` (the upstream key layout) through
    ``utils/import_swin`` into a port Swin on the card: every key used, and
    its two output levels on 2 x 32² against the same import run on the CPU
    (the fixture bundles no outputs; ``tests/test_torch_importers.py`` holds
    the CPU import against JAX's), within 1e-4."""
    from hd_yolo_tpu_torch.hnet import SwinTransformer
    from hd_yolo_tpu_torch.utils.import_swin import import_swin_state_dict

    sd = torch.load(os.path.join(FIXTURES, "swin_tiny.pt"), map_location="cpu",
                    weights_only=False)["state_dict"]
    gpu, cpu = SwinTransformer(**SWIN_FIXTURE_KW).cuda(), SwinTransformer(**SWIN_FIXTURE_KW)
    unused = import_swin_state_dict(sd, gpu) + import_swin_state_dict(sd, cpu)
    need(not unused, f"swin import left keys unused: {unused}")
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(4))
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(gpu(x.cuda()), cpu(x))]
    log(f"  swin_tiny.pt imported on the card: {len(sd)} keys, none unused; outputs vs the "
        f"CPU's max |d| {errs} (need <= 1e-4)")
    need(max(errs) <= 1e-4, "swin import: card vs CPU")
    return {"keys": len(sd), "max_abs_d": errs}


def phase_hnet_darknet(iters: int):
    """Phase 23: hnet-darknet (``hnet_darknet_cfg``) at bf16 on 4 x 640
    uint8 tiles with seeded weights: the launches of one forward (asserted),
    every kernel call on the path held against its plain version and timed,
    the outputs checked, the forward timed and profiled; a training
    micro-step from the fresh model (launches asserted, every backward call
    shadowed, the loss falling over 8 updates as phase 15's), timed; a small
    f32 card vs CPU check; SRGAN; the swin importer."""
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step
    from hd_yolo_tpu_torch.hnet import mask_rcnn
    from hd_yolo_tpu_torch.models import layers

    t0 = time.perf_counter()
    info = {"card": CARD.get("smi")}
    cfg = hnet_darknet_cfg()
    model = HNet.from_cfg(cfg, dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randint(0, 256, (4, 640, 640, 3), generator=gen, device="cuda", dtype=torch.uint8)
    model(x)                                          # warm-up (cuDNN/cuBLAS algorithm choice)
    with capture_calls((pallas_nms, "nms_padded_pallas"), (pallas_roi_align, "roi_align_bounded"),
                       (mask_rcnn, "fused_mask_probs"), (layers, "stem_conv"),
                       (pallas_roi_align, "_levels_forward")) as seen:
        launches, (losses, out) = path_launches(lambda: model(x))
    log(f"  launches in one forward: {launches}")
    for k, n in HNET_DARKNET_LAUNCHES.items():
        need(launches[k] == n, f"hnet-darknet: kernel {k} launched {launches[k]} times in one "
                               f"forward, expected {n}")
    need(losses == {"seg10x": {}, "det40x": {}, "fcos40x": {}, "cl5x": {}},
         f"unexpected losses {losses}")
    info["outputs"] = check_hnet_darknet_outputs(out)
    info["held"] = hold_hnet_darknet_calls(seen, 20)
    info["infer"] = timed_steps(lambda: model(x), iters)
    log(f"  batch-4 forward: median {info['infer']['median_ms']:.2f} ms over {iters} (min "
        f"{info['infer']['min_ms']:.2f}, max {info['infer']['max_ms']:.2f}); tiles/s "
        f"{4e3 / info['infer']['median_ms']:.1f}")
    info["infer"].update(profile_step(lambda: model(x)))
    del model
    torch.cuda.empty_cache()

    model = HNet.from_cfg(cfg, dtype=torch.bfloat16, seed=0)
    state = TrainState.create(model, build_optimizer(model, HNET_HYP, 80, 12))
    step = make_train_step()
    batch, n_obj = hnet_darknet_batch(0)
    r = loss_runs(step, state, batch, hnet_batch_loss(model, batch))
    r.pop("metrics")
    log(f"  loss on the batch ({n_obj} nuclei, eval mode) before 8 updates (the fresh model) "
        f"{r['before']:.4f}; after them through the kernels {r['kernel']:.4f} (their "
        f"{r['held']['calls']} backward calls each held against the plain version, worst |d| / "
        f"max|plain|: {r['held']}), through the plain backwards {r['plain']:.4f}, through the "
        f"kernels again {r['kernel_again']:.4f}; the updates' losses "
        f"{[round(v, 4) for v in r['kernel_per_update']]}")
    need(r["kernel"] < r["before"], "hnet-darknet: the loss did not fall over 8 updates")
    fall = r["before"] - r["plain"]
    need(fall > 0 and abs(r["kernel"] - r["plain"]) <= 0.1 * fall,
         f"hnet-darknet: the loss after 8 updates through the kernels, {r['kernel']:.4f}, is not "
         f"within a tenth of the fall of the plain backwards' {r['plain']:.4f}")
    t_launches, info["train"] = train_timing(step, state, batch, iters)
    log(f"  launches of one training micro-step: {t_launches}")
    for k, n in HNET_DARKNET_TRAIN_LAUNCHES.items():
        need(t_launches[k] == n, f"hnet-darknet training: kernel {k} launched {t_launches[k]} "
                                 f"times in one micro-step, expected {n}")
    info["train"].update(loss_runs=r, objects=n_obj)
    log(f"  train micro-step (batch 4 x 640, bf16, {n_obj} nuclei): median "
        f"{info['train']['median_ms']:.2f} ms over {iters} (min {info['train']['min_ms']:.2f}, "
        f"max {info['train']['max_ms']:.2f}); {info['train']['img_per_s']:.1f} img/s; peak "
        f"{info['train']['peak_gib']:.2f} GiB; items {info['train']['last_items']}")
    del model, state, step, batch
    torch.cuda.empty_cache()
    info["reference"] = hnet_darknet_reference()
    info["srgan"] = srgan_check(iters)
    info["swin_import"] = swin_import_check()
    info["phase_s"] = time.perf_counter() - t0
    log(f"  phase 23: {info['phase_s']:.1f} s")
    return launches, t_launches, info


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def step_delta(m, sd, m_ref, sd_ref, p0) -> dict:
    """How far one update (its metrics ``m`` and state dict ``sd``) is from
    another's from the same start ``p0``: the largest relative difference of
    the loss items (to 1e-3 of the total at least), of the BatchNorm running statistics (to each tensor's
    largest), the norm of the parameters' differences over the reference
    update's, and the worst tensors."""
    need(set(m) == set(m_ref), f"metrics {sorted(m)} vs {sorted(m_ref)}")
    stats, params, num, den = {}, {}, 0.0, 0.0
    for k, v in sd_ref.items():
        d = sd[k] - v
        if "running_" in k:
            stats[k] = float(d.abs().max()) / max(float(v.abs().max()), 1e-12)
        elif v.is_floating_point():
            u = v - p0[k]
            if float(u.abs().max()) > 0:
                params[k] = float(d.abs().max()) / float(u.abs().max())
            num, den = num + float(d.square().sum()), den + float(u.square().sum())
    worst = lambda d: sorted(((v, k) for k, v in d.items()), reverse=True)[:3]  # noqa: E731
    floor = 1e-3 * abs(m_ref["loss"])           # an item near 0 against the total's scale
    return {"loss_items_rel": max(abs(m[k] - m_ref[k]) / max(abs(m_ref[k]), floor)
                                  for k in m_ref),
            "bn_stats_rel": max(stats.values()), "update_norm_rel": (num / max(den, 1e-30)) ** .5,
            "worst_stats": worst(stats), "worst_params_rel_to_update": worst(params),
            "loss": m["loss"]}


def one_updates(state, batch, plain_step, dist_step) -> dict:
    """From one state: one update through the plain step, the distributed
    step, and the plain step with every
    BatchNorm scale moved by +2^-16 and by -2^-16 of itself (changes at the
    level of rounding); each as (metrics, f32 state dict), and the start."""
    snap = train_snapshot(state)

    def run(step, move=0.0):
        train_restore(state, snap)
        if move:
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    if name.endswith("bn.weight"):
                        p.mul_(1 + move)
        _, m = step(state, batch)
        torch.cuda.synchronize()
        return ({k: float(v) for k, v in m.items()},
                {k: v.detach().float().clone() for k, v in state.model.state_dict().items()})

    out = {"start": {k: v.float().clone() for k, v in snap[0].items()}}
    out.update(plain=run(plain_step), distributed=run(dist_step),
               moved=[run(plain_step, mv) for mv in (2 ** -16, -2 ** -16)])
    return out


def ddp_step_check(iters: int) -> tuple:
    """Phase 24 (b): the flagship's micro-step through the distributed path
    (a group of one) against the plain step from the same state.  In f32
    (TF32 off): within 2x of what moving the BatchNorm scales by +/-2^-16
    makes of the plain step, for the loss items, the running statistics and
    the update.  In bf16, as it trains: within the bf16 plain step's own
    distance from the f32 one.  (At a fresh init the flagship's first update
    is that sensitive: in f32 such a move shifts running means by 3e-04 of
    their largest and the update by 3%, in bf16 the update by over 100%; the
    exact checks of the path are the world-2 tests against JAX on the CPU
    and against the whole batch on the card.)"""
    from hd_yolo_tpu_torch.engines.train_step import make_train_step, to_device

    dist_step = make_train_step(distributed=True)
    x, t = hnet_batch(24, B=16, max_t=64)
    batch = to_device({"image": x, "targets": {"detSC": t["det40x"]}}, "cuda")
    keys = ("loss_items_rel", "bn_stats_rel", "update_norm_rel")
    res, ref = {}, None
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        state, plain_step = train_phase_state("yolov5l6-mask", dtype=dtype)
        u = one_updates(state, batch, plain_step, dist_step)
        got = step_delta(*u["distributed"], *u["plain"], u["start"])
        if name == "f32":
            moved = [step_delta(*mv, *u["plain"], u["start"]) for mv in u["moved"]]
            scale = {k: 2 * max(d[k] for d in moved) for k in keys}
            what = "2x the larger of the plain step's moves of the BatchNorm scales by +/-2^-16"
            ref = u["plain"]
            del state
            torch.cuda.empty_cache()
        else:
            own = step_delta(*u["plain"], *ref, u["start"])
            scale = {k: own[k] for k in keys}
            what = "the bf16 plain step's distance from the f32 one"
        log(f"  (b) {name}, the distributed step vs the plain one, one update from the same "
            f"state: {got}; bound ({what}): {scale}")
        for k in keys:
            need(got[k] <= scale[k], f"{name}: the distributed step's {k} {got[k]:.3g} is past "
                                     f"{what}, {scale[k]:.3g}")
        res[name], res[f"{name}_bound"] = got, scale
    del ref, u

    launches, _ = path_launches(lambda: dist_step(state, batch))
    plain_launches, _ = path_launches(lambda: plain_step(state, batch))
    need(launches == plain_launches and launches["roi_align"] == 1
         and launches["roi_align_bwd"] == 1,
         f"the distributed step's kernel launches {launches} are not the plain step's "
         f"{plain_launches}")
    log(f"  kernel launches of the distributed micro-step (the plain step's): {launches}")
    times = step_turns({"plain": lambda: plain_step(state, batch),
                        "distributed": lambda: dist_step(state, batch)}, iters // 2)
    log(f"  step times in turns over {iters // 2}: {times}")
    prof = {k: nccl_profile(fn) for k, fn in (("plain", lambda: plain_step(state, batch)),
                                              ("distributed", lambda: dist_step(state, batch)))}
    log(f"  profiled steps: {prof}")
    mem = device_memory_stats()
    mem = {k: mem[k] / 2 ** 30 for k in ("allocated_bytes.all.current",
                                          "allocated_bytes.all.peak",
                                          "reserved_bytes.all.current") if k in mem}
    log(f"  (e) device_memory_stats after (b), GiB: {mem}")
    info = {**res, "times": times, "profile": prof, "memory_gib": mem}
    del state, batch
    torch.cuda.empty_cache()
    return launches, info


def nccl_profile(fn) -> dict:
    """One profiled ``fn()``: its CUDA kernel launches and device time, and
    those of the NCCL kernels among them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    nccl = [e for e in rows if "nccl" in e.key.lower()]
    return {"launches": sum(e.count for e in rows),
            "device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
            "nccl_launches": sum(e.count for e in nccl),
            "nccl_device_ms": sum(e.self_device_time_total for e in nccl) / 1e3}


# the tiles of phase 24's torchrun set: 2 micro-steps at batch 16
DDP_CLI_TILES = 32


def ddp_cli(tmp: str) -> dict:
    """Phase 24 (c): the train CLI under torchrun at one process, one epoch on
    32 tiles of phase 14's synthetic set (2 micro-steps; PR 16 ran its 64),
    then ``--resume`` to a second."""
    data = make_train_set(tmp, n=DDP_CLI_TILES)
    steps = DDP_CLI_TILES // 16
    save_dir = os.path.join(tmp, "run")
    res = {}
    for epochs, extra in ((1, []), (2, ["--resume"])):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "hd_yolo_tpu_torch.engines.train",
               "--data", data, "--save-dir", save_dir, "--epochs", str(epochs),
               "--dist-timeout", "300", *TRAIN_CLI, *extra]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           env={**os.environ, "PYTHONPATH": os.path.dirname(
                               os.path.abspath(__file__))})
        dt = time.perf_counter() - t0
        need(p.returncode == 0, f"torchrun train exited {p.returncode}:\n{p.stderr[-3000:]}")
        saved = torch.load(os.path.join(save_dir, "last.pt"), map_location="cpu",
                           weights_only=False)
        meta = json.load(open(os.path.join(save_dir, "last.json")))
        # the resumed run continues the same directory's state (a fresh run would
        # have moved to run2 and left last.pt at the first epoch's step)
        need(meta["epoch"] == epochs - 1 and int(saved["step"]) == steps * epochs,
             f"torchrun train, {epochs} epoch(s): last.json {meta}, step {int(saved['step'])}")
        res[f"epochs_{epochs}_s"] = dt
    log(f"  (c) torchrun --nproc_per_node 1 engines.train: one epoch {res['epochs_1_s']:.1f} s, "
        f"--resume to a second {res['epochs_2_s']:.1f} s (wall, the process start included); "
        f"rank 0 wrote last.pt, the resume restored it")
    return res


def ddp_slide(iters: int) -> tuple:
    """Phase 24 (d): ``slide_inference_sharded`` at world 1 on phase 9's slide
    against ``Detector.slide``."""
    from hd_yolo_tpu_torch.wsi import slide_inference_sharded

    det = Detector("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0, pre_nms_topk=1024,
                   max_masks=100, mask_budget=768, mask_window=16)
    slide = np.random.default_rng(9).integers(0, 256, (4096, 4096, 3), dtype=np.uint8)
    grid = tiling.sliding_window_grid(4096, 4096, 640, 64)
    x = tiling.extract_tiles(torch.from_numpy(slide).cuda(), torch.from_numpy(grid[:16]), 640)
    calibrate_detections(det, x, 20.0)
    want = det.slide(slide, tile=640, overlap=64, batch=16)[0]["detSC"]
    dev_slide = torch.from_numpy(slide).cuda()

    def sharded():
        return slide_inference_sharded(lambda t: det.model(t)["detSC"], dev_slide, tile=640,
                                       overlap=64, batch_per_device=16, fused=True)

    launches, out = path_launches(sharded)
    v = out["valid"] & (out["boxes"][:, 0] < 4096) & (out["boxes"][:, 1] < 4096)
    got = {"boxes": np.minimum(out["boxes"][v], 4096), "scores": out["scores"][v],
           "labels": out["labels"][v], "masks": out["masks"][v], "has_mask": out["mask_valid"][v]}
    for k, w in want.items():
        need(np.array_equal(got[k], w), f"slide_inference_sharded at world 1: {k} differs from "
                                        f"Detector.slide's")
    t = timed_steps(sharded, iters)
    log(f"  (d) slide_inference_sharded at world 1, 4096 x 4096, 16 tiles a batch: "
        f"{len(want['boxes'])} detections bit for bit Detector.slide's; launches {launches}; "
        f"{t}")
    for k, n in slide_launches(-(-len(grid) // 16)).items():
        need(launches[k] == n, f"sharded slide: kernel {k} launched {launches[k]}, expected {n}")
    flops = ddp_flops(det)
    del det, dev_slide
    torch.cuda.empty_cache()
    return launches, {"detections": len(want["boxes"]), "times": t, **flops}


def ddp_flops(det) -> dict:
    """Phase 24 (e): the flagship forward's FLOPs at 16 x 640 (packed branch,
    768 mask slots): ``flops_of`` counts the PyTorch ops, the stem and the
    mask head (hand kernels) are added from their formulas."""
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (16, 640, 640, 3),
                                                           dtype=np.uint8)).cuda()
    with torch.no_grad():
        counted = flops_of(lambda: det.model(x))
    stem = 2.0 * 16 * 320 * 320 * 64 * 6 * 6 * 3
    mask = mask_head_flops(768)
    total = counted + stem + mask
    log(f"  (e) flops_of the flagship forward at 16 x 640: {counted / 1e12:.4f} TFLOP counted "
        f"(cuDNN / cuBLAS ops) + stem kernel {stem / 1e12:.4f} + mask head at 768 slots "
        f"{mask / 1e12:.4f} = {total / 1e12:.4f} TFLOP")
    return {"flops_counted": counted, "flops_stem": stem, "flops_mask_head": mask,
            "flops_total": total}


def ddp_hnet_step(iters: int) -> tuple:
    """Phase 24 (d): hnet-nucls's micro-step through the distributed path (a
    group of one) beside the plain one: phase 15's model, batch and recipe
    (Swin-T, drop path 0.2, bf16, 4 x 640).  From the fresh model: the first
    micro-step's loss items against the plain step's from the same state,
    within twice the plain step's own spread over two runs (the step is not
    deterministic on the card, ROADMAP C.5) or 1e-4 relative; 8 updates
    through the distributed step with every backward call held against its
    plain version and the loss falling, within a tenth of that fall of the
    same updates through the plain backwards (``loss_runs``, as phase 15);
    then its kernel launches (the plain step's), the two steps' times in
    turns and a profile of each with its NCCL kernels."""
    from hd_yolo_tpu_torch.engines.train_step import make_train_step

    torch.cuda.empty_cache()
    model, state, plain_step = hnet_train_state()
    batch, n_obj = hnet_train_batch()
    dist_step = make_train_step(distributed=True)
    snap = train_snapshot(state)
    first = {}
    for name, st in (("plain", plain_step), ("plain_again", plain_step),
                     ("distributed", dist_step)):
        train_restore(state, snap)
        first[name] = {k: float(v) for k, v in st(state, batch)[1].items()}
    train_restore(state, snap)
    del snap
    rel = lambda a, b: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)  # noqa: E731
    got, spread = rel(first["distributed"], first["plain"]), rel(first["plain_again"],
                                                                 first["plain"])
    log(f"  (d) hnet-nucls, the distributed micro-step's loss items vs the plain step's from "
        f"the fresh model: largest relative difference {got:.3g} (the plain step against "
        f"itself: {spread:.3g}); items {first['distributed']}")
    need(set(first["distributed"]) == set(first["plain"]) and got <= max(2 * spread, 1e-4),
         f"the distributed hnet step's loss items are {got:.3g} off the plain step's")
    r = loss_runs(dist_step, state, batch, hnet_batch_loss(model, batch))
    r.pop("metrics")
    log(f"  loss on the batch (eval mode) before 8 updates through the distributed step "
        f"{r['before']:.4f}; after them through the kernels {r['kernel']:.4f} (their "
        f"{r['held']['calls']} backward calls each held against the plain version: "
        f"{r['held']}), through the plain backwards {r['plain']:.4f}, through the kernels "
        f"again {r['kernel_again']:.4f}")
    fall = r["before"] - r["plain"]
    need(r["kernel"] < r["before"] and fall > 0 and abs(r["kernel"] - r["plain"]) <= 0.1 * fall,
         f"the distributed hnet step's loss after 8 updates, {r['kernel']:.4f}, did not fall "
         f"from {r['before']:.4f} within a tenth of the plain backwards' fall to "
         f"{r['plain']:.4f}")
    launches, _ = path_launches(lambda: dist_step(state, batch))
    plain_launches, _ = path_launches(lambda: plain_step(state, batch))
    need(launches == plain_launches and all(launches[k] == n
                                            for k, n in HNET_TRAIN_LAUNCHES.items()),
         f"the distributed hnet step's kernel launches {launches} are not the plain step's "
         f"{plain_launches} ({HNET_TRAIN_LAUNCHES})")
    log(f"  kernel launches of the distributed hnet micro-step (the plain step's): {launches}")
    times = step_turns({"plain": lambda: plain_step(state, batch),
                        "distributed": lambda: dist_step(state, batch)}, iters // 2)
    log(f"  hnet step times in turns over {iters // 2}: {times}")
    prof = {k: nccl_profile(fn) for k, fn in (("plain", lambda: plain_step(state, batch)),
                                              ("distributed", lambda: dist_step(state, batch)))}
    log(f"  profiled hnet steps: {prof}")
    info = {"first_step_rel": got, "first_step_spread": spread, "objects": n_obj,
            "loss_runs": {k: v for k, v in r.items() if not k.endswith("_per_update")},
            "times": times, "profile": prof}
    del model, state, batch
    torch.cuda.empty_cache()
    return launches, info


def phase_ddp(iters: int, cli: bool = True):
    """Phase 24: the flagship and hnet-nucls across processes at world 1 on
    NCCL; with ``cli``, (c) the torchrun CLI too (the full script runs it
    itself, after starting phase 26's processes)."""
    import tempfile

    import torch.distributed as dist

    from hd_yolo_tpu_torch import parallel

    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        rank_world = parallel.maybe_initialize_distributed("cuda", timeout=300)
        need(rank_world == (0, 1) and dist.get_backend() == "nccl",
             f"a one-rank NCCL group: got {rank_world}, {dist.get_backend()}")
        log(f"  (a) one-rank NCCL group from torchrun's environment in "
            f"{time.perf_counter() - t0:.2f} s")
        step_launches, info = ddp_step_check(iters)
        slide_l, info["slide"] = ddp_slide(5)
        kernels.reset_launches()
        hnet_l, info["hnet"] = ddp_hnet_step(iters)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if cli:
        with tempfile.TemporaryDirectory() as tmp:
            info["cli"] = ddp_cli(tmp)
    return step_launches, slide_l, hnet_l, info


# nuclei a tile at which phase 25 holds the packed branch, and its budget
OCCUPANCY_DENSITIES = (40, 80)
OCCUPANCY_BUDGET = 768


def phase_occupancy(iters: int):
    """Phase 25: the packed mask branch's occupancy
    (``tools/occupancy_check``) on the flagship at full width in bf16 with
    seeded weights: 16 synthetic tiles of 640 px at 40 and 80 nuclei a tile
    through the per-image branch (``max_masks`` 192) and the packed one
    (budget 768), the objectness calibrated to a tile's nuclei at each
    density.  Held: each batch's drops are max(0, eligible - 768), every
    mask both branches keep is bit for bit the per-image branch's, and the
    mask mAP of both branches is computed; the kernels' launches of one
    density's sweep."""
    import tempfile
    from pathlib import Path

    from hd_yolo_tpu_torch.tools import occupancy_check as occ

    kw = dict(device="cuda", seed=0, pre_nms_topk=1024, max_masks=192, mask_window=16)
    ref = Detector("yolov5l6-mask", "hyp-nuclei", **kw)
    pack = Detector("yolov5l6-mask", "hyp-nuclei", mask_budget=OCCUPANCY_BUDGET, **kw)
    task = ref.model.spec.headers[0].tag
    rows, launches = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for nuclei in OCCUPANCY_DENSITIES:
            csv = occ.write_density(Path(tmp), nuclei, 16, 640, task)
            batches = occ.density_batches(csv, nuclei, 16, 640)
            x = torch.as_tensor(next(iter(batches()))["image"]).cuda()
            frac, n = calibrate_detections(ref, x, nuclei)
            pack.model.load_state_dict(ref.model.state_dict())
            t0 = time.perf_counter()
            launches[nuclei], row = path_launches(
                lambda: occ.density_row(ref.model, pack.model, nuclei, batches, 640))
            row["wall_s"] = time.perf_counter() - t0
            row["calibrated_detections_per_tile"] = n
            log(f"  {nuclei} nuclei a tile (objectness calibrated to {n:.1f} detections a "
                f"tile): {json.dumps(row)}; launches {launches[nuclei]}")
            want = sum(max(0, c - OCCUPANCY_BUDGET) for c in row["eligible_per_batch"])
            need(row["dropped_total"] == want,
                 f"{nuclei} nuclei: the packed branch dropped {row['dropped_total']} masks, "
                 f"max(0, eligible - {OCCUPANCY_BUDGET}) is {want}")
            need(row["max_abs_mask_diff_kept"] == 0.0,
                 f"{nuclei} nuclei: a kept mask differs from the per-image branch's by "
                 f"{row['max_abs_mask_diff_kept']}")
            need(all(math.isfinite(row[k]) for k in ("mask_map50_unpacked", "mask_map50_packed",
                                                     "mask_map_unpacked", "mask_map_packed")),
                 f"{nuclei} nuclei: a mask mAP is not finite")
            for k in FLAGSHIP_KERNELS:
                need(launches[nuclei][k] >= 1, f"{nuclei} nuclei: kernel {k} not launched")
            rows.append(row)
    need(rows[0]["dropped_total"] == 0 and rows[-1]["dropped_total"] > 0,
         "the densities do not straddle the budget: no drops expected at 40, some at 80")
    info = {"sweep": rows, "envelope": occ.envelope(rows), "budget": OCCUPANCY_BUDGET}
    del ref, pack
    torch.cuda.empty_cache()
    return launches[OCCUPANCY_DENSITIES[-1]], info


# the convergence checks' processes, started by ``start_convergence``
CONVERGENCE: dict = {}


def start_convergence() -> None:
    """Start ``tools/convergence_check``'s yolo and ``--hnet`` checks, each a
    process of its own, side by side; ``phase_convergence`` collects them.
    The full script starts them before phase 24's torchrun CLI, so they run
    beside that CLI and phase 25 (wall times there are recorded only)."""
    import atexit
    import tempfile

    if CONVERGENCE:
        return
    tmp = tempfile.TemporaryDirectory()
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    procs = {}
    for name, extra in (("yolo", []), ("hnet", ["--hnet"])):
        report = os.path.join(tmp.name, f"{name}.json")
        cmd = [sys.executable, "-m", "hd_yolo_tpu_torch.tools.convergence_check",
               "--report", report, *extra]
        # the output to a file: a pipe nobody reads until phase 26 could fill
        out = open(os.path.join(tmp.name, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env),
                       report)
        out.close()
    CONVERGENCE.update(tmp=tmp, procs=procs, t0=time.perf_counter())
    atexit.register(stop_convergence)               # a phase that fails before 26 stops them
    log("  (the convergence checks of phase 26 started: two processes)")


def stop_convergence() -> None:
    for p, _ in CONVERGENCE.get("procs", {}).values():
        if p.poll() is None:
            p.kill()
            p.wait()


def phase_convergence(iters: int):
    """Phase 26: ``tools/convergence_check`` at its defaults on the card: the
    yolo check (``yolov5s-test``, 4 images of 128 px, 1000 steps, f32: box
    fitness >= 0.9, mask fitness >= 0.8, a miss fails the run) and
    ``--hnet`` (the small Swin Mask R-CNN, 2 squares, 700 steps; its loss
    must fall to a tenth of the first step's; whether both squares are
    found is recorded: the JAX tool's own config misses that criterion,
    ROADMAP C.10), each a process of its own (``python -m
    ...convergence_check``), the two run side by side on the card (each
    step is host-bound); each reports the kernels' launches of its whole
    run."""
    start_convergence()
    launches, info = {}, {}
    procs, t0 = CONVERGENCE["procs"], CONVERGENCE["t0"]
    with CONVERGENCE.pop("tmp"):
        try:
            for name, (p, report) in procs.items():
                p.wait(timeout=900)
                out = open(os.path.join(os.path.dirname(report), f"{name}.log")).read()
                need(os.path.isfile(report), f"the {name} convergence check wrote no result "
                                             f"(exit {p.returncode}):\n{out[-3000:]}")
                res = json.load(open(report))
                res["wall_s_since_start"] = time.perf_counter() - t0
                launches[name] = res.pop("launches")
                log(f"  {name} (exit {p.returncode}): {json.dumps(res)}; launches "
                    f"{launches[name]}")
                if name == "yolo":
                    need(p.returncode == 0 and res["ok"],
                         f"the yolo convergence check missed its thresholds: {res}")
                else:
                    # the JAX tool's own config misses its criterion (both
                    # squares found) on the JAX package too (ROADMAP C.10):
                    # held is that the loss converges; the detections are
                    # recorded
                    need(p.returncode in (0, 1) and res["final_loss"] < 0.1 * res["first_loss"],
                         f"the hnet convergence check's loss did not fall to a tenth: {res}")
                info[name] = res
        finally:
            stop_convergence()
            CONVERGENCE.clear()
    # training runs the trunk on batch statistics (no stem kernel) and pools
    # the mask targets through the canvas ROI-align and its backward; the
    # validation forwards take the f32 stem form, NMS and the f32 mask head
    need(launches["yolo"]["roi_align_bwd"] >= 1000 and launches["yolo"]["stem_tf32"] >= 1
         and launches["yolo"]["stem"] == 0 and launches["yolo"]["nms"] >= 1
         and launches["yolo"]["mask_head_f32"] >= 1,
         f"the yolo check's f32 run did not take roi_align_bwd, the f32 stem form (and not the "
         f"direct one), NMS and the f32 mask head: {launches['yolo']}")
    need(launches["hnet"]["roi_align_single_bwd"] >= 700 and launches["hnet"]["mask_head_f32"] >= 1,
         f"the hnet check did not take roi_align_single_bwd and the f32 mask head: "
         f"{launches['hnet']}")
    return launches["yolo"], launches["hnet"], info


ONLY_PATHS = {
    "device_augment": "[16] device augmentation: yolov5l6-mask, batch 16 x 640, bf16, masks, "
                      "raw mode",
    "multihead": "[17] multihead: yolov5l6-multihead (det nc 7, detSC nc 4, masks), batch 16 x "
                 "640, bf16",
    "anchor_free": "[18] anchor-free: yolov6s-af (AFDetect, SimOTA), batch 16 x 640, bf16",
    "ensemble": "[19] ensemble: yolov5l6-mask + yolov5l6-multihead merged on detSC, batch 16 x "
                "640, bf16",
    "pretrained": "[20] pretrained: the reference checkpoint fixtures on tiny2l (f32, masks), the "
                  "flagship from both layouts by bare name",
    "nucls_finetune": "[21] NuCLS fine-tune: 64 synthetic FOVs converted, train.main on the "
                      "flagship from the ultralytics .pt, batch 16 x 640, bf16, masks",
    "hub": "[22] hub presets at published widths: yolov5s-ghost (v6.0), yolov5s (v3.1), "
           "yolov5x6 (v6.0), batch 16 x 640, bf16; yolov5x6 also f32 4 x 1280",
    "hnet_darknet": "[23] hnet-darknet: darknet trunk, 17 keypoints, FCOS header, batch 4 x 640, "
                    "bf16; SRGAN; the swin importer",
    "ddp": "[24] ddp: the flagship across processes at world 1 on NCCL, batch 16 x 640, bf16, "
           "masks; torchrun; the sharded slide; hnet-nucls's micro-step, batch 4 x 640, bf16",
    "occupancy": "[25] occupancy: the packed mask branch against the per-image one on the "
                 "flagship, 16 x 640 synthetic tiles at 40 and 80 nuclei, bf16",
    "convergence": "[26] convergence: tools/convergence_check, yolo (1000 steps) and --hnet "
                   "(700 steps), f32, two processes side by side",
}
PATH_PHASES = {"multihead": phase_multihead, "anchor_free": phase_anchor_free,
               "ensemble": phase_ensemble, "pretrained": phase_pretrained,
               "nucls_finetune": phase_nucls_finetune, "hub": phase_hub,
               "hnet_darknet": phase_hnet_darknet, "ddp": phase_ddp,
               "occupancy": phase_occupancy, "convergence": phase_convergence}


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/H100 port.")
    ap.add_argument("--only", default="",
                    help="comma-separated phase-3 kernel names or paths (device_augment, "
                         "multihead, anchor_free, ensemble, pretrained, nucls_finetune, hub, "
                         "hnet_darknet, ddp, occupancy, convergence): "
                         "build, run only their phases and stop (no result lines); without it, "
                         "every phase")
    ap.add_argument("--hnet-loss-trials", type=int, default=0, metavar="N",
                    help="build, run phase 15's loss check N times (hnet_loss_trials) and stop")
    ap.add_argument("--old-stem", default="", metavar="PATH",
                    help="the source of an earlier kernels/stem.cu (its C signature with "
                         "round_in), built and timed in turns with the direct kernel at phase "
                         "3's X1 and X2")
    ap.add_argument("--step-calls", default="", metavar="PATH",
                    help="build, time the two ROI-align backwards at one hnet step's calls "
                         "saved in PATH (captured first where it does not exist) and stop")
    args = ap.parse_args(argv)
    OLD_STEM["src"] = os.path.abspath(args.old_stem) if args.old_stem else None
    only = {k for k in args.only.split(",") if k}
    if only - set(TPU_KERNEL) - set(ONLY_PATHS):
        ap.error(f"unknown kernels {sorted(only - set(TPU_KERNEL) - set(ONLY_PATHS))}; choose "
                 f"from {list(TPU_KERNEL)} or {list(ONLY_PATHS)}")
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    CARD["smi"] = smi
    log(f"[1] card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")
    # the plain versions are the references: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = kernels.build_all()
    if args.hnet_loss_trials or args.step_calls:
        log(f"[2] built {sorted(kernels.KERNELS)} in {secs:.1f} s")
        if args.hnet_loss_trials:
            log(f"[15] hnet-nucls loss check, {args.hnet_loss_trials} trials")
            hnet_loss_trials(args.hnet_loss_trials)
        if args.step_calls:
            step_call_times(args.step_calls)
        return 0
    log(f"[2] built {sorted(kernels.KERNELS)} in {secs:.1f} s; ptxas of the redesigned kernels:")
    from concurrent.futures import ThreadPoolExecutor

    names = REDESIGNED + ("roi_align_bwd", "roi_align_single_bwd")
    with ThreadPoolExecutor(len(names)) as ex:              # one nvcc a source, all at once
        reports = dict(zip(names, ex.map(kernels.ptxas_report, names)))
    for k in names:
        for line in reports[k].splitlines():
            if "Used" in line or "spill" in line or "C75" in line:
                log(f"  {k}: {line}")
    spills = [line for line in reports["stem"].splitlines()
              if "spill" in line and not line.endswith("0 bytes spill stores, 0 bytes spill loads")]
    need(not spills, f"the direct stem kernel spills: {spills}")
    plans = {}
    for key, (shape, N, od) in DIRECT_PATHS.items():
        info = (ctypes.c_int * 7)()
        B, H, W, C = shape
        kernels.check(kernels.fn("stem_conv_plan")(H, W, C, 6, 2, 2, N, H // 2, W // 2,
                                                   int(od == torch.bfloat16), info), "plan")
        plans[key] = dict(zip(("form", "n_tile", "rows", "slots", "slot_floats", "ksteps",
                               "smem_bytes"), list(info)))
    log(f"  stem (direct) plans (form 0 bf16, 1 split TF32): {plans}")
    log(f"  dynamic shared memory per block: mask_head {kernels.fn('mask_head_smem_bytes')()} B; "
        f"mask_head_f32 {kernels.fn('mask_head_f32_smem_bytes')()} B; "
        f"stem_tc at W 640, N 64 {kernels.fn('stem_tc_smem_bytes')(640, 320, 64)} B "
        f"(2 blocks per SM), at W 640, N 32 {kernels.fn('stem_tc_smem_bytes')(640, 320, 32)} B; "
        f"stem_tf32 at W 640, N 64 {kernels.fn('stem_tf32_smem_bytes')(640, 320, 64)} B, at W 64, "
        f"N 8 {kernels.fn('stem_tf32_smem_bytes')(64, 32, 8)} B (one block per SM)")

    log("[3] kernels vs plain versions (each at its path's shapes)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for kname, fn in (("stem", phase_stem), ("stem_tf32", phase_stem_tf32),
                      ("stem_tc", phase_stem_tc), ("nms", phase_nms),
                      ("roi_align", phase_roi), ("mask_head", phase_mask_head),
                      ("mask_head_f32", phase_mask_head_f32),
                      ("roi_align_single", phase_roi_single),
                      ("roi_align_single_bwd", phase_roi_single_bwd),
                      ("stem_k108", phase_stem_k108), ("stem_dot108", phase_stem_dot108)):
        if only and kname not in only:
            continue
        results[kname] = fn(gen, 20)
        r = results[kname]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {kname}: kernel {r['ms']:.4f} ms ({r['ms_back_to_back']:.4f} back to back) | "
            f"plain {r['plain_ms']:.4f} ms | "
            f"library {lib} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    if "roi_align_bwd" in only:
        log("[14] training: yolov5l6-mask, batch 16 x 640, bf16, masks")
        phase_train(10)
        log("[14b] training reference: yolov5s-test 256 px f32, the card against the CPU")
        phase_train_reference()
    if "roi_align_single_bwd" in only:
        log("[15] hnet training: hnet-nucls, batch 4 x 640, bf16, drop path 0.2")
        phase_hnet_train(10)
        log("[15b] hnet training reference: the small hnet in f32, the card against the CPU")
        phase_hnet_train_reference()
    if "device_augment" in only:
        log("[16] device augmentation: yolov5l6-mask, batch 16 x 640, bf16, masks, raw mode")
        log("  " + json.dumps({"device_augment": phase_device_augment(10)[1]}))
    for path in PATH_PHASES:
        if path in only:
            log(ONLY_PATHS[path])
            log("  " + json.dumps({path: PATH_PHASES[path](10)[-1]}, default=float))
    if only:
        log(f"  --only {','.join(sorted(only))}: the other phases and the result lines skipped")
        return 0
    log("    kernels 2-4 at the hnet-nucls shapes")
    hnet_times = check_hnet_shapes(gen, 20)
    log("    the NMS kernel at the slide stitch's shapes")
    stitch = check_stitch_nms(gen, 20)

    log("[4] flagship yolov5l6-mask, batch 16 x 640, bf16")
    launches = phase_flagship(10)
    log("[4b] flagship at Detector()'s defaults: per-image mask branch, batch 16 x 640, bf16")
    default_launches, per_image = phase_defaults(10)
    log("[5] reference check on a small input")
    phase_reference()
    log("[6] hnet-nucls, batch 4 x 640, bf16")
    hnet_launches = phase_hnet(10)
    log("[7] hnet reference check on a small input")
    phase_hnet_reference()
    log("[8] stem lab, batch 16 x 640, every formulation")
    lab_launches = phase_lab()
    log("[9] flagship slide, 4096 x 4096, tile 640, overlap 64, batch 16, bf16")
    slide_launches = phase_slide(5)
    log("[10] slide reference check on a small slide")
    phase_slide_reference()
    log("[11] val: engines/val.run on the flagship at its defaults, 4 batches of 8 x 640, bf16")
    val_launches, val_res = phase_val()
    log("[12] evaluate and export: inference_on_loader at batch 16, torch.export at "
        "(16, 640, 640, 3)")
    export_launches, loader_launches, export_info = phase_export()
    log("[13] serving: the request path on the flagship at its defaults")
    serving_launches, serving_info = phase_serving()
    log("  " + json.dumps({"val": val_res, "export": export_info, "serving": serving_info}))
    log("[14] training: yolov5l6-mask, batch 16 x 640, bf16, masks")
    train_launches, results["roi_align_bwd"], train_info = phase_train(10)
    log("[14b] training reference: yolov5s-test 256 px f32, the card against the CPU")
    phase_train_reference()
    log("  " + json.dumps({"train": train_info}))
    log("[15] hnet training: hnet-nucls, batch 4 x 640, bf16, drop path 0.2")
    hnet_train_launches, hnet_train_info = phase_hnet_train(10)
    log("[15b] hnet training reference: the small hnet in f32, the card against the CPU")
    phase_hnet_train_reference()
    log("  " + json.dumps({"hnet_train": hnet_train_info}))
    log("[16] device augmentation: yolov5l6-mask, batch 16 x 640, bf16, masks, raw mode")
    aug_launches, aug_info = phase_device_augment(10, train_info["cli"])
    log("  " + json.dumps({"device_augment": aug_info}))
    log(ONLY_PATHS["multihead"])
    mh_launches, mh_default_launches, mh_train_launches, mh_info = phase_multihead(10)
    log("  " + json.dumps({"multihead": mh_info}, default=float))
    log(ONLY_PATHS["anchor_free"])
    af_launches, af_train_launches, af_info = phase_anchor_free(10)
    log("  " + json.dumps({"anchor_free": af_info}, default=float))
    log(ONLY_PATHS["ensemble"])
    ens_launches, ens_info = phase_ensemble(10)
    log("  " + json.dumps({"ensemble": ens_info}, default=float))
    log(ONLY_PATHS["pretrained"])
    pre_launches, pre_info = phase_pretrained(10)
    log("  " + json.dumps({"pretrained": pre_info}, default=float))
    log(ONLY_PATHS["nucls_finetune"])
    nucls_launches, nucls_info = phase_nucls_finetune(10)
    log("  " + json.dumps({"nucls_finetune": nucls_info}, default=float))
    log(ONLY_PATHS["hub"])
    hub_launches, hub_info = phase_hub(10)
    log("  " + json.dumps({"hub": hub_info}, default=float))
    log(ONLY_PATHS["hnet_darknet"])
    hd_launches, hd_train_launches, hd_info = phase_hnet_darknet(10)
    log("  " + json.dumps({"hnet_darknet": hd_info}, default=float))
    log(ONLY_PATHS["ddp"])
    ddp_step_launches, ddp_slide_launches, ddp_hnet_launches, ddp_info = phase_ddp(10, cli=False)
    start_convergence()
    with tempfile.TemporaryDirectory() as tmp:
        ddp_info["cli"] = ddp_cli(tmp)
    log("  " + json.dumps({"ddp": ddp_info}, default=float))
    log(ONLY_PATHS["occupancy"])
    occ_launches, occ_info = phase_occupancy(10)
    log("  " + json.dumps({"occupancy": occ_info}, default=float))
    log(ONLY_PATHS["convergence"])
    conv_launches, conv_hnet_launches, conv_info = phase_convergence(10)
    log("  " + json.dumps({"convergence": conv_info}, default=float))

    paths = {"flagship": launches, "defaults": default_launches, "hnet": hnet_launches,
             "lab": lab_launches, "slide": slide_launches, "val": val_launches,
             "loader": loader_launches, "export": export_launches, "serving": serving_launches,
             "train": train_launches, "hnet_train": hnet_train_launches,
             "device_augment": aug_launches, "multihead": mh_launches,
             "multihead_defaults": mh_default_launches, "multihead_train": mh_train_launches,
             "anchor_free": af_launches, "anchor_free_train": af_train_launches,
             "ensemble": ens_launches, "pretrained": pre_launches["metayolo_tiny"],
             "nucls_finetune": nucls_launches["micro_step"],
             "nucls_finetune_val": nucls_launches["val"],
             "hub_ghost": hub_launches["yolov5s-ghost"], "hub_v3.1": hub_launches["yolov5s-v3.1"],
             "hub_x6": hub_launches["yolov5x6"], "hub_x6_f32": hub_launches["yolov5x6-f32"],
             "hnet_darknet": hd_launches, "hnet_darknet_train": hd_train_launches,
             "ddp_step": ddp_step_launches, "ddp_slide": ddp_slide_launches,
             "ddp_hnet_step": ddp_hnet_launches, "occupancy": occ_launches,
             "convergence": conv_launches, "convergence_hnet": conv_hnet_launches}
    main_path = {k: "flagship" for k in FLAGSHIP_KERNELS}
    main_path.update(mask_head_f32="pretrained", stem_tf32="pretrained", roi_align_single="hnet",
                     stem_k108="lab",
                     stem_dot108="lab", stem="hub_x6", roi_align_bwd="train",
                     roi_align_single_bwd="hnet_train")
    results["nms"]["stitch"] = stitch
    results["nms"]["hnet"] = {k: v for k, v in hnet_times.items() if k.startswith("nms")}
    results["roi_align"]["hnet"] = {k: v for k, v in hnet_times.items()
                                    if k.startswith("roi_align")}
    for k, v in per_image.items():
        results[k]["per_image"] = v
    results["stem_tc"]["anchor_free_n32"] = af_info["stem_tc_n32"]
    results["nms"]["ensemble_16x600"] = ens_info["nms_16x600"]
    for k in ("nms", "roi_align", "mask_head"):
        results[k]["multihead_calls_held"] = {
            b: mh_info[f"held_{b}"].get(k, []) for b in ("packed", "defaults")}
    hd_times = hd_info["held"]["times"]
    results["stem_tc"]["hnet_darknet_n32"] = dict(
        hd_times["stem_tc"], max_abs_err=hd_info["held"]["stem_tc_max_abs_err"])
    results["roi_align_single"]["hnet_darknet"] = hd_times["roi_align_single"]
    results["mask_head"]["hnet_darknet"] = hd_times["mask_head"]
    for k in ("roi_align", "nms"):
        results[k]["hnet_darknet"] = {c: v for c, v in hd_times.items()
                                      if c.startswith(k + "_")}
    for k, pre in (("roi_align", "fwd"), ("roi_align_bwd", "bwd")):
        results[k]["hnet_train"] = {c: v for c, v in hnet_train_info["canvas_at_step"].items()
                                    if c.startswith(pre)}
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": f"hd_yolo_tpu_torch/kernels/{k}.cu",
         "replaces": TPU_KERNEL[k], "launches": paths[main_path[k]][k],
         "launches_by_path": {p: n.get(k, 0) for p, n in paths.items()}, **results[k]}
        for k in TPU_KERNEL]}
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record, default=float), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
