"""Smoke run of the PyTorch port (``codeps_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

 1. device: needs CUDA; prints the card, the device count and
    ``nvidia-smi``'s name and power limit; TF32 is turned off for
    convolutions and matmuls so comparisons run in full float32;
 2. build: compiles ``codeps_torch/csrc/grouping.cu`` with nvcc (sm_90a);
 3. kernel against plain: ``group_pixels_cuda`` equals
    ``group_pixels_plain`` exactly at 384x1408, K = 200, B = 1 and 2,
    with invalid centers, an image without centers, NaN offsets and
    duplicate centers (truly NHWC offsets, copied once by the wrapper),
    and on the fixed timing inputs of phase 5 at every valid-center count
    (read in place, no copy);
 4. slice: the serving path at full width (ResNet-101, GUDA semantic
    head, instance head, 14 classes, 384x1408, seeded weights) streams
    8 uint8 frames through ``CodepsNet(mode="eval")``; the grouping
    kernel must launch once per frame and read the head's offset planes
    in place (no layout copy), the outputs must be finite and
    well formed, at least one frame must hold a center, and the fused
    maps must equal the fusion recomputed on the CPU with the plain
    grouping; a 64x128 run on the card must agree with the same slice
    on the CPU;
 5. timing: the kernel's device time, its bound and what bounds it on
    fixed inputs that do not depend on the weights (1x384x1408 offsets
    drawn from the seed and passed as the NHWC view of an NCHW tensor,
    K = 200 slots of which the first n are valid, n in VALID_COUNTS);
    then on the inputs of the last streamed frame: the kernel's device
    time, its time per call with the host's launch overhead, and the
    plain version's time per call;
 6. adaptation step: the online adaptation step of
    ``cfg/adapt_cityscapes_kitti_360.yaml`` at full width on the phase-4
    modules (frozen ResNet-101 and instance head; live ResNet-18 pose net,
    depth, pose and semantic heads; semantic teacher EMA 0.99) with the
    published batch: target triplet 1x3x384x1408, 2 target-replay
    triplets, 2 source triplets at 512x1024 with labels, 2 composed
    cut-mixup samples at 512x1024, eval GT. One warm-up step, then 5 timed
    steps; every loss must be finite, frozen parameters bit-unchanged,
    live ones moved, the semantic teacher equal to the EMA formula
    recomputed here, the depth and pose teachers equal to the student, the
    grouping kernel launched once per step with no layout copy, the depth
    metrics finite and the confusion matrix summing to H*W. Prints the
    step latency, steps/s and peak memory, then the same in float32 from
    the same starting weights. Then one step at 64x192
    (target) and 64x128 (source) from the same weights, batch and
    automask noise on the card and on the CPU, whose losses must agree;
 7. adaptation stream: the port's ``AdaptationRunner`` streams a
    KITTI-360-like target sequence made in memory from the seed (frames,
    semantic/instance GT and sparse depth at 384x1408, STREAM_FRAMES
    frames after the 0.7 adaptation split) with a Cityscapes-like source
    of SOURCE_IMAGES images at 512x1024 through the published config
    (2 source and 2 target replay samples, ``[cut_mixup, cut_mixup]``
    with the camera warp, diversity buffers of 300 at threshold 0.95,
    EMA 0.99 on the semantic head); the readers' code runs on the
    in-memory frames (label decoding, center/offset GT, histogram
    matching, the numpy color jitter), only file decoding is bypassed.
    The grouping kernel must launch twice a frame (teacher eval and GT
    map) with no layout copy and equal its plain version on every call;
    every meter must be finite; every GT panoptic map must hold thing
    segments and score PQ 1 against itself. Frames go to the card as
    float32, the yaml's default. Prints the frame latency (host clock,
    median after 2 warm-up frames, and its range), frames/s (those frames
    over their summed wall time), the host time of
    ``ReplayBuffer.__getitem__`` and of ``buffer.add``, the peak memory
    and the final PQ, mIoU and abs_rel; times the published rare-class
    source sampling on its own. Then one more step of the stream's last
    batch from the state it left, replayed through the step's CUDA graph
    and twice eagerly with the generator's draws handed in as ``noise``:
    the losses, replay features and skip ring must be equal, the live
    gradients, the live student and the EMA teacher within
    GRAPH_SPREAD_FACTOR times the eager path's own spread. Then the same stream again with frames
    PROFILED_FRAMES after the warm-up traced by ``torch.profiler``: the
    card's busy share of the host's wall time; the stream with uint8
    frames (``normalization.uint8_transfer``), as a second row;
    ``buffer.add`` on its own on an index filled to the buffer's 300
    vectors of 2048 floats, then adds that evict. Last, a 3-frame stream
    at 64x192 (source 64x128) with ResNet-18 runs on the card and on the
    CPU from the same weights, samples and automask noise: their PQ,
    mIoU and abs_rel must agree within ``scripts/parity_e2e.py``'s
    tolerances, their GT panoptic maps must be equal, and so must their
    per-class GT segment counts and true positives;
 8. adaptation CLI: ``codeps_torch.scripts.adapt.run_adaptation`` (what
    ``python -m codeps_torch.scripts.adapt`` runs after reading its files)
    with ``cfg/adapt_cityscapes_semkittidvps.yaml``'s values set in code
    (ResNet-101, 384x1280, Cityscapes at 512x1024, the KITTI-360 yaml's
    adapt section) on a SemKITTI-DVPS-like sequence of CLI_FRAMES frames
    made in memory (the reader's own label maps, P2 camera and depth
    handling; the 0.7 split streams 8 frames and holds out 4), a
    Cityscapes-like source of SOURCE_IMAGES images and a val of
    CLI_SOURCE_VAL. The CLI
    loads the stream's starting weights from a ``.pth`` written by
    ``io/checkpoint.save_checkpoint`` under ``chiprun_out/`` (and deleted
    after), and every tensor it loads must equal the saved one. It streams,
    then validates the EMA teacher on the held-out frames and on the source
    val. The grouping counts are set to 0 before each part and read after:
    2 launches a frame, 2 a validation batch, no layout copy, the kernel
    equal to its plain version on every call (shapes printed); every GT
    panoptic map holds thing segments and scores PQ 1 against itself.
    Prints the stream's frame latency and frames/s, the validation time per
    batch (host clock, median) of both splits, both metric dicts and the
    peak memory, the kernel's device time at 1x384x1280 and 1x512x1024
    (the last call of the stream and of the source val), then the parts
    of a validation batch timed on their own (item, upload, eval forward,
    GT map, readback with PQ). Then a ResNet-18 ``run_validation`` at 64x192 over 2
    held-out batches on the card and on the CPU: the GT and the predicted
    panoptic maps equal, the confusion matrices within NEAR_TIE_SHARE of
    their pixels, PQ/SQ/RQ, mIoU and abs_rel within 0.005 and the other
    depth means within DEPTH_REL_TOL relative;
 9. pretraining: ``codeps_torch.scripts.train.run_training`` (what
    ``python -m codeps_torch.scripts.train`` runs after reading its files)
    with ``cfg/train_cityscapes.yaml``'s values set in code (ResNet-101,
    ResNet-18 pose net, depth, pose, GUDA semantic and instance heads with
    the thing mask, batch 6 at 512x1024, bfloat16 by the package default)
    on a Cityscapes-like train set of TRAIN_STEPS x 6 images and a val set
    of TRAIN_VAL_IMAGES made in memory: TRAIN_STEPS steps (an epoch; the
    first TRAIN_WARMUP are warm-up), a checkpoint under ``chiprun_out/``
    (deleted after), validation with losses at batch 2 (2 grouping
    launches a batch at 2x512x1024, each equal to the plain version, no
    layout copy; none in the steps). Then the run resumes from that
    checkpoint: the loaded tensors, Adam moments, step and generator state
    must be bit-equal to the saved ones, and it takes one more step. Then
    one float32 train step at 64x128 (ResNet-18, batch 2) from the same
    weights, batch and noise on the card and on the CPU: losses within
    1e-4 relative, BatchNorm running statistics within 1e-5. Then
    ``cfg/train_cityscapes_depth_only.yaml``'s values (ResNet-18, only
    RGB, batch 1 at 192x640) for DEPTH_ONLY_STEPS steps. Prints the step's
    median host-clock time and images/s, the loop's time a step, peak
    memory, the loader's item time, validation time per batch and the
    kernel's device time at 2x512x1024;
10. host mixup parts: ``Mixup.conf_instance_mixup`` on street-like label
    maps at 512x1024 with the yaml's ``conf_instance_mix`` (conf_thresh
    0.98, min_inst_size 2000), re-fused on the card once by the kernel
    and once by the plain grouping: equal RGB, semantic and instance maps,
    one launch, no layout copy, instances pasted. Then a 3-frame host
    mixup stream at 64x192 (source 64x128, ResNet-18, float32, thing
    logits and center bias shifted so that the pseudo-labels hold
    instances, min_inst_size scaled by the source's area) on the card and
    on the CPU from the same weights, samples and automask noise: PQ,
    mIoU and abs_rel within ``scripts/parity_e2e.py``'s tolerances and
    equal GT panoptic maps;
11. host mixup stream: phase 7's configuration with ``mixup_strategies:
    [cut_mixup, conf_instance_mixup]`` and the yaml's
    ``conf_instance_mix`` (HOST_MIXUP_FRAMES frames; the phase-7 weights
    with the thing logits shifted so that half of a frame's pixels are
    things, so that instances are pasted). Each frame launches the kernel
    four times (teacher eval, GT map, the pseudo-label stack of the two
    mixup items at 2x384x1408, the re-fusion at 1x512x1024), each equal
    to its plain version, with no layout copy. Prints the frame latency,
    frames/s, the main thread's time in ``_compose_mixups`` by part
    (prep, readback, each strategy, the re-fusion), instances pasted and
    valid centers per re-fusion, the peak memory against phase 7's fused
    stream, and the kernel's device time and bound at both new shapes;
12. scene flow: the flow head (``model.make_sflow`` with a live
    ``adapt.model.sflow``; an 8-channel ResNet-18 pose net taking RGB-D
    pairs, the other modules phase 4's) on (a) phase 6's adaptation step
    and batch, one warm-up and FLOW_STEPS timed steps in bfloat16 and in
    float32 from the same weights: finite flow losses, the student's
    target motion pair (2, 1, 384, 1408, 3) in the eval results, one
    launch a step with no layout copy; prints the step time, the peak
    memory and the auto-mask's kept share of pixels; (b) phase 7's
    stream with the flow head for FLOW_STREAM_FRAMES frames: 2 launches
    a frame, each equal to its plain version, no copy; frame latency,
    frames/s, peak memory; (c) phase 9's pretraining with the flow head
    (every frame of the batch through the encoder in one pass) for
    FLOW_TRAIN_STEPS steps at batch 6 at 512x1024, then validation with
    losses at batch 2 (2 launches a batch, each equal to its plain
    version); step time, images/s, peak memory; (d) one float32 flow
    adaptation step at 64x192 (ResNet-18) and one float32 flow train
    step at 64x128 (batch 2) from the same weights, batch and noise on
    the card and on the CPU: every flow-head call's auto-mask equal
    outside the tie band, the losses within FLOW_REL_TOL (REL_TOL for
    the frozen instance head's and the total, and for those through the
    mask if a pixel of the band flipped), the train step's BatchNorm
    statistics within 1e-5;
13. data parallel: (a) DDP_RANKS processes (``torch.multiprocessing``)
    share the card over gloo (NCCL refuses two ranks on one card), each
    in one process group, through ``run_training`` at phase 9's config
    (batch 6 a rank): DDP_STEPS steps, a checkpoint written by rank 0,
    validation with losses of DDP_VAL_IMAGES images (a global batch of 4
    as 2 rows a rank, and a tail of 1 evaluated whole on every rank, its
    GT map on rank 0), then a step resumed from the checkpoint on every
    rank (bit-equal state); the step metrics and the validation metrics
    must be the same on every rank, the kernel equal to its plain
    version on every call, 0 launches in the steps, 4 and 3 a validation
    on ranks 0 and 1, no layout copy. Prints the slowest rank's step
    time, global images/s, the gradient all-reduce's time a step (timed
    on its own), each rank's peak memory and launches; (b) one step of
    DDP_EXACT_ROWS rows a rank at 512x1024 against one process on all of
    them from the same weights and generator state, in float64 and in
    float32, held to ``ddp_bounds``; (c) NCCL as a world of one in this
    process: NCCL_STEPS steps and a validation;
14. spatial sharding (``tpu.spatial_shard``, ``parallel/spatial.py``):
    SPATIAL_RANKS processes share the card over gloo, each holding a slab
    of every image's rows. (a) One adaptation step of the published batch
    (target 1x384x1408 with 2 replay triplets, 2 source triplets and 2
    fused cut mixups with the camera warp at 512x1024, phase 7's weights)
    in float64 against one process (rank 0 under ``parallel.replicated``)
    on the same weights, batch and automask noise: losses, each live
    module's gradient and parameters within SPATIAL_F64_BOUND, replay
    features, ``sem_conf`` and the fused panoptic map equal; (b) the same
    in float32 (TF32 off) on SPATIAL_F32_BATCHES seeded batches: for
    each module the median over the batches of its gradient's distance
    from the one-process float64 step over the one-process float32
    step's, within SPATIAL_F32_FACTOR; then bfloat16 steps timed (row
    split and one process) and one
    with its halo exchanges, gathers and gradient all-reduce timed on
    their own. (c) phase 7's stream for SPATIAL_FRAMES frames through
    ``AdaptationRunner`` with the row split (rank 0 streams and
    broadcasts each batch, rank 1 follows) and in one process, in
    bfloat16 and with float64 modules: equal buffer ids in both; in
    float64 every panoptic map equal and PQ, mIoU and abs_rel within
    ``scripts/parity_e2e.py``'s tolerances (a slab's convolutions round
    otherwise than the whole frame's in bfloat16 and float32 on the
    card, and the steps carry it through the stream: bfloat16's meters
    are printed); the frame latency, the
    follower's step, the broadcast and the gathers a frame, peak memory
    a rank; the kernel 2 launches a frame on rank 0, 0 on rank 1, equal
    to its plain version on every call, no copy. (d) ``python -m
    torch.distributed.run --nproc_per_node 2 -m codeps_torch.scripts.adapt``
    on synthetic trees at SPATIAL_CLI_SIZE (ResNet-18): exit 0 with rank
    0's two files and buffer state only, and with ``model.make_sflow:
    true`` exit 0 with rank 0's two files; (e) SPATIAL_UNEVEN_RANKS
    ranks on the card, uneven slabs of whole 32-row blocks (target 4 / 4
    / 4 blocks, source 6 / 5 / 5): one float64 step of (a)'s batch
    against one process within SPATIAL_UNEVEN_BOUND, ``sem_conf`` and the
    panoptic map equal; (f) the scene-flow step (phase 12's flow head on
    (a)'s batch) split over SPATIAL_RANKS ranks against one process in
    float64 (within SPATIAL_F64_BOUND, the auto-mask's kept shares
    equal), SPATIAL_FLOW_TIMED_STEPS timed bfloat16 steps of each, and
    phase 7's stream with the flow head for SPATIAL_FLOW_FRAMES frames,
    split and in one process (the kept shares, meters and frame times
    printed; 2 launches a frame on rank 0, 0 on rank 1);
15. the ``kernels`` line (with the per-n times and bounds, the times at
    the CLI's, pretraining's, the host mixup path's and the flow paths'
    shapes and the launches and layout copies on each path), the
    ``adapt_step``, ``adapt_stream``, ``adapt_cli``, ``train``,
    ``host_mixup_stream``, ``step_graph``, ``flow``, ``ddp`` and
    ``spatial`` lines, the
    script's total wall seconds, then the last line ``{"ok": true,
    "device": {...}}``. Each phase's wall seconds are printed as it ends.

Every stream on the card that draws its automask noise from the step's
generator (phase 7's published, traced and uint8 streams, phase 8's CLI
stream, phase 11's and phase 12 (b)'s) runs the adaptation step through
its CUDA graph (``tasks/step_graph.py``): ``check_step_graph`` requires
each frame to take one eager step or one replay, at least one capture,
and a replay in the last frame, and prints the counts; the ``step_graph``
line of phase 15 holds them. The comparisons with the CPU inject their
noise and take the eager path.

The full-width runs compute in bfloat16, the package default
(``cfg.tpu.compute_dtype``, as the JAX package's); phase 6 also times the
step in float32. Every comparison of the card with the CPU runs in
float32.

Random weights from the JAX package's initialization scheme let the
activations grow block by block through ResNet-101 (eval-mode BatchNorm
with unit statistics normalizes nothing), which saturates every head. So
the BatchNorm statistics are first set from one forward pass over a seeded
frame (``calibrate_batch_norm``), as a trained model's would be.

The configuration is the port's adaptation defaults with the values of
``cfg/adapt_cityscapes_kitti_360.yaml`` set in code (feed size 384x1408;
the defaults already give ResNet-101, GUDA fusion, no thing mask,
``codeps`` labels and ImageNet normalization), so no YAML reader is
needed. The center conv's bias is shifted once, before the counted run,
so that the random weights put 0.02% of the pixels over the center
threshold: a few tens of centers, as a street scene has instances.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HEIGHT, WIDTH = 384, 1408
TOP_K = 200
# valid centers of the fixed grouping inputs (phases 3 and 5)
VALID_COUNTS = (0, 16, 64, 200)
NUM_FRAMES = 8
SEED = 0
THINGS = (9, 10, 11, 12, 13)
NUM_CLASSES = 14
# H100 SXM peaks (NVIDIA data sheet): HBM rate and FP32 off the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Card against CPU on one input: cuDNN may run float32 3x3 convolutions
# through Winograd or FFT algorithms, whose rounding error is larger than
# a direct sum's; the 240-channel GUDA conv then moves the semantic
# probabilities by about 1e-4 of their maximum (seen on an H100). The
# adaptation step's losses are means over such outputs and are held to
# the same relative bound.
REL_TOL = 1e-3
# Adaptation step (phase 6): cfg/adapt_cityscapes_kitti_360.yaml.
SOURCE_HEIGHT, SOURCE_WIDTH = 512, 1024
NUM_SOURCE = NUM_REPLAY = NUM_MIXUP = 2
ADAPT_STEPS = 5
# Pinhole intrinsics [fx, fy, cx, cy]: KITTI-360's rectified perspective
# camera 00 at 1408x376 and a Cityscapes camera at 2048x1024, scaled to
# the feed sizes.
KITTI_360_CAMERA = (552.554261, 552.554261 * 384 / 376, 682.049453,
                    238.769549 * 384 / 376)
CITYSCAPES_CAMERA = (2262.52 / 2, 2265.3017905988554 / 2, 1096.98 / 2,
                     513.137 / 2)
# Adaptation stream (phase 7): frames after the 0.7 adaptation split of a
# target sequence of STREAM_FRAMES / 0.7, source images, warm-up frames.
STREAM_FRAMES = 12
SOURCE_IMAGES = 8
WARMUP_FRAMES = 2
# stream frames profiled after the warm-up, for the card's busy share
PROFILED_FRAMES = 3
# a step replayed through the adaptation step's CUDA graph against the
# eager step: gradients and weights within this many times the eager
# path's own spread (float32 atomics in the bilinear and grid-sample
# backwards sum in another order each run)
GRAPH_SPREAD_FACTOR = 4.0
# full-size images of the two datasets, (W, H)
KITTI_360_FULL = (1408, 376)
CITYSCAPES_FULL = (2048, 1024)
# scripts/parity_e2e.py:52-54, PQ as a fraction
PQ_TOL, MIOU_TOL, ABS_REL_TOL = 0.005, 0.005, 0.005
# Adaptation CLI (phase 8): cfg/adapt_cityscapes_semkittidvps.yaml's feed
# size; a target sequence of CLI_FRAMES frames, of which the 0.7 split
# streams 8 and holds out 4, and a Cityscapes val of CLI_SOURCE_VAL images.
SEMKITTI_HEIGHT, SEMKITTI_WIDTH = 384, 1280
CLI_FRAMES = 12
CLI_SOURCE_VAL = 4
# SemanticKITTI sequence 07 (KITTI odometry 04-12): the full-size image,
# (W, H), and the left color camera's P2 in calib.txt
SEMKITTI_FULL = (1226, 370)
SEMKITTI_P2 = (707.0912, 0.0, 601.8873, 46.88783, 0.0, 707.0912, 183.1104,
               0.1178601, 0.0, 0.0, 1.0, 0.006203223)
# SemanticKITTI raw ids: building, vegetation, terrain, sidewalk, road
# bands; person and car rectangles
SEMKITTI_LABELS = {"stuff": (12, 14, 16, 10, 8), "thing_ids": (5, 0),
                   "stuff_instances": False}
# Pretraining (phase 9): cfg/train_cityscapes.yaml at its feed size, an
# epoch of TRAIN_STEPS steps of its batch (the first TRAIN_WARMUP not
# timed), a val set of TRAIN_VAL_IMAGES; cfg/train_cityscapes_depth_only
# .yaml's feed size and steps.
TRAIN_BATCH = 6
TRAIN_STEPS = 8
TRAIN_WARMUP = 2
TRAIN_VAL_IMAGES = 4
DEPTH_ONLY_SIZE = (192, 640)
DEPTH_ONLY_STEPS = 3
# card against CPU, one float32 train step: losses, BatchNorm statistics
TRAIN_REL_TOL = 1e-4
TRAIN_STAT_TOL = 1e-5
# other depth means, card against CPU (tests/test_torch_validate.py)
DEPTH_REL_TOL = 1e-3
# share of pixels whose argmax may flip between two float32 devices
NEAR_TIE_SHARE = 0.005
# Host mixup stream (phase 11): frames, and the yaml's conf_instance_mix;
# min_inst_size is in pixels of the 512x1024 source frame, so a smaller
# source scales it by its area.
HOST_MIXUP_FRAMES = 8
CONF_THRESH, MIN_INST_SIZE = 0.98, 2000
# share of the teacher's pixels that its shifted thing logits label as
# things, and share over the center threshold of the small stream's
# shifted center head
THING_SHARE = 0.5
CENTER_SHARE = 1e-3
# Scene flow (phase 12): timed adaptation steps after one warm-up, stream
# frames (the first WARMUP_FRAMES not timed), pretraining steps (the first
# TRAIN_WARMUP not timed). Card against CPU: losses within FLOW_REL_TOL
# where the auto-masks agree; a pixel whose mask differs must lie within
# TIE_BAND (relative) above the smallest norm its side kept.
FLOW_STEPS = 3
FLOW_STREAM_FRAMES = 6
FLOW_TRAIN_STEPS = 5
FLOW_REL_TOL = 1e-4
TIE_BAND = 1e-4
# phase 13, data-parallel pretraining: DDP_RANKS ranks share the card over
# gloo, DDP_STEPS steps of batch TRAIN_BATCH a rank (the first TRAIN_WARMUP
# not timed), validation of DDP_VAL_IMAGES at 2 a rank (a global batch of
# 4 and a tail of 1), a resumed step; (b) DDP_EXACT_ROWS a rank against one
# process on them all at full width, in float64 and in float32, held to
# DDP_BOUNDS (``ddp_bounds``): losses (relative), BatchNorm running
# statistics (max |diff| / (1 + max |value|)) and each module's gradient
# (relative L2); (c) NCCL_STEPS steps over NCCL as a world of one.
# float64 holds the data-parallel step to the one-process step's rounding.
# In float32 the ranks' BatchNorm runs torch's SyncBN kernels and the one
# process's cuDNN's, and 100 train-mode BatchNorm layers of ResNet-101 at
# random weights amplify either's rounding far past the float32 bounds
# below; so float32 holds the data-parallel step's distance from the
# float64 step to the larger of those bounds and DDP_F32_FACTOR times the
# one-process float32 step's own distance from it. Two such roundings
# differ by chance: the 64x128 ResNet-18 CPU rehearsal gave a ratio of
# 2.34 on the pose head (48 elements a channel in layer4), hence 4; a
# fault of the data-parallel step (a scale, a missing reduction) moves
# the gradients by O(1).
DDP_RANKS = 2
DDP_STEPS = 4
DDP_VAL_IMAGES = 5
DDP_EXACT_ROWS = 3
DDP_BOUNDS = {"float32": {"loss_rel": 1e-4, "stat_err": 1e-5,
                          "grad_rel_l2": 1e-3},
              "float64": {"loss_rel": 1e-6, "stat_err": 1e-10,
                          "grad_rel_l2": 1e-6}}
DDP_F32_FACTOR = 4.0
NCCL_STEPS = 3
# phase 14, spatial sharding: SPATIAL_RANKS ranks share the card over gloo.
# (a) one float64 step of the published batch (the fused cut mixup with
# the camera warp) against one process, within SPATIAL_F64_BOUND; (b) the
# same in float32, each module's gradient within SPATIAL_F32_FACTOR times
# the one-process float32 step's distance from the float64 step; (c)
# SPATIAL_FRAMES frames of phase 7's stream against one process (the
# runner's hybrid placement); (d) the torchrun CLI on a ResNet-18 config
# at SPATIAL_CLI_SIZE for SPATIAL_CLI_FRAMES frames; (g) the hybrid
# placement (side domains by images): one float64 step against one
# process within SPATIAL_F64_BOUND, SPATIAL_TIMED_STEPS timed bfloat16
# steps of the hybrid, the pure-row and the one-process step in turns,
# one instrumented step of each placement, and (c)'s stream under pure
# rows.
SPATIAL_RANKS = 2
SPATIAL_F64_BOUND = 1e-9
SPATIAL_F32_FACTOR = 1.5
# (b) holds the median over SPATIAL_F32_BATCHES seeded batches of each
# module's ratio: on the card a slab's float32 convolutions round
# otherwise than the whole frame's (cuDNN chooses by shape; two
# one-process runs agree to 1e-7), and the automask's minimum and the
# warp's taps turn such rounding into jumps of the pose gradients of a
# few percent, as they do float32's own rounding; one batch's ratio
# scatters (0.58-3.8 on the pose head over the batches measured)
SPATIAL_F32_BATCHES = 5
SPATIAL_TIMED_STEPS = 3
SPATIAL_FRAMES = 6
SPATIAL_CLI_SIZE = (64, 192)
SPATIAL_CLI_FRAMES = 3
# (e) one float64 step on SPATIAL_UNEVEN_RANKS ranks under the hybrid
# placement, which puts every domain by rows (2 side samples do not divide
# over 3): the target's 12 blocks split 4 / 4 / 4, the source's 16 blocks
# 6 / 5 / 5; held to SPATIAL_UNEVEN_BOUND of one process
SPATIAL_UNEVEN_RANKS = 3
SPATIAL_UNEVEN_BOUND = 1e-12
# (f) the flow step on SPATIAL_RANKS ranks: float64 against one process,
# SPATIAL_FLOW_TIMED_STEPS timed bfloat16 steps after a warm-up, and
# SPATIAL_FLOW_FRAMES frames of the flow stream
SPATIAL_FLOW_TIMED_STEPS = 2
SPATIAL_FLOW_FRAMES = 4
# (h) fewer 32-row blocks than ranks, the last ranks' slabs empty, gloo
# ranks sharing the card as in (e): (h1) one float64 step of the published
# batch at the published widths on SPATIAL_EMPTY_RANKS ranks, the target
# at SPATIAL_EMPTY_SIZES[0] (3 blocks: 1 / 1 / 1 / 0) and the source and
# mixup at SPATIAL_EMPTY_SIZES[1] (2 blocks: 1 / 1 / 0 / 0), under the
# hybrid placement (all rows), held to SPATIAL_UNEVEN_BOUND of one
# process; (h2) the published 384x1408 frame on SPATIAL_WIDE_RANKS ranks,
# two 8-card nodes' count (target 12 blocks: 4 ranks empty; source 16):
# the float64 teacher eval's maps equal to one process's, then
# SPATIAL_WIDE_TIMED_STEPS timed bfloat16 steps under the hybrid
# placement after an instrumented warm-up (some 50 s a step: 16 gloo
# ranks on 8 cores)
SPATIAL_EMPTY_RANKS = 4
SPATIAL_EMPTY_SIZES = ((96, WIDTH), (64, SOURCE_WIDTH))
SPATIAL_WIDE_RANKS = 16
SPATIAL_WIDE_TIMED_STEPS = 1


def phase(name):
    """Prints the wall seconds of the phase before (if any), then the
    header of ``name`` (None after the last phase)."""
    now = time.perf_counter()
    if phase.current is not None:
        print(f"phase {phase.current}: wall {now - phase.started:.3f} s",
              flush=True)
    phase.current, phase.started = name, now
    if name is not None:
        print(f"== {name}", flush=True)


phase.current = None
phase.started = 0.0


def slice_config():
    from codeps_torch.config import get_cfg_defaults_adapt
    cfg = get_cfg_defaults_adapt()
    # cfg/adapt_cityscapes_kitti_360.yaml, dataset section
    cfg.dataset.name = "kitti_360"
    cfg.dataset.feed_img_size = [HEIGHT, WIDTH]
    cfg.dataset.sequences = ["03"]
    assert cfg.model.po_depth_net.params.nof_layers == 101
    assert cfg.model.semantic_head.use_guda_fusion
    assert not cfg.model.instance_head.use_thing_mask
    assert cfg.dataset.label_mode == "codeps"
    assert cfg.dataset.normalization.active
    return cfg


def grouping_cases(torch, device):
    """(name, centers (B, K, 2), valid (B, K), offsets (B, H, W, 2))."""
    import numpy as np
    rng = np.random.default_rng(SEED)

    def image(valid_share, nan_share=0.0, duplicates=False):
        yx = rng.uniform([0, 0], [HEIGHT, WIDTH], (TOP_K, 2))
        valid = rng.random(TOP_K) < valid_share
        offsets = rng.normal(0, 20, (HEIGHT, WIDTH, 2))
        if nan_share:
            offsets[rng.random((HEIGHT, WIDTH)) < nan_share] = np.nan
        if duplicates:
            yx = np.round(yx)
            yx[1::2] = yx[0::2]
            offsets = np.round(offsets)
        return (yx.astype(np.float32), valid,
                offsets.astype(np.float32))

    cases = [("B=1 random, 70% valid", [image(0.7)]),
             ("B=1 NaN offsets, duplicate centers",
              [image(0.9, nan_share=0.02, duplicates=True)]),
             ("B=2 random + no valid center", [image(0.5), image(0.0)])]
    for name, images in cases:
        yield (name, *(torch.from_numpy(np.stack(parts)).to(device)
                       for parts in zip(*images)))


def fixed_grouping_inputs(torch, device, num_valid):
    """Grouping inputs that do not depend on the model: centers (1, K, 2)
    uniform over the image, of which the first ``num_valid`` are valid
    (the prefix layout of ``find_instance_centers_batch``), and offsets
    ~ N(0, 20) px as the NHWC view (1, H, W, 2) of an NCHW tensor, the
    layout the instance head hands to fusion. The same draws for every
    ``num_valid``."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    planes = rng.normal(0, 20, (1, 2, HEIGHT, WIDTH)).astype(np.float32)
    yx = rng.uniform([0, 0], [HEIGHT, WIDTH], (1, TOP_K, 2))
    valid = np.arange(TOP_K)[None] < num_valid
    return (torch.from_numpy(yx.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(planes).to(device).permute(0, 2, 3, 1))


def grouping_bound(num_valid):
    """(bound_ms, bound_by, bytes, operations) of grouping one
    HEIGHTxWIDTH image against TOP_K slots of which ``num_valid`` are
    valid: offsets read and ids written once (12 bytes a pixel), centers
    and flags read once; 5 FP32 operations per (pixel, valid center)."""
    pixels = HEIGHT * WIDTH
    moved = pixels * (8 + 4) + TOP_K * (8 + 1)
    ops = 5 * pixels * num_valid
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms > bytes_ms else "bytes", moved, ops)


def grouping_bound_batch(batch, height, width, valid_per_image):
    """(bound_ms, bound_by) of grouping a (batch, height, width) map against
    TOP_K slots an image, with the images' valid-center counts: offsets
    read and ids written once, centers and flags read once; 5 FP32
    operations per (pixel, valid center)."""
    moved = batch * (height * width * (8 + 4) + TOP_K * (8 + 1))
    ops = 5 * height * width * sum(valid_per_image)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms > bytes_ms else "bytes")


def time_grouping_call(torch, call):
    """(device ms, bound ms, bound by, valid centers) of one recorded
    grouping call (yx, valid, offsets)."""
    from codeps_torch.ops import grouping
    yx, valid, offsets = call
    ms = device_ms(torch, lambda: grouping.group_pixels_cuda(
        yx, valid, offsets), iters=100)
    counts = [int(v) for v in valid.sum(1)]
    bound_ms, bound_by = grouping_bound_batch(*offsets.shape[:3], counts)
    return ms, bound_ms, bound_by, counts


def calibrate_batch_norm(torch, modules, image):
    """Set every BatchNorm's running statistics to the mean and the
    unbiased variance of its input on ``image`` (B, H, W, 3 uint8), as
    torch's own BatchNorm update sets them: one forward in train mode,
    then back to eval. (The port's train-mode update takes Flax's biased
    variance. Calibrated with it, phase 6's 64x192 replay features of
    these random weights, pooled from a network calibrated on the image
    it evaluates, nearly cancel, and the card and the CPU then differ
    by twice the bound of that check.)"""
    from codeps_torch.ops.normalize import maybe_normalize
    norms = [m for m in modules.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    stats = {}

    def capture(bn, args):
        stats[bn] = torch.var_mean(args[0].float(), dim=(0, 2, 3),
                                   correction=1)
    hooks = [bn.register_forward_pre_hook(capture) for bn in norms]
    x = maybe_normalize(torch.from_numpy(image).to(
        next(modules.parameters()).device)).permute(0, 3, 1, 2)
    modules.train()
    try:
        with torch.no_grad():
            modules.instance_head(modules.backbone_po_depth(x))
    finally:
        modules.eval()
        for hook in hooks:
            hook.remove()
    with torch.no_grad():
        for bn in norms:
            bn.reset_running_stats()
            if bn in stats:
                var, mean = stats[bn]
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)


def call_ms(torch, fn, iters, warmup):
    """Time per call of ``fn`` with CUDA events around a loop of calls:
    the host's launch overhead included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device time of one call of ``fn`` (a single kernel launch).

    A call of a few microseconds on the card costs more than that on the
    host (Python, checks, the launch itself), so events around a loop of
    calls measure the host. Here a sleep kernel first keeps the card busy
    while the host queues all ``iters`` calls; the events then see only
    the calls' own work.
    """
    host_ms = call_ms(torch, fn, iters, warmup=3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    sleep_ms = 2 * host_ms * iters + 5
    torch.cuda._sleep(int(cycles_per_ms * sleep_ms))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # the host must have queued everything before the sleep ran out
    assert queued_ms < sleep_ms, (queued_ms, sleep_ms)
    return start.elapsed_time(end) / iters


def check_outputs(torch, result, batch, height, width):
    shapes = {"depth": (batch, height, width, 1),
              "semantic_soft": (batch, height, width, NUM_CLASSES),
              "semantic": (batch, height, width),
              "center": (batch, height, width, 1),
              "offset": (batch, height, width, 2),
              "panoptic": (batch, height, width),
              "instance": (batch, height, width)}
    for key, shape in shapes.items():
        value = result[key]
        assert tuple(value.shape) == shape, (key, value.shape)
        if value.is_floating_point():
            assert bool(torch.isfinite(value).all()), f"{key} not finite"
    assert result["semantic"].dtype == torch.int32
    assert result["panoptic"].dtype == result["instance"].dtype == torch.int32
    depth = result["depth"]
    assert bool(((depth >= 0.1 - 1e-4) & (depth <= 100.0 + 1e-3)).all())
    sums = result["semantic_soft"].sum(-1)
    assert bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-4))


def adapt_config(target_size, source_size):
    """The slice config with cfg/adapt_cityscapes_kitti_360.yaml's adapt
    section set in code."""
    cfg = slice_config()
    cfg.dataset.feed_img_size = list(target_size)
    flags = cfg.adapt.model
    flags.backbone_po_depth = False
    flags.backbone_pose_sflow = flags.depth = flags.pose = True
    flags.sflow = False
    flags.semantic = True
    flags.instance = False
    cfg.adapt.ema.alpha = 0.99
    cfg.adapt.ema.semantic = True
    cfg.adapt.ema.instance = False
    cfg.adapt.source_dataset.feed_img_size = list(source_size)
    cfg.adapt.replay_sampler.nof_source_samples = NUM_SOURCE
    cfg.adapt.replay_sampler.nof_target_samples = NUM_REPLAY
    cfg.adapt.mixup.general.mixup_strategies = ["cut_mixup", "cut_mixup"]
    cfg.adapt.mixup.general.nof_samples = NUM_MIXUP
    cfg.train.nof_adaptation_steps = 1
    return cfg


def adapt_batch(rng, target_size, source_size):
    """One step's batch in the step's layout (uint8 frames, NHWC)."""
    import numpy as np
    (ht, wt), (hs, ws) = target_size, source_size

    def frames(n, h, w):
        return rng.integers(0, 256, (n, 3, h, w, 3), dtype=np.uint8)

    def camera(n, intrinsics):
        return np.tile(np.asarray([intrinsics], np.float32), (n, 1))

    return {
        "target": {"frames": frames(1, ht, wt),
                   "camera": camera(1, KITTI_360_CAMERA)},
        "target_replay": {"frames": frames(NUM_REPLAY, ht, wt),
                          "camera": camera(NUM_REPLAY, KITTI_360_CAMERA)},
        "source": {
            "frames": frames(NUM_SOURCE, hs, ws),
            "camera": camera(NUM_SOURCE, CITYSCAPES_CAMERA),
            "semantic": rng.integers(0, NUM_CLASSES, (NUM_SOURCE, hs, ws),
                                     dtype=np.int32),
            "semantic_weights": rng.uniform(
                1.0, 3.0, (NUM_SOURCE, hs, ws)).astype(np.float32),
            "center": rng.uniform(0, 1, (NUM_SOURCE, hs, ws, 1)).astype(
                np.float32),
            "offset": rng.normal(0, 20, (NUM_SOURCE, hs, ws, 2)).astype(
                np.float32),
        },
        "mixup": {
            "rgb": rng.integers(0, 256, (NUM_MIXUP, hs, ws, 3),
                                dtype=np.uint8),
            "semantic": rng.integers(0, NUM_CLASSES, (NUM_MIXUP, hs, ws),
                                     dtype=np.int32),
        },
        "eval_gt": {
            "semantic": rng.integers(0, NUM_CLASSES, (1, ht, wt),
                                     dtype=np.int32),
            "depth_gt": rng.uniform(1.0, 80.0, (1, ht, wt)).astype(
                np.float32),
        },
    }


def build_adapt(torch, modules, cfg, device):
    """(AdaptState on ``device``, the step) for ``modules``."""
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    from codeps_torch.tasks.adapt_loop import adapt_module_lists
    from codeps_torch.tasks.state import make_adapt_state
    frozen, ema = adapt_module_lists(cfg, modules.module_names())
    state = make_adapt_state(modules, cfg.train.optimizer.learning_rate,
                             ema_modules=ema, frozen_modules=frozen,
                             ema_alpha=cfg.adapt.ema.alpha, seed=SEED,
                             device=device)
    step = make_adapt_step(
        cfg, list(cfg.semantics.class_weights), has_replay=True,
        num_mixup=NUM_MIXUP,
        mixup_groups=(("cut_mixup", NUM_MIXUP),),
        eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))
    return state, step


def automask_noise(torch, rng, target_size, source_size, num_scales):
    """Automask normals for one step in the order the step asks for them
    (source scales, then target scales), as numpy arrays."""
    import numpy as np
    shapes = [(NUM_SOURCE, 2, source_size[0] >> s, source_size[1] >> s)
              for s in range(num_scales)]
    shapes += [(1 + NUM_REPLAY, 2, target_size[0] >> s, target_size[1] >> s)
               for s in range(num_scales)]
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in shapes]


def injected(torch, arrays, device):
    arrays = list(arrays)

    def noise(shape):
        draw = arrays.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(draw).to(device)
    return noise


def check_adapt_outputs(torch, metrics, results, stats, height, width):
    for key, value in metrics.items():
        if key != "target_skipped":
            assert bool(torch.isfinite(value)), f"loss {key} not finite"
    for key in ("d_abs_rel", "d_sq_rel", "d_rmse", "d_rmse_log", "d_a1"):
        assert bool(torch.isfinite(stats[key])), f"{key} not finite"
    conf_sum = int(stats["sem_conf"].sum())
    assert conf_sum == height * width, conf_sum
    check_outputs(torch, results, 1, height, width)


def stream_config(target_size, source_size, layers=101, uint8=False):
    """The adapt config with the rest of cfg/adapt_cityscapes_kitti_360.yaml
    set in code (the replay sampler and buffers, the cut-mixup grid, the
    adaptation split); with ``uint8`` the frames go to the card as uint8
    (``normalization.uint8_transfer``, which the yaml leaves off)."""
    cfg = adapt_config(target_size, source_size)
    cfg.model.po_depth_net.params.nof_layers = layers
    cfg.dataset.path = cfg.adapt.source_dataset.path = "(in memory)"
    cfg.adapt.source_dataset.name = "cityscapes"
    # gen_config copies these dataset settings to the source
    for key in ("center_heatmap_sigma", "return_only_rgb",
                "small_instance_area_full_res", "small_instance_weight",
                "remove_classes", "label_mode", "augmentation",
                "normalization"):
        cfg.adapt.source_dataset[key] = cfg.dataset[key]
    cfg.adapt.target_dataset_adapt_ratio = 0.7
    cfg.adapt.replay_sampler.seed = 42
    cfg.adapt.replay_buffer.seed = 20
    cfg.adapt.replay_buffer.source_size = 300
    cfg.adapt.replay_buffer.target_size = 300
    cfg.adapt.replay_buffer.maximize_diversity = True
    cfg.adapt.replay_buffer.similarity_threshold = 0.95
    cfg.adapt.mixup.general.geom_augment = True
    cfg.adapt.mixup.cut_mix.nof_hor_splits = 4
    cfg.adapt.mixup.cut_mix.nof_vert_splits = 2
    cfg.adapt.mixup.cut_mix.nof_segments = 2
    # a transport setting: the card normalizes with the host's arithmetic,
    # so the model sees the same floats (tests/test_torch_data.py)
    cfg.dataset.normalization.uint8_transfer = uint8
    cfg.adapt.source_dataset.normalization = cfg.dataset.normalization
    return cfg


def scaled_camera(camera, full_size, size):
    """Intrinsics ``camera`` of an image of ``full_size`` (H, W) at
    ``size``."""
    sy, sx = size[0] / full_size[0], size[1] / full_size[1]
    return (camera[0] * sx, camera[1] * sy, camera[2] * sx, camera[3] * sy)


def street_labels(rng, height, width, things, stuff=(23, 11, 21, 8, 7),
                  thing_ids=(24, 26), stuff_instances=True):
    """Raw label ids (uint8) and instance ids (uint16) of a street-like
    frame: five bands of ``stuff`` ids (by default KITTI-360's and
    Cityscapes' sky, building, vegetation, sidewalk, road) and ``things``
    rectangles alternating between the two ``thing_ids`` (people and
    cars), both always present. A thing's instance id is its raw id *
    1000 + its number; stuff pixels carry raw id * 1000, or 0 without
    ``stuff_instances``."""
    import numpy as np
    semantic = np.empty((height, width), np.uint8)
    for (top, bottom), raw in zip(((0, 0.2), (0.2, 0.45), (0.45, 0.55),
                                   (0.55, 0.7), (0.7, 1.0)), stuff):
        semantic[int(top * height):int(bottom * height)] = raw
    instance = semantic.astype(np.uint16) * 1000 if stuff_instances \
        else np.zeros((height, width), np.uint16)
    for i in range(things):
        raw = thing_ids[i % 2]
        h = int(rng.integers(height // 10, height // 3))
        w = int(rng.integers(width // 40, width // 8))
        y = int(rng.integers(height // 3, height - h))
        x = int(rng.integers(0, width - w))
        semantic[y:y + h, x:x + w] = raw
        instance[y:y + h, x:x + w] = raw * 1000 + i + 1
    return semantic, instance


def memory_sequence(rng, n, height, width, **labels):
    """(frames, labels): n + 2 uint8 frames (n centers and their two
    neighbours) and n street-like label maps (``street_labels`` with
    ``labels``) drawn from ``rng``."""
    import numpy as np
    images = rng.integers(0, 256, (n + 2, height, width, 3), dtype=np.uint8)
    return images, [street_labels(rng, height, width, 6, **labels)
                    for _ in range(n)]


def memory_depths(rng, n, height, width):
    """n sparse metric depth maps (5% of the pixels, 2-79 m), as projected
    LiDAR is."""
    import numpy as np
    return [np.where(rng.random((height, width)) < 0.05,
                     rng.uniform(2.0, 79.0, (height, width)),
                     0.0).astype(np.float32) for _ in range(n)]


def memory_cityscapes(source_cfg, mode, count, rng):
    """The port's Cityscapes reader in ``mode`` on ``count`` images made
    in memory from ``rng`` at the config's feed size (``_read`` replaced;
    everything after the file decoding is the reader's own); it counts its
    class distribution where the reader loads the pickled one."""
    from codeps_torch.data.cityscapes import Cityscapes
    from codeps_torch.data.dataset import Dataset, class_distribution

    class MemoryCityscapes(Cityscapes):
        def __init__(self):
            Dataset.__init__(self, "cityscapes", [mode], mode, source_cfg)
            height, width = self.image_size
            self.images, self.labels = memory_sequence(rng, count, height,
                                                       width)
            self.frame_paths = [{"frame": i} for i in range(count)]
            full = CITYSCAPES_FULL[::-1]
            fx, fy, cx, cy = scaled_camera(CITYSCAPES_CAMERA,
                                           (SOURCE_HEIGHT, SOURCE_WIDTH),
                                           full)
            self.camera = {"intrinsic": {"fx": fx, "fy": fy, "u0": cx,
                                         "v0": cy},
                           "extrinsic": {"baseline": 0.209313}}
            self.distribution = None

        def _read(self, index, with_labels):
            n = self.frame_paths[index]["frame"]
            out = {"rgb": {0: self.images[n + 1], -1: self.images[n],
                           1: self.images[n + 2]},
                   "image_size": CITYSCAPES_FULL, "camera": self.camera}
            if with_labels:
                out["semantic"], out["instance"] = self.labels[n]
            return out

        def load_class_distribution(self):
            if self.distribution is None:
                self.distribution = class_distribution(self)
            return self.distribution

    return MemoryCityscapes()


def stream_datasets(cfg, frames, source_images, seed):
    """(target, source): the port's KITTI-360 and Cityscapes readers on
    frames made in memory from ``seed`` at the config's feed sizes (their
    ``_read`` replaced; everything after the file decoding is the
    readers' own). The target has ``frames`` / 0.7 frames so that
    ``frames`` remain after the adaptation split; its depth GT is sparse,
    as projected LiDAR is."""
    import numpy as np
    from codeps_torch.data.dataset import Dataset
    from codeps_torch.data.kitti_360 import Kitti360
    rng = np.random.default_rng(seed)

    class MemoryKitti360(Kitti360):
        def __init__(self):
            Dataset.__init__(self, "kitti_360", ["sequence"], "sequence",
                             cfg.dataset, return_depth=True)
            self.sequence_reference_mode = "rgb"
            self.semantic_seq_mode_image_skipped = []
            self.sequences = list(cfg.dataset.sequences)
            height, width = self.image_size
            n = int(np.ceil(frames / 0.7))
            self.images, self.labels = memory_sequence(rng, n, height, width)
            self.depths = memory_depths(rng, n, height, width)
            self.frame_paths = [{"frame": i} for i in range(n)]
            self.camera_model = np.asarray(scaled_camera(
                KITTI_360_CAMERA, (HEIGHT, WIDTH), self.image_size),
                np.float32)

        def _read(self, index, with_labels):
            n = self.frame_paths[index]["frame"]
            out = {"rgb": {0: self.images[n + 1], -1: self.images[n],
                           1: self.images[n + 2]},
                   "image_size": KITTI_360_FULL}
            if with_labels:
                out["semantic"], out["instance"] = self.labels[n]
                out["depth"] = self.depths[n]
            return out

    target = MemoryKitti360()
    return target, memory_cityscapes(cfg.adapt.source_dataset, "train",
                                     source_images, rng)


def semkitti_config(target_size, source_size, layers=101):
    """cfg/adapt_cityscapes_semkittidvps.yaml's values set in code: those
    of the KITTI-360 yaml (``stream_config``) but for the dataset section.
    The source buffer takes all SOURCE_IMAGES images by the published
    rare-class sampling (the yaml's 300 of Cityscapes' 2975)."""
    cfg = stream_config(target_size, source_size, layers=layers)
    cfg.dataset.name = "sem_kitti_dvps"
    cfg.dataset.sequences = ["07"]
    cfg.adapt.replay_buffer.source_size = SOURCE_IMAGES
    return cfg


def semkitti_datasets(cfg, seed):
    """(target, held-out target, source, source val): the port's
    SemKITTI-DVPS and Cityscapes readers on data made in memory from
    ``seed`` at the config's feed sizes (their ``_read`` replaced;
    everything after the file decoding, the camera from P2 included, is
    the readers' own). Both target readers read one sequence of
    CLI_FRAMES frames, which the replay buffers split at 0.7."""
    import numpy as np
    from codeps_torch.data.dataset import Dataset
    from codeps_torch.data.sem_kitti_dvps import SemKittiDvps
    rng = np.random.default_rng(seed)
    height, width = cfg.dataset.feed_img_size
    images, labels = memory_sequence(rng, CLI_FRAMES, height, width,
                                     **SEMKITTI_LABELS)
    depths = memory_depths(rng, CLI_FRAMES, height, width)

    class MemorySemKittiDvps(SemKittiDvps):
        def __init__(self):
            Dataset.__init__(self, "sem_kitti_dvps", ["sequence"],
                             "sequence", cfg.dataset, return_depth=True)
            self.sequences = list(cfg.dataset.sequences)
            self.frame_paths = [{"frame": i} for i in range(CLI_FRAMES)]

        def _read(self, index, with_labels):
            n = self.frame_paths[index]["frame"]
            out = {"rgb": {0: images[n + 1], -1: images[n],
                           1: images[n + 2]},
                   "image_size": SEMKITTI_FULL, "p2": list(SEMKITTI_P2)}
            if with_labels:
                out["semantic"], out["instance"] = labels[n]
                out["depth"] = depths[n]
            return out

    target, val_target = MemorySemKittiDvps(), MemorySemKittiDvps()
    source = memory_cityscapes(cfg.adapt.source_dataset, "train",
                               SOURCE_IMAGES, rng)
    source_val = memory_cityscapes(cfg.adapt.source_dataset, "val",
                                   CLI_SOURCE_VAL, rng)
    return target, val_target, source, source_val


def drive_cli(torch, cfg, datasets, checkpoint, saved, device):
    """``scripts/adapt.run_adaptation`` of the port on ``datasets`` from
    ``checkpoint`` on ``device``, with the grouping counts set to 0 just
    before each of its parts (the stream, the held-out target validation,
    the source validation) and read just after. Every module the CLI loads
    must equal ``saved`` (the checkpoint's state dicts) bit for bit. Every
    grouping call and every (GT, prediction) map the PQ meters take is
    kept, by part, and each call is checked against the plain version.
    Returns (the CLI's result, the parts' numbers)."""
    import numpy as np
    from codeps_torch.evaluation.panoptic_metrics import PanopticEvaluator
    from codeps_torch.ops import grouping
    from codeps_torch.ops import panoptic as panoptic_ops
    from codeps_torch.scripts import adapt as adapt_cli
    from codeps_torch.tasks.adapt_loop import AdaptationRunner
    parts, current = {}, [None]
    group_pixels = panoptic_ops.group_pixels
    load = adapt_cli.pretrained_from_checkpoints
    validate = adapt_cli.run_validation
    run = AdaptationRunner.run
    update = PanopticEvaluator.update

    def recording(yx, valid, offsets):
        out = group_pixels(yx, valid, offsets)
        parts[current[0]]["calls"].append(
            (yx.clone(), valid.clone(), offsets.clone(), out))
        return out

    def recording_update(self, pan_gt, pan_pred):
        parts[current[0]]["pq_maps"].append((pan_gt.copy(), pan_pred.copy()))
        update(self, pan_gt, pan_pred)

    def counted(name, fn):
        current[0] = name
        parts[name] = {"calls": [], "pq_maps": []}
        torch.cuda.synchronize()
        grouping.group_pixels_cuda.launches = 0
        grouping.group_pixels_cuda.copies = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name].update(seconds=time.perf_counter() - t0,
                           launches=grouping.group_pixels_cuda.launches,
                           copies=grouping.group_pixels_cuda.copies)
        return out

    def checked_load(specs, modules, cfg):
        names = load(specs, modules, cfg)
        tensors = 0
        for name in names:
            for key, value in getattr(modules, name).state_dict().items():
                assert torch.equal(value.cpu(), saved[name][key]), \
                    f"loaded {name}.{key} != saved"
                tensors += 1
        parts["load"] = {"modules": names, "tensors": tensors}
        return names

    def counted_run(self, *args, **kwargs):
        parts["runner"] = self
        return counted("stream", lambda: run(self, *args, **kwargs))

    def counted_validation(cfg, teacher, loader, *args, **kwargs):
        name = "source_val" if "target_val" in parts else "target_val"
        marks = []

        def timed():
            for batch in loader:
                marks.append(time.perf_counter())
                yield batch
            marks.append(time.perf_counter())

        metrics = counted(name, lambda: validate(cfg, teacher, timed(),
                                                 *args, **kwargs))
        parts[name]["batch_s"] = [float(t) for t in np.diff(marks)]
        return metrics

    panoptic_ops.group_pixels = recording
    PanopticEvaluator.update = recording_update
    adapt_cli.pretrained_from_checkpoints = checked_load
    adapt_cli.run_validation = counted_validation
    AdaptationRunner.run = counted_run
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = adapt_cli.run_adaptation(
            cfg, *datasets, checkpoints=[str(checkpoint)], device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        panoptic_ops.group_pixels = group_pixels
        PanopticEvaluator.update = update
        adapt_cli.pretrained_from_checkpoints = load
        adapt_cli.run_validation = validate
        AdaptationRunner.run = run
    parts["seconds"] = seconds
    parts["peak"] = torch.cuda.max_memory_allocated()
    for name in ("stream", "target_val", "source_val"):
        part = parts[name]
        part["shapes"] = sorted({tuple(off.shape[:3]) for _, _, off, _
                                 in part["calls"]})
        part["centers"] = [int(v.sum()) for _, v, _, _ in part["calls"]]
        part["max_abs_err"] = 0
        for yx, valid, offsets, out in part["calls"]:
            ref = grouping.group_pixels_plain(yx, valid, offsets)
            part["max_abs_err"] = max(part["max_abs_err"], int(
                (out.long() - ref.long()).abs().max()))
            assert torch.equal(out, ref), f"kernel != plain in {name}"
        part["last_call"] = part["calls"][-1][:3]
        del part["calls"]
    return result, parts


def validation_breakdown(torch, cfg, teacher, dataset, thing_list,
                         stuff_list, ignore_classes):
    """Host-clock ms of the parts of a validation batch, each on its own
    over every item of ``dataset`` (batch 1), medians: the loader's item
    (``__getitem__`` and collate), the upload, the eval forward and the
    GT map (each synchronized), and the readback with the host's PQ
    accumulation."""
    from codeps_torch.data.loader import collate_batch
    from codeps_torch.evaluation.panoptic_metrics import PanopticEvaluator
    from codeps_torch.tasks.adapt import make_eval_step, make_gt_panoptic_step
    from codeps_torch.tasks.validate import _to_device
    device = next(teacher.parameters()).device
    eval_step = make_eval_step(cfg, thing_list, teacher.num_classes,
                               ignore_classes)
    gt_panoptic = make_gt_panoptic_step(thing_list, teacher.num_classes)
    evaluator = PanopticEvaluator(list(stuff_list), list(thing_list))
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for index in range(len(dataset)):
        batch_np = timed("item", lambda: collate_batch([dataset[index]]))
        batch = timed("upload", lambda: _to_device(batch_np, device))
        results, stats = timed("eval", lambda: eval_step(teacher, batch))
        pan_gt = timed("gt_map", lambda: gt_panoptic(
            batch["semantic"], batch["center"], batch["offset"]))
        timed("readback_pq", lambda: evaluator.update(
            pan_gt.cpu().numpy(), results["panoptic"].cpu().numpy()))
    return {name: statistics.median(t) for name, t in times.items()}


def small_validation(torch, device, rng):
    """``run_validation`` of one ResNet-18 model at 64x192 over the first
    2 batches of the in-memory SemKITTI-DVPS held-out split, on
    ``device`` and on the CPU: (metrics, (GT, prediction) maps) per
    device."""
    from codeps_torch.data.loader import DataLoader
    from codeps_torch.data.replay_buffer import ReplayBuffer
    from codeps_torch.evaluation.panoptic_metrics import PanopticEvaluator
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.tasks.adapt import make_eval_step
    from codeps_torch.tasks.validate import run_validation
    import numpy as np
    size = (64, 192)
    cfg = semkitti_config(size, (64, 128), layers=18)
    cfg.tpu.compute_dtype = "float32"
    _, val_target, _, _ = semkitti_datasets(cfg, SEED)
    val = ReplayBuffer(val_target, cfg.adapt, mode="val")
    cpu_modules = init_params(build_modules(cfg, NUM_CLASSES, device="cpu"),
                              seed=SEED, device="cpu")
    frame = rng.integers(0, 256, (1, *size, 3), dtype=np.uint8)
    calibrate_batch_norm(torch, cpu_modules, frame)
    # a few centers a frame: 1% of the pixels over the center threshold
    results, _ = make_eval_step(cfg, THINGS, NUM_CLASSES)(
        cpu_modules, {"image": torch.from_numpy(frame)})
    shift = float(0.1 - torch.quantile(results["center"].flatten(), 0.99))
    with torch.no_grad():
        cpu_modules.instance_head.center_head.net.conv.bias.add_(shift)
    card_modules = copy.deepcopy(cpu_modules).to(device)
    update = PanopticEvaluator.update
    out = {}
    try:
        for name, mods in (("card", card_modules), ("cpu", cpu_modules)):
            maps = []

            def recording_update(self, pan_gt, pan_pred):
                maps.append((pan_gt.copy(), pan_pred.copy()))
                update(self, pan_gt, pan_pred)
            PanopticEvaluator.update = recording_update
            metrics = run_validation(
                cfg, mods, DataLoader(val, batch_size=1, offsets=[1],
                                      shuffle=False),
                val.thing_classes, val.stuff_classes, val.ignore_classes,
                max_batches=2)
            out[name] = (metrics, maps)
    finally:
        PanopticEvaluator.update = update
    return out


def build_stream(cfg, modules, device, seed, noise=None):
    """(runner, buffer) of the port on in-memory data: the whole source
    becomes the source buffer."""
    import random
    from codeps_torch.data.replay_buffer import ReplayBuffer
    from codeps_torch.tasks.adapt_loop import AdaptationRunner
    target, source = stream_datasets(cfg, STREAM_FRAMES, SOURCE_IMAGES,
                                     seed)
    buffer = ReplayBuffer(target, cfg.adapt, "train",
                          rng=random.Random(seed))
    buffer.initialize_source_buffer(source, None)
    runner = AdaptationRunner(cfg, modules, buffer, seed=seed, device=device,
                              verbose=False, noise=noise)
    return runner, buffer


def numpy_noise(torch, seed, device):
    """Automask noise from a numpy generator: the same normals, in the same
    order, on every device."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def noise(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)
    return noise


def check_step_graph(name, runner):
    """The adaptation step's CUDA graph (``tasks/step_graph.py``) in a
    stream on one card with the step's own noise: every frame takes one
    eager step or one replay, a capture comes only in a replayed frame,
    at least one graph is captured and the last frame replays. Prints and
    returns the stream's counts."""
    counters = runner.frame_counters
    eager, captures, replays = (counters[f"step.{kind}"] for kind in
                                ("eager_steps", "graph_captures",
                                 "graph_replays"))
    for e, c, r in zip(eager, captures, replays):
        assert e + r == 1 and c <= r, (name, eager, captures, replays)
    assert sum(captures) >= 1 and replays[-1] == 1, (name, captures,
                                                     replays)
    counts = {"frames": len(eager), "eager": sum(eager),
              "captures": sum(captures), "replays": sum(replays),
              "eager_frames": [i for i, e in enumerate(eager) if e]}
    print(f"{name}: adaptation steps in {counts['frames']} frames: "
          f"{counts['eager']} eager (frames {counts['eager_frames']}), "
          f"{counts['captures']} graph capture(s), {counts['replays']} "
          f"replays")
    return counts


def keep_last_step(runner):
    """Wraps ``runner``'s step functions; the returned dict then holds
    the last one called and its batch."""
    kept = {}

    def keeping(step):
        def call(state, batch, noise=None):
            kept.update(step=step, batch=batch)
            return step(state, batch, noise=noise)
        return call
    runner.steps = {key: keeping(step) for key, step in runner.steps.items()}
    return kept


def graphed_against_eager(torch, runner, kept):
    """One more step of the stream's last batch (``keep_last_step``) from
    the state the stream left: replayed through its graph, then twice
    eagerly with the state's generator handed in as ``noise`` (the same
    draws, on the eager path), the state restored before each. The
    losses, the replay features and the skip ring must be equal; the live
    parameters' gradients, the live student and the EMA teacher within
    GRAPH_SPREAD_FACTOR times the eager path's own spread (relative L2).
    Returns the distances."""
    from codeps_torch.tasks import trace
    state, step, batch = runner.state, kept["step"], kept["batch"]
    ring = (state.dist_buffer, state.dist_count, state.dist_head)
    live = [p for group in state.optimizer.param_groups
            for p in group["params"]]
    ema = [p for name in state.ema_modules
           for p in getattr(state.teacher, name).parameters()]
    saved = ({k: v.clone() for k, v in state.student.state_dict().items()},
             {k: v.clone() for k, v in state.teacher.state_dict().items()},
             copy.deepcopy(state.optimizer.state_dict()),
             state.generator.get_state(), [t.clone() for t in ring],
             state.step)

    def restore():
        student, teacher, optimizer, generator, values, count = saved
        state.student.load_state_dict(student)
        state.teacher.load_state_dict(teacher)
        state.optimizer.load_state_dict(optimizer)
        state.generator.set_state(generator)
        for tensor, value in zip(ring, values):
            tensor.copy_(value)
        state.step = count

    def generator_noise(shape):
        return torch.randn(shape, generator=state.generator,
                           device=state.device)

    def flat(tensors):
        return torch.cat([t.detach().double().flatten() for t in tensors])

    readings = []
    for noise in (None, generator_noise, generator_noise):
        restore()
        phases, counters = {}, {}
        with trace.frame(0, phases, counters):
            out = step(state, batch, noise=noise)
        assert counters["step.graph_replays"] == [int(noise is None)], \
            counters
        readings.append({
            "losses": {k: v.detach().clone() for k, v in out[0].items()},
            "features": out[1].detach().clone(),
            "ring": [t.clone() for t in ring],
            "grads": flat(p.grad for p in live if p.grad is not None),
            "student": flat(live), "teacher": flat(ema)})
    restore()
    graphed, eager, again = readings
    assert set(graphed["losses"]) == set(eager["losses"])
    for name, value in eager["losses"].items():
        assert torch.equal(graphed["losses"][name], value), name
    assert torch.equal(graphed["features"], eager["features"])
    for got, want in zip(graphed["ring"], eager["ring"]):
        assert torch.equal(got, want), "skip ring"
    distances = {}
    for kind in ("grads", "student", "teacher"):
        def rel(a, b):
            return float((a - b).norm() / b.norm())
        gap = rel(graphed[kind], eager[kind])
        spread = rel(again[kind], eager[kind])
        distances[kind] = {"graphed": gap, "eager_spread": spread}
        assert gap <= max(1e-6, GRAPH_SPREAD_FACTOR * spread), (kind, gap,
                                                                spread)
    return distances


def meter_values(meters):
    """{name: value} of the scalar meters that were updated."""
    import numpy as np
    out = {}
    for kind in ("losses", "metrics"):
        for name, meter in meters[kind].items():
            count = getattr(meter, "count", 1)
            if count and np.ndim(meter.value) == 0:
                out[name] = float(meter.value)
    return out


def drive_stream(torch, runner, card, max_frames=None, on_frame=None,
                 launches_per_frame=2):
    """(meters, run) of ``runner``'s stream, with the grouping counts set
    to 0 just before it and read just after. On the ``card`` the kernel
    must launch ``launches_per_frame`` times a frame with no layout copy,
    and every grouping call is kept and checked against the plain version
    after the run. ``run`` also holds the (GT, prediction) panoptic maps
    the PQ meter took, the seconds, the peak memory, each call's shape
    and valid centers, and the last call of each shape."""
    from codeps_torch.ops import grouping
    from codeps_torch.ops import panoptic as panoptic_ops
    grouped, pq_maps = [], []
    group_pixels = panoptic_ops.group_pixels
    update = runner.panoptic_eval.update

    def recording(yx, valid, offsets):
        out = group_pixels(yx, valid, offsets)
        grouped.append((yx.clone(), valid.clone(), offsets.clone(), out))
        return out

    def recording_update(pan_gt, pan_pred):
        pq_maps.append((pan_gt.copy(), pan_pred.copy()))
        update(pan_gt, pan_pred)

    panoptic_ops.group_pixels = recording
    runner.panoptic_eval.update = recording_update
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    grouping.group_pixels_cuda.launches = 0
    grouping.group_pixels_cuda.copies = 0
    t0 = time.perf_counter()
    try:
        meters = runner.run(max_frames=max_frames, on_frame=on_frame)
        if card:
            torch.cuda.synchronize()
    finally:
        panoptic_ops.group_pixels = group_pixels
        runner.panoptic_eval.update = update
    run = {"seconds": time.perf_counter() - t0,
           "launches": grouping.group_pixels_cuda.launches,
           "copies": grouping.group_pixels_cuda.copies,
           "peak": torch.cuda.max_memory_allocated() if card else 0,
           "frames": runner.state.step, "pq_maps": pq_maps,
           "centers": [int(v.sum()) for _, v, _, _ in grouped],
           "shapes": [tuple(o.shape[:3]) for _, _, o, _ in grouped],
           "last_by_shape": {tuple(o.shape[:3]): (yx, v, o)
                             for yx, v, o, _ in grouped},
           "max_abs_err": 0}
    if card:
        assert run["launches"] == launches_per_frame * run["frames"], \
            run["launches"]
        assert run["copies"] == 0, run["copies"]
        for yx, valid, offsets, out in grouped:
            ref = grouping.group_pixels_plain(yx, valid, offsets)
            run["max_abs_err"] = max(run["max_abs_err"], int(
                (out.long() - ref.long()).abs().max()))
            assert torch.equal(out, ref), "kernel != plain in the stream"
    values = meter_values(meters)
    bad = [k for k, v in values.items() if not math.isfinite(v)]
    assert not bad, f"meters not finite: {bad}"
    return meters, run


def check_gt_maps(pq_maps, stuff, things):
    """Each GT panoptic map the PQ meter took holds thing segments, and
    scores PQ 1 against itself: the accumulation sees what the map
    holds. Returns the thing segments per map."""
    import numpy as np
    from codeps_torch.evaluation.panoptic_metrics import PanopticEvaluator
    segments = []
    for gt, _ in pq_maps:
        ids = set(int(i) for i in np.unique(gt))
        segments.append(sum(1 for i in ids if i // 1000 in things))
        evaluator = PanopticEvaluator(list(stuff), list(things))
        evaluator.update(gt, gt)
        pq = evaluator.evaluate()["All"]["pq"]
        assert pq == 1.0, f"PQ of a GT map against itself: {pq}"
    assert segments and min(segments) > 0, segments
    return segments


def stream_numbers(runner, run):
    """Frame latency (median and range after the warm-up frames), frames/s
    (those frames over their summed wall time) and the host times, ms."""
    latencies = runner.step_times[WARMUP_FRAMES:]
    getitem_ms = [t * 1e3 for t in runner.host_times["getitem"]]
    add_ms = [t * 1e3 for t in runner.host_times["add"]]
    return {
        "frames": run["frames"],
        "frame_ms": statistics.median(latencies) * 1e3,
        "frame_min_ms": min(latencies) * 1e3,
        "frame_max_ms": max(latencies) * 1e3,
        "frames_per_s": len(latencies) / sum(latencies),
        "stream_s": run["seconds"],
        "all_ms": [t * 1e3 for t in runner.step_times],
        "getitem_ms": statistics.median(getitem_ms),
        "getitem_all_ms": getitem_ms,
        "add_ms": statistics.median(add_ms),
        "phases_ms": {name: statistics.median(t[WARMUP_FRAMES:]) * 1e3
                      for name, t in runner.frame_phases.items()},
        "peak_mib": run["peak"] / 2**20}


def print_stream(name, numbers):
    n = numbers
    print(f"{name}: frame latency (host clock, median of "
          f"{n['frames'] - WARMUP_FRAMES} after {WARMUP_FRAMES} warm-up "
          f"frames) {n['frame_ms']:.3f} ms, range {n['frame_min_ms']:.3f}-"
          f"{n['frame_max_ms']:.3f} ms; all: "
          f"{[round(t, 3) for t in n['all_ms']]}")
    print(f"{name}: {n['frames_per_s']:.3f} frames/s (the frames after the "
          f"warm-up over their summed wall time); whole stream "
          f"{n['stream_s']:.3f} s for {n['frames']} frames")
    print(f"{name}: ReplayBuffer.__getitem__ in the worker thread, median "
          f"{n['getitem_ms']:.3f} ms a frame; all "
          f"{[round(t, 3) for t in n['getitem_all_ms']]}")
    print(f"{name}: main thread per frame, median ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in n["phases_ms"].items()))
    print(f"{name}: buffer.add in the stream, median {n['add_ms']:.3f} ms; "
          f"peak device memory {n['peak_mib']:.1f} MiB")


def time_diversity_add(cfg, seed, extra=40):
    """``ReplayBuffer.add`` on its own at the deployment's size: distinct
    seeded features of 2048 floats fill the target buffer to its size
    (300), then ``extra`` more adds each evict one. Returns ms: adds while
    the index holds its last 50 fills, the first evicting add (which builds
    the similarity matrix), the later evicting adds, and a search of the
    full index alone."""
    import random
    import numpy as np
    from codeps_torch.data.replay_buffer import ReplayBuffer
    size = cfg.adapt.replay_buffer.target_size

    class Frames:
        """A target stream long enough to fill the buffer."""
        def __init__(self, n):
            self.frame_paths = [{"frame": i} for i in range(n)]

        def __len__(self):
            return len(self.frame_paths)

    n = int(math.ceil((size + extra) / cfg.adapt.target_dataset_adapt_ratio))
    buffer = ReplayBuffer(Frames(n + 1), cfg.adapt, "train",
                          rng=random.Random(seed))
    features = np.random.default_rng(seed).standard_normal(
        (size + extra, 1, 2048)).astype(np.float32)
    add_ms = []
    for index, feature in enumerate(features):
        t0 = time.perf_counter()
        buffer.add(index, feature)
        add_ms.append((time.perf_counter() - t0) * 1e3)
        assert buffer.sim_index.ntotal == min(index + 1, size), index
    query = features[0] / np.linalg.norm(features[0])
    search_ms = []
    for _ in range(50):
        t0 = time.perf_counter()
        scores, _ = buffer.sim_index.search(query, 1)
        search_ms.append((time.perf_counter() - t0) * 1e3)
    return {"fill_ms": statistics.median(add_ms[size - 50:size]),
            "first_evict_ms": add_ms[size],
            "evict_ms": statistics.median(add_ms[size + 1:]),
            "search_ms": statistics.median(search_ms),
            "size": buffer.sim_index.ntotal,
            "dim": buffer.sim_index.dim}


def device_busy(torch, events):
    """(busy, first start, last end) in us of the card's kernels, copies
    and sets among profiler ``events``; overlaps count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        busy += end - start
    return busy, (spans[0][0] if spans else 0.0), (end or 0.0)


def train_config(size, layers=101, batch=TRAIN_BATCH):
    """cfg/train_cityscapes.yaml's values set in code over the port's
    pretraining defaults (which give the ResNet-18 pose net, GUDA fusion,
    the ``codeps`` labels and bfloat16). The loader runs one producer
    thread: datasets made in memory go to no worker process."""
    from codeps_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    model = cfg.model
    model.make_depth = model.make_semantic = model.make_instance = True
    model.make_sflow = False
    model.instance_head.use_thing_mask = True
    model.po_depth_net.params.nof_layers = layers
    cfg.train.nof_epochs = 600
    cfg.train.batch_size_per_gpu = batch
    cfg.train.nof_workers_per_gpu = 0
    cfg.train.optimizer.learning_rate = 1e-4
    cfg.train.scheduler.type = "StepLR"
    cfg.train.scheduler.step_lr.step_size = 600
    cfg.val.batch_size_per_gpu = 2
    cfg.dataset.name = "cityscapes"
    cfg.dataset.feed_img_size = list(size)
    cfg.semantics.class_weights = [1.0] * NUM_CLASSES
    cfg.semantics.top_k = 0.2
    cfg.depth.num_recon_scales = 5
    for key, value in (("depth_recon", 10.0), ("depth_smth", 0.001),
                       ("flow_smth", 10.0), ("flow_sparsity", 10.0),
                       ("semantic", 1.0), ("center", 20.0),
                       ("offset", 0.1), ("thing_mask", 0.5)):
        cfg.losses.weights[key] = value
    cfg.visualization.scale = 0.5
    cfg.tpu.remat = True
    assert model.pose_sflow_net.params.nof_layers == 18
    assert model.semantic_head.use_guda_fusion
    assert cfg.dataset.label_mode == "codeps"
    assert cfg.tpu.compute_dtype == "bfloat16"
    return cfg


def depth_only_config():
    """cfg/train_cityscapes_depth_only.yaml's values set in code."""
    cfg = train_config(DEPTH_ONLY_SIZE, layers=18, batch=1)
    cfg.model.make_semantic = cfg.model.make_instance = False
    cfg.train.nof_epochs = 20
    cfg.train.scheduler.step_lr.step_size = 15
    cfg.dataset.return_only_rgb = True
    cfg.losses.weights.depth_recon = 10.0
    cfg.losses.weights.depth_smth = 0.001
    return cfg


def train_datasets(cfg, train_images, val_images, seed):
    """(train, val): the port's Cityscapes reader on images made in memory
    from ``seed`` at the config's feed size (``memory_cityscapes``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    train = memory_cityscapes(cfg.dataset, "train", train_images, rng)
    val = memory_cityscapes(cfg.dataset, "val", val_images, rng)
    for dataset in (train, val):
        dataset.return_only_rgb = cfg.dataset.return_only_rgb
    return train, val


def drive_training(torch, cfg, datasets, device, **kwargs):
    """``scripts/train.run_training`` on ``datasets`` with its parts
    counted: the grouping counts are set to 0 just before the steps and
    before each validation and read just after; every grouping call is
    checked against the plain version; each step's start and each
    validation batch are timed. ``kwargs`` go to ``run_training``; a
    ``check_resumed(state)`` among them runs before the first step.
    Returns (the run's result, the parts' numbers)."""
    import numpy as np
    from codeps_torch.ops import grouping
    from codeps_torch.ops import panoptic as panoptic_ops
    from codeps_torch.scripts import train as train_cli
    check_resumed = kwargs.pop("check_resumed", None)
    parts = {"steps": {"starts": []}, "val": []}
    calls = []
    group_pixels = panoptic_ops.group_pixels
    make_train_step = train_cli.make_train_step
    validate = train_cli.run_validation

    def recording(yx, valid, offsets):
        out = group_pixels(yx, valid, offsets)
        calls.append((yx.clone(), valid.clone(), offsets.clone(), out))
        return out

    def timed_step(*args, **step_kwargs):
        step = make_train_step(*args, **step_kwargs)

        def run(state, batch, noise=None):
            if check_resumed is not None and not parts["steps"]["starts"]:
                check_resumed(state)
            parts["steps"]["starts"].append(time.perf_counter())
            return step(state, batch, noise=noise)
        return run

    def counted_validation(cfg, modules, loader, *args, **val_kwargs):
        torch.cuda.synchronize()
        if not parts["val"]:
            parts["steps"].update(
                launches=grouping.group_pixels_cuda.launches,
                copies=grouping.group_pixels_cuda.copies)
        marks = []

        def timed():
            for batch in loader:
                marks.append(time.perf_counter())
                yield batch
            marks.append(time.perf_counter())

        grouping.group_pixels_cuda.launches = 0
        grouping.group_pixels_cuda.copies = 0
        first = len(calls)
        metrics = validate(cfg, modules, timed(), *args, **val_kwargs)
        torch.cuda.synchronize()
        parts["val"].append({
            "launches": grouping.group_pixels_cuda.launches,
            "copies": grouping.group_pixels_cuda.copies,
            "batch_s": [float(t) for t in np.diff(marks)],
            "calls": len(calls) - first})
        return metrics

    panoptic_ops.group_pixels = recording
    train_cli.make_train_step = timed_step
    train_cli.run_validation = counted_validation
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grouping.group_pixels_cuda.launches = 0
        grouping.group_pixels_cuda.copies = 0
        t0 = time.perf_counter()
        result = train_cli.run_training(cfg, *datasets, seed=SEED,
                                        device=device, **kwargs)
        torch.cuda.synchronize()
        parts["seconds"] = time.perf_counter() - t0
    finally:
        panoptic_ops.group_pixels = group_pixels
        train_cli.make_train_step = make_train_step
        train_cli.run_validation = validate
    parts["peak"] = torch.cuda.max_memory_allocated()
    parts["steps"].setdefault("launches", grouping.group_pixels_cuda.launches)
    parts["steps"].setdefault("copies", grouping.group_pixels_cuda.copies)
    parts["shapes"] = sorted({tuple(off.shape[:3]) for _, _, off, _
                              in calls})
    parts["centers"] = [[int(n) for n in v.sum(1)] for _, v, _, _ in calls]
    parts["max_abs_err"] = 0
    for yx, valid, offsets, out in calls:
        ref = grouping.group_pixels_plain(yx, valid, offsets)
        parts["max_abs_err"] = max(parts["max_abs_err"], int(
            (out.long() - ref.long()).abs().max()))
        assert torch.equal(out, ref), "kernel != plain in pretraining"
    parts["last_call"] = calls[-1][:3] if calls else None
    return result, parts


def train_batch(rng, batch, height, width):
    """One pretraining batch in the loader's layout (uint8 frames)."""
    import numpy as np
    return {
        "frames": rng.integers(0, 256, (batch, 3, height, width, 3),
                               dtype=np.uint8),
        "camera": np.tile(np.asarray([scaled_camera(
            CITYSCAPES_CAMERA, (SOURCE_HEIGHT, SOURCE_WIDTH),
            (height, width))], np.float32), (batch, 1)),
        "semantic": rng.integers(0, NUM_CLASSES, (batch, height, width),
                                 dtype=np.int32),
        "semantic_weights": rng.uniform(1.0, 3.0, (batch, height, width))
        .astype(np.float32),
        "center": rng.uniform(0, 1, (batch, height, width, 1)).astype(
            np.float32),
        "offset": rng.normal(0, 20, (batch, height, width, 2)).astype(
            np.float32),
        "thing_mask": rng.integers(0, 2, (batch, height, width),
                                   dtype=np.int32),
    }


def train_step_card_vs_cpu(torch, device, rng):
    """One float32 train step at 64x128 (ResNet-18, batch 2) from the same
    weights, batch and automask noise on the card and on the CPU:
    (metrics, BatchNorm running statistics) per device."""
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.tasks.state import make_train_state
    from codeps_torch.tasks.train import make_train_step
    size = (64, 128)
    cfg = train_config(size, layers=18, batch=2)
    cfg.tpu.compute_dtype = "float32"
    batch = train_batch(rng, 2, *size)
    cpu_modules = init_params(build_modules(cfg, NUM_CLASSES, device="cpu"),
                              seed=SEED, device="cpu")
    step = make_train_step(cfg, list(cfg.semantics.class_weights))
    out = {}
    for name, mods, dev in (("card", copy.deepcopy(cpu_modules), device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        state = make_train_state(mods, 1e-4, seed=SEED, device=dev)
        metrics = step(state, batch, noise=numpy_noise(torch, SEED, dev))
        stats = {f"{n}.{k}": v.cpu() for n in mods.module_names()
                 for k, v in getattr(mods, n).state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        out[name] = ({k: float(v) for k, v in metrics.items()
                      if v.ndim == 0}, stats)
    return out


def host_mixup_config(target_size, source_size, layers=101):
    """``stream_config`` with the package-default strategies ``[cut_mixup,
    conf_instance_mixup]`` and the yaml's ``conf_instance_mix``
    (``min_inst_size`` scaled by the source's area). Neither the yaml nor
    the defaults weight the conf_instance_mixup loss, which would leave
    its composed samples unread: it gets the cut-mixup loss's weight."""
    cfg = stream_config(target_size, source_size, layers=layers)
    cfg.adapt.mixup.general.mixup_strategies = ["cut_mixup",
                                                "conf_instance_mixup"]
    conf = cfg.adapt.mixup.conf_instance_mix
    conf.conf_thresh = CONF_THRESH
    conf.min_inst_size = int(MIN_INST_SIZE * source_size[0] * source_size[1]
                             / (SOURCE_HEIGHT * SOURCE_WIDTH))
    cfg.losses.weights.semantic_conf_instance_mixup = \
        cfg.losses.weights.semantic_cut_mixup
    return cfg


def shift_thing_logits(torch, modules, image):
    """Shift the semantic head's thing logits so that THING_SHARE of the
    pixels of ``image`` (1, H, W, 3 uint8) argmax to a thing class: by the
    quantile of (log of the best stuff probability - log of the best
    thing probability), a raise where fewer are things and a cut where
    more are. Returns the shift."""
    from codeps_torch.ops.normalize import maybe_normalize
    from codeps_torch.tasks.forward import apply_encoder
    device = next(modules.parameters()).device
    head = modules.semantic_head
    with torch.no_grad():
        probs = head(apply_encoder(modules.backbone_po_depth, maybe_normalize(
            torch.from_numpy(image).to(device)))).float()
        is_thing = torch.zeros(probs.shape[1], dtype=torch.bool,
                               device=device)
        is_thing[list(THINGS)] = True
        margin = (probs[:, ~is_thing].amax(1).log()
                  - probs[:, is_thing].amax(1).log())
        shift = float(torch.quantile(margin.flatten().float(), THING_SHARE))
        conv = (head.semconv_guda if head.use_guda_fusion
                else head.semconv[-1])
        conv.bias[list(THINGS)] += shift
    return shift


def raise_pseudo_instances(torch, modules, image):
    """``shift_thing_logits``, and the center head's bias shifted so that
    CENTER_SHARE of the pixels of ``image`` pass the 0.1 center
    threshold. Returns (thing logit shift, center bias shift)."""
    from codeps_torch.ops.normalize import maybe_normalize
    from codeps_torch.tasks.forward import apply_encoder
    thing = shift_thing_logits(torch, modules, image)
    device = next(modules.parameters()).device
    with torch.no_grad():
        center, _, _ = modules.instance_head(apply_encoder(
            modules.backbone_po_depth,
            maybe_normalize(torch.from_numpy(image).to(device))))
        shift = float(0.1 - torch.quantile(center.flatten().float(),
                                           1.0 - CENTER_SHARE))
        modules.instance_head.center_head.net.conv.bias.add_(shift)
    return thing, shift


def host_mixup_labels(rng, height, width):
    """Source and target of one ``conf_instance_mixup`` at height x width:
    street-like train-id maps (``street_labels`` with stuff ids 0-4 and
    thing ids 11 and 13), six things in the source and twelve in the
    target, RGB normalized-like floats."""
    import numpy as np
    out = {}
    for name, things in (("src", 6), ("tgt", 12)):
        semantic, instance = street_labels(
            rng, height, width, things, stuff=(10, 2, 8, 1, 0),
            thing_ids=(11, 13), stuff_instances=False)
        out[f"semantic_{name}"] = semantic.astype(np.int32)
        out[f"instance_{name}"] = instance.astype(np.int32)
        out[f"img_{name}"] = rng.normal(0, 1, (height, width, 3)).astype(
            np.float32)
    return out


def refusion_on_card(torch, device, rng):
    """``Mixup.conf_instance_mixup`` at the source size with the yaml's
    threshold and size, re-fused on the card by the kernel and by the plain
    grouping (on the same card): equal outputs, one launch, no layout
    copy. Returns the numbers."""
    from codeps_torch.data.mixup import Mixup
    from codeps_torch.ops import grouping
    from codeps_torch.ops import panoptic as panoptic_ops
    labels = host_mixup_labels(rng, SOURCE_HEIGHT, SOURCE_WIDTH)
    args = (labels["img_src"], labels["img_tgt"], labels["instance_src"],
            labels["semantic_src"], labels["semantic_tgt"],
            labels["instance_tgt"], MIN_INST_SIZE)
    group_pixels = panoptic_ops.group_pixels
    outs, stats, seconds = {}, {}, {}
    for name, group in (("kernel", group_pixels),
                        ("plain", grouping.group_pixels_plain)):
        panoptic_ops.group_pixels = group
        grouping.group_pixels_cuda.launches = 0
        grouping.group_pixels_cuda.copies = 0
        stats[name] = {}
        try:
            t0 = time.perf_counter()
            outs[name] = Mixup.conf_instance_mixup(
                *args, thing_list=THINGS, num_classes=NUM_CLASSES,
                conf_thresh=CONF_THRESH, device=device, stats=stats[name])
            seconds[name] = time.perf_counter() - t0
        finally:
            panoptic_ops.group_pixels = group_pixels
        stats[name]["launches"] = grouping.group_pixels_cuda.launches
        stats[name]["copies"] = grouping.group_pixels_cuda.copies
    for part, ours, ref in zip(("rgb", "semantic", "instance"),
                               outs["kernel"], outs["plain"]):
        assert (ours == ref).all(), f"conf_instance_mixup {part}: kernel " \
            "!= plain"
    assert stats["kernel"]["launches"] == 1, stats
    assert stats["kernel"]["copies"] == 0, stats
    assert stats["plain"]["launches"] == 0, stats
    assert stats["kernel"]["pasted"] > 0, stats
    targets = len([i for i in set(labels["instance_tgt"].flat) if i])
    print(f"conf_instance_mixup at {SOURCE_HEIGHT}x{SOURCE_WIDTH} (street "
          f"labels, {targets} target things, conf_thresh {CONF_THRESH}, "
          f"min_inst_size {MIN_INST_SIZE}): re-fused by the kernel and by "
          f"the plain grouping, equal rgb, semantic and instance; pasted "
          f"{stats['kernel']['pasted']}, conflicts "
          f"{stats['kernel']['conflicts']}; grouping launches "
          f"{stats['kernel']['launches']}, layout copies "
          f"{stats['kernel']['copies']}; host clock {seconds['kernel']:.3f}"
          f" s (kernel) / {seconds['plain']:.3f} s (plain)")
    return {"pasted": stats["kernel"]["pasted"],
            "conflicts": stats["kernel"]["conflicts"],
            "target_things": targets, "seconds": seconds}


def drive_host_mixup_stream(torch, runner, card, max_frames):
    """``drive_stream`` on the host mixup path: the teacher eval, the GT
    map, the pseudo-label stack and one re-fusion per conf_instance_mixup
    item launch the kernel each frame. Also returns the host seconds of
    each re-fusion (upload, fusion, readback)."""
    from codeps_torch.data import mixup as mixup_lib
    refuse = mixup_lib.refuse_instances
    refusion_s = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = refuse(*args, **kwargs)
        refusion_s.append(time.perf_counter() - t0)
        return out

    strategies = list(runner.cfg.adapt.mixup.general.mixup_strategies)
    per_frame = 3 + strategies.count("conf_instance_mixup")
    mixup_lib.refuse_instances = timed
    try:
        meters, run = drive_stream(torch, runner, card,
                                   max_frames=max_frames,
                                   launches_per_frame=per_frame)
    finally:
        mixup_lib.refuse_instances = refuse
    run["refusion_s"] = refusion_s
    return meters, run


def flow_modules(torch, cfg, weights):
    """The modules of flow config ``cfg`` on the host: seeded, then every
    module of ``weights`` (the calibrated modules of phase 4) loaded into
    its namesake; the 8-channel pose net and the flow head keep their
    seeded weights."""
    from codeps_torch.models import build_modules, init_params
    modules = init_params(build_modules(cfg, NUM_CLASSES, device="cpu"),
                          seed=SEED, device="cpu")
    for name in weights.module_names():
        if name != "backbone_pose_sflow":
            getattr(modules, name).load_state_dict(
                getattr(weights, name).state_dict())
    return modules


def flow_automask_noise(rng, target_size, source_size, num_scales):
    """Automask normals for one flow adaptation step in the order it asks
    for them: source, target, then replay scales (with a flow head target
    and replay take separate passes)."""
    import numpy as np
    shapes = []
    for batch, (height, width) in ((NUM_SOURCE, source_size),
                                   (1, target_size),
                                   (NUM_REPLAY, target_size)):
        shapes += [(batch, 2, height >> s, width >> s)
                   for s in range(num_scales)]
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in shapes]


def recording_motion(module, records):
    """Patch ``module.depth_forward`` to append each object-motion pair it
    returns to ``records`` (NHWC numpy); returns the function to restore
    it with."""
    forward = module.depth_forward

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        records.append([m.detach().permute(0, 2, 3, 1).cpu().numpy()
                        for m in out["object_motion_maps"]])
        return out
    module.depth_forward = recording

    def restore():
        module.depth_forward = forward
    return restore


def mask_flips(ours, ref):
    """(pixels whose auto-mask differs, the largest relative distance of
    such a pixel's norm above the smallest norm its side kept) for two
    motion maps (..., 3) of one flow-head call. A differing pixel must lie
    in the tie band: its norm within TIE_BAND of that side's threshold,
    which the smallest kept norm bounds from above."""
    import numpy as np
    kept = [np.any(m != 0, axis=-1) for m in (ours, ref)]
    differ = kept[0] != kept[1]
    worst = 0.0
    for m, k in zip((ours, ref), kept):
        norm = np.sqrt((m * m).sum(-1))
        if (differ & k).any():
            worst = max(worst, float(norm[differ & k].max()
                                     / norm[k].min() - 1.0))
    assert worst <= TIE_BAND, \
        f"auto-mask differs outside the tie band: {worst}"
    return int(differ.sum()), worst


def compare_motion(records):
    """(pixels whose auto-mask differs, pixels, the largest relative
    distance above the threshold) over the recorded motion pairs of the
    card and the CPU."""
    flips = pixels = 0
    worst = 0.0
    assert len(records["card"]) == len(records["cpu"]) > 0
    for pair_card, pair_cpu in zip(records["card"], records["cpu"]):
        for card, cpu in zip(pair_card, pair_cpu):
            n, w = mask_flips(card, cpu)
            flips += n
            pixels += card.shape[0] * card.shape[1] * card.shape[2]
            worst = max(worst, w)
    return flips, pixels, worst


# losses computed through the flow head's auto-mask: a pixel in the tie
# band moves them by its own share
MASKED_LOSSES = ("depth_recon", "flow_smth", "flow_sparsity", "loss_total")
# the frozen instance head's losses: card against CPU they moved by 3.6e-4
# in phase 6's 64x192 step on an H100, as REL_TOL says of its outputs
INSTANCE_LOSSES = ("center_source", "offset_source", "loss_total")


def check_flow_losses(name, card, cpu, flips):
    """Each loss of the card within FLOW_REL_TOL of the CPU's; REL_TOL for
    the instance head's, and for those through the auto-mask when a pixel
    of the tie band flipped."""
    assert set(card) == set(cpu), (set(card), set(cpu))
    worst = 0.0
    for key, ref in cpu.items():
        tol = FLOW_REL_TOL
        if key in INSTANCE_LOSSES or (flips and key in MASKED_LOSSES):
            tol = REL_TOL
        err = abs(card[key] - ref) / max(abs(ref), 1e-30)
        print(f"{name} card vs CPU {key}: {card[key]:.6g} vs {ref:.6g}, "
              f"rel err {err:.3g} (bound {tol})")
        assert err <= tol, key
        if key not in INSTANCE_LOSSES:
            worst = max(worst, err)
    return worst


def flow_card_vs_cpu(torch, device, rng):
    """(d): one float32 flow adaptation step at 64x192 (source 64x128,
    ResNet-18) and one float32 flow train step at 64x128 (batch 2), each
    from the same weights, batch and automask noise on the card and on the
    CPU, TF32 off. Returns the numbers of the ``flow`` line."""
    import numpy as np
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.tasks import adapt as adapt_task
    from codeps_torch.tasks import train as train_task
    from codeps_torch.tasks.state import make_train_state
    out = {}
    target, source = (64, 192), (64, 128)
    cfg = adapt_config(target, source)
    cfg.model.make_sflow = cfg.adapt.model.sflow = True
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.tpu.compute_dtype = "float32"
    batch = adapt_batch(rng, target, source)
    noise = flow_automask_noise(rng, target, source,
                                cfg.depth.num_recon_scales)
    cpu_modules = init_params(build_modules(cfg, NUM_CLASSES, device="cpu"),
                              seed=SEED, device="cpu")
    calibrate_batch_norm(torch, cpu_modules, batch["target"]["frames"][:, 0])
    card_modules = copy.deepcopy(cpu_modules)
    losses, records = {}, {}
    for name, mods, dev in (("card", card_modules, device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        records[name] = []
        restore = recording_motion(adapt_task, records[name])
        try:
            state, step = build_adapt(torch, mods, cfg, dev)
            metrics, _, results, _ = step(state, batch,
                                          noise=injected(torch, noise, dev))
        finally:
            restore()
        assert tuple(results["object_motion_map"].shape) == (2, 1, *target,
                                                             3)
        losses[name] = {k: float(v) for k, v in metrics.items()
                        if k != "target_skipped"}
    flips, pixels, worst = compare_motion(records)
    print(f"64x192 flow step card vs CPU: auto-masks differ on {flips} of "
          f"{pixels} pixels ({2 * len(records['cpu'])} flow-head calls), "
          f"all within the tie band "
          f"(largest {worst:.3g} above the threshold, bound {TIE_BAND})")
    out["adapt"] = {"mask_flips": flips, "pixels": pixels,
                    "tie_worst": worst,
                    "max_rel_err": check_flow_losses(
                        "64x192 flow step", losses["card"], losses["cpu"],
                        flips)}

    size = (64, 128)
    cfg = train_config(size, layers=18, batch=2)
    cfg.model.make_sflow = True
    cfg.tpu.compute_dtype = "float32"
    batch = train_batch(rng, 2, *size)
    cpu_modules = init_params(build_modules(cfg, NUM_CLASSES, device="cpu"),
                              seed=SEED, device="cpu")
    step = train_task.make_train_step(cfg, list(cfg.semantics.class_weights))
    losses, stats, records = {}, {}, {}
    for name, mods, dev in (("card", copy.deepcopy(cpu_modules), device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        records[name] = []
        restore = recording_motion(train_task, records[name])
        try:
            state = make_train_state(mods, 1e-4, seed=SEED, device=dev)
            metrics = step(state, batch, noise=numpy_noise(torch, SEED, dev))
        finally:
            restore()
        losses[name] = {k: float(v) for k, v in metrics.items()
                        if v.ndim == 0 and not k.startswith("d_")}
        stats[name] = {f"{n}.{k}": v.cpu() for n in mods.module_names()
                       for k, v in getattr(mods, n).state_dict().items()
                       if k.endswith(("running_mean", "running_var"))}
    flips, pixels, worst = compare_motion(records)
    print(f"64x128 flow train step card vs CPU: auto-masks differ on "
          f"{flips} of {pixels} pixels, all within the tie band (largest "
          f"{worst:.3g} above the threshold)")
    stat_err = max(float((stats["card"][k] - v).abs().max()
                         / (1.0 + float(v.abs().max())))
                   for k, v in stats["cpu"].items())
    print(f"64x128 flow train step card vs CPU BatchNorm running statistics "
          f"(the depth encoder's from its 3B pass): max |diff| / (1 + max "
          f"|value|) {stat_err:.3g} (bound {TRAIN_STAT_TOL}) over "
          f"{len(stats['cpu'])} tensors")
    assert stat_err <= TRAIN_STAT_TOL
    out["train"] = {"mask_flips": flips, "pixels": pixels,
                    "tie_worst": worst, "stat_err": stat_err,
                    "max_rel_err": check_flow_losses(
                        "64x128 flow train step", losses["card"],
                        losses["cpu"], flips)}
    return out


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ddp_exactness(torch, device):
    """Phase 13 (b) on this rank: one train step of ``train_config`` at
    full width on this rank's DDP_EXACT_ROWS rows of a seeded global
    batch, with modules and frames in float64 and then in float32; after
    each, rank 0 takes the one-process step on the whole batch
    (``parallel.replicated``) from the same seeded weights and generator
    state. Returns, by dtype, rank 0's distances (``step_distances``) of
    the data-parallel step from the one-process step, in float32 also
    both float32 steps' distances from the one-process float64 step, and
    every rank's step metrics; and rank 0's peak memory in each step."""
    import numpy as np
    from codeps_torch import parallel
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
    from codeps_torch.tasks.state import make_train_state
    from codeps_torch.tasks.train import make_train_step
    cfg = train_config((SOURCE_HEIGHT, SOURCE_WIDTH))
    cfg.tpu.compute_dtype = "float32"
    rows = DDP_EXACT_ROWS * parallel.world_size()
    batch = train_batch(np.random.default_rng(SEED), rows, SOURCE_HEIGHT,
                        SOURCE_WIDTH)
    # float frames are taken as normalized: both dtypes see the same values
    frames = (batch["frames"] / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    modules = init_params(build_modules(cfg, NUM_CLASSES, device=device),
                          seed=SEED, device=device)
    step = make_train_step(cfg, list(cfg.semantics.class_weights))

    peaks = []

    def run(dtype, given):
        torch.cuda.reset_peak_memory_stats()
        mods = copy.deepcopy(modules).to(dtype)
        state = make_train_state(mods, 1e-4, seed=SEED, device=device)
        metrics = step(state, given)
        peaks.append(torch.cuda.max_memory_allocated() / 2**20)
        grads = {name: torch.cat([p.grad.reshape(-1) for p in
                                  getattr(mods, name).parameters()]).cpu()
                 for name in mods.module_names()}
        stats = {f"{name}.{key}": value.cpu()
                 for name in mods.module_names()
                 for key, value in getattr(mods, name).state_dict().items()
                 if key.endswith(("running_mean", "running_var"))}
        del mods, state
        torch.cuda.empty_cache()
        return ({k: float(v) for k, v in metrics.items() if v.ndim == 0},
                grads, stats)

    out, truth = {}, None
    for name, dtype in (("float64", torch.float64),
                        ("float32", torch.float32)):
        given = dict(batch, frames=frames.astype(str(dtype)[6:]))
        ours = run(dtype, {k: v[parallel.shard_rows(rows)]
                           for k, v in given.items()})
        part = {"metrics": ours[0]}
        if parallel.rank() == 0:
            with parallel.replicated():
                ref = run(dtype, given)
            part.update(step_distances(torch, ours, ref),
                        peak_mib={"data_parallel": peaks[-2],
                                  "one_process": peaks[-1]})
            if truth is None:
                truth = ref
            else:
                part["to_float64"] = {
                    "data_parallel": step_distances(torch, ours, truth),
                    "one_process": step_distances(torch, ref, truth)}
        out[name] = part
        del ours
        parallel.barrier()
    del modules, truth
    torch.cuda.empty_cache()
    return out


def step_distances(torch, ours, ref):
    """The distances of a train step's (scalars, gradients by module,
    running statistics) from ``ref``'s, in float64: each loss relative,
    the statistics as max |diff| / (1 + max |value|) over the tensors and
    each module's gradient by relative L2."""
    (scalars, grads, stats), (ref_scalars, ref_grads, ref_stats) = ours, ref
    return {
        "loss_rel": {k: abs(scalars[k] - v) / max(abs(v), 1e-30)
                     for k, v in ref_scalars.items()},
        "stat_err": max(float((stats[k].double() - v.double()).abs().max()
                              / (1.0 + float(v.abs().max())))
                        for k, v in ref_stats.items()),
        "stat_tensors": len(ref_stats),
        "grad_rel_l2": {
            name: float(torch.linalg.vector_norm(grads[name].double()
                                                 - g.double())
                        / torch.linalg.vector_norm(g.double()))
            for name, g in ref_grads.items()}}


def ddp_bounds(part):
    """(b)'s (quantity, key, distance, bound) for one dtype's ``part``.
    float64: the data-parallel step against the one-process step, to
    DDP_BOUNDS. float32: the data-parallel step's distance from the
    one-process float64 step, each to the larger of DDP_BOUNDS and
    DDP_F32_FACTOR times the one-process float32 step's
    own distance from it (that float32 rounding, amplified by train-mode
    BatchNorm, is the floor of any float32 comparison)."""
    if "to_float64" not in part:
        return [(q, key, err, DDP_BOUNDS["float64"][q])
                for q, key, err in _distance_items(part)]
    own = {(q, key): err for q, key, err in
           _distance_items(part["to_float64"]["one_process"])}
    return [(q, key, err, max(DDP_BOUNDS["float32"][q],
                              DDP_F32_FACTOR * own[q, key]))
            for q, key, err in
            _distance_items(part["to_float64"]["data_parallel"])]


def _distance_items(distances):
    return ([("loss_rel", k, v) for k, v in distances["loss_rel"].items()]
            + [("stat_err", "all", distances["stat_err"])]
            + [("grad_rel_l2", k, v)
               for k, v in distances["grad_rel_l2"].items()])


def ddp_smoke_rank(rank, world, port, out_dir):
    """One rank of phase 13 (a) and (b), started by
    ``torch.multiprocessing.spawn``: every rank on the explicit card
    ``cuda:0``, which ``parallel.default_backend`` puts on gloo (NCCL
    refuses two ranks on one card). Writes the numbers of
    ``_ddp_smoke_parts`` to ``out_dir/rank<rank>.json``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch
    from codeps_torch import parallel
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(out_dir)
    device = torch.device("cuda", 0)
    allreduce_s = []
    average = parallel.average_gradients

    def timed_average(parameters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average(parameters)
        torch.cuda.synchronize()
        allreduce_s.append(time.perf_counter() - t0)

    parallel.average_gradients = timed_average
    # one process group for the whole run: a group made again on the same
    # port could read the last group's addresses
    with parallel.process_group(device):
        numbers = _ddp_smoke_parts(torch, rank, world, device, out_dir,
                                   allreduce_s)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(numbers))


def _ddp_smoke_parts(torch, rank, world, device, out_dir, allreduce_s):
    """(a) ``run_training`` at full width through ``drive_training`` (the
    grouping counts set to 0 before the steps and each validation, every
    call checked against the plain version; ``allreduce_s`` gathers the
    gradient all-reduce's times), then a resumed step from rank 0's
    checkpoint; (b) ``ddp_exactness``."""
    import numpy as np
    from codeps_torch import parallel
    from codeps_torch.io.checkpoint import load_checkpoint
    cfg = train_config((SOURCE_HEIGHT, SOURCE_WIDTH))
    datasets = train_datasets(cfg, DDP_STEPS * TRAIN_BATCH * world,
                              DDP_VAL_IMAGES, SEED)
    run_dir = out_dir / "run"
    result, parts = drive_training(torch, cfg, datasets, device,
                                   max_steps=DDP_STEPS, run_dir=str(run_dir))
    steps_allreduce = list(allreduce_s)
    ckpt = Path(result["checkpoints"][0])
    saved = load_checkpoint(str(ckpt))
    resumed_checks = {}

    def check_resumed(state):
        tensors = 0
        for name in state.modules.module_names():
            for key, value in getattr(state.modules,
                                      name).state_dict().items():
                assert torch.equal(value.cpu(),
                                   saved["state_dict"][name][key]), \
                    f"rank {rank}: resumed {name}.{key} != saved"
                tensors += 1
        assert torch.equal(state.generator.get_state(),
                           saved["state_dict"]["rng"])
        assert state.step == DDP_STEPS, state.step
        resumed_checks.update(tensors=tensors, world=parallel.world_size(),
                              backend=torch.distributed.get_backend())

    resumed, resumed_parts = drive_training(
        torch, cfg, datasets, device, max_steps=DDP_STEPS + 1,
        checkpoint=str(ckpt), check_resumed=check_resumed)
    del saved, datasets
    torch.cuda.empty_cache()
    exact = ddp_exactness(torch, device)
    return {
        "rank": rank, "step_s": result["step_times"],
        "starts": parts["steps"]["starts"],
        "allreduce_s": steps_allreduce, "peak_mib": parts["peak"] / 2**20,
        "metrics": result["metrics"], "val": [
            {k: float(v) for k, v in m.items() if np.ndim(v) == 0}
            for m in result["val"]],
        "sem_conf": [m["sem_conf"].tolist() for m in result["val"]],
        "launches": parts["steps"]["launches"],
        "copies": parts["steps"]["copies"],
        "val_launches": [v["launches"] for v in parts["val"]
                         + resumed_parts["val"]],
        "val_copies": [v["copies"] for v in parts["val"]
                       + resumed_parts["val"]],
        "val_batch_s": parts["val"][0]["batch_s"],
        "calls": len(parts["centers"]) + len(resumed_parts["centers"]),
        "shapes": parts["shapes"],
        "max_abs_err": max(parts["max_abs_err"],
                           resumed_parts["max_abs_err"]),
        "checkpoint": ckpt.name, "resumed": resumed_checks,
        "resumed_metrics": resumed["metrics"],
        "global_step": resumed["global_step"], "exact": exact}


def spatial_batch(rng, target_size, source_size):
    """Phase 14's batch: ``adapt_batch``'s, with the raw materials of the
    fused cut mixup (source images and labels, target images, the camera
    warp's taps, cut cells) in place of composed samples."""
    import numpy as np
    from codeps_torch.tasks.mixup_prep import c2c_prewarp
    batch = adapt_batch(rng, target_size, source_size)
    (ht, wt), (hs, ws) = target_size, source_size
    cameras = [np.tile(np.asarray([cam], np.float32), (NUM_MIXUP, 1))
               for cam in (KITTI_360_CAMERA, CITYSCAPES_CAMERA)]
    batch["mixup"] = {
        "rgb_src": rng.integers(0, 256, (NUM_MIXUP, hs, ws, 3),
                                dtype=np.uint8),
        "semantic_src": rng.integers(0, NUM_CLASSES, (NUM_MIXUP, hs, ws),
                                     dtype=np.int32),
        "rgb_tgt": rng.integers(0, 256, (NUM_MIXUP, ht, wt, 3),
                                dtype=np.uint8),
        "prewarp": c2c_prewarp(cameras[0], cameras[1], (ht, wt), (hs, ws)),
        "cut_cells": np.stack([rng.choice(8, 2, replace=False)
                               for _ in range(NUM_MIXUP)]).astype(np.int32)}
    return batch


def float_frames(torch, batch, dtype):
    """``batch`` with its uint8 images normalized into ``dtype`` (the
    step takes float images as normalized): every dtype sees the same
    values."""
    from codeps_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float64)
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = float_frames(torch, value, dtype)
        elif key in ("frames", "rgb_src", "rgb_tgt"):
            x = torch.as_tensor(value).double() / 255.0
            out[key] = ((x - mean) / std).to(dtype)
        else:
            out[key] = value
    return out


def with_compute_dtype(torch, modules, dtype):
    """``modules`` with every module's compute dtype set to ``dtype``
    (``models/precision.py``; the weights keep their own type)."""
    for name in modules.module_names():
        getattr(modules, name).compute_dtype = dtype
    return modules


def spatial_step_run(torch, step, cfg, modules, batch, noise, device):
    """One adaptation step from a fresh state of ``modules``: metrics,
    the live modules' flat gradients and parameters after the step (on
    the host), the replay features, and (where the eval is scored) the
    panoptic map and ``sem_conf``."""
    from codeps_torch.tasks.adapt_loop import adapt_module_lists
    from codeps_torch.tasks.state import make_adapt_state
    frozen, ema = adapt_module_lists(cfg, modules.module_names())
    state = make_adapt_state(modules, cfg.train.optimizer.learning_rate,
                             ema_modules=ema, frozen_modules=frozen,
                             ema_alpha=cfg.adapt.ema.alpha, seed=SEED,
                             device=device)
    metrics, features, results, stats = step(
        state, batch, noise=injected(torch, noise, device))
    torch.cuda.synchronize()
    live = state.live_modules()
    out = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {name: torch.cat([p.grad.reshape(-1).double() for p in
                                   getattr(modules, name).parameters()
                                   if p.grad is not None]).cpu()
                  for name in live},
        "params": {name: torch.cat([p.detach().reshape(-1).double() for p in
                                    getattr(modules, name).parameters()])
                   .cpu() for name in live},
        "features": features.double().cpu(),
        "panoptic": None if results is None else results["panoptic"].cpu(),
        "sem_conf": None if stats is None else stats["sem_conf"].cpu()}
    del state, metrics, features, results, stats
    torch.cuda.empty_cache()
    return out


def spatial_distances(torch, ours, ref):
    """The distances of ``spatial_step_run``'s ``ours`` from ``ref``: the
    losses (relative), each module's gradient (relative L2) and parameters
    after the step (max |diff| / (1 + max |value|)), the replay features
    (max |diff|), and whether ``sem_conf`` and the panoptic map are
    equal."""
    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    out = {
        "loss_rel": {k: abs(ours["metrics"][k] - v) / max(abs(v), 1e-30)
                     for k, v in ref["metrics"].items()},
        "grad_rel_l2": {k: rel_l2(ours["grads"][k], v)
                        for k, v in ref["grads"].items()},
        "param_err": {k: float((ours["params"][k] - v).abs().max()
                               / (1.0 + v.abs().max()))
                      for k, v in ref["params"].items()},
        "features": float((ours["features"] - ref["features"]).abs().max())}
    if ours["panoptic"] is not None and ref["panoptic"] is not None:
        out["sem_conf_equal"] = bool(torch.equal(ours["sem_conf"],
                                                 ref["sem_conf"]))
        out["panoptic_equal"] = bool(torch.equal(ours["panoptic"],
                                                 ref["panoptic"]))
        out["panoptic_diff_share"] = float(
            (ours["panoptic"] != ref["panoptic"]).double().mean())
    return out


# what each timed collective needs to communicate
SPLIT_COLLECTIVES = {"halo_rows": "rows", "gather_rows": "rows",
                     "gather_images": "images", "all_reduce": "group",
                     "all_gather": "group", "sum_gradients": "group"}


def timed_collectives(torch, names):
    """Wraps each function in ``names`` (of ``codeps_torch.parallel.spatial``
    or, for ``all_reduce``, ``all_gather`` and ``sum_gradients``, of
    ``codeps_torch.parallel``: batch statistics, the top-k, the metrics
    and the gradients) so that its calls are timed on the host clock after
    a synchronize, those that communicate (inside the split the function
    serves, SPLIT_COLLECTIVES); returns (the seconds by name, a function
    that restores them)."""
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    homes = {name: spatial if hasattr(spatial, name) else parallel
             for name in names}
    when = {"rows": spatial.active, "images": spatial.images_active,
            "group": parallel.active}
    seconds = {name: [] for name in names}
    saved = {name: getattr(homes[name], name) for name in names}

    def timed(name):
        fn, communicates = saved[name], when[SPLIT_COLLECTIVES[name]]

        def call(*args, **kwargs):
            if not communicates():
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            return out
        return call
    for name in names:
        setattr(homes[name], name, timed(name))

    def restore():
        for name, fn in saved.items():
            setattr(homes[name], name, fn)
    return seconds, restore


def spatial_exactness(torch, device, modules):
    """Phase 14 (a) and (b) on this rank; ``modules`` are phase 7's float32
    weights on the host. Returns rank 0's distances of the row split from
    one process (float64; float32 with its control), every rank's metrics
    and the grouping calls. The timed steps are (g)'s."""
    import numpy as np
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    num_scales = adapt_config(target_size,
                              source_size).depth.num_recon_scales

    def batch_of(index):
        rng = np.random.default_rng(SEED + 14 + index)
        batch = spatial_batch(rng, target_size, source_size)
        return batch, automask_noise(torch, rng, target_size, source_size,
                                     num_scales)
    batch, noise = batch_of(0)
    lead = parallel.rank() == 0
    finish = recorded_grouping(torch)

    def build(dtype_name):
        cfg = adapt_config(target_size, source_size)
        cfg.tpu.compute_dtype = dtype_name
        cfg.adapt.mixup.general.geom_augment = True
        step = make_adapt_step(
            cfg, list(cfg.semantics.class_weights), has_replay=True,
            num_mixup=NUM_MIXUP, mixup_groups=(("cut_mixup", NUM_MIXUP),),
            fused_mixup=True,
            eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))
        return cfg, step

    out, peaks = {"float32": []}, {}
    try:
        cfg, step = build("float32")
        # no autocast: float64 and float32 are each exact
        mods = with_compute_dtype(torch, modules, torch.float32)

        def run(given, given_noise, dtype, split, name):
            torch.cuda.reset_peak_memory_stats()
            with spatial.rows() if split else parallel.replicated():
                result = spatial_step_run(
                    torch, step, cfg, copy.deepcopy(mods).to(device, dtype),
                    given, given_noise, device)
            peaks[name] = torch.cuda.max_memory_allocated()
            return result

        for index in range(SPATIAL_F32_BATCHES):
            given, given_noise = (batch, noise) if index == 0 \
                else batch_of(index)
            f64 = float_frames(torch, given, torch.float64)
            f32 = float_frames(torch, given, torch.float32)
            truth = None
            if index == 0:
                ours = run(f64, given_noise, torch.float64, True,
                           "float64_split")
                out["float64"] = {"metrics": ours["metrics"]}
            if lead:
                truth = run(f64, given_noise, torch.float64, False,
                            "float64_one_process")
                if index == 0:
                    out["float64"]["against_one_process"] = \
                        spatial_distances(torch, ours, truth)
            parallel.barrier()
            ours = run(f32, given_noise, torch.float32, True,
                       "float32_split")
            part = {"metrics": ours["metrics"]}
            if lead:
                ref = run(f32, given_noise, torch.float32, False,
                          "float32_one_process")
                part["against_one_process"] = spatial_distances(torch, ours,
                                                                ref)
                part["to_float64"] = {
                    "split": spatial_distances(torch, ours, truth),
                    "one_process": spatial_distances(torch, ref, truth)}
                if index == 0:
                    # the one-process step again: the card's run-to-run
                    # float32 spread, for scale
                    again = run(f32, given_noise, torch.float32, False,
                                "float32_one_process")
                    part["one_process_again"] = spatial_distances(
                        torch, again, ref)
                    del again
            out["float32"].append(part)
            del ours, truth
            parallel.barrier()
    finally:
        grouped = finish()
    return {"exact": out, "peak_mib": {k: v / 2**20
                                       for k, v in peaks.items()},
            **grouped}


def spatial_hybrid(torch, device, modules):
    """Phase 14 (g) on this rank: (a)'s published batch under the hybrid
    placement (``spatial.hybrid``: on SPATIAL_RANKS = 2 ranks the source,
    target replay and fused cut mixup, 2 samples each, by images, the
    target and its eval by rows): one float64 step against one process
    on rank 0; timed bfloat16 steps on uint8 frames under the hybrid
    placement, under pure rows (``spatial.rows``) and in one process, in
    turns; then one step of each placement with its halo exchanges,
    gathers and all-reduces counted and timed (``timed_collectives``).
    ``modules`` are phase 7's float32 weights on the host."""
    import numpy as np
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    lead = parallel.rank() == 0
    # (a)'s first batch and noise
    rng = np.random.default_rng(SEED + 14)
    batch = spatial_batch(rng, target_size, source_size)
    noise = automask_noise(torch, rng, target_size, source_size,
                           adapt_config(target_size, source_size)
                           .depth.num_recon_scales)

    def build(dtype_name):
        cfg = adapt_config(target_size, source_size)
        cfg.tpu.compute_dtype = dtype_name
        cfg.adapt.mixup.general.geom_augment = True
        return cfg, make_adapt_step(
            cfg, list(cfg.semantics.class_weights), has_replay=True,
            num_mixup=NUM_MIXUP, mixup_groups=(("cut_mixup", NUM_MIXUP),),
            fused_mixup=True,
            eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))

    placements = {"hybrid": spatial.hybrid, "rows": spatial.rows,
                  "one_process": parallel.replicated}
    out = {"placement": spatial.hybrid_placement(batch,
                                                  parallel.world_size())}
    finish = recorded_grouping(torch)
    try:
        # float64, exact: no autocast
        cfg, step = build("float32")
        mods = with_compute_dtype(torch, copy.deepcopy(modules),
                                  torch.float32)
        f64 = float_frames(torch, batch, torch.float64)
        runs = {}
        for name in ("hybrid", "one_process"):
            if name == "hybrid" or lead:
                torch.cuda.reset_peak_memory_stats()
                with placements[name]():
                    runs[name] = spatial_step_run(
                        torch, step, cfg,
                        copy.deepcopy(mods).to(device, torch.float64), f64,
                        noise, device)
                runs[name]["peak_mib"] = \
                    torch.cuda.max_memory_allocated() / 2**20
            parallel.barrier()
        out["float64"] = {"metrics": runs["hybrid"]["metrics"],
                          "peak_mib": runs["hybrid"]["peak_mib"]}
        if lead:
            out["float64"]["against_one_process"] = spatial_distances(
                torch, runs["hybrid"], runs["one_process"])
        del runs, mods
        torch.cuda.empty_cache()
        # bfloat16, the package default, on uint8 frames: a warm-up and
        # SPATIAL_TIMED_STEPS timed steps of each placement in turns (one
        # process on rank 0 alone)
        cfg, step = build("bfloat16")
        mods = with_compute_dtype(torch, copy.deepcopy(modules),
                                  torch.bfloat16)
        times = {name: [] for name in placements}
        for _ in range(1 + SPATIAL_TIMED_STEPS):
            for name, placement in placements.items():
                if name != "one_process" or lead:
                    t0 = time.perf_counter()
                    with placement():
                        spatial_step_run(torch, step, cfg,
                                         copy.deepcopy(mods).to(device),
                                         batch, noise, device)
                    times[name].append((time.perf_counter() - t0) * 1e3)
                parallel.barrier()
        out["step_ms"] = times
        # one instrumented step of each split placement
        out["collectives_ms"] = {}
        for name in ("hybrid", "rows"):
            seconds, restore = timed_collectives(
                torch, list(SPLIT_COLLECTIVES))
            try:
                with placements[name]():
                    spatial_step_run(torch, step, cfg,
                                     copy.deepcopy(mods).to(device), batch,
                                     noise, device)
            finally:
                restore()
            out["collectives_ms"][name] = {k: [t * 1e3 for t in v]
                                           for k, v in seconds.items()}
            parallel.barrier()
    finally:
        out.update(finish())
    return out


def spatial_stream(torch, device, modules):
    """Phase 14 (c) on this rank: phase 7's stream for SPATIAL_FRAMES
    frames with ``tpu.spatial_shard`` (rank 0 streams, the others follow;
    the runner's steps under the hybrid placement), the gathers timed on
    their own, then on rank 0 the same stream in one process; in bfloat16
    (the package default), then with float64 modules (the runner then
    streams float64 batches); then (g) the bfloat16 split stream with the
    runner's steps under pure rows (``bfloat16``'s ``rows``). Returns the
    numbers of each, by name."""
    import numpy as np
    from codeps_torch import parallel
    from codeps_torch.ops import grouping
    from codeps_torch.parallel import spatial
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    lead = parallel.rank() == 0

    def stream(spatial_shard, name, preds, placement=None):
        # float64 modules compute without autocast
        compute = "float32" if name == "float64" else "bfloat16"
        cfg = stream_config(target_size, source_size)
        cfg.tpu.spatial_shard = spatial_shard
        cfg.tpu.compute_dtype = compute
        mods = with_compute_dtype(torch, copy.deepcopy(modules),
                                  getattr(torch, compute))
        runner, buffer = build_stream(
            cfg, mods.to(device, torch.float64 if name == "float64"
                         else torch.float32),
            device, SEED, noise=numpy_noise(torch, SEED, device))
        if placement is not None:
            runner.placement = placement
        if lead:
            meters, run = drive_stream(torch, runner, card=True,
                                       max_frames=SPATIAL_FRAMES)
            numbers = stream_numbers(runner, run)
            numbers.update(values=meter_values(meters),
                           ids={k: np.asarray(v).tolist() for k, v in
                                buffer.buffer_indices.items()},
                           launches=run["launches"], copies=run["copies"],
                           calls=len(run["centers"]),
                           max_abs_err=run["max_abs_err"])
            preds.append([pred for _, pred in run["pq_maps"]])
        else:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            grouping.group_pixels_cuda.launches = 0
            grouping.group_pixels_cuda.copies = 0
            runner.run(max_frames=SPATIAL_FRAMES)
            torch.cuda.synchronize()
            numbers = {"launches": grouping.group_pixels_cuda.launches,
                       "copies": grouping.group_pixels_cuda.copies,
                       "peak_mib": torch.cuda.max_memory_allocated()
                       / 2**20}
        numbers["row_times_ms"] = {k: [t * 1e3 for t in v]
                                   for k, v in runner.row_times.items()}
        del runner, buffer
        torch.cuda.empty_cache()
        return numbers

    out = {}
    for name in ("bfloat16", "float64"):
        preds = []
        seconds, restore = timed_collectives(torch, ["gather_rows"])
        try:
            part = {"split": stream(True, name, preds)}
        finally:
            restore()
        part["split"]["gather_ms"] = [t * 1e3
                                      for t in seconds["gather_rows"]]
        if lead:
            with parallel.replicated():
                part["one_process"] = stream(False, name, preds)
            part["panoptic_diff_share"] = [
                float((a != b).mean()) for a, b in zip(*preds)]
        parallel.barrier()
        out[name] = part
    # (g): the runner's steps under pure rows, for the frame latency of
    # both placements
    out["bfloat16"]["rows"] = stream(True, "bfloat16_rows", [],
                                     placement=spatial.rows)
    parallel.barrier()
    return out


def recorded_grouping(torch):
    """Records every grouping call of the panoptic fusion from here on,
    with the counts set to 0. Returns ``finish()``, which restores the
    fusion's grouping and returns the launches, copies, calls, the
    largest |kernel - plain| over the calls and the offsets' shapes, each
    call held equal to ``group_pixels_plain`` on the same inputs."""
    from codeps_torch.ops import grouping
    from codeps_torch.ops import panoptic as panoptic_ops
    calls = []
    group_pixels = panoptic_ops.group_pixels

    def recording(yx, valid, offsets):
        out = group_pixels(yx, valid, offsets)
        calls.append((yx.clone(), valid.clone(), offsets.clone(), out))
        return out
    panoptic_ops.group_pixels = recording
    grouping.group_pixels_cuda.launches = 0
    grouping.group_pixels_cuda.copies = 0

    def finish():
        panoptic_ops.group_pixels = group_pixels
        max_err = 0
        for yx, valid, offsets, got in calls:
            ref = grouping.group_pixels_plain(yx, valid, offsets)
            max_err = max(max_err, int((got.long() - ref.long()).abs()
                                       .max()))
            assert torch.equal(got, ref), "kernel != plain in phase 14"
        return {"launches": grouping.group_pixels_cuda.launches,
                "copies": grouping.group_pixels_cuda.copies,
                "calls": len(calls), "max_abs_err": max_err,
                "shapes": sorted({tuple(o.shape[:3])
                                  for _, _, o, _ in calls})}
    return finish


def kept_shares(torch, module, shares):
    """Patch ``module.depth_forward`` to append, for each object-motion
    pair it returns, the auto-mask's kept share of each map's pixels to
    ``shares``; returns the function that restores it."""
    forward = module.depth_forward

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        shares.append([float((m.detach() != 0).any(1).double().mean())
                       for m in out["object_motion_maps"]])
        return out
    module.depth_forward = recording

    def restore():
        module.depth_forward = forward
    return restore


def spatial_flow(torch, device, modules):
    """Phase 14 (f) on this rank: the scene-flow step of phase 12 (the
    flow head live, phase 14's batch with the fused cut mixup) split over
    the ranks against one process, in float64 (held to
    SPATIAL_F64_BOUND, the eval's motion pair and the auto-mask's kept
    shares equal) and timed in bfloat16; then phase 7's stream with the
    flow head for SPATIAL_FLOW_FRAMES frames, split and in one process,
    with the kept share of every flow-head call. ``modules`` are phase
    7's float32 weights on the host."""
    import numpy as np
    from codeps_torch import parallel
    from codeps_torch.ops import grouping
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks import adapt as adapt_module
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    lead = parallel.rank() == 0
    rng = np.random.default_rng(SEED + 15)
    batch = spatial_batch(rng, target_size, source_size)

    def flow_cfg(dtype_name):
        cfg = adapt_config(target_size, source_size)
        cfg.model.make_sflow = cfg.adapt.model.sflow = True
        cfg.tpu.compute_dtype = dtype_name
        cfg.adapt.mixup.general.geom_augment = True
        return cfg

    cfg = flow_cfg("float32")
    noise = flow_automask_noise(rng, target_size, source_size,
                                cfg.depth.num_recon_scales)
    host = flow_modules(torch, cfg, modules)

    def build(dtype_name):
        cfg = flow_cfg(dtype_name)
        return cfg, make_adapt_step(
            cfg, list(cfg.semantics.class_weights), has_replay=True,
            num_mixup=NUM_MIXUP, mixup_groups=(("cut_mixup", NUM_MIXUP),),
            fused_mixup=True,
            eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))

    out = {}
    finish = recorded_grouping(torch)
    # float64, exact: no autocast
    cfg, step = build("float32")
    mods = with_compute_dtype(torch, copy.deepcopy(host), torch.float32)
    f64 = float_frames(torch, batch, torch.float64)
    runs = {}
    for split in (True, False):
        if not split and not lead:
            continue
        shares = []
        restore = kept_shares(torch, adapt_module, shares)
        try:
            with spatial.rows() if split else parallel.replicated():
                runs[split] = spatial_step_run(
                    torch, step, cfg,
                    copy.deepcopy(mods).to(device, torch.float64), f64,
                    noise, device)
        finally:
            restore()
        runs[split]["kept_share"] = shares
    out["float64"] = {"metrics": runs[True]["metrics"],
                      "kept_share": runs[True]["kept_share"]}
    if lead:
        out["float64"]["against_one_process"] = spatial_distances(
            torch, runs[True], runs[False])
        out["float64"]["one_process_kept_share"] = runs[False]["kept_share"]
    del runs
    parallel.barrier()
    # bfloat16, uint8 frames: timed steps, row split then one process
    cfg, step = build("bfloat16")
    mods = with_compute_dtype(torch, copy.deepcopy(host), torch.bfloat16)
    times = {"split": [], "one_process": []}
    for split in (True, False):
        if not split and not lead:
            continue
        for _ in range(1 + SPATIAL_FLOW_TIMED_STEPS):
            t0 = time.perf_counter()
            with spatial.rows() if split else parallel.replicated():
                spatial_step_run(torch, step, cfg,
                                 copy.deepcopy(mods).to(device), batch,
                                 noise, device)
            times["split" if split else "one_process"].append(
                (time.perf_counter() - t0) * 1e3)
    out["step_ms"] = times
    parallel.barrier()
    out["step_grouping"] = finish()

    def stream(spatial_shard):
        scfg = stream_config(target_size, source_size)
        scfg.model.make_sflow = scfg.adapt.model.sflow = True
        scfg.tpu.spatial_shard = spatial_shard
        runner, buffer = build_stream(
            scfg, with_compute_dtype(torch, copy.deepcopy(host),
                                     torch.bfloat16).to(device),
            device, SEED, noise=numpy_noise(torch, SEED, device))
        shares = []
        restore = kept_shares(torch, adapt_module, shares)
        try:
            if lead:
                meters, run = drive_stream(torch, runner, card=True,
                                           max_frames=SPATIAL_FLOW_FRAMES)
                numbers = stream_numbers(runner, run)
                numbers.update(
                    values=meter_values(meters), launches=run["launches"],
                    copies=run["copies"], calls=len(run["centers"]),
                    max_abs_err=run["max_abs_err"],
                    ids={k: np.asarray(v).tolist() for k, v in
                         buffer.buffer_indices.items()})
            else:
                grouping.group_pixels_cuda.launches = 0
                grouping.group_pixels_cuda.copies = 0
                runner.run(max_frames=SPATIAL_FLOW_FRAMES)
                torch.cuda.synchronize()
                numbers = {"launches": grouping.group_pixels_cuda.launches,
                           "copies": grouping.group_pixels_cuda.copies}
        finally:
            restore()
        numbers["kept_share"] = shares
        del runner, buffer
        torch.cuda.empty_cache()
        return numbers

    out["stream"] = {"split": stream(True)}
    if lead:
        with parallel.replicated():
            out["stream"]["one_process"] = stream(False)
    parallel.barrier()
    return out


def spatial_three_rank(rank, world, port, out_dir):
    """Phase 14 (e), one of SPATIAL_UNEVEN_RANKS ranks started by
    ``torch.multiprocessing.spawn`` on card ``cuda:0`` over gloo: one
    float64 step of the published batch under the hybrid placement (2
    side samples do not divide over 3 ranks: every domain by rows) with
    the target's 384 rows split 4 / 4 / 4 blocks and the source's 512
    rows 6 / 5 / 5, against one
    process on rank 0 (``parallel.replicated``), from phase 7's weights
    in ``out_dir/modules.pt``. Writes ``out_dir/uneven<rank>.json``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import numpy as np
    import torch
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(out_dir)
    device = torch.device("cuda", 0)
    modules = torch.load(out_dir / "modules.pt", weights_only=False)
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    rng = np.random.default_rng(SEED + 14)
    batch = spatial_batch(rng, target_size, source_size)
    cfg = adapt_config(target_size, source_size)
    cfg.tpu.compute_dtype = "float32"
    cfg.adapt.mixup.general.geom_augment = True
    noise = automask_noise(torch, rng, target_size, source_size,
                           cfg.depth.num_recon_scales)
    step = make_adapt_step(
        cfg, list(cfg.semantics.class_weights), has_replay=True,
        num_mixup=NUM_MIXUP, mixup_groups=(("cut_mixup", NUM_MIXUP),),
        fused_mixup=True,
        eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))
    mods = with_compute_dtype(torch, modules, torch.float32)
    f64 = float_frames(torch, batch, torch.float64)
    t0 = time.perf_counter()
    finish = recorded_grouping(torch)
    with parallel.process_group(device):
        assert torch.distributed.get_backend() == "gloo"
        slabs = row_slabs(spatial, {
            "target": (HEIGHT, WIDTH),
            "source": (SOURCE_HEIGHT, SOURCE_WIDTH)})
        torch.cuda.reset_peak_memory_stats()
        with spatial.hybrid():
            ours = spatial_step_run(torch, step, cfg, copy.deepcopy(mods).to(
                device, torch.float64), f64, noise, device)
        numbers = {"rank": rank, "slabs": slabs, "metrics": ours["metrics"],
                   "placement": spatial.hybrid_placement(f64, world),
                   "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        if rank == 0:
            with parallel.replicated():
                ref = spatial_step_run(torch, step, cfg, copy.deepcopy(
                    mods).to(device, torch.float64), f64, noise, device)
            numbers["against_one_process"] = spatial_distances(torch, ours,
                                                               ref)
        parallel.barrier()
    numbers.update(finish())
    numbers["seconds"] = time.perf_counter() - t0
    (out_dir / f"uneven{rank}.json").write_text(json.dumps(
        numbers, default=float))


def spatial_empty_rank(rank, world, port, out_dir):
    """Phase 14 (h1), one of SPATIAL_EMPTY_RANKS ranks started by
    ``torch.multiprocessing.spawn`` on card ``cuda:0`` over gloo: one
    float64 step of the published batch at the published widths and
    SPATIAL_EMPTY_SIZES' heights, fewer 32-row blocks than ranks (the
    target's 3 blocks 1 / 1 / 1 / 0, the source's and mixup's 2 blocks
    1 / 1 / 0 / 0), under the hybrid placement (2 side samples do not
    divide over 4 ranks: every domain by rows), against one process on
    rank 0 (``parallel.replicated``), from phase 7's weights in
    ``out_dir/modules.pt``. Writes ``out_dir/empty<rank>.json``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import numpy as np
    import torch
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(out_dir)
    device = torch.device("cuda", 0)
    modules = torch.load(out_dir / "modules.pt", weights_only=False)
    target_size, source_size = SPATIAL_EMPTY_SIZES
    rng = np.random.default_rng(SEED + 14)
    batch = spatial_batch(rng, target_size, source_size)
    cfg = adapt_config(target_size, source_size)
    cfg.tpu.compute_dtype = "float32"
    cfg.adapt.mixup.general.geom_augment = True
    noise = automask_noise(torch, rng, target_size, source_size,
                           cfg.depth.num_recon_scales)
    step = make_adapt_step(
        cfg, list(cfg.semantics.class_weights), has_replay=True,
        num_mixup=NUM_MIXUP, mixup_groups=(("cut_mixup", NUM_MIXUP),),
        fused_mixup=True,
        eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))
    mods = with_compute_dtype(torch, modules, torch.float32)
    f64 = float_frames(torch, batch, torch.float64)
    t0 = time.perf_counter()
    finish = recorded_grouping(torch)
    with parallel.process_group(device):
        assert torch.distributed.get_backend() == "gloo"
        slabs = row_slabs(spatial, {"target": target_size,
                                    "source": source_size})
        torch.cuda.reset_peak_memory_stats()
        with spatial.hybrid():
            ours = spatial_step_run(torch, step, cfg, copy.deepcopy(mods).to(
                device, torch.float64), f64, noise, device)
        numbers = {"rank": rank, "slabs": slabs, "metrics": ours["metrics"],
                   "placement": spatial.hybrid_placement(f64, world),
                   "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        if rank == 0:
            with parallel.replicated():
                ref = spatial_step_run(torch, step, cfg, copy.deepcopy(
                    mods).to(device, torch.float64), f64, noise, device)
            numbers["against_one_process"] = spatial_distances(torch, ours,
                                                               ref)
        parallel.barrier()
    numbers.update(finish())
    numbers["seconds"] = time.perf_counter() - t0
    (out_dir / f"empty{rank}.json").write_text(json.dumps(
        numbers, default=float))


def row_slabs(spatial, sizes):
    """This rank's [first, stop) rows of each named image (height,
    width) under ``spatial.rows()``."""
    slabs = {}
    with spatial.rows():
        for name, (height, width) in sizes.items():
            with spatial.image(height, width):
                rows = spatial.row_slab(height)
                slabs[name] = [rows.start, rows.stop]
    return slabs


def spatial_wide_rank(rank, world, port, out_dir):
    """Phase 14 (h2), one of SPATIAL_WIDE_RANKS ranks (a two-node count)
    started by ``torch.multiprocessing.spawn`` on card ``cuda:0`` over
    gloo, on the published 384x1408 frame from phase 7's weights: the
    target's 12 blocks on the first 12 ranks, empty slabs on the others,
    the source's 16 blocks one a rank. The float64 teacher eval under
    ``spatial.rows()``, its maps held equal to one process's on rank 0;
    then SPATIAL_WIDE_TIMED_STEPS timed bfloat16 steps of the published
    batch under the hybrid placement (every domain by rows: 2 side
    samples do not divide 16) after a warm-up, which is instrumented (its
    collectives counted and timed), and each rank's peak memory.
    Writes ``out_dir/wide<rank>.json``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import numpy as np
    import torch
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks.adapt import (build_eval_forward,
                                          make_adapt_step, make_eval_step)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    started = time.perf_counter()
    out_dir = Path(out_dir)
    device = torch.device("cuda", 0)
    modules = torch.load(out_dir / "modules.pt", weights_only=False)
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    rng = np.random.default_rng(SEED + 14)
    batch = spatial_batch(rng, target_size, source_size)
    noise = automask_noise(torch, rng, target_size, source_size,
                           adapt_config(target_size, source_size)
                           .depth.num_recon_scales)
    lead = rank == 0
    finish = recorded_grouping(torch)
    with parallel.process_group(device):
        assert torch.distributed.get_backend() == "gloo"
        numbers = {"rank": rank, "slabs": row_slabs(
            spatial, {"target": target_size, "source": source_size}),
            "start_s": time.perf_counter() - started}
        # the float64 teacher eval, split and (rank 0) in one process
        cfg = adapt_config(target_size, source_size)
        cfg.tpu.compute_dtype = "float32"
        eval_step = make_eval_step(cfg, THINGS, NUM_CLASSES)
        teacher = with_compute_dtype(torch, copy.deepcopy(modules),
                                     torch.float32).to(device,
                                                       torch.float64).eval()
        f64 = float_frames(torch, batch, torch.float64)
        eval_batch = {"frames": f64["target"]["frames"], **f64["eval_gt"]}
        t0 = time.perf_counter()
        with spatial.rows():
            results, stats = eval_step(teacher, eval_batch)
        torch.cuda.synchronize()
        numbers["eval_s"] = time.perf_counter() - t0
        numbers["eval_on_rank"] = results is not None
        if lead:
            with parallel.replicated():
                ref, ref_stats = eval_step(teacher, eval_batch)
            numbers["eval_equal"] = {
                key: bool(torch.equal(results[key], ref[key]))
                for key in ("semantic", "instance", "panoptic")}
            numbers["eval_equal"]["sem_conf"] = bool(torch.equal(
                stats["sem_conf"], ref_stats["sem_conf"]))
            numbers["eval_depth_err"] = float(
                (results["depth"] - ref["depth"]).abs().max()
                / ref["depth"].abs().max())
            del ref, ref_stats
        del teacher, results, stats
        torch.cuda.empty_cache()
        parallel.barrier()
        # bfloat16, the package default, on uint8 frames
        cfg = adapt_config(target_size, source_size)
        cfg.tpu.compute_dtype = "bfloat16"
        cfg.adapt.mixup.general.geom_augment = True
        step = make_adapt_step(
            cfg, list(cfg.semantics.class_weights), has_replay=True,
            num_mixup=NUM_MIXUP, mixup_groups=(("cut_mixup", NUM_MIXUP),),
            fused_mixup=True,
            eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))
        mods = with_compute_dtype(torch, copy.deepcopy(modules),
                                  torch.bfloat16)
        numbers["placement"] = spatial.hybrid_placement(batch, world)
        numbers["step_ms"], numbers["metrics"] = [], []
        torch.cuda.reset_peak_memory_stats()
        for index in range(1 + SPATIAL_WIDE_TIMED_STEPS):
            # the warm-up is the instrumented step
            if index == 0:
                seconds, restore = timed_collectives(
                    torch, list(SPLIT_COLLECTIVES))
            parallel.barrier()
            t0 = time.perf_counter()
            try:
                with spatial.hybrid():
                    run = spatial_step_run(torch, step, cfg,
                                           copy.deepcopy(mods).to(device),
                                           batch, noise, device)
            finally:
                if index == 0:
                    restore()
            numbers["step_ms"].append((time.perf_counter() - t0) * 1e3)
            numbers["metrics"].append(run["metrics"])
            if index == 0:
                numbers["collectives_ms"] = {
                    k: [t * 1e3 for t in v] for k, v in seconds.items()}
        numbers["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        parallel.barrier()
    numbers.update(finish())
    numbers["seconds"] = time.perf_counter() - started
    (out_dir / f"wide{rank}.json").write_text(json.dumps(
        numbers, default=float))


def spatial_smoke_rank(rank, world, port, out_dir):
    """One rank of phase 14 (a) to (c) and (f), started by
    ``torch.multiprocessing.spawn``: every rank on the explicit card
    ``cuda:0``, over gloo. Reads phase 7's weights from
    ``out_dir/modules.pt`` and writes its numbers to
    ``out_dir/rank<rank>.json``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch
    from codeps_torch import parallel
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(out_dir)
    device = torch.device("cuda", 0)
    modules = torch.load(out_dir / "modules.pt", weights_only=False)
    with parallel.process_group(device):
        assert torch.distributed.get_backend() == "gloo"
        t0 = time.perf_counter()
        numbers = {"rank": rank, "exactness": spatial_exactness(
            torch, device, modules)}
        numbers["exactness_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        numbers["hybrid"] = spatial_hybrid(torch, device, modules)
        numbers["hybrid_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        numbers["stream"] = spatial_stream(torch, device, modules)
        numbers["stream_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        numbers["flow"] = spatial_flow(torch, device, modules)
        numbers["flow_s"] = time.perf_counter() - t0
    (out_dir / f"rank{rank}.json").write_text(json.dumps(
        numbers, default=float))


SPATIAL_CLI_YAML = """
model:
  make_sflow: {sflow}
  po_depth_net:
    params:
      nof_layers: 18
adapt:
  model:
    backbone_po_depth: false
    instance: false
  ema:
    semantic: true
    alpha: 0.99
  source_dataset:
    name: cityscapes
    path: {cs}
    feed_img_size: [{height}, {width}]
  replay_sampler:
    nof_source_samples: 2
    nof_target_samples: 2
  replay_buffer:
    maximize_diversity: true
    target_size: 3
  mixup:
    general:
      mixup_strategies: [cut_mixup, cut_mixup]
      nof_samples: 2
dataset:
  name: kitti_360
  path: {k360}
  sequences: ["03"]
  feed_img_size: [{height}, {width}]
  center_heatmap_sigma: 4
tpu:
  spatial_shard: true
"""


def spatial_cli(root):
    """Phase 14 (d): ``python -m torch.distributed.run --nproc_per_node
    SPATIAL_RANKS -m codeps_torch.scripts.adapt`` on synthetic KITTI-360
    and Cityscapes trees written under ``root`` (ResNet-18 at
    SPATIAL_CLI_SIZE, ``tpu.spatial_shard: true``, every rank on card
    ``cuda:0`` over gloo), then the same with ``model.make_sflow: true``.
    Returns (seconds, files written, the flow run's exit code, seconds and
    files, output tails)."""
    import os
    from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                             make_kitti360_tree)
    height, width = SPATIAL_CLI_SIZE
    cs = make_cityscapes_tree(root / "cs", num_frames=6, width=width,
                              height=height)
    make_cityscapes_tree(cs, num_frames=2, width=width, height=height,
                         split="val", seed=5)
    k360 = make_kitti360_tree(root / "k360", num_frames=8, width=width,
                              height=height)
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")

    def run(name, sflow):
        config = root / f"{name}.yaml"
        config.write_text(SPATIAL_CLI_YAML.format(
            sflow=sflow, cs=cs, k360=k360, height=height, width=width))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", str(SPATIAL_RANKS), "--master_port",
             str(free_port()), "-m", "codeps_torch.scripts.adapt",
             "--run_name", name, "--filename_config", str(config),
             "--max_frames", str(SPATIAL_CLI_FRAMES), "--device", "cuda:0",
             "--experiments_dir", str(root / "experiments"),
             "--save_buffer_state", str(root / f"{name}_buffer.pkl")],
            env=env, cwd=str(root), capture_output=True, text=True,
            timeout=600)
        return proc, time.perf_counter() - t0

    proc, seconds = run("spatial", "false")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    written = sorted(str(p.relative_to(root / "experiments"))
                     for p in (root / "experiments").rglob("*")
                     if p.is_file())
    log = (root / "experiments" / "adapt_spatial" / "logs"
           / "run.log").read_text()
    buffer_states = sorted(p.name for p in root.glob("*_buffer.pkl"))
    flow, flow_seconds = run("flow", "true")
    flow_written = sorted(str(p.relative_to(root / "experiments"))
                          for p in (root / "experiments" / "adapt_flow")
                          .rglob("*") if p.is_file())
    return {"seconds": seconds, "written": written,
            "buffer_states": buffer_states,
            "stream_lines": log.count("Adaptation done"),
            "val_lines": log.count("Target val"),
            "flow_rc": flow.returncode, "flow_seconds": flow_seconds,
            "flow_written": flow_written,
            "flow_tail": flow.stdout[-3000:] + flow.stderr[-3000:],
            "tail": proc.stdout[-1500:]}


def main() -> int:
    script_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "machine with a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from codeps_torch.models import CodepsNet, build_modules, init_params
    from codeps_torch.ops import grouping
    from codeps_torch.ops._build import build
    from codeps_torch.ops.panoptic import (find_instance_centers_batch,
                                           panoptic_fusion_batch)

    phase("1 device")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; count {count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convolutions and matmuls: comparisons run "
          "in full float32")

    phase("2 build")
    t0 = time.perf_counter()
    paths = build(["grouping"])
    print(f"built {paths['grouping'].name} in "
          f"{time.perf_counter() - t0:.2f} s")

    phase("3 kernel against plain")
    max_err = 0
    # made one at a time and dropped after, so that none counts in the
    # later phases' peak memory; truly NHWC inputs are copied once, views
    # never
    cases = itertools.chain(
        ((*case, 1) for case in grouping_cases(torch, device)),
        ((f"fixed inputs, first {n} of {TOP_K} valid, NCHW view",
          *fixed_grouping_inputs(torch, device, n), 0)
         for n in VALID_COUNTS))
    for name, yx, valid, offsets, copies in cases:
        before = grouping.group_pixels_cuda.copies
        ours = grouping.group_pixels_cuda(yx, valid, offsets)
        copied = grouping.group_pixels_cuda.copies - before
        ref = grouping.group_pixels_plain(yx, valid, offsets)
        torch.cuda.synchronize()
        err = int((ours.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        print(f"{name}: valid {valid.sum(1).tolist()}, max |id diff| "
              f"{err}, layout copies {copied}")
        assert torch.equal(ours, ref), f"kernel != plain on {name}"
        assert copied == copies, (name, copied)
    del yx, valid, offsets, ours, ref

    phase("4 slice")
    cfg = slice_config()
    import numpy as np
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (NUM_FRAMES + 1, 1, HEIGHT, WIDTH, 3),
                          dtype=np.uint8)
    modules = init_params(build_modules(cfg, NUM_CLASSES, device=device),
                          seed=SEED, device=device)
    calibrate_batch_norm(torch, modules, frames[-1])
    net = CodepsNet(modules, thing_list=THINGS, device=device)
    warm = net(frames[-1], mode="eval")
    shift = float(0.1 - torch.quantile(warm["center"].flatten(), 0.9998))
    with torch.no_grad():
        modules.instance_head.center_head.net.conv.bias.add_(shift)
    net(frames[-1], mode="eval")
    torch.cuda.synchronize()
    print(f"center bias shifted by {shift:.4f}")

    torch.cuda.reset_peak_memory_stats()
    grouping.group_pixels_cuda.launches = 0
    grouping.group_pixels_cuda.copies = 0
    results, seconds = [], []
    for frame in frames[:NUM_FRAMES]:
        t0 = time.perf_counter()
        results.append(net(frame, mode="eval"))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = grouping.group_pixels_cuda.launches
    copies = grouping.group_pixels_cuda.copies
    peak = torch.cuda.max_memory_allocated()
    print(f"grouping launches in the streamed run: {launches}; layout "
          f"copies: {copies}")
    assert launches == NUM_FRAMES, launches
    assert copies == 0, copies

    centers_per_frame = []
    for result in results:
        check_outputs(torch, result, 1, HEIGHT, WIDTH)
        cpu = {k: v.cpu() for k, v in result.items() if v is not None}
        pan, inst, centers = panoptic_fusion_batch(
            cpu["semantic_soft"], cpu["center"], cpu["offset"], THINGS)
        assert torch.equal(inst, cpu["instance"]), "instance != plain"
        assert torch.equal(pan, cpu["panoptic"]), "panoptic != plain"
        centers_per_frame.append(int(centers.valid.sum()))
    print(f"valid centers per frame: {centers_per_frame}")
    assert max(centers_per_frame) > 0, "no frame had a center"
    latency_ms = statistics.median(seconds) * 1e3
    print(f"per-frame latency (host clock, median of {NUM_FRAMES}): "
          f"{latency_ms:.3f} ms; all: "
          f"{[round(s * 1e3, 3) for s in seconds]}")
    print(f"peak device memory: {peak / 2**20:.1f} MiB")

    small = [64, 128]
    small_cfg = slice_config()
    small_cfg.dataset.feed_img_size = small
    small_cfg.tpu.compute_dtype = "float32"
    small_frames = rng.integers(0, 256, (2, 1, *small, 3), dtype=np.uint8)
    cpu_modules = init_params(build_modules(
        small_cfg, NUM_CLASSES, device="cpu"), seed=SEED, device="cpu")
    calibrate_batch_norm(torch, cpu_modules, small_frames[0])
    with torch.no_grad():
        cpu_modules.instance_head.center_head.net.conv.bias.add_(shift)
    card_modules = copy.deepcopy(cpu_modules)
    on_card, on_cpu = (
        CodepsNet(mods, thing_list=THINGS, device=dev)(small_frames[1],
                                                       mode="eval")
        for mods, dev in ((card_modules, device), (cpu_modules, "cpu")))
    check_outputs(torch, on_card, 1, *small)
    for key in ("depth", "semantic_soft", "center", "offset"):
        ref = on_cpu[key]
        err = float((on_card[key].cpu() - ref).abs().max())
        bound = REL_TOL * float(ref.abs().max())
        print(f"64x128 card vs CPU {key}: max abs err {err:.3g} "
              f"(bound {bound:.3g})")
        assert err <= bound, key
    for key in ("semantic", "panoptic", "instance"):
        agree = float((on_card[key].cpu() == on_cpu[key]).float().mean())
        print(f"64x128 card vs CPU {key}: {agree:.6f} of pixels agree")
        # near-ties of the float outputs may flip a few pixels
        assert agree >= 0.999, key

    phase("5 timing")
    by_valid = []
    for n in VALID_COUNTS:
        yx, valid, offsets = fixed_grouping_inputs(torch, device, n)
        n_ms = device_ms(torch, lambda: grouping.group_pixels_cuda(
            yx, valid, offsets), iters=100)
        n_bound_ms, n_bound_by, moved, ops = grouping_bound(n)
        by_valid.append({"valid_centers": n, "ms": n_ms,
                         "bound_ms": n_bound_ms, "bound_by": n_bound_by})
        print(f"group_pixels, fixed inputs 1x{HEIGHT}x{WIDTH}, {n} valid "
              f"of {TOP_K}: kernel device time {n_ms * 1e3:.3f} us; bound "
              f"{n_bound_ms * 1e3:.3f} us ({n_bound_by}: {moved} B, {ops} "
              f"FP32 ops)")

    last = results[-1]
    centers = find_instance_centers_batch(last["center"][..., 0],
                                          top_k=TOP_K)
    yx, valid, offsets = centers.yx, centers.valid, last["offset"]

    def kernel():
        return grouping.group_pixels_cuda(yx, valid, offsets)

    def plain():
        return grouping.group_pixels_plain(yx, valid, offsets)

    kernel_ms = device_ms(torch, kernel, iters=100)
    kernel_call_ms = call_ms(torch, kernel, iters=100, warmup=10)
    # The plain version is some 1,600 small launches per call, more than
    # the launch queue holds, so only its time per call is measured.
    plain_ms = call_ms(torch, plain, iters=10, warmup=3)
    num_valid = int(valid.sum())
    bound_ms, bound_by, moved, ops = grouping_bound(num_valid)
    print(f"group_pixels, last streamed frame 1x{HEIGHT}x{WIDTH}, "
          f"{num_valid} valid of {TOP_K}: kernel device time "
          f"{kernel_ms * 1e3:.3f} us, per call with the host "
          f"{kernel_call_ms * 1e3:.3f} us; plain per call "
          f"{plain_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}: {moved} B, {ops} FP32 ops)")
    timing_copies = grouping.group_pixels_cuda.copies - copies
    print(f"layout copies in the timing runs: {timing_copies}")
    assert timing_copies == 0, timing_copies

    phase("6 adaptation step")
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    cfg = adapt_config(target_size, source_size)
    # the float32 step starts from the same weights
    f32_modules = copy.deepcopy(modules)
    state, step = build_adapt(torch, modules, cfg, device)
    frozen = {name: [p.detach().clone() for p in
                     getattr(state.student, name).parameters()]
              for name in state.frozen_modules}
    live0 = {name: [p.detach().clone() for p in
                    getattr(state.student, name).parameters()]
             for name in state.live_modules()}
    print(f"frozen: {list(state.frozen_modules)}; live: "
          f"{state.live_modules()}; EMA: {list(state.ema_modules)}")
    from codeps_torch.tasks.adapt import batch_to_device
    batch = batch_to_device(adapt_batch(rng, target_size, source_size),
                            device)
    step(state, batch)                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grouping.group_pixels_cuda.launches = 0
    grouping.group_pixels_cuda.copies = 0
    step_seconds = []
    for i in range(ADAPT_STEPS):
        if i == ADAPT_STEPS - 1:
            ema0 = [p.detach().clone() for p in
                    state.teacher.semantic_head.parameters()]
        t0 = time.perf_counter()
        metrics, features, results, stats = step(state, batch)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        check_adapt_outputs(torch, metrics, results, stats, HEIGHT, WIDTH)
    adapt_launches = grouping.group_pixels_cuda.launches
    adapt_copies = grouping.group_pixels_cuda.copies
    adapt_peak = torch.cuda.max_memory_allocated()
    print(f"grouping launches in the {ADAPT_STEPS} timed steps: "
          f"{adapt_launches}; layout copies: {adapt_copies}")
    assert adapt_launches == ADAPT_STEPS, adapt_launches
    assert adapt_copies == 0, adapt_copies
    print("losses of the last step: " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in metrics.items()))
    print(f"teacher eval of the last step: d_abs_rel "
          f"{float(stats['d_abs_rel']):.6g}, confusion matrix sum "
          f"{int(stats['sem_conf'].sum())}, "
          f"{int(results['instance'].max())} instance ids")
    assert tuple(features.shape) == (1, 2048), features.shape
    assert int(state.dist_count) == 1 + ADAPT_STEPS, int(state.dist_count)
    for name, before in frozen.items():
        for p, p0 in zip(getattr(state.student, name).parameters(), before):
            assert torch.equal(p, p0), f"frozen {name} moved"
    for name, before in live0.items():
        moved = any(not torch.equal(p, p0) for p, p0 in zip(
            getattr(state.student, name).parameters(), before))
        assert moved, f"live {name} did not move"
    alpha = state.ema_alpha["semantic_head"]
    for e, e0, p in zip(state.teacher.semantic_head.parameters(), ema0,
                        state.student.semantic_head.parameters()):
        assert torch.equal(e, alpha * e0 + (1.0 - alpha) * p), \
            "semantic teacher != EMA formula"
    for name in ("depth_head", "pose_head", "backbone_pose_sflow"):
        for e, p in zip(getattr(state.teacher, name).parameters(),
                        getattr(state.student, name).parameters()):
            assert torch.equal(e, p), f"{name} teacher != student"
    step_ms = statistics.median(step_seconds) * 1e3
    print(f"adaptation step latency (host clock, median of "
          f"{ADAPT_STEPS}): {step_ms:.3f} ms; all: "
          f"{[round(t * 1e3, 3) for t in step_seconds]}")
    print(f"adaptation steps per second: {1e3 / step_ms:.3f}")
    print(f"adaptation peak device memory: {adapt_peak / 2**20:.1f} MiB "
          f"(compute dtype {cfg.tpu.compute_dtype})")
    del state, metrics, results, stats, features, frozen, live0

    f32_cfg = adapt_config(target_size, source_size)
    f32_cfg.tpu.compute_dtype = "float32"
    for name in f32_modules.module_names():
        getattr(f32_modules, name).compute_dtype = torch.float32
    f32_state, f32_step = build_adapt(torch, f32_modules, f32_cfg, device)
    f32_step(f32_state, batch)                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f32_seconds = []
    for _ in range(ADAPT_STEPS):
        t0 = time.perf_counter()
        f32_metrics = f32_step(f32_state, batch)[0]
        torch.cuda.synchronize()
        f32_seconds.append(time.perf_counter() - t0)
    assert all(math.isfinite(float(v)) for k, v in f32_metrics.items()
               if k != "target_skipped")
    f32_step_ms = statistics.median(f32_seconds) * 1e3
    f32_peak = torch.cuda.max_memory_allocated()
    print(f"adaptation step in float32 (TF32 off), same starting weights "
          f"and batch: {f32_step_ms:.3f} ms (median of {ADAPT_STEPS}); all: "
          f"{[round(t * 1e3, 3) for t in f32_seconds]}; peak "
          f"{f32_peak / 2**20:.1f} MiB; bfloat16 / float32 time "
          f"{step_ms / f32_step_ms:.3f}")
    del f32_state, f32_step, f32_modules, f32_metrics, batch

    small_target, small_source = (64, 192), (64, 128)
    small_cfg = adapt_config(small_target, small_source)
    small_cfg.tpu.compute_dtype = "float32"
    small_batch = adapt_batch(rng, small_target, small_source)
    noise = automask_noise(torch, rng, small_target, small_source,
                           small_cfg.depth.num_recon_scales)
    cpu_modules = init_params(build_modules(
        small_cfg, NUM_CLASSES, device="cpu"), seed=SEED, device="cpu")
    calibrate_batch_norm(torch, cpu_modules,
                         small_batch["target"]["frames"][:, 0])
    card_modules = copy.deepcopy(cpu_modules)
    outs = {}
    for name, mods, dev in (("card", card_modules, device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        small_state, small_step = build_adapt(torch, mods, small_cfg, dev)
        metrics, features, results, stats = small_step(
            small_state, small_batch, noise=injected(torch, noise, dev))
        outs[name] = ({k: float(v) for k, v in metrics.items()},
                      features.cpu(), {k: float(v) for k, v in stats.items()
                                       if v.ndim == 0})
    for key, ref in outs["cpu"][0].items():
        err = abs(outs["card"][0][key] - ref)
        print(f"64x192 step card vs CPU {key}: {outs['card'][0][key]:.6g} "
              f"vs {ref:.6g}, rel err {err / max(abs(ref), 1e-30):.3g}")
        assert err <= REL_TOL * abs(ref), key
    err = float((outs["card"][1] - outs["cpu"][1]).abs().max())
    print(f"64x192 step card vs CPU replay features: max abs err {err:.3g}")
    assert err <= REL_TOL * float(outs["cpu"][1].abs().max())
    for key in ("d_abs_rel", "d_rmse"):
        ref = outs["cpu"][2][key]
        assert abs(outs["card"][2][key] - ref) <= REL_TOL * abs(ref), key

    phase("7 adaptation stream")
    from codeps_torch.data.dataset import class_distribution
    from codeps_torch.data.replay_buffer import rare_class_sample
    from torch.profiler import ProfilerActivity, profile, schedule
    cfg = stream_config(target_size, source_size)
    # the streams' peak memory counts what a stream holds: the earlier
    # phases' outputs go, and the weights every stream starts from wait
    # on the host
    del net, warm, last, centers, yx, valid, offsets, card_modules, on_card
    stream_modules = modules.cpu()
    runner, buffer = build_stream(cfg, copy.deepcopy(stream_modules).to(
        device), device, SEED)
    frames = len(buffer)
    print(f"stream, published config (float32 frames): {frames} frames of "
          f"{HEIGHT}x{WIDTH} after the adaptation split, source "
          f"{len(buffer.source_data)} images of {SOURCE_HEIGHT}x"
          f"{SOURCE_WIDTH}; frozen {list(runner.state.frozen_modules)}, EMA "
          f"{list(runner.state.ema_modules)}")
    kept = keep_last_step(runner)
    meters, run = drive_stream(torch, runner, card=True)
    graph_counts = {"published": check_step_graph("published", runner)}
    graph_parity = graphed_against_eager(torch, runner, kept)
    print("published: one more step of the last batch, replayed against "
          "eager (the generator's draws handed in): losses, replay "
          "features and skip ring equal; relative L2 " + ", ".join(
              f"{k} {v['graphed']:.3e} (eager's own spread "
              f"{v['eager_spread']:.3e})" for k, v in graph_parity.items()))
    del kept
    stream_launches, stream_copies = run["launches"], run["copies"]
    stream_err = run["max_abs_err"]
    print(f"grouping launches in the stream: {stream_launches} in {frames} "
          f"frames; layout copies: {stream_copies}")
    assert run["frames"] == frames, run["frames"]
    print(f"kernel == plain on all {len(run['centers'])} grouping calls of "
          f"the stream; valid centers per call: {run['centers']}")
    segments = check_gt_maps(run["pq_maps"], runner.stuff_list,
                             runner.thing_list)
    print(f"GT panoptic maps: thing segments per frame {segments}; each "
          f"scores PQ 1 against itself")
    values = meter_values(meters)
    published = stream_numbers(runner, run)
    print_stream("published", published)
    print(f"buffer holds {buffer.sim_index.ntotal} of {frames} frames")
    print("final meters: " + ", ".join(
        f"{k} {values[k]:.6g}" for k in ("p_pq", "p_sq", "p_rq", "sem_miou",
                                         "sem_miou_pixels", "d_abs_rel",
                                         "d_a1")))
    print("mean losses: " + ", ".join(
        f"{k} {v:.6g}" for k, v in values.items()
        if k in meters["losses"]))
    # host data preparation on its own, nothing else running
    alone_ms = []
    for index in range(3):
        t0 = time.perf_counter()
        buffer[index]
        alone_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"ReplayBuffer.__getitem__ on its own: "
          f"{[round(t, 3) for t in alone_ms]} ms")
    source = buffer.source_data
    t0 = time.perf_counter()
    distribution = class_distribution(source)
    count_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    drawn = rare_class_sample(distribution, SOURCE_IMAGES // 2,
                              cfg.adapt.replay_buffer.seed)
    draw_s = time.perf_counter() - t0
    print(f"rare-class source sampling: class distribution of "
          f"{len(source)} images {count_s * 1e3:.3f} ms, {len(drawn)} images "
          f"drawn {draw_s * 1e3:.3f} ms: {sorted(int(i) for i in drawn)}")
    del runner, buffer, meters, run, source

    # the card's busy share of stream frames after the warm-up: the same
    # stream again, with frames first..last profiled (CUDA activity only)
    first = WARMUP_FRAMES + 1
    last = first + PROFILED_FRAMES - 1
    runner, _ = build_stream(cfg, copy.deepcopy(stream_modules).to(device),
                             device, SEED)
    marks, traced = {}, {}

    def trace_ready(prof):
        traced["busy"] = device_busy(torch, prof.events())

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=first - 1, warmup=1,
                                   active=PROFILED_FRAMES, repeat=1),
                 on_trace_ready=trace_ready) as prof:
        def on_frame(it):
            marks[it] = time.perf_counter()
            prof.step()
        drive_stream(torch, runner, card=True, max_frames=last + 1,
                     on_frame=on_frame)
    graph_counts["traced"] = check_step_graph("traced", runner)
    busy_us, start_us, end_us = traced["busy"]
    assert busy_us > 0, "no device work in the profiled frames"
    window_ms = (marks[last] - marks[first - 1]) * 1e3
    busy = {"frames": [first, last],
            "host_ms": window_ms / PROFILED_FRAMES,
            "device_busy_ms": busy_us / 1e3 / PROFILED_FRAMES,
            "busy_share": busy_us / 1e3 / window_ms,
            "device_span_ms": (end_us - start_us) / 1e3 / PROFILED_FRAMES,
            "step_ms": statistics.median(
                runner.frame_phases["step"][first:last + 1]) * 1e3}
    print(f"profiled frames {first}-{last}: host {busy['host_ms']:.3f} ms "
          f"a frame (profiler on), of which the main thread's step "
          f"{busy['step_ms']:.3f} ms (median); card busy "
          f"{busy['device_busy_ms']:.3f} ms a frame = "
          f"{100 * busy['busy_share']:.1f}% of the host's window, idle "
          f"{100 * (1 - busy['busy_share']):.1f}%; first to last device "
          f"work {busy['device_span_ms']:.3f} ms a frame")
    del runner

    # the uint8 transport (an option of the config; the card normalizes)
    runner, _ = build_stream(stream_config(target_size, source_size,
                                           uint8=True),
                             copy.deepcopy(stream_modules).to(device), device,
                             SEED)
    meters, run = drive_stream(torch, runner, card=True)
    assert run["frames"] == frames, run["frames"]
    graph_counts["uint8_frames"] = check_step_graph("uint8 frames", runner)
    check_gt_maps(run["pq_maps"], runner.stuff_list, runner.thing_list)
    print(f"uint8 frames: grouping launches {run['launches']} in {frames} "
          f"frames, layout copies {run['copies']}, kernel == plain on every "
          f"call")
    uint8_frames = stream_numbers(runner, run)
    print_stream("uint8 frames", uint8_frames)
    # the stream's starting weights wait for phase 8's checkpoint
    del runner, meters, run, modules

    # the diversity buffer at the size a deployment reaches
    diversity = time_diversity_add(cfg, SEED)
    print(f"buffer.add on its own, index of {diversity['size']} vectors of "
          f"{diversity['dim']} floats: {diversity['fill_ms']:.3f} ms (median "
          f"of the last 50 adds that fill it), first evicting add "
          f"{diversity['first_evict_ms']:.3f} ms (builds the similarity "
          f"matrix), later evicting adds {diversity['evict_ms']:.3f} ms "
          f"(median); a search of the full index alone "
          f"{diversity['search_ms']:.3f} ms")

    small_target, small_source = (64, 192), (64, 128)
    small_cfg = stream_config(small_target, small_source, layers=18)
    small_cfg.tpu.compute_dtype = "float32"
    cpu_modules = init_params(build_modules(
        small_cfg, NUM_CLASSES, device="cpu"), seed=SEED, device="cpu")
    calibrate_batch_norm(torch, cpu_modules, rng.integers(
        0, 256, (1, *small_target, 3), dtype=np.uint8))
    card_modules = copy.deepcopy(cpu_modules)
    small = {}
    for name, mods, dev in (("card", card_modules, device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        small_runner, _ = build_stream(small_cfg, mods, dev, SEED,
                                       noise=numpy_noise(torch, SEED, dev))
        small_meters, small_run = drive_stream(
            torch, small_runner, card=name == "card", max_frames=3)
        labels = (small_runner.stuff_list, small_runner.thing_list)
        assert small_run["frames"] == 3
        stats = small_runner.panoptic_eval.pq_stats.pq_per_cat
        small[name] = (meter_values(small_meters), small_run["pq_maps"],
                       {int(c): (s.tp, s.fp, s.fn, s.iou)
                        for c, s in sorted(stats.items())})
    for key, tol in (("p_pq", PQ_TOL), ("sem_miou", MIOU_TOL),
                     ("d_abs_rel", ABS_REL_TOL)):
        card, cpu = small["card"][0][key], small["cpu"][0][key]
        print(f"64x192 stream card vs CPU {key}: {card:.6g} vs {cpu:.6g}, "
              f"|diff| {abs(card - cpu):.3g} (bound {tol})")
        assert abs(card - cpu) <= tol, key
    for key in small["cpu"][0]:
        assert key in small["card"][0], key
    # PQ is 0 with random heads: the GT maps and the per-class counts are
    # what can disagree
    assert len(small["card"][1]) == len(small["cpu"][1]) == 3
    for (gt_card, pred_card), (gt_cpu, pred_cpu) in zip(small["card"][1],
                                                        small["cpu"][1]):
        assert np.array_equal(gt_card, gt_cpu), "GT panoptic map card != CPU"
        print(f"64x192 stream GT panoptic map: card == CPU, "
              f"{len(np.unique(gt_card))} segments; the predicted maps agree "
              f"on {float((pred_card == pred_cpu).mean()):.6f} of the pixels")
    check_gt_maps(small["card"][1], *labels)
    print(f"64x192 stream PQ statistics per class (tp, fp, fn, iou): card "
          f"{small['card'][2]}; CPU {small['cpu'][2]}")
    gt_segments = {name: {c: tp + fn for c, (tp, _, fn, _) in
                          side[2].items() if tp + fn}
                   for name, side in small.items()}
    assert gt_segments["card"] == gt_segments["cpu"], gt_segments
    assert sum(gt_segments["card"].values()) > 0, gt_segments
    for c, (tp, _, fn, _) in small["cpu"][2].items():
        assert small["card"][2].get(c, (0, 0, 0, 0))[0] == tp, c

    phase("8 adaptation CLI")
    phase_start = time.perf_counter()
    from codeps_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from codeps_torch.io.logging import init_logging
    init_logging()
    cli_size = (SEMKITTI_HEIGHT, SEMKITTI_WIDTH)
    cfg = semkitti_config(cli_size, source_size)
    checkpoint = (Path(__file__).resolve().parent / "chiprun_out" /
                  "chip_smoke_adapt_cli.pth")
    datasets = semkitti_datasets(cfg, SEED)
    # the checkpoint (some 280 MiB) goes once the CLI has read it: the
    # output directory must stay small
    try:
        save_checkpoint(str(checkpoint), cfg, stream_modules)
        saved = load_checkpoint(str(checkpoint))["state_dict"]
        print(f"adaptation CLI, cfg/adapt_cityscapes_semkittidvps.yaml's "
              f"values: target {len(datasets[0])} frames of {cli_size[0]}x"
              f"{cli_size[1]} (split at "
              f"{cfg.adapt.target_dataset_adapt_ratio}), source "
              f"{len(datasets[2])} images of {SOURCE_HEIGHT}x"
              f"{SOURCE_WIDTH}, source val {len(datasets[3])}; checkpoint "
              f"{checkpoint.name} ({checkpoint.stat().st_size / 2**20:.1f} "
              f"MiB)")
        result, parts = drive_cli(torch, cfg, datasets, checkpoint, saved,
                                  device)
    finally:
        checkpoint.unlink(missing_ok=True)
    load = parts["load"]
    print(f"checkpoint: {load['modules']} loaded, {load['tensors']} "
          f"tensors bit-equal to the saved ones")
    assert load["modules"] == list(saved), load["modules"]
    runner = parts["runner"]
    cli_frames = runner.state.step
    graph_counts["cli"] = check_step_graph("CLI stream", runner)
    batches = {"target_val": 0, "source_val": 0}
    for name, n in (("stream", cli_frames),
                    ("target_val", len(parts["target_val"]["batch_s"])),
                    ("source_val", len(parts["source_val"]["batch_s"]))):
        part = parts[name]
        print(f"{name}: grouping launches {part['launches']} for {n} "
              f"{'frames' if name == 'stream' else 'batches'}, layout "
              f"copies {part['copies']}; kernel == plain on all "
              f"{len(part['centers'])} calls, shapes {part['shapes']}, "
              f"valid centers per call {part['centers']}")
        assert part["launches"] == 2 * n > 0, (name, part["launches"])
        assert part["copies"] == 0, (name, part["copies"])
        segments = check_gt_maps(part["pq_maps"], runner.stuff_list,
                                 runner.thing_list)
        print(f"{name}: GT panoptic maps hold {segments} thing segments; "
              f"each scores PQ 1 against itself")
        if name != "stream":
            batches[name] = n
    assert cli_frames == int(CLI_FRAMES
                             * cfg.adapt.target_dataset_adapt_ratio)
    assert batches["target_val"] == CLI_FRAMES - cli_frames
    assert batches["source_val"] == CLI_SOURCE_VAL
    assert parts["stream"]["shapes"] == [(1, *cli_size)]
    assert parts["source_val"]["shapes"] == [(1, SOURCE_HEIGHT,
                                              SOURCE_WIDTH)]
    cli_run = {"frames": cli_frames, "seconds": parts["stream"]["seconds"],
               "peak": parts["peak"]}
    cli_stream = stream_numbers(runner, cli_run)
    print_stream("CLI stream", cli_stream)
    stream_values = meter_values(result["meters"])
    bad = [k for k, v in stream_values.items() if not math.isfinite(v)]
    assert not bad, f"CLI stream meters not finite: {bad}"
    val_numbers = {}
    for name in ("target_val", "source_val"):
        metrics = {k: float(v) for k, v in result[name].items()
                   if np.ndim(v) == 0}
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        assert not bad, f"{name} not finite: {bad}"
        height, width = (cli_size if name == "target_val"
                         else (SOURCE_HEIGHT, SOURCE_WIDTH))
        conf_sum = int(result[name]["sem_conf"].sum())
        assert conf_sum == batches[name] * height * width, (name, conf_sum)
        batch_ms = [t * 1e3 for t in parts[name]["batch_s"]]
        val_numbers[name] = {
            "batches": batches[name],
            "batch_ms": statistics.median(batch_ms), "all_ms": batch_ms,
            "seconds": parts[name]["seconds"], "metrics": metrics}
        print(f"{name}: time per batch (host clock, median of "
              f"{len(batch_ms)}) {val_numbers[name]['batch_ms']:.3f} ms; "
              f"all {[round(t, 3) for t in batch_ms]}; part "
              f"{parts[name]['seconds']:.3f} s")
        print(f"{name} metrics: " + ", ".join(
            f"{k} {v:.6g}" for k, v in metrics.items()))
    assert "d_abs_rel" in val_numbers["target_val"]["metrics"]
    print(f"CLI: whole run_adaptation {parts['seconds']:.3f} s; peak device "
          f"memory {parts['peak'] / 2**20:.1f} MiB")
    cli_launches = {name: parts[name]["launches"]
                    for name in ("stream", "target_val", "source_val")}
    cli_copies = {name: parts[name]["copies"]
                  for name in ("stream", "target_val", "source_val")}
    cli_peak, cli_values = parts["peak"], stream_values
    cli_err = max(parts[name]["max_abs_err"]
                  for name in ("stream", "target_val", "source_val"))
    cli_labels = (runner.stuff_list, runner.thing_list)
    by_shape = []
    for name in ("stream", "source_val"):
        yx, valid, offsets = parts[name]["last_call"]
        t_ms, t_bound_ms, t_bound_by, counts = time_grouping_call(
            torch, (yx, valid, offsets))
        by_shape.append({"path": f"cli_{name}",
                         "shape": list(offsets.shape[:3]),
                         "valid_centers": counts, "ms": t_ms,
                         "bound_ms": t_bound_ms, "bound_by": t_bound_by})
        print(f"group_pixels, last call of the CLI's {name} "
              f"{'x'.join(map(str, offsets.shape[:3]))}, {counts} valid of "
              f"{TOP_K}: kernel device time {t_ms * 1e3:.3f} us; bound "
              f"{t_bound_ms * 1e3:.3f} us ({t_bound_by})")
    from codeps_torch.data.replay_buffer import ReplayBuffer
    breakdown = {
        name: validation_breakdown(torch, cfg, runner.state.teacher, dataset,
                                   runner.thing_list, runner.stuff_list,
                                   ignore)
        for name, dataset, ignore in (
            ("target_val", ReplayBuffer(semkitti_datasets(cfg, SEED)[1],
                                        cfg.adapt, mode="val"),
             runner.ignore_classes),
            ("source_val", datasets[3], ()))}
    for name, parts_ms in breakdown.items():
        print(f"{name}: a batch's parts on their own, median ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts_ms.items()))
    del runner, result, parts, datasets, saved

    small = small_validation(torch, device, rng)
    (card_metrics, card_maps), (cpu_metrics, cpu_maps) = (small["card"],
                                                          small["cpu"])
    assert len(card_maps) == len(cpu_maps) == 2
    agree = []
    for (gt_card, pred_card), (gt_cpu, pred_cpu) in zip(card_maps,
                                                        cpu_maps):
        agree.append(float((pred_card == pred_cpu).mean()))
        print(f"64x192 validation card vs CPU: GT panoptic maps equal "
              f"{np.array_equal(gt_card, gt_cpu)}, predicted maps equal "
              f"{np.array_equal(pred_card, pred_cpu)} ({agree[-1]:.6f} of "
              f"the pixels)")
        assert np.array_equal(gt_card, gt_cpu), "GT panoptic map card != CPU"
        assert np.array_equal(pred_card, pred_cpu), \
            "predicted panoptic map card != CPU"
    check_gt_maps(card_maps, *cli_labels)
    conf_card, conf_cpu = card_metrics["sem_conf"], cpu_metrics["sem_conf"]
    assert conf_card.sum() == conf_cpu.sum() > 0
    moved = int(np.abs(conf_card - conf_cpu).sum()) // 2
    print(f"64x192 validation card vs CPU: {moved} of {conf_cpu.sum()} "
          f"pixels moved in the confusion matrix")
    assert moved <= NEAR_TIE_SHARE * conf_cpu.sum()
    scalars = [k for k, v in cpu_metrics.items() if np.ndim(v) == 0]
    assert set(scalars) == {k for k, v in card_metrics.items()
                            if np.ndim(v) == 0}
    for key in scalars:
        card, cpu = float(card_metrics[key]), float(cpu_metrics[key])
        tol = (PQ_TOL if key.startswith(("p_", "sem_miou"))
               or key == "d_abs_rel" else DEPTH_REL_TOL * abs(cpu))
        print(f"64x192 validation card vs CPU {key}: {card:.6g} vs "
              f"{cpu:.6g}, |diff| {abs(card - cpu):.3g} (bound {tol:.3g})")
        assert abs(card - cpu) <= tol, key
    print(f"phase 8: {time.perf_counter() - phase_start:.3f} s")

    phase("9 pretraining")
    phase_start = time.perf_counter()
    from codeps_torch.scripts.train import run_training
    train_size = (SOURCE_HEIGHT, SOURCE_WIDTH)
    cfg = train_config(train_size)
    datasets = train_datasets(cfg, TRAIN_STEPS * TRAIN_BATCH,
                              TRAIN_VAL_IMAGES, SEED)
    run_dir = Path(__file__).resolve().parent / "chiprun_out" / "train_smoke"
    print(f"pretraining, cfg/train_cityscapes.yaml's values: ResNet-"
          f"{cfg.model.po_depth_net.params.nof_layers}, batch "
          f"{cfg.train.batch_size_per_gpu} at {train_size[0]}x"
          f"{train_size[1]}, compute dtype {cfg.tpu.compute_dtype}; train "
          f"{len(datasets[0])} images, val {len(datasets[1])} at batch "
          f"{cfg.val.batch_size_per_gpu}")
    # a checkpoint of the modules, Adam's moments and the meters is some
    # 0.8 GiB: it goes once the resumed run has read it
    try:
        result, parts = drive_training(torch, cfg, datasets, device,
                                       max_steps=TRAIN_STEPS,
                                       run_dir=str(run_dir))
        ckpt = Path(result["checkpoints"][0])
        saved = load_checkpoint(str(ckpt))
        print(f"checkpoint {ckpt.name}: {ckpt.stat().st_size / 2**20:.1f} "
              f"MiB, training_meta {saved['training_meta']}")
        assert saved["training_meta"] == {"epoch": 0,
                                          "global_step": TRAIN_STEPS}
        resumed_checks = {}

        def check_resumed(state):
            """The resumed run's state before its first step equals what
            was saved, bit for bit."""
            tensors = 0
            for name in state.modules.module_names():
                for key, value in getattr(state.modules,
                                          name).state_dict().items():
                    assert torch.equal(value.cpu(),
                                       saved["state_dict"][name][key]), \
                        f"resumed {name}.{key} != saved"
                    tensors += 1
            opt = state.optimizer.state_dict()
            ref_opt = saved["state_dict"]["optimizer"]
            assert set(opt["state"]) == set(ref_opt["state"])
            for index, moments in ref_opt["state"].items():
                for key in ("step", "exp_avg", "exp_avg_sq"):
                    assert torch.equal(opt["state"][index][key].cpu(),
                                       moments[key]), (index, key)
            assert torch.equal(state.generator.get_state(),
                               saved["state_dict"]["rng"])
            assert state.step == TRAIN_STEPS, state.step
            resumed_checks.update(tensors=tensors,
                                  moments=len(ref_opt["state"]))

        resumed, resumed_parts = drive_training(
            torch, cfg, datasets, device, max_steps=TRAIN_STEPS + 1,
            checkpoint=str(ckpt), check_resumed=check_resumed)
    finally:
        for path in sorted(run_dir.rglob("*"), reverse=True):
            path.unlink() if path.is_file() else path.rmdir()
        if run_dir.exists():
            run_dir.rmdir()
    del saved
    assert resumed["global_step"] == TRAIN_STEPS + 1
    print(f"resumed from {ckpt.name}: {resumed_checks['tensors']} module "
          f"tensors, the Adam state of {resumed_checks['moments']} "
          f"parameters, the step and the generator state bit-equal to the "
          f"saved ones; one more step: " + ", ".join(
              f"{k} {v:.6g}" for k, v in resumed["metrics"][0].items()))
    steps = parts["steps"]
    assert len(result["metrics"]) == TRAIN_STEPS
    for metrics in result["metrics"] + resumed["metrics"]:
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        assert not bad, f"train metrics not finite: {bad}"
    assert {"depth_recon", "depth_smth", "semantic", "center", "offset",
            "thing_mask", "loss_total"} <= set(result["metrics"][0])
    assert steps["launches"] == steps["copies"] == 0, steps
    val = parts["val"][0]
    val_batches = len(val["batch_s"])
    assert val_batches == TRAIN_VAL_IMAGES // cfg.val.batch_size_per_gpu
    assert val["launches"] == 2 * val_batches, val["launches"]
    assert val["copies"] == 0, val["copies"]
    assert parts["shapes"] == [(cfg.val.batch_size_per_gpu, *train_size)]
    print(f"pretraining: grouping launches {steps['launches']} in "
          f"{TRAIN_STEPS} steps; validation {val['launches']} in "
          f"{val_batches} batches, layout copies {val['copies']}; kernel == "
          f"plain on all {len(parts['centers'])} calls, shapes "
          f"{parts['shapes']}, valid centers per call {parts['centers']}")
    val_metrics = {k: float(v) for k, v in result["val"][0].items()
                   if np.ndim(v) == 0}
    bad = [k for k, v in val_metrics.items() if not math.isfinite(v)]
    assert not bad, f"validation not finite: {bad}"
    assert {"val_loss", "val_loss_depth_recon", "val_loss_semantic",
            "val_loss_thing_mask", "sem_miou", "p_pq"} <= set(val_metrics)
    timed = result["step_times"][TRAIN_WARMUP:]
    train_step_ms = statistics.median(timed) * 1e3
    loop_ms = statistics.median(np.diff(steps["starts"][TRAIN_WARMUP:])) \
        * 1e3
    val_ms = [t * 1e3 for t in val["batch_s"]]
    item_ms = []
    for index in range(3):
        t0 = time.perf_counter()
        datasets[0][index]
        item_ms.append((time.perf_counter() - t0) * 1e3)
    t_ms, t_bound_ms, t_bound_by, counts = time_grouping_call(
        torch, parts["last_call"])
    by_shape.append({"path": "train_val",
                     "shape": list(parts["last_call"][2].shape[:3]),
                     "valid_centers": counts, "ms": t_ms,
                     "bound_ms": t_bound_ms, "bound_by": t_bound_by})
    train_numbers = {
        "config": "cfg/train_cityscapes.yaml",
        "compute_dtype": cfg.tpu.compute_dtype,
        "batch": cfg.train.batch_size_per_gpu, "size": list(train_size),
        "step_ms": train_step_ms,
        "images_per_s": cfg.train.batch_size_per_gpu / train_step_ms * 1e3,
        "all_step_ms": [t * 1e3 for t in result["step_times"]],
        "loop_ms": loop_ms, "peak_mib": parts["peak"] / 2**20,
        "item_ms": statistics.median(item_ms),
        "val_batch_ms": statistics.median(val_ms), "val_all_ms": val_ms,
        "val_metrics": val_metrics,
        "last_step": result["metrics"][-1]}
    print(f"pretraining step (host clock, median of {len(timed)} after "
          f"{TRAIN_WARMUP} warm-up): {train_step_ms:.3f} ms, "
          f"{train_numbers['images_per_s']:.3f} images/s; all "
          f"{[round(t, 3) for t in train_numbers['all_step_ms']]}; the "
          f"loop's time a step (loader included) {loop_ms:.3f} ms; peak "
          f"device memory {train_numbers['peak_mib']:.1f} MiB "
          f"(tpu.remat not acted on)")
    print(f"loader: a train item on its own {[round(t, 3) for t in item_ms]}"
          f" ms; validation per batch (host clock, median of "
          f"{len(val_ms)}) {train_numbers['val_batch_ms']:.3f} ms, all "
          f"{[round(t, 3) for t in val_ms]}")
    print("last step: " + ", ".join(
        f"{k} {v:.6g}" for k, v in result["metrics"][-1].items()))
    print("validation: " + ", ".join(
        f"{k} {v:.6g}" for k, v in val_metrics.items()))
    print(f"group_pixels, validation call "
          f"{'x'.join(map(str, parts['last_call'][2].shape[:3]))}, "
          f"{counts} valid of {TOP_K}: kernel device time "
          f"{t_ms * 1e3:.3f} us; bound {t_bound_ms * 1e3:.3f} us "
          f"({t_bound_by})")
    train_launches = {"train": steps["launches"],
                      "train_val": sum(v["launches"] for v in parts["val"])
                      + sum(v["launches"] for v in resumed_parts["val"])}
    train_copies = {"train": steps["copies"],
                    "train_val": sum(v["copies"] for v in parts["val"])
                    + sum(v["copies"] for v in resumed_parts["val"])}
    train_err = max(parts["max_abs_err"], resumed_parts["max_abs_err"])
    del result, resumed, datasets

    small = train_step_card_vs_cpu(torch, device, rng)
    for key, ref in small["cpu"][0].items():
        card = small["card"][0][key]
        err = abs(card - ref)
        print(f"64x128 train step card vs CPU {key}: {card:.6g} vs "
              f"{ref:.6g}, rel err {err / max(abs(ref), 1e-30):.3g}")
        assert err <= TRAIN_REL_TOL * abs(ref), key
    assert set(small["card"][0]) == set(small["cpu"][0])
    stat_err = max(float((small["card"][1][k] - v).abs().max()
                         / (1.0 + float(v.abs().max())))
                   for k, v in small["cpu"][1].items())
    print(f"64x128 train step card vs CPU BatchNorm running statistics: "
          f"max |diff| / (1 + max |value|) {stat_err:.3g} (bound "
          f"{TRAIN_STAT_TOL}) over {len(small['cpu'][1])} tensors")
    assert stat_err <= TRAIN_STAT_TOL

    depth_cfg = depth_only_config()
    depth_data = train_datasets(depth_cfg, 8, 2, SEED)
    depth_result = run_training(depth_cfg, *depth_data, seed=SEED,
                                max_steps=DEPTH_ONLY_STEPS, device=device)
    assert len(depth_result["metrics"]) == DEPTH_ONLY_STEPS
    for metrics in depth_result["metrics"]:
        assert set(metrics) == {"loss_total", "depth_recon", "depth_smth"}
        assert all(math.isfinite(v) for v in metrics.values()), metrics
    depth_numbers = {
        "config": "cfg/train_cityscapes_depth_only.yaml",
        "size": list(DEPTH_ONLY_SIZE),
        "step_ms": statistics.median(depth_result["step_times"][1:]) * 1e3,
        "last_step": depth_result["metrics"][-1]}
    print(f"depth-only config ({DEPTH_ONLY_SIZE[0]}x{DEPTH_ONLY_SIZE[1]}, "
          f"batch 1, only RGB): {DEPTH_ONLY_STEPS} steps, median after the "
          f"first {depth_numbers['step_ms']:.3f} ms; last step " + ", ".join(
              f"{k} {v:.6g}" for k, v in depth_result["metrics"][-1].items()))
    del depth_result, depth_data
    print(f"phase 9: {time.perf_counter() - phase_start:.3f} s")

    phase("10 host mixup parts")
    phase_start = time.perf_counter()
    refusion = refusion_on_card(torch, device, rng)
    small_target, small_source = (64, 192), (64, 128)
    small_cfg = host_mixup_config(small_target, small_source, layers=18)
    small_cfg.tpu.compute_dtype = "float32"
    cpu_modules = init_params(build_modules(
        small_cfg, NUM_CLASSES, device="cpu"), seed=SEED, device="cpu")
    image = rng.integers(0, 256, (1, *small_target, 3), dtype=np.uint8)
    calibrate_batch_norm(torch, cpu_modules, image)
    small_shift = raise_pseudo_instances(torch, cpu_modules, image)
    card_modules = copy.deepcopy(cpu_modules)
    small = {}
    for name, mods, dev in (("card", card_modules, device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        small_runner, _ = build_stream(small_cfg, mods, dev, SEED,
                                       noise=numpy_noise(torch, SEED, dev))
        small_meters, small_run = drive_host_mixup_stream(
            torch, small_runner, card=name == "card", max_frames=3)
        assert small_run["frames"] == 3 and not small_runner.fused_mixup
        small[name] = (meter_values(small_meters), small_run["pq_maps"],
                       small_runner.pasted_instances)
    min_size = small_cfg.adapt.mixup.conf_instance_mix.min_inst_size
    print(f"64x192 host mixup stream (ResNet-18, float32, thing logits "
          f"{small_shift[0]:+.4f}, center bias {small_shift[1]:+.4f}, "
          f"min_inst_size {min_size}): pasted instances per frame card "
          f"{small['card'][2]}, CPU {small['cpu'][2]}")
    for key, tol in (("p_pq", PQ_TOL), ("sem_miou", MIOU_TOL),
                     ("d_abs_rel", ABS_REL_TOL)):
        card, cpu = small["card"][0][key], small["cpu"][0][key]
        print(f"64x192 host mixup stream card vs CPU {key}: {card:.6g} vs "
              f"{cpu:.6g}, |diff| {abs(card - cpu):.3g} (bound {tol})")
        assert abs(card - cpu) <= tol, key
    assert set(small["card"][0]) == set(small["cpu"][0])
    assert "semantic_conf_instance_mixup" in small["cpu"][0]
    for (gt_card, _), (gt_cpu, _) in zip(small["card"][1], small["cpu"][1]):
        assert np.array_equal(gt_card, gt_cpu), "GT panoptic map card != CPU"
    print("64x192 host mixup stream: GT panoptic maps card == CPU")
    del card_modules, cpu_modules, small_runner, small_meters
    print(f"phase 10: {time.perf_counter() - phase_start:.3f} s")

    phase("11 host mixup stream")
    phase_start = time.perf_counter()
    cfg = host_mixup_config(target_size, source_size)
    host_modules = copy.deepcopy(stream_modules).to(device)
    thing_shift = shift_thing_logits(torch, host_modules, rng.integers(
        0, 256, (1, HEIGHT, WIDTH, 3), dtype=np.uint8))
    runner, buffer = build_stream(cfg, host_modules, device, SEED)
    del host_modules
    assert not runner.fused_mixup
    meters, run = drive_host_mixup_stream(torch, runner, True,
                                          HOST_MIXUP_FRAMES)
    assert run["frames"] == HOST_MIXUP_FRAMES, run["frames"]
    graph_counts["host_mixup"] = check_step_graph("host mixup stream",
                                                  runner)
    host_launches, host_copies = run["launches"], run["copies"]
    host_err = run["max_abs_err"]
    refusion_shape = (1, SOURCE_HEIGHT, SOURCE_WIDTH)
    prep_shape = (NUM_MIXUP, HEIGHT, WIDTH)
    centers = {shape: [c for c, s in zip(run["centers"], run["shapes"])
                       if s == shape] for shape in (prep_shape,
                                                    refusion_shape)}
    pasted = list(runner.pasted_instances)
    print(f"host mixup stream, the phase-7 config with strategies "
          f"{list(cfg.adapt.mixup.general.mixup_strategies)}, "
          f"conf_thresh {CONF_THRESH}, min_inst_size {MIN_INST_SIZE}, thing "
          f"logits {thing_shift:+.4f}: grouping launches {host_launches} in "
          f"{run['frames']} frames, layout copies {host_copies}; kernel == "
          f"plain on all {len(run['centers'])} calls")
    print(f"host mixup: valid centers per pseudo-label stack "
          f"{'x'.join(map(str, prep_shape))} {centers[prep_shape]}; per "
          f"re-fusion {'x'.join(map(str, refusion_shape))} "
          f"{centers[refusion_shape]}; instances pasted per frame {pasted}")
    assert len(centers[refusion_shape]) == HOST_MIXUP_FRAMES
    assert sum(pasted) > 0, pasted
    check_gt_maps(run["pq_maps"], runner.stuff_list, runner.thing_list)
    host_values = meter_values(meters)
    assert meters["losses"]["semantic_conf_instance_mixup"].count \
        == HOST_MIXUP_FRAMES
    host_numbers = stream_numbers(runner, run)
    print_stream("host mixup", host_numbers)
    mixup_ms = {name[len("mixup."):]: statistics.median(t[WARMUP_FRAMES:])
                * 1e3 for name, t in runner.frame_phases.items()
                if name.startswith("mixup.")}
    refusion_ms = [t * 1e3 for t in run["refusion_s"]]
    mixup_ms["refusion"] = statistics.median(refusion_ms[WARMUP_FRAMES:])
    print("host mixup: main thread in _compose_mixups per frame, median "
          "ms: " + ", ".join(f"{k} {v:.3f}" for k, v in mixup_ms.items())
          + f" (conf_instance_mixup includes the re-fusion); re-fusion "
          f"(upload, fusion, readback) all {[round(t, 3) for t in refusion_ms]}")
    print(f"host mixup against the fused stream of phase 7: "
          f"{host_numbers['frame_ms']:.3f} against "
          f"{published['frame_ms']:.3f} ms a frame, "
          f"{host_numbers['frames_per_s']:.3f} against "
          f"{published['frames_per_s']:.3f} frames/s, peak "
          f"{host_numbers['peak_mib']:.1f} against "
          f"{published['peak_mib']:.1f} MiB")
    print("host mixup final meters: " + ", ".join(
        f"{k} {host_values[k]:.6g}" for k in (
            "p_pq", "sem_miou", "d_abs_rel", "semantic_cut_mixup",
            "semantic_conf_instance_mixup")))
    for path, shape in (("host_mixup_prep", prep_shape),
                        ("host_mixup_refusion", refusion_shape)):
        t_ms, t_bound_ms, t_bound_by, counts = time_grouping_call(
            torch, run["last_by_shape"][shape])
        by_shape.append({"path": path, "shape": list(shape),
                         "valid_centers": counts, "ms": t_ms,
                         "bound_ms": t_bound_ms, "bound_by": t_bound_by})
        print(f"group_pixels, last {path} call "
              f"{'x'.join(map(str, shape))}, {counts} valid of {TOP_K}: "
              f"kernel device time {t_ms * 1e3:.3f} us; bound "
              f"{t_bound_ms * 1e3:.3f} us ({t_bound_by})")
    host_mixup = {
        "config": "cfg/adapt_cityscapes_kitti_360.yaml, strategies "
                  "[cut_mixup, conf_instance_mixup]",
        "stream": {k: host_numbers[k] for k in (
            "frames", "frame_ms", "frame_min_ms", "frame_max_ms",
            "frames_per_s", "getitem_ms", "add_ms", "peak_mib")},
        "compose_ms": mixup_ms, "refusion_all_ms": refusion_ms,
        "pasted": pasted, "prep_centers": centers[prep_shape],
        "refusion_centers": centers[refusion_shape],
        "refusion_parts": refusion,
        "p_pq": host_values["p_pq"], "sem_miou": host_values["sem_miou"],
        "d_abs_rel": host_values["d_abs_rel"]}
    del runner, buffer, meters, run
    print(f"phase 11: {time.perf_counter() - phase_start:.3f} s")

    phase("12 scene flow")
    phase_start = time.perf_counter()
    # (a) the adaptation step of phase 6 with the flow head live
    flow_cfg = adapt_config(target_size, source_size)
    flow_cfg.model.make_sflow = flow_cfg.adapt.model.sflow = True
    host_flow = flow_modules(torch, flow_cfg, stream_modules)
    assert tuple(host_flow.backbone_pose_sflow.encoder.conv1.weight.shape) \
        == (64, 8, 7, 7)
    batch = batch_to_device(adapt_batch(rng, target_size, source_size),
                            device)
    flow_step_numbers = {}
    for dtype in ("bfloat16", "float32"):
        flow_cfg.tpu.compute_dtype = dtype
        mods = copy.deepcopy(host_flow)
        for name in mods.module_names():
            getattr(mods, name).compute_dtype = getattr(torch, dtype)
        state, step = build_adapt(torch, mods.to(device), flow_cfg, device)
        assert "flow_head" in state.live_modules()
        step(state, batch)                                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grouping.group_pixels_cuda.launches = 0
        grouping.group_pixels_cuda.copies = 0
        seconds = []
        for _ in range(FLOW_STEPS):
            t0 = time.perf_counter()
            metrics, features, results, stats = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            check_adapt_outputs(torch, metrics, results, stats, HEIGHT,
                                WIDTH)
        motion = results["object_motion_map"]
        assert tuple(motion.shape) == (2, 1, HEIGHT, WIDTH, 3), motion.shape
        assert bool(torch.isfinite(motion).all())
        numbers = {
            "ms": statistics.median(seconds) * 1e3,
            "all_ms": [t * 1e3 for t in seconds],
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "kept_share": [float((m != 0).any(-1).float().mean())
                           for m in motion],
            "launches": grouping.group_pixels_cuda.launches,
            "copies": grouping.group_pixels_cuda.copies,
            "losses": {k: float(v) for k, v in metrics.items()
                       if k != "target_skipped"}}
        assert numbers["launches"] == FLOW_STEPS, numbers["launches"]
        assert numbers["copies"] == 0, numbers["copies"]
        assert {"flow_smth", "flow_sparsity"} <= set(numbers["losses"])
        flow_step_numbers[dtype] = numbers
        print(f"flow adaptation step ({dtype}), phase 6's batch with the "
              f"flow head live: {numbers['ms']:.3f} ms (median of "
              f"{FLOW_STEPS} after a warm-up); all "
              f"{[round(t, 3) for t in numbers['all_ms']]}; peak "
              f"{numbers['peak_mib']:.1f} MiB; auto-mask keeps "
              f"{numbers['kept_share']} of the target pair's pixels; "
              f"grouping launches {numbers['launches']}, layout copies "
              f"{numbers['copies']}; flow_smth "
              f"{numbers['losses']['flow_smth']:.6g}, flow_sparsity "
              f"{numbers['losses']['flow_sparsity']:.6g}")
        del state, step, mods, metrics, features, results, stats, motion
    flow_launches = {"flow_adapt": flow_step_numbers["bfloat16"]["launches"]}
    flow_copies = {"flow_adapt": flow_step_numbers["bfloat16"]["copies"]}
    print(f"flow adaptation step against phase 6's: "
          f"{flow_step_numbers['bfloat16']['ms']:.3f} against "
          f"{step_ms:.3f} ms in bfloat16, "
          f"{flow_step_numbers['float32']['ms']:.3f} against "
          f"{f32_step_ms:.3f} ms in float32")
    del batch

    # (b) phase 7's stream with the flow head
    flow_cfg = stream_config(target_size, source_size)
    flow_cfg.model.make_sflow = flow_cfg.adapt.model.sflow = True
    runner, buffer = build_stream(flow_cfg, copy.deepcopy(host_flow).to(
        device), device, SEED)
    meters, run = drive_stream(torch, runner, card=True,
                               max_frames=FLOW_STREAM_FRAMES)
    assert run["frames"] == FLOW_STREAM_FRAMES, run["frames"]
    graph_counts["flow_stream"] = check_step_graph("flow stream", runner)
    check_gt_maps(run["pq_maps"], runner.stuff_list, runner.thing_list)
    for name in ("flow_smth", "flow_sparsity"):
        assert meters["losses"][name].count == FLOW_STREAM_FRAMES, name
    flow_launches["flow_stream"] = run["launches"]
    flow_copies["flow_stream"] = run["copies"]
    flow_err = run["max_abs_err"]
    print(f"flow stream: grouping launches {run['launches']} in "
          f"{run['frames']} frames, layout copies {run['copies']}; kernel "
          f"== plain on all {len(run['centers'])} calls")
    flow_stream = stream_numbers(runner, run)
    print_stream("flow stream", flow_stream)
    flow_values = meter_values(meters)
    print("flow stream final meters: " + ", ".join(
        f"{k} {flow_values[k]:.6g}" for k in (
            "p_pq", "sem_miou", "d_abs_rel", "flow_smth", "flow_sparsity")))
    t_ms, t_bound_ms, t_bound_by, counts = time_grouping_call(
        torch, run["last_by_shape"][(1, HEIGHT, WIDTH)])
    by_shape.append({"path": "flow_stream", "shape": [1, HEIGHT, WIDTH],
                     "valid_centers": counts, "ms": t_ms,
                     "bound_ms": t_bound_ms, "bound_by": t_bound_by})
    print(f"group_pixels, last flow stream call 1x{HEIGHT}x{WIDTH}, "
          f"{counts} valid of {TOP_K}: kernel device time "
          f"{t_ms * 1e3:.3f} us; bound {t_bound_ms * 1e3:.3f} us "
          f"({t_bound_by})")
    del runner, buffer, meters, run, host_flow

    # (c) pretraining with the flow head at the yaml's batch
    flow_cfg = train_config(train_size)
    flow_cfg.model.make_sflow = True
    datasets = train_datasets(flow_cfg, FLOW_TRAIN_STEPS * TRAIN_BATCH,
                              TRAIN_VAL_IMAGES, SEED)
    result, parts = drive_training(torch, flow_cfg, datasets, device,
                                   max_steps=FLOW_TRAIN_STEPS)
    assert len(result["metrics"]) == FLOW_TRAIN_STEPS
    for metrics in result["metrics"]:
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        assert not bad, f"flow train metrics not finite: {bad}"
        assert {"flow_smth", "flow_sparsity"} <= set(metrics)
    steps = parts["steps"]
    assert steps["launches"] == steps["copies"] == 0, steps
    val = parts["val"][0]
    val_batches = len(val["batch_s"])
    assert val["launches"] == 2 * val_batches, val["launches"]
    assert val["copies"] == 0, val["copies"]
    flow_val = {k: float(v) for k, v in result["val"][0].items()
                if np.ndim(v) == 0}
    assert {"val_loss_flow_smth", "val_loss_flow_sparsity"} <= set(flow_val)
    assert all(math.isfinite(v) for v in flow_val.values()), flow_val
    flow_launches.update(flow_train=steps["launches"],
                         flow_train_val=val["launches"])
    flow_copies.update(flow_train=steps["copies"],
                       flow_train_val=val["copies"])
    flow_err = max(flow_err, parts["max_abs_err"])
    timed = result["step_times"][TRAIN_WARMUP:]
    val_ms = [t * 1e3 for t in val["batch_s"]]
    flow_train = {
        "config": "cfg/train_cityscapes.yaml with model.make_sflow: true",
        "batch": TRAIN_BATCH, "size": list(train_size),
        "step_ms": statistics.median(timed) * 1e3,
        "images_per_s": TRAIN_BATCH / statistics.median(timed),
        "all_step_ms": [t * 1e3 for t in result["step_times"]],
        "loop_ms": statistics.median(np.diff(
            steps["starts"][TRAIN_WARMUP:])) * 1e3,
        "peak_mib": parts["peak"] / 2**20,
        "val_batch_ms": statistics.median(val_ms), "val_all_ms": val_ms,
        "last_step": result["metrics"][-1],
        "val_flow": {k: flow_val[k] for k in ("val_loss_flow_smth",
                                               "val_loss_flow_sparsity")}}
    print(f"flow pretraining step (host clock, median of {len(timed)} "
          f"after {TRAIN_WARMUP} warm-up): {flow_train['step_ms']:.3f} ms, "
          f"{flow_train['images_per_s']:.3f} images/s; all "
          f"{[round(t, 3) for t in flow_train['all_step_ms']]}; the loop's "
          f"time a step {flow_train['loop_ms']:.3f} ms; peak device memory "
          f"{flow_train['peak_mib']:.1f} MiB, against phase 9's "
          f"{train_numbers['step_ms']:.3f} ms and "
          f"{train_numbers['peak_mib']:.1f} MiB")
    print(f"flow pretraining: grouping launches {steps['launches']} in "
          f"{FLOW_TRAIN_STEPS} steps; validation {val['launches']} in "
          f"{val_batches} batches, layout copies {val['copies']}, kernel "
          f"== plain on all {len(parts['centers'])} calls; validation per "
          f"batch {flow_train['val_batch_ms']:.3f} ms; "
          + ", ".join(f"{k} {v:.6g}" for k, v in flow_val.items()
                      if k.startswith("val_loss")))
    t_ms, t_bound_ms, t_bound_by, counts = time_grouping_call(
        torch, parts["last_call"])
    by_shape.append({"path": "flow_train_val",
                     "shape": list(parts["last_call"][2].shape[:3]),
                     "valid_centers": counts, "ms": t_ms,
                     "bound_ms": t_bound_ms, "bound_by": t_bound_by})
    del result, parts, datasets

    # (d) card against CPU in float32
    flow_small = flow_card_vs_cpu(torch, device, rng)
    flow_numbers = {
        "adapt_step": flow_step_numbers, "stream": {
            k: flow_stream[k] for k in (
                "frames", "frame_ms", "frame_min_ms", "frame_max_ms",
                "frames_per_s", "getitem_ms", "peak_mib")},
        "train": flow_train, "card_vs_cpu": flow_small,
        "launches": flow_launches, "copies": flow_copies,
        "p_pq": flow_values["p_pq"], "d_abs_rel": flow_values["d_abs_rel"]}
    print(f"phase 12: {time.perf_counter() - phase_start:.3f} s")

    phase("13 data parallel")
    phase_start = time.perf_counter()
    import torch.multiprocessing as torch_mp
    import torch.distributed as torch_dist
    # (a) and (b): DDP_RANKS processes on this one card over gloo
    ddp_dir = Path(__file__).resolve().parent / "chiprun_out" / "ddp_smoke"
    torch.cuda.empty_cache()
    try:
        torch_mp.spawn(ddp_smoke_rank, args=(DDP_RANKS, free_port(),
                                             str(ddp_dir)),
                       nprocs=DDP_RANKS, join=True)
        ranks = [json.loads((ddp_dir / f"rank{r}.json").read_text())
                 for r in range(DDP_RANKS)]
    finally:
        for path in sorted(ddp_dir.rglob("*"), reverse=True):
            path.unlink() if path.is_file() else path.rmdir()
        if ddp_dir.exists():
            ddp_dir.rmdir()
    ddp_batch = TRAIN_BATCH * DDP_RANKS
    for r, numbers in enumerate(ranks):
        assert len(numbers["metrics"]) == DDP_STEPS
        assert numbers["global_step"] == DDP_STEPS + 1
        for metrics in numbers["metrics"] + numbers["resumed_metrics"]:
            bad = [k for k, v in metrics.items() if not math.isfinite(v)]
            assert not bad, f"rank {r}: train metrics not finite: {bad}"
        # the step metrics are the global batch's: the same on every rank
        assert numbers["metrics"] == ranks[0]["metrics"], r
        assert numbers["val"] == ranks[0]["val"], r
        assert numbers["sem_conf"] == ranks[0]["sem_conf"], r
        assert numbers["resumed"]["world"] == DDP_RANKS
        assert numbers["resumed"]["backend"] == "gloo"
        assert numbers["launches"] == numbers["copies"] == 0, numbers
        # the global batch of 4 gives each rank 2 rows (prediction and GT
        # map); the tail of 1 is evaluated whole on every rank, its GT map
        # on rank 0 alone, which counts it
        expect = 4 if r == 0 else 3
        assert numbers["val_launches"] == [expect, expect], numbers
        assert numbers["val_copies"] == [0, 0], numbers
        assert numbers["shapes"] == [[1, SOURCE_HEIGHT, SOURCE_WIDTH],
                                     [2, SOURCE_HEIGHT, SOURCE_WIDTH]], \
            numbers["shapes"]
        assert numbers["max_abs_err"] == 0
    # a step ends when every rank's scalars are on its host
    step_s = [max(numbers["step_s"][i] for numbers in ranks)
              for i in range(DDP_STEPS)][TRAIN_WARMUP:]
    ddp_step_ms = statistics.median(step_s) * 1e3
    exact = ranks[0]["exact"]
    ddp_numbers = {
        "card": smi, "ranks": DDP_RANKS, "backend": "gloo",
        "shared_card": True, "config": "cfg/train_cityscapes.yaml",
        "batch_per_rank": TRAIN_BATCH, "global_batch": ddp_batch,
        "size": [SOURCE_HEIGHT, SOURCE_WIDTH],
        "compute_dtype": "bfloat16",
        "step_ms": ddp_step_ms,
        "images_per_s": ddp_batch / ddp_step_ms * 1e3,
        "all_step_ms": [[t * 1e3 for t in n["step_s"]] for n in ranks],
        "loop_ms": [statistics.median(np.diff(
            n["starts"][TRAIN_WARMUP:])) * 1e3 for n in ranks],
        "allreduce_ms": [statistics.median(n["allreduce_s"][TRAIN_WARMUP:])
                         * 1e3 for n in ranks],
        "all_allreduce_ms": [[t * 1e3 for t in n["allreduce_s"]]
                             for n in ranks],
        "peak_mib": [n["peak_mib"] for n in ranks],
        "launches": {f"rank{n['rank']}": {
            "steps": n["launches"], "val": n["val_launches"],
            "copies": n["copies"], "val_copies": n["val_copies"]}
            for n in ranks},
        "kernel_equals_plain_calls": [n["calls"] for n in ranks],
        "val_batch_ms": [[t * 1e3 for t in n["val_batch_s"]]
                         for n in ranks],
        "val_metrics": ranks[0]["val"][0],
        "exactness": {"rows_per_rank": DDP_EXACT_ROWS,
                      "size": [SOURCE_HEIGHT, SOURCE_WIDTH],
                      "bounds": DDP_BOUNDS, "f32_factor": DDP_F32_FACTOR,
                      **{name: {k: v for k, v in part.items()
                                if k != "metrics"}
                         for name, part in exact.items()},
                      "held": {name: ddp_bounds(part)
                               for name, part in exact.items()}}}
    print(f"data parallel (a), {DDP_RANKS} ranks sharing one card over "
          f"gloo ({smi}), cfg/train_cityscapes.yaml's values, batch "
          f"{TRAIN_BATCH} a rank ({ddp_batch} global) at {SOURCE_HEIGHT}x"
          f"{SOURCE_WIDTH}, bfloat16: step (host clock, slowest rank, median "
          f"of {len(step_s)} after {TRAIN_WARMUP} warm-up) {ddp_step_ms:.3f} "
          f"ms, {ddp_numbers['images_per_s']:.3f} global images/s (two "
          f"ranks on one card are no faster than one: multi-card throughput "
          f"waits for a 4-chip cell); gradient all-reduce "
          f"{[round(t, 3) for t in ddp_numbers['allreduce_ms']]} ms a step "
          f"by rank; peak memory "
          f"{[round(m, 1) for m in ddp_numbers['peak_mib']]} MiB by rank")
    print(f"data parallel (a): grouping launches by rank "
          f"{ddp_numbers['launches']}; kernel == plain on all "
          f"{ddp_numbers['kernel_equals_plain_calls']} calls by rank; "
          f"resumed from {ranks[0]['checkpoint']} on every rank "
          f"({ranks[0]['resumed']['tensors']} tensors and the generator "
          f"bit-equal); validation " + ", ".join(
              f"{k} {v:.6g}" for k, v in ddp_numbers["val_metrics"].items()))
    def distances_text(d):
        return (f"losses rel {max(d['loss_rel'].values()):.3g}; BatchNorm "
                f"running statistics {d['stat_err']:.3g} over "
                f"{d['stat_tensors']} tensors; gradients by relative L2 "
                + ", ".join(f"{k} {v:.3g}"
                            for k, v in d["grad_rel_l2"].items()))

    for name, part in exact.items():
        print(f"data parallel (b), {name} at {SOURCE_HEIGHT}x{SOURCE_WIDTH},"
              f" {DDP_RANKS} x {DDP_EXACT_ROWS} rows against one process on "
              f"{DDP_RANKS * DDP_EXACT_ROWS}: {distances_text(part)}; peak "
              f"memory of rank 0 {part['peak_mib']} MiB")
        for who, d in part.get("to_float64", {}).items():
            print(f"data parallel (b), {name}, the {who} step against the "
                  f"one-process float64 step: {distances_text(d)}")
        q, key, err, bound = max(ddp_bounds(part),
                                 key=lambda held: held[2] / held[3])
        print(f"data parallel (b), {name}: nearest its bound {q} {key} "
              f"{err:.3g} of {bound:.3g}")

    # (c) NCCL as a world of one, in this process
    import os
    nccl_env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                    MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    os.environ.update(nccl_env)
    nccl_seen = {}

    def record_group(state):
        nccl_seen.update(backend=torch_dist.get_backend(),
                         world=torch_dist.get_world_size(),
                         device=str(state.device))

    try:
        from codeps_torch import parallel
        with parallel.process_group("cuda") as nccl_device:
            nccl_cfg = train_config((SOURCE_HEIGHT, SOURCE_WIDTH))
            nccl_data = train_datasets(nccl_cfg, NCCL_STEPS * TRAIN_BATCH,
                                       TRAIN_VAL_IMAGES, SEED)
            nccl_result, nccl_parts = drive_training(
                torch, nccl_cfg, nccl_data, nccl_device,
                max_steps=NCCL_STEPS,
                check_resumed=record_group)
    finally:
        for key in nccl_env:
            os.environ.pop(key, None)
    assert nccl_seen == {"backend": "nccl", "world": 1,
                         "device": "cuda:0"}, nccl_seen
    assert not torch_dist.is_initialized()
    assert len(nccl_result["metrics"]) == NCCL_STEPS
    for metrics in nccl_result["metrics"]:
        assert all(math.isfinite(v) for v in metrics.values()), metrics
    nccl_val = nccl_parts["val"][0]
    assert nccl_parts["steps"]["launches"] == 0
    assert nccl_val["launches"] == 2 * (TRAIN_VAL_IMAGES
                                        // nccl_cfg.val.batch_size_per_gpu)
    assert nccl_val["copies"] == 0
    ddp_numbers["nccl"] = {
        "backend": "nccl", "world": 1,
        "step_ms": [t * 1e3 for t in nccl_result["step_times"]],
        "val_batch_ms": [t * 1e3 for t in nccl_val["batch_s"]],
        "launches": {"steps": nccl_parts["steps"]["launches"],
                     "val": nccl_val["launches"]},
        "copies": nccl_val["copies"],
        "val_metrics": {k: float(v) for k, v in nccl_result["val"][0].items()
                        if np.ndim(v) == 0}}
    print(f"data parallel (c), NCCL as a world of one on {nccl_seen['device']}"
          f": {NCCL_STEPS} steps "
          f"{[round(t, 3) for t in ddp_numbers['nccl']['step_ms']]} ms, "
          f"validation {nccl_val['launches']} launches in "
          f"{len(nccl_val['batch_s'])} batches, 0 copies, kernel == plain "
          f"on all {len(nccl_parts['centers'])} calls; p_pq "
          f"{ddp_numbers['nccl']['val_metrics']['p_pq']:.6g}")
    ddp_launches = {
        "ddp_train": sum(n["launches"] for n in ranks)
        + nccl_parts["steps"]["launches"],
        "ddp_val": sum(sum(n["val_launches"]) for n in ranks)
        + nccl_val["launches"]}
    ddp_copies = {
        "ddp_train": sum(n["copies"] for n in ranks)
        + nccl_parts["steps"]["copies"],
        "ddp_val": sum(sum(n["val_copies"]) for n in ranks)
        + nccl_val["copies"]}
    ddp_err = max(max(n["max_abs_err"] for n in ranks),
                  nccl_parts["max_abs_err"])
    del nccl_result, nccl_parts, nccl_data
    # (b)'s bounds, held after (c) has run
    for name, part in exact.items():
        for q, key, err, bound in ddp_bounds(part):
            assert err <= bound, (name, q, key, err, bound)
        assert all(n["exact"][name]["metrics"] == part["metrics"]
                   for n in ranks)
    print(f"phase 13: {time.perf_counter() - phase_start:.3f} s")

    phase("14 spatial sharding")
    phase_start = time.perf_counter()
    # (a) to (c): SPATIAL_RANKS processes on this one card over gloo, from
    # phase 7's weights
    spatial_dir = ddp_dir.parent / "spatial_smoke"
    spatial_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()
    try:
        torch.save(stream_modules, spatial_dir / "modules.pt")
        del stream_modules
        torch_mp.spawn(spatial_smoke_rank, args=(SPATIAL_RANKS, free_port(),
                                                 str(spatial_dir)),
                       nprocs=SPATIAL_RANKS, join=True)
        sranks = [json.loads((spatial_dir / f"rank{r}.json").read_text())
                  for r in range(SPATIAL_RANKS)]
        # (e) three ranks: uneven slabs of the source
        torch_mp.spawn(spatial_three_rank,
                       args=(SPATIAL_UNEVEN_RANKS, free_port(),
                             str(spatial_dir)),
                       nprocs=SPATIAL_UNEVEN_RANKS, join=True)
        uneven = [json.loads((spatial_dir / f"uneven{r}.json").read_text())
                  for r in range(SPATIAL_UNEVEN_RANKS)]
        # (h1) four ranks, fewer blocks than ranks at the published widths
        torch_mp.spawn(spatial_empty_rank,
                       args=(SPATIAL_EMPTY_RANKS, free_port(),
                             str(spatial_dir)),
                       nprocs=SPATIAL_EMPTY_RANKS, join=True)
        empty = [json.loads((spatial_dir / f"empty{r}.json").read_text())
                 for r in range(SPATIAL_EMPTY_RANKS)]
        # (h2) the published frame on a two-node rank count
        wide_start = time.perf_counter()
        torch_mp.spawn(spatial_wide_rank,
                       args=(SPATIAL_WIDE_RANKS, free_port(),
                             str(spatial_dir)),
                       nprocs=SPATIAL_WIDE_RANKS, join=True)
        wide_seconds = time.perf_counter() - wide_start
        wide = [json.loads((spatial_dir / f"wide{r}.json").read_text())
                for r in range(SPATIAL_WIDE_RANKS)]
        # (d) the CLI under torchrun, every rank on card 0
        cli_numbers = spatial_cli(spatial_dir)
    finally:
        for path in sorted(spatial_dir.rglob("*"), reverse=True):
            path.unlink() if path.is_file() else path.rmdir()
        if spatial_dir.exists():
            spatial_dir.rmdir()
    lead_numbers = sranks[0]
    ex = lead_numbers["exactness"]
    exact = ex["exact"]
    for r, numbers in enumerate(sranks):
        # every rank holds the global losses
        mine = numbers["exactness"]["exact"]
        for part, lead_part in zip([mine["float64"], *mine["float32"]],
                                   [exact["float64"], *exact["float32"]]):
            assert part["metrics"] == lead_part["metrics"], r
            bad = [k for k, v in part["metrics"].items()
                   if not math.isfinite(v)]
            assert not bad, (r, bad)
        # (g): every rank holds the global losses, and places as rank 0
        assert numbers["hybrid"]["float64"]["metrics"] == sranks[0][
            "hybrid"]["float64"]["metrics"], r
        assert numbers["hybrid"]["placement"] == sranks[0]["hybrid"][
            "placement"], r
        assert all(math.isfinite(v) for v in numbers["hybrid"]["float64"][
            "metrics"].values()), r
        if r:
            assert numbers["exactness"]["launches"] == 0, numbers
            assert numbers["hybrid"]["launches"] == 0, numbers["hybrid"]
            for part in numbers["stream"].values():
                assert part["split"]["launches"] == 0
                assert part["split"]["copies"] == 0
                assert len(part["split"]["row_times_ms"][
                    "step"]) == SPATIAL_FRAMES
            rows_part = numbers["stream"]["bfloat16"]["rows"]
            assert rows_part["launches"] == rows_part["copies"] == 0
            assert len(rows_part["row_times_ms"]["step"]) == SPATIAL_FRAMES
    f64 = exact["float64"]["against_one_process"]
    f64_worst = max([*f64["loss_rel"].values(), *f64["grad_rel_l2"].values(),
                     *f64["param_err"].values()])
    f32 = exact["float32"]

    ratios = {k: statistics.median(
        part["to_float64"]["split"]["grad_rel_l2"][k]
        / part["to_float64"]["one_process"]["grad_rel_l2"][k]
        for part in f32) for k in f32[0]["to_float64"]["split"][
            "grad_rel_l2"]}
    # (g) the hybrid placement; the timed steps of all three placements
    hy = lead_numbers["hybrid"]
    f64_hybrid = hy["float64"]["against_one_process"]
    hybrid_worst = max([*f64_hybrid["loss_rel"].values(),
                        *f64_hybrid["grad_rel_l2"].values(),
                        *f64_hybrid["param_err"].values()])
    placement_ms = {name: [max(n["hybrid"]["step_ms"][name][i]
                               for n in sranks
                               if n["hybrid"]["step_ms"][name])
                           for i in range(1 + SPATIAL_TIMED_STEPS)]
                    for name in ("hybrid", "rows", "one_process")}
    split_steps = placement_ms["rows"]
    collectives = {name: {k: sum(v) for k, v in part.items()}
                   for name, part in hy["collectives_ms"].items()}
    collective_calls = {name: {k: len(v) for k, v in part.items()}
                        for name, part in hy["collectives_ms"].items()}
    st = lead_numbers["stream"]["bfloat16"]
    split_stream, one_stream = st["split"], st["one_process"]
    st64 = lead_numbers["stream"]["float64"]
    follower = sranks[1]["stream"]["bfloat16"]["split"]
    print(f"spatial sharding, {SPATIAL_RANKS} ranks sharing one card over "
          f"gloo ({smi}), the published batch (target 1x{HEIGHT}x{WIDTH}, "
          f"{NUM_REPLAY} replay, {NUM_SOURCE} source and {NUM_MIXUP} fused "
          f"cut mixups at {SOURCE_HEIGHT}x{SOURCE_WIDTH}, ResNet-101):")
    print(f"spatial (a) float64, {SPATIAL_RANKS} ranks against one process: "
          f"losses rel {max(f64['loss_rel'].values()):.3g}; gradients by "
          f"relative L2 " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      f64["grad_rel_l2"].items())
          + f"; parameters after the step {max(f64['param_err'].values()):.3g}"
          f"; replay features max |diff| {f64['features']:.3g}; sem_conf "
          f"equal {f64['sem_conf_equal']}, panoptic map equal "
          f"{f64['panoptic_equal']}; peak memory "
          + ", ".join(f"{k} {v:.1f}" for k, v in ex["peak_mib"].items())
          + " MiB (rank 0)")
    for index, part in enumerate(f32):
        split_d = part["to_float64"]["split"]["grad_rel_l2"]
        one_d = part["to_float64"]["one_process"]["grad_rel_l2"]
        print(f"spatial (b) float32 (TF32 off), batch {index}: "
              f"{SPATIAL_RANKS} ranks against one process: gradients "
              + ", ".join(f"{k} {v:.3g}" for k, v in
                          part["against_one_process"]["grad_rel_l2"].items())
              + "; against the float64 step, row split / one process: "
              + ", ".join(f"{k} {v:.3g} / {one_d[k]:.3g} "
                          f"({v / one_d[k]:.3f})"
                          for k, v in split_d.items()))
    print("spatial (b) float32, batch 0, the one-process step run twice: "
          "gradients " + ", ".join(
              f"{k} {v:.3g}" for k, v in
              f32[0]["one_process_again"]["grad_rel_l2"].items()))
    print(f"spatial (b) float32: the median over {SPATIAL_F32_BATCHES} "
          f"batches of the ratio of the distances from float64, row split "
          f"/ one process: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
          + f" (bound {SPATIAL_F32_FACTOR})")
    print(f"spatial (g) hybrid placement {hy['placement']}: float64, "
          f"{SPATIAL_RANKS} ranks against one process: losses rel "
          f"{max(f64_hybrid['loss_rel'].values()):.3g}; gradients by "
          f"relative L2 " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      f64_hybrid["grad_rel_l2"].items())
          + f"; parameters {max(f64_hybrid['param_err'].values()):.3g}; "
          f"replay features {f64_hybrid['features']:.3g}; sem_conf equal "
          f"{f64_hybrid['sem_conf_equal']}, panoptic map equal "
          f"{f64_hybrid['panoptic_equal']}; peak "
          f"{hy['float64']['peak_mib']:.1f} MiB (rank 0)")
    print(f"spatial step, bfloat16, in turns ({smi}): hybrid (slowest rank) "
          f"{[round(t, 3) for t in placement_ms['hybrid']]} ms, row split "
          f"{[round(t, 3) for t in split_steps]} ms, one process "
          f"{[round(t, 3) for t in placement_ms['one_process']]} ms (host "
          f"clock, first is the warm-up)")
    for name in ("hybrid", "rows"):
        calls, ms = collective_calls[name], collectives[name]
        print(f"spatial step, bfloat16, {name}: in an instrumented step "
              f"(synchronized, rank 0) the halo exchanges "
              f"{ms['halo_rows']:.3f} ms in {calls['halo_rows']} calls, the "
              f"row gathers {ms['gather_rows']:.3f} ms in "
              f"{calls['gather_rows']}, the image gathers "
              f"{ms['gather_images']:.3f} ms in {calls['gather_images']}, the "
              f"all-reduces {ms['all_reduce']:.3f} ms in "
              f"{calls['all_reduce']} and all-gathers {ms['all_gather']:.3f} "
              f"ms in {calls['all_gather']} (batch statistics, top-k, "
              f"metrics), the gradient all-reduce "
              f"{ms['sum_gradients']:.3f} ms")
    rows_stream = st["rows"]
    print(f"spatial (c) stream, {SPATIAL_FRAMES} frames, bfloat16 ({smi}): "
          f"hybrid placement frame {split_stream['frame_ms']:.3f} ms (median "
          f"after {WARMUP_FRAMES}; all "
          f"{[round(t, 3) for t in split_stream['all_ms']]}), pure rows "
          f"{rows_stream['frame_ms']:.3f} ms (all "
          f"{[round(t, 3) for t in rows_stream['all_ms']]}), one process "
          f"{one_stream['frame_ms']:.3f} ms (all "
          f"{[round(t, 3) for t in one_stream['all_ms']]}); follower step "
          + str([round(t, 3) for t in follower["row_times_ms"]["step"]])
          + " ms; broadcast "
          + str([round(t, 3) for t in split_stream["row_times_ms"][
              "broadcast"]]) + " ms; gathers a frame (rank 0, synchronized) "
          f"{sum(split_stream['gather_ms']) / SPATIAL_FRAMES:.3f} ms; peak "
          f"memory rank 0 {split_stream['peak_mib']:.1f} MiB, rank 1 "
          f"{follower['peak_mib']:.1f} MiB, one process "
          f"{one_stream['peak_mib']:.1f} MiB")
    for name, part in (("bfloat16", st), ("float64", st64)):
        print(f"spatial (c) {name} meters, hybrid split / one process: "
              + ", ".join(f"{k} {part['split']['values'][k]:.6g} / "
                          f"{part['one_process']['values'][k]:.6g}"
                          for k in ("p_pq", "sem_miou", "d_abs_rel",
                                    "loss"))
              + f"; panoptic pixels that differ by frame "
              f"{[round(v, 6) for v in part['panoptic_diff_share']]}; "
              f"buffer ids equal "
              f"{part['split']['ids'] == part['one_process']['ids']}; "
              f"frame {part['split']['frame_ms']:.3f} / "
              f"{part['one_process']['frame_ms']:.3f} ms")
    print(f"spatial grouping launches: steps {ex['launches']} on rank 0, "
          f"{sranks[1]['exactness']['launches']} on rank 1; streams "
          f"{split_stream['launches']} + {st64['split']['launches']} on "
          f"rank 0 in 2 x {SPATIAL_FRAMES} frames, "
          f"{follower['launches']} on rank 1; 0 copies; kernel == plain on "
          f"all {ex['calls'] + split_stream['calls'] + st64['split']['calls']}"
          f" calls; shapes {ex['shapes']}")
    print(f"spatial (d) CLI: torchrun --nproc_per_node {SPATIAL_RANKS} on "
          f"{SPATIAL_CLI_SIZE[0]}x{SPATIAL_CLI_SIZE[1]} (ResNet-18, "
          f"{SPATIAL_CLI_FRAMES} frames) exit 0 in {cli_numbers['seconds']:.3f}"
          f" s; files {cli_numbers['written']}, buffer states "
          f"{cli_numbers['buffer_states']}; make_sflow exit "
          f"{cli_numbers['flow_rc']} in {cli_numbers['flow_seconds']:.3f} s, "
          f"files {cli_numbers['flow_written']}")
    # (e) three ranks, uneven slabs
    f64_uneven = uneven[0]["against_one_process"]
    uneven_worst = max([*f64_uneven["loss_rel"].values(),
                        *f64_uneven["grad_rel_l2"].values(),
                        *f64_uneven["param_err"].values()])
    print(f"spatial (e) float64, {SPATIAL_UNEVEN_RANKS} ranks sharing the "
          f"card ({smi}), rows of target / source by rank "
          + ", ".join(f"{n['slabs']['target']} / {n['slabs']['source']}"
                      for n in uneven)
          + f", against one process: losses rel "
          f"{max(f64_uneven['loss_rel'].values()):.3g}; gradients by "
          f"relative L2 " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      f64_uneven["grad_rel_l2"].items())
          + f"; parameters {max(f64_uneven['param_err'].values()):.3g}; "
          f"replay features {f64_uneven['features']:.3g}; sem_conf equal "
          f"{f64_uneven['sem_conf_equal']}, panoptic map equal "
          f"{f64_uneven['panoptic_equal']}; peak memory by rank "
          f"{[round(n['peak_mib'], 1) for n in uneven]} MiB; "
          f"{[round(n['seconds'], 3) for n in uneven]} s")
    # (f) the flow head, 2 ranks
    fl = lead_numbers["flow"]
    f64_flow = fl["float64"]["against_one_process"]
    flow_worst = max([*f64_flow["loss_rel"].values(),
                      *f64_flow["grad_rel_l2"].values(),
                      *f64_flow["param_err"].values()])
    flow_split_ms = [max(n["flow"]["step_ms"]["split"][i] for n in sranks)
                     for i in range(1 + SPATIAL_FLOW_TIMED_STEPS)]
    fs = fl["stream"]
    print(f"spatial (f) flow step float64, {SPATIAL_RANKS} ranks against "
          f"one process: losses rel {max(f64_flow['loss_rel'].values()):.3g}"
          f"; gradients by relative L2 "
          + ", ".join(f"{k} {v:.3g}" for k, v in
                      f64_flow["grad_rel_l2"].items())
          + f"; parameters {max(f64_flow['param_err'].values()):.3g}; "
          f"sem_conf equal {f64_flow['sem_conf_equal']}, panoptic map "
          f"equal {f64_flow['panoptic_equal']}; auto-mask kept shares by "
          f"call, split {fl['float64']['kept_share']}, one process "
          f"{fl['float64']['one_process_kept_share']}")
    print(f"spatial (f) flow step bfloat16: row split (slowest rank) "
          f"{[round(t, 3) for t in flow_split_ms]} ms, one process "
          f"{[round(t, 3) for t in fl['step_ms']['one_process']]} ms (host "
          f"clock after a synchronize, first is the warm-up)")
    print(f"spatial (f) flow stream, {SPATIAL_FLOW_FRAMES} frames, bfloat16:"
          f" row split {fs['split']['frame_ms']:.3f} ms a frame (all "
          f"{[round(t, 3) for t in fs['split']['all_ms']]}), one process "
          f"{fs['one_process']['frame_ms']:.3f} ms (all "
          f"{[round(t, 3) for t in fs['one_process']['all_ms']]}); meters "
          f"split / one process "
          + ", ".join(f"{k} {fs['split']['values'][k]:.6g} / "
                      f"{fs['one_process']['values'][k]:.6g}"
                      for k in ("p_pq", "sem_miou", "d_abs_rel",
                                "flow_smth", "flow_sparsity"))
          + f"; buffer ids equal "
          f"{fs['split']['ids'] == fs['one_process']['ids']}; auto-mask "
          f"kept share by call (target pair), split "
          f"{[round(v, 4) for c in fs['split']['kept_share'] for v in c]}"
          f", one process "
          f"{[round(v, 4) for c in fs['one_process']['kept_share'] for v in c]}"
          f"; grouping launches {fs['split']['launches']} on rank 0, "
          f"{sranks[1]['flow']['stream']['split']['launches']} on rank 1")
    assert f64_worst <= SPATIAL_F64_BOUND, f64
    assert f64["features"] <= SPATIAL_F64_BOUND, f64["features"]
    assert f64["sem_conf_equal"] and f64["panoptic_equal"], f64
    # (g): 2 samples of each side domain divide over 2 ranks
    assert hy["placement"] == {"target": "rows", "eval_gt": "rows",
                               "source": "images", "target_replay": "images",
                               "mixup": "images"}, hy["placement"]
    assert hybrid_worst <= SPATIAL_F64_BOUND, f64_hybrid
    assert f64_hybrid["features"] <= SPATIAL_F64_BOUND, f64_hybrid
    assert f64_hybrid["sem_conf_equal"] and f64_hybrid["panoptic_equal"], \
        f64_hybrid
    # an eval a step on rank 0: float64 hybrid and one process, then the
    # warm-up and timed steps of the three placements and the two
    # instrumented steps
    assert hy["launches"] == 2 + 3 * (1 + SPATIAL_TIMED_STEPS) + 2, hy
    assert hy["copies"] == hy["max_abs_err"] == 0, hy
    assert rows_stream["copies"] == rows_stream["max_abs_err"] == 0
    assert rows_stream["launches"] == 2 * SPATIAL_FRAMES
    # the side domains by images: fewer halo exchanges, no row gather
    # but the target's
    assert collective_calls["hybrid"]["halo_rows"] \
        < collective_calls["rows"]["halo_rows"], collective_calls
    assert collective_calls["rows"]["gather_images"] == 0, collective_calls
    for name, ratio in ratios.items():
        assert ratio <= SPATIAL_F32_FACTOR, (name, ratio)
    # the buffer's choices in both; the meters and every panoptic map in
    # float64: a slab's convolutions round otherwise than the whole
    # frame's in bfloat16 and float32, and the adaptation steps carry the
    # difference through the stream (bfloat16's printed above)
    for part in (st, st64):
        assert part["split"]["ids"] == part["one_process"]["ids"]
        assert part["split"]["copies"] == 0
        assert part["split"]["max_abs_err"] == 0
    for key, tol in (("p_pq", PQ_TOL), ("sem_miou", MIOU_TOL),
                     ("d_abs_rel", ABS_REL_TOL)):
        assert abs(st64["split"]["values"][key]
                   - st64["one_process"]["values"][key]) <= tol, key
    assert not any(st64["panoptic_diff_share"]), st64["panoptic_diff_share"]
    assert ex["copies"] == 0 and ex["max_abs_err"] == 0
    assert cli_numbers["written"] == ["adapt_spatial/config.yaml",
                                      "adapt_spatial/logs/run.log"], \
        cli_numbers["written"]
    assert cli_numbers["buffer_states"] == ["spatial_buffer.pkl"]
    assert cli_numbers["stream_lines"] == cli_numbers["val_lines"] == 1
    assert cli_numbers["flow_rc"] == 0, cli_numbers["flow_tail"]
    assert cli_numbers["flow_written"] == ["adapt_flow/config.yaml",
                                           "adapt_flow/logs/run.log"], \
        cli_numbers["flow_written"]
    assert uneven_worst <= SPATIAL_UNEVEN_BOUND, f64_uneven
    assert f64_uneven["features"] <= SPATIAL_UNEVEN_BOUND
    assert f64_uneven["sem_conf_equal"] and f64_uneven["panoptic_equal"]
    # whole blocks in order, as evenly as blocks allow (512 rows: 192,
    # 160, 160)
    for name, height in (("target", HEIGHT), ("source", SOURCE_HEIGHT)):
        slabs = [n["slabs"][name] for n in uneven]
        sizes = [stop - start for start, stop in slabs]
        assert slabs[0][0] == 0 and slabs[-1][1] == height, slabs
        assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:])), slabs
        assert all(size % 32 == 0 for size in sizes), slabs
        assert max(sizes) - min(sizes) <= 32, slabs
    for n in uneven:
        assert n["metrics"] == uneven[0]["metrics"]
        assert set(n["placement"].values()) == {"rows"}, n["placement"]
    assert flow_worst <= SPATIAL_F64_BOUND, f64_flow
    assert f64_flow["sem_conf_equal"] and f64_flow["panoptic_equal"]
    assert fl["float64"]["kept_share"] == \
        fl["float64"]["one_process_kept_share"]
    assert all(0.0 < v < 1.0 for c in fl["float64"]["kept_share"]
               for v in c), fl["float64"]["kept_share"]
    for n in sranks:
        assert n["flow"]["float64"]["metrics"] == fl["float64"]["metrics"]
        # the motion maps are whole on every rank: the same kept shares
        assert n["flow"]["float64"]["kept_share"] == \
            fl["float64"]["kept_share"]
    assert len(fs["split"]["kept_share"]) == len(
        fs["one_process"]["kept_share"]) > 0
    for part in fs.values():
        assert part["copies"] == 0
    assert fs["split"]["max_abs_err"] == fs["one_process"][
        "max_abs_err"] == 0
    assert fs["split"]["launches"] == 2 * SPATIAL_FLOW_FRAMES
    assert sranks[1]["flow"]["stream"]["split"]["launches"] == 0
    # one eval a step on rank 0: float64 split and one process, then the
    # bfloat16 warm-up and timed steps of each
    flow_grouped = fl["step_grouping"]
    assert flow_grouped["launches"] == 2 * (2 + SPATIAL_FLOW_TIMED_STEPS), \
        flow_grouped
    assert sranks[1]["flow"]["step_grouping"]["launches"] == 0
    assert flow_grouped["copies"] == flow_grouped["max_abs_err"] == 0
    # (e): the split's eval and the one process's on rank 0
    assert [n["launches"] for n in uneven] == [2] + [0] * (
        SPATIAL_UNEVEN_RANKS - 1), uneven
    assert all(n["copies"] == n["max_abs_err"] == 0 for n in uneven)
    # (h1) four ranks, empty slabs
    f64_empty = empty[0]["against_one_process"]
    empty_worst = max([*f64_empty["loss_rel"].values(),
                       *f64_empty["grad_rel_l2"].values(),
                       *f64_empty["param_err"].values()])
    print(f"spatial (h1) float64, {SPATIAL_EMPTY_RANKS} ranks sharing the "
          f"card ({smi}), fewer blocks than ranks: target "
          f"{SPATIAL_EMPTY_SIZES[0][0]}x{SPATIAL_EMPTY_SIZES[0][1]}, source "
          f"and mixup {SPATIAL_EMPTY_SIZES[1][0]}x"
          f"{SPATIAL_EMPTY_SIZES[1][1]}, rows of target / source by rank "
          + ", ".join(f"{n['slabs']['target']} / {n['slabs']['source']}"
                      for n in empty)
          + f", against one process: losses rel "
          f"{max(f64_empty['loss_rel'].values()):.3g}; gradients by "
          f"relative L2 " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      f64_empty["grad_rel_l2"].items())
          + f"; parameters {max(f64_empty['param_err'].values()):.3g}; "
          f"replay features {f64_empty['features']:.3g}; sem_conf equal "
          f"{f64_empty['sem_conf_equal']}, panoptic map equal "
          f"{f64_empty['panoptic_equal']}; peak memory by rank "
          f"{[round(n['peak_mib'], 1) for n in empty]} MiB; "
          f"{[round(n['seconds'], 3) for n in empty]} s")
    # (h2) sixteen ranks on the published frame
    wide_lead = wide[0]
    wide_ms = [max(n["step_ms"][i] for n in wide)
               for i in range(1 + SPATIAL_WIDE_TIMED_STEPS)]
    wide_calls = {k: len(v) for k, v in wide_lead["collectives_ms"].items()}
    wide_collectives = {k: sum(v) for k, v in
                        wide_lead["collectives_ms"].items()}
    print(f"spatial (h2) {SPATIAL_WIDE_RANKS} ranks sharing the card "
          f"({smi}), the published {HEIGHT}x{WIDTH} frame: target rows by "
          f"rank {[n['slabs']['target'] for n in wide]}, source "
          f"{[n['slabs']['source'] for n in wide]}; the float64 teacher "
          f"eval split / one process: maps equal "
          f"{wide_lead['eval_equal']}, depth max rel "
          f"{wide_lead['eval_depth_err']:.3g}, split eval "
          f"{[round(n['eval_s'], 3) for n in wide]} s; placement "
          f"{wide_lead['placement']}")
    print(f"spatial (h2) bfloat16 steps under the hybrid placement, "
          f"{SPATIAL_WIDE_RANKS} ranks ({smi}): slowest rank "
          f"{[round(t, 3) for t in wide_ms]} ms (host clock, first is the "
          f"warm-up, instrumented); losses "
          f"{wide_lead['metrics'][-1]['loss_total']:.6g}; "
          f"peak memory by rank {[round(n['peak_mib'], 1) for n in wide]} "
          f"MiB; in the instrumented step (synchronized, rank 0) the halo "
          f"exchanges {wide_collectives['halo_rows']:.3f} ms in "
          f"{wide_calls['halo_rows']} calls, the row gathers "
          f"{wide_collectives['gather_rows']:.3f} ms in "
          f"{wide_calls['gather_rows']}, the all-reduces "
          f"{wide_collectives['all_reduce']:.3f} ms in "
          f"{wide_calls['all_reduce']} and all-gathers "
          f"{wide_collectives['all_gather']:.3f} ms in "
          f"{wide_calls['all_gather']}, the gradient all-reduce "
          f"{wide_collectives['sum_gradients']:.3f} ms; ranks up "
          f"{max(n['start_s'] for n in wide):.3f} s, the spawn "
          f"{wide_seconds:.3f} s")
    assert empty_worst <= SPATIAL_UNEVEN_BOUND, f64_empty
    assert f64_empty["features"] <= SPATIAL_UNEVEN_BOUND, f64_empty
    assert f64_empty["sem_conf_equal"] and f64_empty["panoptic_equal"], \
        f64_empty
    for n in empty:
        assert n["metrics"] == empty[0]["metrics"]
        assert set(n["placement"].values()) == {"rows"}, n["placement"]
    for name, index in (("target", 0), ("source", 1)):
        height = SPATIAL_EMPTY_SIZES[index][0]
        blocks = height // 32
        assert [n["slabs"][name] for n in empty] == [
            [32 * r, 32 * r + 32] for r in range(blocks)] + [
            [height, height]] * (SPATIAL_EMPTY_RANKS - blocks), empty
    assert [n["launches"] for n in empty] == [2] + [0] * (
        SPATIAL_EMPTY_RANKS - 1), empty
    assert all(n["copies"] == n["max_abs_err"] == 0 for n in empty)
    # (h2): 12 target blocks and 4 empty slabs, 16 source blocks
    assert [n["slabs"]["target"] for n in wide] == [
        [32 * r, 32 * r + 32] for r in range(HEIGHT // 32)] + [
        [HEIGHT, HEIGHT]] * (SPATIAL_WIDE_RANKS - HEIGHT // 32), wide
    assert all(n["slabs"]["source"][1] - n["slabs"]["source"][0] == 32
               for n in wide), wide
    assert all(wide_lead["eval_equal"].values()), wide_lead["eval_equal"]
    assert [n["eval_on_rank"] for n in wide] == [True] + [False] * (
        SPATIAL_WIDE_RANKS - 1)
    for n in wide:
        assert n["metrics"] == wide_lead["metrics"]
        assert all(math.isfinite(v) for m in n["metrics"]
                   for v in m.values()), n["metrics"]
        assert set(n["placement"].values()) == {"rows"}, n["placement"]
        assert n["copies"] == n["max_abs_err"] == 0
    # rank 0: the split eval and one process's, then an eval a step
    assert [n["launches"] for n in wide] == [
        2 + 1 + SPATIAL_WIDE_TIMED_STEPS] + [0] * (
        SPATIAL_WIDE_RANKS - 1), [n["launches"] for n in wide]
    spatial_launches = {
        "spatial_step": sum(n["exactness"]["launches"] for n in sranks),
        "spatial_stream": sum(part["split"]["launches"] for n in sranks
                              for part in n["stream"].values()),
        "spatial_flow_step": sum(n["flow"]["step_grouping"]["launches"]
                                 for n in sranks),
        "spatial_flow_stream": sum(n["flow"]["stream"]["split"]["launches"]
                                   for n in sranks),
        "spatial_uneven_step": sum(n["launches"] for n in uneven),
        "spatial_hybrid_step": sum(n["hybrid"]["launches"] for n in sranks),
        "spatial_stream_rows": sum(n["stream"]["bfloat16"]["rows"][
            "launches"] for n in sranks),
        "spatial_empty_step": sum(n["launches"] for n in empty),
        "spatial_wide": sum(n["launches"] for n in wide)}
    spatial_copies = {
        "spatial_step": sum(n["exactness"]["copies"] for n in sranks),
        "spatial_stream": sum(part["split"]["copies"] for n in sranks
                              for part in n["stream"].values()),
        "spatial_flow_step": sum(n["flow"]["step_grouping"]["copies"]
                                 for n in sranks),
        "spatial_flow_stream": sum(n["flow"]["stream"]["split"]["copies"]
                                   for n in sranks),
        "spatial_uneven_step": sum(n["copies"] for n in uneven),
        "spatial_hybrid_step": sum(n["hybrid"]["copies"] for n in sranks),
        "spatial_stream_rows": sum(n["stream"]["bfloat16"]["rows"][
            "copies"] for n in sranks),
        "spatial_empty_step": sum(n["copies"] for n in empty),
        "spatial_wide": sum(n["copies"] for n in wide)}
    print(f"spatial grouping launches, (g) the hybrid steps "
          f"{hy['launches']} on rank 0, "
          f"{sranks[1]['hybrid']['launches']} on rank 1, the pure-rows "
          f"stream {rows_stream['launches']} on rank 0, "
          f"{sranks[1]['stream']['bfloat16']['rows']['launches']} on rank "
          f"1; 0 copies; kernel == plain on all "
          f"{hy['calls'] + rows_stream['calls']} calls; shapes "
          f"{hy['shapes']}")
    print(f"spatial grouping launches, the flow paths: steps "
          f"{spatial_launches['spatial_flow_step']}, stream "
          f"{spatial_launches['spatial_flow_stream']}; the uneven step "
          f"{spatial_launches['spatial_uneven_step']} (all ranks); 0 "
          f"copies; kernel == plain on all "
          f"{flow_grouped['calls'] + fs['split']['calls'] + uneven[0]['calls']}"
          f" calls")
    spatial_numbers = {
        "card": smi, "ranks": SPATIAL_RANKS, "backend": "gloo",
        "shared_card": True, "config": "cfg/adapt_cityscapes_kitti_360.yaml",
        "exactness": {"float64": f64, "float32": f32, "ratios": ratios,
                      "bounds": {"float64": SPATIAL_F64_BOUND,
                                 "f32_factor": SPATIAL_F32_FACTOR},
                      "peak_mib": ex["peak_mib"]},
        "step_ms": {"split": split_steps,
                    "one_process": placement_ms["one_process"],
                    "collectives_ms": collectives["rows"],
                    "collective_calls": collective_calls["rows"]},
        "hybrid": {"placement": hy["placement"], "float64": f64_hybrid,
                   "bound": SPATIAL_F64_BOUND,
                   "peak_mib": hy["float64"]["peak_mib"],
                   "step_ms": placement_ms, "collectives_ms": collectives,
                   "collective_calls": collective_calls,
                   "stream_frame_ms": {
                       "hybrid": split_stream["frame_ms"],
                       "rows": rows_stream["frame_ms"],
                       "one_process": one_stream["frame_ms"]},
                   "stream_all_ms": {"hybrid": split_stream["all_ms"],
                                     "rows": rows_stream["all_ms"]}},
        "stream": {
            "split": {k: split_stream[k] for k in (
                "frame_ms", "frame_min_ms", "frame_max_ms", "frames_per_s",
                "all_ms", "peak_mib")},
            "one_process": {k: one_stream[k] for k in (
                "frame_ms", "frame_min_ms", "frame_max_ms", "frames_per_s",
                "all_ms", "peak_mib")},
            "follower_step_ms": follower["row_times_ms"]["step"],
            "follower_peak_mib": follower["peak_mib"],
            "broadcast_ms": split_stream["row_times_ms"]["broadcast"],
            "gather_ms_per_frame": sum(split_stream["gather_ms"])
            / SPATIAL_FRAMES,
            "panoptic_diff_share": st["panoptic_diff_share"],
            "meters": {name: {k: [part["split"]["values"][k],
                                  part["one_process"]["values"][k]]
                              for k in ("p_pq", "sem_miou", "d_abs_rel")}
                       for name, part in (("bfloat16", st),
                                          ("float64", st64))},
            "float64_panoptic_diff_share": st64["panoptic_diff_share"],
            "float64_frame_ms": [st64["split"]["frame_ms"],
                                 st64["one_process"]["frame_ms"]]},
        "cli": {k: cli_numbers[k] for k in ("seconds", "written", "flow_rc",
                                            "flow_seconds", "flow_written")},
        "uneven": {"ranks": SPATIAL_UNEVEN_RANKS,
                   "slabs": [n["slabs"] for n in uneven],
                   "float64": f64_uneven,
                   "bound": SPATIAL_UNEVEN_BOUND,
                   "peak_mib": [n["peak_mib"] for n in uneven]},
        "empty": {"ranks": SPATIAL_EMPTY_RANKS,
                  "sizes": SPATIAL_EMPTY_SIZES,
                  "slabs": [n["slabs"] for n in empty],
                  "float64": f64_empty, "bound": SPATIAL_UNEVEN_BOUND,
                  "peak_mib": [n["peak_mib"] for n in empty]},
        "wide": {"ranks": SPATIAL_WIDE_RANKS,
                 "slabs": [n["slabs"] for n in wide],
                 "eval_equal": wide_lead["eval_equal"],
                 "eval_depth_err": wide_lead["eval_depth_err"],
                 "eval_s": [n["eval_s"] for n in wide],
                 "step_ms": wide_ms,
                 "step_ms_by_rank": [n["step_ms"] for n in wide],
                 "peak_mib": [n["peak_mib"] for n in wide],
                 "collectives_ms": wide_collectives,
                 "collective_calls": wide_calls,
                 "spawn_s": wide_seconds},
        "flow": {"float64": f64_flow,
                 "kept_share": fl["float64"]["kept_share"],
                 "step_ms": {"split": flow_split_ms,
                             "one_process": fl["step_ms"]["one_process"]},
                 "stream": {name: {k: part[k] for k in (
                     "frame_ms", "all_ms", "peak_mib", "kept_share")}
                     for name, part in fs.items()},
                 "stream_meters": {k: [fs["split"]["values"][k],
                                       fs["one_process"]["values"][k]]
                                   for k in ("p_pq", "sem_miou",
                                             "d_abs_rel")}},
        "launches": spatial_launches, "copies": spatial_copies,
        "seconds": {"exactness": [n["exactness_s"] for n in sranks],
                    "hybrid": [n["hybrid_s"] for n in sranks],
                    "stream": [n["stream_s"] for n in sranks],
                    "flow": [n["flow_s"] for n in sranks],
                    "uneven": [n["seconds"] for n in uneven],
                    "empty": [n["seconds"] for n in empty],
                    "wide": [n["seconds"] for n in wide]}}
    spatial_err = max(ex["max_abs_err"], split_stream["max_abs_err"],
                      st64["split"]["max_abs_err"],
                      fs["split"]["max_abs_err"], flow_grouped["max_abs_err"],
                      hy["max_abs_err"], rows_stream["max_abs_err"],
                      *(n["max_abs_err"] for n in uneven + empty + wide))
    print(f"phase 14: {time.perf_counter() - phase_start:.3f} s")

    phase("15 result")
    print(json.dumps({"kernels": [{
        "name": "group_pixels", "route": "cuda",
        "source": "codeps_torch/csrc/grouping.cu",
        "replaces": "codeps_tpu/ops/pallas/grouping.py:30",
        "launches": (launches + adapt_launches + stream_launches
                     + sum(cli_launches.values())
                     + sum(train_launches.values()) + host_launches
                     + sum(flow_launches.values())
                     + sum(ddp_launches.values())
                     + sum(spatial_launches.values())),
        "launches_by_path": {"serve": launches, "adapt": adapt_launches,
                             "stream": stream_launches,
                             **{f"cli_{k}": v
                                for k, v in cli_launches.items()},
                             **train_launches, "host_mixup": host_launches,
                             **flow_launches, **ddp_launches,
                             **spatial_launches},
        "copies_by_path": {"serve": copies, "adapt": adapt_copies,
                           "stream": stream_copies,
                           **{f"cli_{k}": v
                              for k, v in cli_copies.items()},
                           **train_copies, "host_mixup": host_copies,
                           **flow_copies, **ddp_copies,
                           **spatial_copies},
        "exact": True,
        "max_abs_err": max(max_err, stream_err, cli_err, train_err,
                           host_err, flow_err, ddp_err, spatial_err),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "kernel_ms": kernel_ms, "bound_us": bound_ms * 1e3,
        "call_ms": kernel_call_ms,
        "valid_centers": num_valid, "by_valid_centers": by_valid,
        "by_shape": by_shape}]}))
    print(json.dumps({"adapt_step": {
        "ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "peak_mib": adapt_peak / 2**20,
        "all_ms": [t * 1e3 for t in step_seconds],
        "float32": {"ms": f32_step_ms, "peak_mib": f32_peak / 2**20,
                    "all_ms": [t * 1e3 for t in f32_seconds]}}}))
    keep = ("frames", "frame_ms", "frame_min_ms", "frame_max_ms",
            "frames_per_s", "getitem_ms", "add_ms", "peak_mib")
    print(json.dumps({"adapt_stream": {
        "published": {k: published[k] for k in keep},
        "uint8_frames": {k: uint8_frames[k] for k in keep},
        "device_busy": busy, "diversity_add": diversity,
        "p_pq": values["p_pq"], "sem_miou": values["sem_miou"],
        "d_abs_rel": values["d_abs_rel"]}}))
    print(json.dumps({"adapt_cli": {
        "config": "cfg/adapt_cityscapes_semkittidvps.yaml",
        "stream": {k: cli_stream[k] for k in keep},
        "target_val": val_numbers["target_val"],
        "source_val": val_numbers["source_val"],
        "peak_mib": cli_peak / 2**20, "launches": cli_launches,
        "copies": cli_copies, "validation_parts_ms": breakdown,
        "p_pq": cli_values["p_pq"],
        "sem_miou": cli_values["sem_miou"],
        "d_abs_rel": cli_values["d_abs_rel"],
        "small_card_vs_cpu_agree": agree}}))
    print(json.dumps({"train": {**train_numbers, "launches": train_launches,
                                "copies": train_copies,
                                "depth_only": depth_numbers}}))
    print(json.dumps({"host_mixup_stream": host_mixup}))
    print(json.dumps({"step_graph": {"counts": graph_counts,
                                     "published_parity": graph_parity}}))
    print(json.dumps({"flow": flow_numbers}))
    print(json.dumps({"ddp": ddp_numbers}))
    print(json.dumps({"spatial": spatial_numbers}))
    phase(None)
    print(f"chip_smoke: total wall {time.perf_counter() - script_start:.3f} "
          f"s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
