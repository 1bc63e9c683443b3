#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA device and prints its name and power limit.
2. Builds the CUDA kernels from ``understanding_flow_robustness_tpu_torch/
   csrc/`` (into ``build/torch_kernels/``, one nvcc per source, all at
   once) and prints the build times and the ptxas reports.
3. Holds the lookup kernel ``alt_corr_fwd`` against its plain PyTorch
   version on the card, at the serving path's shape and at a ragged shape,
   in f32 and bf16, for calibrated, wild, out-of-volume and smooth centres;
   prints for each case the share of (8x8 query tile, level) pairs that
   took the kernel's tensor-core tile path and checks that both paths ran;
   times the kernel (calibrated, wild and smooth) and the plain version at
   the serving shape.
4. Holds the backward kernel ``alt_corr_bwd`` against the plain backward
   the same way, at the train path's shape, the attack path's and the
   ragged one, adding a smooth field of centres; prints for each case the
   share of (8x8 query tile, level) pairs that took the kernel's tile path
   and checks that both paths ran; times the kernel (calibrated and
   smooth) at the train and attack shapes with the bound of each, and the
   plain backward at the train shape.
4b. Drives the lookup's coordinate gradient (coords that require grad)
   through ``alt_corr_features`` at the serving shape, which launches the
   coordinate-gradient kernel ``alt_corr_dcoords`` (no model path does);
   holds the kernel against its plain version in f32 and bf16 for
   calibrated, wild, far-out (+-1e30) and exactly integer centres, two
   launches bit-equal, and its (tile, level) path counts equal to
   ``alt_corr_fwd``'s on the same inputs (the tile stage they share);
   prints its tile-path share; times both.
5. Holds the warp kernel ``warp_fwd`` against its plain version in its
   three modes, f32 and bf16, at SPyNet's and PWC-Net's largest warp
   shapes and a ragged one, for smooth, wild and +-1e30 flows; times it,
   the plain version and ``F.grid_sample`` at the two main shapes and
   prints the kernel's share of its bound.
5b. Holds the volume lookup kernel ``corr_lookup_fwd`` against its plain
   version on RAFT's pyramid (f32 and bf16) at the serving shape and a
   ragged one, for calibrated, wild and hand-placed edge centres; times it,
   the plain version and the reference CorrBlock's four ``F.grid_sample``
   calls at the serving shape.
6. Serving path: RAFT-12 (seeded random weights) serving 3 requests of 8
   frame pairs at 384x1280 through ``predict_flow``, at the calibrated
   (``scale_flow_head(0.05)``) and the wild (raw init) operating point;
   checks shapes, finiteness and that every forward launched the lookup
   kernel 12 times; prints the tile-path share of ``alt_corr_fwd`` for the
   coords of a request's 12 iterations at each point; compares the flow
   with the plain lookup; times pairs/s.
6b. Serving path: RAFT-12 on its volume path (``corr_impl="volume"``),
   the same 3 requests at both operating points; checks 12 launches of
   ``corr_lookup_fwd`` and none of ``alt_corr_fwd`` per request, the flow
   against the alt path on the same weights (also in f32) and against the
   plain lookup; times pairs/s and reads the peak memory.
6c. Feature taps: RAFT-12 with ``return_features=True`` serving one
   request; checks the keys against ``get_feature_map_keys("RAFT")``, every
   shape, finiteness, and that each ``idx_corr_vol_{i}`` is the kernel's
   lookup output; times the request and reads the peak memory.
6d. Serving path: ``RAFT_FlowNetCEncoder_WoContext`` (calibrated) serving 3
   requests; checks 12 ``alt_corr_fwd`` launches per request and the flow
   against the plain lookup; times pairs/s.
7. Serving path: SPyNet (f32) and PWC-Net (mixed precision) serving 3
   requests of 8 pairs at 384x1280 each; checks 6 and 4 warp launches per
   request, the flow against the model with the plain warp (and PWC-Net in
   f32 too); times pairs/s.
8. Train path: RAFT-12 in mixed precision taking 2 + 5 AdamW/OneCycle
   steps at batch 4, 288x960 through ``make_train_step``; checks finite
   losses, moved parameters and 12 launches of each kernel per step; times
   frames/s and reads the peak memory; one more step prints the tile-path
   share of ``alt_corr_bwd`` for the coords of its 12 iterations.
9. The parameter gradients of one train-mode backward with the kernels
   against those with the plain lookup, in f32 and in bf16.
10. Attack path: I-FGSM with the attack CLI's defaults (40 steps, eps
   0.02, l2 loss) on ``fetch_model("RAFT")``, batch 1 at 256x640, against
   a target offset from the clean flow (the warm-up prints the tile-path
   share of ``alt_corr_bwd`` for the attack's coords); checks 12 launches
   of each lookup kernel per step and none of the coordinate-gradient
   kernel, the eps-ball, the image range and that the loss grew; times ms
   per step and reads the peak memory.  Then one image gradient with the
   kernels against one with the plain lookup (f32 and bf16), and one FGSM
   on PWC-Net through the warp kernel.
11. The attack CLI on RAFT with ``--perturb_method ifgsm --synthetic 2
   --n_step 3``.
12. The train CLI with ``--synthetic 3``, then its resume.

The FlowNet slice adds, after the RAFT grad phase (so that the earlier
phases' random inputs stay as they were):
13. The spatial correlation's kernels ``spatial_corr_fwd`` and
   ``spatial_corr_bwd`` against the plain version and its autograd at
   FlowNetC's serving, attack and patch shapes and the patch CLI's 256 px
   crop (f32, patch 21, dilation 2), PWC-Net's five bf16 levels (patch 9), three ragged shapes (C = 3,
   33, 196) and the generic kernel's patches 1 and 3 (C = 40, 35); times
   of kernel, plain version and bound at FlowNetC's serving and patch
   shapes and PWC-Net's level 2 (forward) and at FlowNetC's attack and
   patch shapes and PWC-Net's level 2 (backward).
14. FlowNetC, FlowNetCFlexLarger_k3_reps3 and FlowNetS (f32) serving 3
   requests of 8 pairs at 384x1280 through ``predict_flow``: one
   ``spatial_corr_fwd`` launch per FlowNetC-family request and none for
   FlowNetS, the flow against the model with the plain correlation,
   pairs/s; then one taps request on FlowNetC (keys, shapes, the corr tap
   against the plain correlation).
15. I-FGSM with the attack CLI's defaults on FlowNetC (one launch of each
   correlation kernel per step, the eps-ball, the image range, the loss
   growing, ms per step, peak memory; the image gradient against the
   plain correlation's, with the leaky-ReLU inputs whose sign differs
   between the two forwards and both gradients' distance to an f64 one),
   and the attack CLI with its default ``--flownet``.
The patch slice adds, after the train CLI:
16. The patch attack's inner loop on FlowNetC (f32) at the JAX bench's
   geometry (batch 1 at 384x1280, a 100x100 mask at rows and columns
   100:200, target = -clean flow, 8 iterations pinned by
   ``loss_threshold=0``): one launch of each correlation kernel per
   iteration plus the clean flow's forward, the images bit-equal to the
   clean ones outside the mask and inside [0, 1], the loss falling; ms per
   inner iteration, iterations/s, peak memory; then one iteration's update
   against the plain correlation's, with phase 15's witnesses.
17. The patch CLI on FlowNetC (a 153-pixel circle, 2 epochs of 3
   synthetic 384x1280 batches, 2 inner iterations): launches, the patches'
   shape, the validation metrics; then ``test_patch`` on its patch in the
   default, ``--true_motion`` (``patch3d``) and ``--different_pos`` modes.
18. The patch CLI on RAFT (mixed precision): 12 launches of each lookup
   kernel per inner iteration, none of ``alt_corr_dcoords``; then one
   inner iteration's update with the kernels against the plain lookup's,
   bf16 and f32, and both f32 updates' distance to the update in f64 with
   the plain lookup.
19. The universal-perturbation CLI on FlowNetC (256x640, 2 batches of 3
   steps): one ``spatial_corr_bwd`` per step, the eps-ball, the snapshot;
   then ``run_perturb_model --universal_evaluation`` on that snapshot.
The FlowNet2, corruption and adversarial-training slice adds, after the
universal perturbation:
20. FlowNet2 (f32, seeded weights) serving 3 requests of 8 pairs at
   384x1280 through ``predict_flow``: 4 border-mode ``warp_fwd`` and 1
   ``spatial_corr_fwd`` launches per request, the flow against the same
   model with the plain warp and the plain correlation, pairs/s over
   requests 2-3, peak memory; ``warp_fwd`` in border mode at FlowNet2's
   (8, 3, 384, 1280) f32 against its plain version, timed beside the
   plain version, ``F.grid_sample`` and its bound.
21. I-FGSM with the attack CLI's defaults on that FlowNet2 at 256x640:
   per step 4 ``warp_fwd``, 1 ``spatial_corr_fwd`` and 1
   ``spatial_corr_bwd`` (the warps' gradient is the plain sampler's
   autograd), the eps-ball, the image range, the loss growing, ms per
   step, peak memory; one image gradient against the plain versions';
   then ``run_perturb_model --flownet FlowNet2 --synthetic 2 --n_step 3``.
22. ``run_perturb_model --perturb_method gaussian_noise --synthetic 2``
   on the default FlowNetC: the severity sweep 1-5 (a numpy corruption,
   which needs no cv2), one ``spatial_corr_fwd`` per forward, the
   five results folders, the noise growing with the severity.
23. The train CLI with ``--model RAFT --adversarial --synthetic 2
   --batch_size 1`` at 256x640 with 3 attack steps: (3 + 3) x 12 launches
   of ``alt_corr_fwd`` and ``alt_corr_bwd`` per batch and none of
   ``alt_corr_dcoords``, finite losses, moved parameters, the train step
   on the doubled batch, ms per batch.
The evaluation and file-serving slice adds, after adversarial training
(the phases write their frames and GT under the ignored build/ with the
port's writers and the phase's own PNG encoder, which cycles every row
through filter types 0-4, as a file from an encoder that picks a filter
per row has them):
24. The PNG codec on the host at 375x1242: a u8 RGB frame and a 16-bit
   flow PNG with a sparse valid mask round-trip bit for bit; a frame with
   filter types 0-4 decodes to its samples; decode and encode ms.
25. ``cli.infer`` serving 8 pairs at 375x1242 through RAFT-12 at batch 8
   (--save flo,png,viz): 12 ``alt_corr_fwd`` launches, every .flo
   bit-equal to ``predict_flow`` on the decoded, padded frames and the
   flows within BF16_REL_EPE_TOL of the plain lookup's, every flow PNG
   within 1/64 of round(64 flow) / 64; pairs/s with decode and writing,
   and the model's share of the wall time.
26. ``cli.evaluate --dataset kitti`` (RAFT f32, 24 iterations, batch 1) on
   a KITTI 2015 training layout of 8 scenes at the four KITTI sizes, with
   a seeded, calibrated ``.pth``: 24 ``alt_corr_fwd`` launches a scene,
   EPE and F1 equal to the phase's own from ``predict_flow``, every
   scene's flow within F32_FLOW_TOL_PX (max abs) of the plain lookup's;
   seconds per scene.
27. The dataset branches on that layout: ``run_perturb_model`` on a
   2-pair ``kitti_scene_flow_train_*.txt`` list (FlowNetC I-FGSM, 3
   steps) and ``test_patch --valset kitti2015`` on 2 scenes; both
   correlation kernels' launches.
The training-data slice adds, after the dataset branches (its trees
under the ignored build/, JPEG frames from the fixtures committed in the
port's package):
28. The JPEG decoder on the four 375x1242 fixture frames: each equal to
   the sha256 of PIL's decode recorded beside them; host ms per frame.
29. A FlyingChairs tree (16 pairs of 384x512 .ppm + .flo and
   ``datasets/chairs_split.txt``) and a KITTI 2015 tree (8 scenes at the
   KITTI sizes): per sample on one thread the ms of decode, colour
   jitter, spatial transform and collate; the ``DataLoader`` at 4 threads
   in samples/s, against phase 8's synthetic train step.
30. The train CLI from those files, run from their parent directory:
   ``--stage kitti`` at the bench's geometry (batch 4, 288x960, mixed
   precision) for 6 batches with ``--validation kitti`` every 3,
   ``--stage chairs`` at the CLI's defaults for 2 batches, and
   ``--stage kitti2015 --adversarial`` on 2 KITTI pairs (batch 1,
   256x640, 3 attack steps), then ``--stage kitti`` for 20 batches of
   one epoch without validation: 12 launches of ``alt_corr_fwd`` and
   ``alt_corr_bwd`` per forward and backward, finite losses; the last
   run's frames/s with the loader over its wall time.
31. ``alt_corr_fwd`` and ``alt_corr_bwd`` against their plain versions at
   the feature shape of ``--stage chairs`` (6, 32, 80, 256), f32 and bf16.
32. The patch CLI (FlowNetC) for one epoch of SequenceFolder training on
   the JPEG fixtures with the KITTI valset at 384x1280, then from a
   patch and a mask in PNG files; the universal CLI for one epoch from
   the same fixtures with its valset sweep: both correlation kernels'
   launches, the files and metrics the CLIs write.
33. RAFT (f32) at 56x88, whose fourth pyramid level is empty: the alt and
   volume paths' kernels against the plain lookup within
   F32_FLOW_TOL_PX, then the lookups (``alt_corr_fwd``, its backward
   ``alt_corr_bwd``, ``corr_lookup_fwd``) on levels that include the
   empty one against their plain versions, and the kernels' wrappers
   refusing the empty level.
The patch-analysis and family-training slice adds, after phase 33 (its
files under the ignored build/):
34. ``test_moving_patch`` on RAFT (mixed precision, calibrated through a
   seeded ``.pth``) over a 384x1280 pair: the bench's 100 px patch swept
   with stride 100, 36 locations, 12 ``alt_corr_fwd`` launches a forward;
   seconds per location, the device's idle share over the sweep
   (``torch.profiler``); every location's adversarial flow and EPE
   against the same sweep with the plain lookup; the CSVs and heat maps.
35. ``test_replace_features`` on FlowNetC (f32) over 2 pairs with ``-fk
   corr conv_redir conv3_1 --all_key_subsets``: 56 ``spatial_corr_fwd``
   launches, ``key_sets.json`` and ``results.csv``; injecting a pair's own
   captured maps gives back its flow bit for bit.
36. ``test_patch_embeddings`` on FlowNetC (f32) and PWC-Net (mixed; its
   taps launch 5 ``spatial_corr_fwd`` and 4 ``warp_fwd`` a forward) over
   8 pairs: the MMD per key, the t-SNE points.
37. ``spatial_corr_fwd`` / ``spatial_corr_bwd`` and ``warp_fwd`` at the
   train steps' shapes (FlowNetC's and PWC-Net's level-2 correlation,
   SPyNet's and PWC-Net's warps at batch 6, 256x640) against their plain
   versions, with times of kernel, plain version and bound, and the time
   of the warp's gradient (the plain sampler's autograd).
38. The train CLI with ``--synthetic`` on FlowNetS, FlowNetC,
   FlowNetCFlexLarger_k3_reps3, PWC-Net, SpyNet (batch 6) and FlowNet2
   (batch 2) at 256x640: the kernels' launches per step, finite losses,
   ms per step, frames/s, peak memory; each family's first step with the
   kernels against the plain versions (loss, gradient norm).
39. ``cli.train --adversarial`` on FlowNetCFlexLarger_k3_reps3 and PWC-Net,
   2 batches of batch 1 at 256x640 with 3 attack steps: the launches of
   every attack step and update.
The remaining-configurations slice adds, after phase 39 (its files under
the ignored build/):
40. B1, B2, B3 and B5 at every radius 1..7 against their plain versions
   (small RAFT's serving shape (8, 48, 160, 128) for B1, B3, B5, its train
   shape (4, 36, 120, 128) for B2, and a ragged one for all four; f32 and
   bf16; calibrated, wild, far (+-1e30) and integer centres) under the r =
   4 phases' bounds; B3 bit-equal over two launches and on B1's (tile,
   level) paths; at small RAFT's r = 3 the tile-path shares of B1, B2 and
   B3 (both paths must run), each kernel's time, its plain version's and
   its bound; B3 driven at r = 3 through ``alt_corr_features``' coordinate
   gradient; r = 0 and 8 refused by the wrappers and, with their check
   widened, by the kernels' entry points.
41. Small RAFT (``fetch_model("RAFT", small=True)``, bf16, calibrated)
   serving 3 requests of 8 pairs at 384x1280 on the alt path (12
   ``alt_corr_fwd`` at r = 3 a request) and the volume path (12
   ``corr_lookup_fwd``), and the spatial-correlation RAFT
   (``compute_spatial=True``: one ``spatial_corr_fwd`` and no window
   lookup a request): the flow against the plain lookup (the plain
   correlation) within the 1 % bar, pairs/s, peak memory.
42. Small RAFT, the spatial-correlation RAFT and
   RAFT_FlowNetCEncoder_WoContext training, 2 + 3 steps at batch 4,
   288x960 (the spatial mode at 320x960: its lookup needs H and W
   multiples of 64): each step's launches (12 ``alt_corr_fwd`` and 12
   ``alt_corr_bwd``, or one of each spatial kernel), the first step of the
   f32 model with the kernels against the plain lookup (loss, parameter
   gradients),
   frames/s, peak memory.
43. The CLIs: ``cli.train --synthetic 3`` with ``--small``,
   ``--compute_spatial`` and ``--model RAFT_FlowNetCEncoder_WoContext``;
   ``cli.evaluate --small`` on a written KITTI layout; ``cli.parity
   --synthetic 2`` over a written zoo directory (RAFT and WoContext under
   the JAX registry's file names).
44. ``spatial_corr_fwd`` / ``spatial_corr_bwd`` at the spatial mode's train
   shape (4, 256, 40, 120) f32 against their plain versions, with times of
   kernel, plain version and bound.
The cv2 / PIL host-path slice adds, after phase 44 (its files under the
ignored build/):
45. The host library's OpenCV and Pillow operations (JPEG encoding at six
   qualities and odd sizes, RGB<->HSV, BOX / NEAREST, the circle rings at
   n = 40, 96, 153 and 400, the disk kernels, warpAffine, INTER_CUBIC of
   float64 and uint8, the spatter chain) on seeded inputs: each output's
   SHA-256 against ``data/fixtures/cv_digests.json``, which cv2 and PIL
   wrote; a mismatch fails.
46. The attack CLI's corruption sweep on FlowNetC for the 8 corruptions
   the JAX copy takes from cv2 or PIL, severities 1-5 on 2 synthetic
   pairs at 384x1280 (30 ``spatial_corr_fwd`` launches each, results0.txt
   in every folder), then one I-FGSM run with ``--write_out
   --show_evolve``, whose PNGs and GIFs the port's readers read back.
47. ``test_patch --self_correlated_patch circle --patch_size 153`` on
   RAFT-12 over 2 synthetic scenes at 384x1280 with the viz panels on:
   ``alt_corr_fwd`` launches, the CSVs, the ``viz###.jpg`` panels decoded
   by ``native.decode_jpeg``.
48. The host seconds per severity of each of the 19 corruptions on one
   384x1280 frame.
The checkpoint, analysis-helper and KITTI-raw slice adds, after phase 48
(its files under the ignored build/):
49. Seeded RAFT-12 (calibrated), PWC-Net and FlowNet2 saved as ``.pth``,
   converted to the JAX package's flax ``.msgpack`` by ``cli.convert``,
   loaded by ``fetch_model(pretrained_path=x.msgpack)`` and by the
   ``.pth`` on the card: the same weights, one request of 8 pairs at
   384x1280 each with the flows bit-equal (cuDNN deterministic) and the
   kernels' launches of a request (12 ``alt_corr_fwd``; 4 ``warp_fwd`` and
   5 / 1 ``spatial_corr_fwd``); host seconds to read and decode each file
   and of each ``fetch_model``.
50. ``cli.infer --pretrained x.msgpack`` (8 pairs at 375x1242, every .flo
   the .pth run's bytes), ``cli.evaluate --model x.msgpack`` on a written
   KITTI layout (EPE and F1 the .pth run's) and ``cli.train
   --restore_ckpt`` from a params-only ``.msgpack`` (2 RAFT steps, 12
   ``alt_corr_bwd`` launches each, the restored weights the file's).
51. ``cli.prepare_train_data`` on a written KITTI raw tree (2 drives of 8
   frames at 375x1242 with static frames): scenes, kept frames,
   ``cam.txt``, split; host ms per frame of reading, resizing and
   encoding; then the patch CLI (FlowNetC) for 2 batches on a 384x1280
   dump of the tree through ``SequenceFolder``: both correlation kernels'
   launches.
52. One RAFT-12 request inside ``utils.profile_trace``: the Chrome trace
   names ``alt_corr_fwd``; the device's idle share.
The data-parallel slice adds, last (``parallel.launch``: one process a
rank, each building nothing, loading the kernels built above):
53. (a) RAFT-12's train step (batch 4 at 288x960, mixed precision, B1 and
   B2) at world 1 over NCCL against the plain step on the same batch, and
   both timed in turns; (b) the step at world 2 over gloo with both ranks
   on cuda:0 against the plain step on the full batch (gradients before
   the optimizer, loss, batch-norm running statistics); (c) the explicit
   step with bf16 gradient transport against the explicit f32 one; (d)
   sharded KITTI validation at world 2 against one rank's; (e)
   ``make_sharded_attack`` (I-FGSM, one step with cuDNN and three without
   it, gaussian) at world 2 against the unsharded attack; with two cards, (b) over NCCL across them.  Its B1 and
   B2 launches join the totals; its last line gives the world-1 step's ms
   against the plain step's, the bytes all-reduced a step in f32 and bf16,
   and the world-2 one-card ms (not a scaling number).
PWC-Net's serving phase (7) also counts its 5 ``spatial_corr_fwd``
launches per request, holds the flow against the plain warp and the plain
correlation together, and times pairs/s with the plain correlation too, in
turns with the kernel; its FGSM (10) counts 5 launches of each correlation
kernel.

Any failed check raises, so the script exits non-zero and prints no result.
Before them, one line gives the patch step's ms per inner iteration and
iterations/s with the card, and one FlowNet2's pairs/s, its I-FGSM ms per
step and the adversarial train batch's ms, and one the infer CLI's pairs/s,
the PNG decode ms and the evaluate CLI's seconds per scene, and one the
JPEG decode ms, the loader's samples/s and the train CLI's frames/s from
files, and one the moving patch's seconds per location and idle share and
the families' ms per train step, and one the r = 4 and r = 3 kernel times
and the new configurations' pairs/s and ms per train step, and one the
host-op digests and the corruptions' seconds, and one the ``.msgpack`` and
``.pth`` load seconds and the preparation's ms per frame.  The last
three
lines are the card's name and
power limit, a JSON object per
kernel (its launches on the main paths, its error against its plain
version, its time, the plain version's, the least time the card could take
and what bounds it, and the time of a PyTorch call that computes the same
function where there is one) and the result object.  TF32 is off
throughout, so f32 convolutions run in full f32.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import math
import re
import shutil
import struct
import subprocess
import time
import zlib
from pathlib import Path

import numpy as np
import torch

B, H, W = 8, 384, 1280
REQUESTS = 3
ITERS = 12
RADIUS, LEVELS = 4, 4
TB, TH, TW = 4, 288, 960  # the train step's geometry (bench.py:281-321)
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
TRAIN_KERNELS = ("alt_corr_fwd", "alt_corr_bwd")  # RAFT's train step
F32_TOL = 1e-4           # abs, the JAX package's bar (test_ops_correlation.py:327)
# corr_lookup_fwd vs its plain version, abs, f32 and bf16 pyramids alike:
# both widen the same taps to f32 and blend them in the same order, one
# rounding per product and sum, so they should agree bit for bit; the bar
# is the JAX package's (test_ops_correlation.py:267-268)
VOL_TOL = 1e-4
BF16_REL_TOL = 1e-5      # x max|corr|: same bf16 inputs, both accumulate in f32
# x max|grad|, f32 and bf16 alike: both sides sum the same products of the
# same inputs in f32, in other orders (the kernel's df2 atomics land in an
# order that changes from run to run)
BWD_REL_TOL = 1e-5
# alt_corr_dcoords vs its plain version, x max|dcoords|, f32 and bf16
# alike: both form the same dots of the same inputs in f32 (the kernel by
# lane FMAs and shuffles, the plain version by cuBLAS with TF32 off) and
# contract them with g in other orders
DCOORDS_REL_TOL = 1e-5
AB, AH, AW = 1, 256, 640  # the attack geometry (cli/run_perturb_model.py:44-45)
ATTACK_STEPS, ATTACK_EPS = 40, 0.02  # the attack CLI's defaults
ATTACK_SEED = 100  # the attack phase's images (torch_kernel_ab.py's first)
# relative L2 of the parameter gradients, kernels vs plain lookup, one
# train-mode backward: (worst tensor, all parameters together).  Both paths
# read the same values and keep the lookup's gradient f32, but they sum in
# other orders, so their forward trajectories part a little over the 12
# iterations (the serving phase's flows: ~1e-4 px in f32, 0.2 % of the
# flow in bf16, where the autocast convolutions round each difference),
# and the gradients of the early encoder layers grow that most.  Measured
# on an H100: f32 5.3e-4 worst, 4.1e-6 together; bf16 5.0e-2 worst, 3.2e-2
# median, 6.3e-4 together.  A wrong or missing gradient is off by O(1).
# The biases of the encoders' convolutions that feed a norm are left out:
# the norm removes a bias, so their gradient is zero and what they get is
# rounding noise
GRAD_F32_REL_L2 = (2e-3, 5e-5)
GRAD_BF16_REL_L2 = (0.15, 5e-3)
NORMED_BIAS = re.compile(r"net\.(conv1|layer\d\.\d\.(conv\d|downsample\.0))"
                         r"\.bias$")
F32_FLOW_TOL_PX = 1e-2   # max abs flow difference, kernel vs plain lookup, f32
BF16_REL_EPE_TOL = 0.01  # mean EPE / mean |flow|, the 1% bar (BASELINE.md)
CAL_BAND = (5.0, 40.0)   # trained-checkpoint mean |flow| band (bench.py:115)
# sanity bounds of the calibrated magnitude (tests/test_bf16_drift.py:120):
# the random draw decides where in or near CAL_BAND it lands
CAL_SANITY = (1.0, 60.0)
WARP_F32_REL_TOL = 1e-5  # x max|img|: the same coordinates, f32 weights
# the warp shapes of the serving paths (B, C, H, W): SPyNet's finest level
# (f32, mode "spynet") and PWC-Net's level 2 (bf16, mode "zeros_mask")
WARP_MAIN = {"spynet": ((B, 3, H, W), torch.float32),
             "zeros_mask": ((B, 32, H // 4, W // 4), torch.bfloat16)}
FLOW_F32_TOL_PX = 1e-3   # max |dflow|, warp kernel vs plain warp, f32 models
# spatial correlation kernels vs their plain versions, f32, x max|plain|:
# the same products of the same inputs summed in f32 in other orders.
# bf16: one bf16 ulp of the plain value (both round one f32 sum), or this
# f32 bar where a sum cancels below it
CORR_REL_TOL = 1e-5
# the correlation shapes of the main paths, (B, C, H, W), patch, dilation,
# dtype: FlowNetC serving, attacked and patch-attacked (f32; the patch
# CLI from files trains on 256x256 crops), PWC-Net mixed levels 6..2
CORR_MAIN = {"flownetc": ((B, 256, H // 8, W // 8), 21, 2, torch.float32),
             "attack": ((1, 256, 256 // 8, 640 // 8), 21, 2, torch.float32),
             "patch": ((1, 256, 384 // 8, 1280 // 8), 21, 2, torch.float32),
             "patch_256": ((1, 256, 256 // 8, 256 // 8), 21, 2,
                           torch.float32)}
CORR_PWC = {f"pwc_l{lvl}": ((B, c, H >> lvl, W >> lvl), 9, 1, torch.bfloat16)
            for lvl, c in ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))}
CORR_RAGGED = {"ragged_c3": ((2, 3, 13, 21), 21, 2, torch.float32),
               "ragged_c33": ((2, 33, 37, 45), 9, 1, torch.bfloat16),
               "ragged_c196": ((1, 196, 7, 9), 21, 2, torch.bfloat16),
               # the generic kernel: P = 1 (the op's default) and 3, C > 16
               "p1_c40": ((2, 40, 13, 37), 1, 1, torch.float32),
               "p3_c35": ((2, 35, 19, 45), 3, 1, torch.bfloat16)}
# models with the correlation kernel vs the same with its plain version,
# f32 with TF32 off, relative L2 of the flows: summation order only
FLOW_F32_REL_L2 = 1e-5
# FlowNet-family serving: (ID, spatial_corr_fwd launches per request)
FLOWNETS = (("FlowNetC", 1), ("FlowNetCFlexLarger_k3_reps3", 1),
            ("FlowNetS", 0))
# the patch step: the JAX bench's geometry (bench.py:200-230): batch 1 at
# 384x1280, a 100x100 mask at rows and columns 100:200, 8 inner iterations
# pinned by loss_threshold=0; its images from a generator of its own
PB, PH, PW = 1, 384, 1280
PATCH_ITERS = 8
PATCH_SEED = 200
# the patch and universal CLIs' outputs, under the ignored build/
PATCH_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_patch"
# FlowNet2 (f32, TF32 off) with the warp and correlation kernels against
# the same with their plain versions, relative L2 of the flows: the
# correlation's sums in another order, carried through the cascade's four
# warps (the CPU parity with the JAX package: 1.2e-5 at 64x128,
# tests/test_torch_flownet2.py)
FLOWNET2_REL_L2 = 1e-4
# FlowNet2's image gradient with the kernels against the plain versions',
# relative L2: four chained warps make it jump where a sample coordinate
# crosses an integer; on the CPU a 1e-6 relative change of the input moves
# it by 2.3 % (tests/test_torch_flownet2.py)
FLOWNET2_GRAD_REL_L2 = 5e-2
# warp_fwd in border mode at FlowNet2's warp shape (B, C, H, W) f32
WARP_FLOWNET2 = (B, 3, H, W)
# the adversarial train CLI's batches: batch 1 at the attack geometry,
# 3 I-FGSM steps, 2 batches of INNER updates
ADV_TRAIN_STEPS, ADV_TRAIN_BATCHES, ADV_INNER = 3, 2, 3
# the evaluation and file-serving slice: KITTI 2015's four frame sizes
# (375x1242 its own resolution), 8 scenes; frames and GT are written under
# the ignored build/ by the phases themselves
KITTI_SIZES = ((375, 1242), (370, 1224), (374, 1238), (376, 1241))
KITTI_SCENES = 8
DATA_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_data"
EVAL_ITERS = 24  # cli.evaluate's RAFT iterations on KITTI (evaluate.py:349)
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s of HBM3 and
# FLOP/s by input type (bf16 on the tensor cores, f32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn()``: ``reps`` calls captured in one CUDA graph
    and replayed between CUDA events, so that the host's cost of each call
    (a Python wrapper's checks, the ctypes call: tens of us, as long as a
    small warp) stays out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, reps=1, warmup=0) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes that
    must move (each input read once, each output written once) over the
    HBM rate and the operations over the peak rate of the inputs' type."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lookup_cases(gen, main_shape, more_shapes=(), smooth=False,
                 main="main", ragged=True):
    """(name, b, h, w, c, coords) for the kernel-vs-plain phases: the main
    path's feature shape (named ``main``), ``more_shapes`` ((name, (b, h,
    w, c)), ...) and with ``ragged`` a ragged one whose pooled levels drop
    rows and columns, each with calibrated (2 px of noise on every
    centre), wild and hand-placed edge centres, and with ``smooth`` a
    smooth field (``warp_flow``'s)."""
    from understanding_flow_robustness_tpu_torch.ops import coords_grid

    shapes = ((main, main_shape), *more_shapes)
    if ragged:
        shapes += (("ragged", (2, 13, 21, 64)),)
    for shape_name, (b, h, w, c) in shapes:
        grid = coords_grid(h, w, device="cuda")[None].expand(b, h, w, 2)
        noise = torch.randn((b, h, w, 2), generator=gen, device="cuda")
        edge = grid + noise
        edge[0, 0, :4] = torch.tensor(
            [[-50.0, -50.0], [500.0, 500.0], [-3.5, -3.5],
             [w - 0.25, h - 0.25]], device="cuda")
        edge[0, 1, :3] = torch.tensor(
            [[-1e30, 3.0], [3.0, 1e30], [w - 1.0, h - 1.0]], device="cuda")
        cases = [("calibrated", grid + 2.0 * noise),
                 ("wild", grid + 150.0 * noise), ("edge", edge)]
        if smooth:
            field = warp_flow(gen, b, h, w, "smooth").permute(0, 2, 3, 1)
            cases.append(("smooth", grid + field))
        for coords_name, coords in cases:
            yield f"{shape_name}/{coords_name}", b, h, w, c, coords


@contextlib.contextmanager
def path_counts(wrapper: str):
    """Every launch of ``correlation.<wrapper>`` inside (``_alt_corr_bwd_cuda``
    or ``_alt_corr_lookup_cuda``) adds its (8x8 query tile, level) path
    counter into the yielded int32 tensor: [l] the tile path, [LEVELS + l]
    the per-query path."""
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    counts = torch.zeros(2 * LEVELS, dtype=torch.int32, device="cuda")
    launch = getattr(corr, wrapper)
    setattr(corr, wrapper, lambda *a: launch(*a, path_counts=counts))
    try:
        yield counts
    finally:
        setattr(corr, wrapper, launch)


def path_share(counts: torch.Tensor) -> tuple:
    """(share of the (tile, level) pairs with a live window that took the
    tile path, a per-level summary)."""
    tile, per_query = counts[:LEVELS].tolist(), counts[LEVELS:].tolist()
    share = sum(tile) / max(1, sum(tile) + sum(per_query))
    return share, " ".join(f"L{lvl}:{t}/{t + p}" for lvl, (t, p) in
                           enumerate(zip(tile, per_query)))


def kernel_phase(gen, shape=(B, H // 8, W // 8, 256), main="main",
                 ragged=True) -> dict:
    """B1 against its plain version at ``shape`` (named ``main``, timed)
    and, with ``ragged``, at a ragged shape."""
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print(f"== alt_corr_fwd vs plain (TF32 off), {main} shape {shape} ==",
          flush=True)
    res = {}
    for name, b, h, w, c, coords in lookup_cases(
            gen, shape, smooth=True, main=main, ragged=ragged):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        cflat = coords.reshape(b, h * w, 2).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            with path_counts("_alt_corr_lookup_cuda") as counts:
                got = corr.alt_corr_lookup(f1, levels, cflat, RADIUS)
            ref = corr.alt_corr_lookup_reference(f1, levels, cflat, RADIUS)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = F32_TOL if dtype == torch.float32 else BF16_REL_TOL * scale
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            share, per_level = path_share(counts)
            print(f"{tag:32s} max_abs_err={err:.3e} tol={tol:.3e} "
                  f"max|corr|={scale:.3f}; tile path {100 * share:.1f}% "
                  f"({per_level})", flush=True)
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"{tag}: kernel output malformed")
            check(err <= tol, f"{tag}: kernel disagrees with plain version")
            res[tag] = err
            res[f"{tag}/tile_share"] = share
            res.setdefault("paths", counts.new_zeros(2 * LEVELS))
            res["paths"] += counts
            if name.split("/")[0] == main and not name.endswith("/edge"):
                k_ms = cuda_ms(lambda: corr.alt_corr_lookup(
                    f1, levels, cflat, RADIUS), reps=20)
                res[f"{tag}/ms"] = k_ms
                if name == f"{main}/calibrated":
                    p_ms = cuda_ms(lambda: corr.alt_corr_lookup_reference(
                        f1, levels, cflat, RADIUS), reps=5, warmup=1)
                    res[f"{tag}/plain_ms"] = p_ms
                    # per query and level: the (2r+2)^2 integer-grid dots
                    # of length C, a multiply-add each
                    flops = 2 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                    res[f"{tag}/bound"] = bound(
                        nbytes(f1, *levels, cflat, got), flops, dtype)
                    m = res[f"{tag}/bound"]
                    print(f"{tag:32s} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                          f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}; "
                          f"the kernel at {100 * m['bound_ms'] / k_ms:.1f}% of "
                          "it) per lookup (4 levels)", flush=True)
                else:
                    print(f"{tag:32s} kernel {k_ms:.3f} ms per lookup",
                          flush=True)
            del got, ref
    paths = res["paths"]
    check(paths[:LEVELS].sum().item() > 0 and paths[LEVELS:].sum().item() > 0,
          f"alt_corr_fwd: the cases did not take both paths ({paths.tolist()})")
    return res


def backward_phase(gen, shape=(TB, TH // 8, TW // 8, 256),
                   more=(("attack", (AB, AH // 8, AW // 8, 256)),),
                   main="main", ragged=True) -> dict:
    """B2 against its plain backward at ``shape`` (named ``main``), the
    ``more`` shapes and, with ``ragged``, a ragged one; the calibrated and
    smooth bf16 cases timed, the plain backward at ``shape``'s."""
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print(f"== alt_corr_bwd vs plain backward (TF32 off), {main} shape "
          f"{shape} ==", flush=True)
    res = {}
    n2 = (2 * RADIUS + 1) ** 2
    for name, b, h, w, c, coords in lookup_cases(
            gen, shape, more, smooth=True, main=main, ragged=ragged):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        cflat = coords.reshape(b, h * w, 2).contiguous()
        g = torch.randn((b, h * w, LEVELS * n2), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
            with path_counts("_alt_corr_bwd_cuda") as counts:
                got = corr._alt_corr_bwd_cuda(f1, levels, cflat, g, RADIUS)
            ref = corr.alt_corr_lookup_backward_reference(f1, levels, cflat, g,
                                                          RADIUS)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            worst = 0.0
            for part, k, r in [("df1", got[0], ref[0])] + [
                    (f"dlevels[{lvl}]", k, r)
                    for lvl, (k, r) in enumerate(zip(got[1], ref[1]))]:
                check(k.shape == r.shape and k.dtype == torch.float32
                      and bool(torch.isfinite(k).all()),
                      f"{tag} {part}: kernel output malformed")
                err = (k - r).abs().max().item()
                scale = r.abs().max().item()
                tol = BWD_REL_TOL * scale
                print(f"{tag:28s} {part:11s} max_abs_err={err:.3e} "
                      f"tol={tol:.3e} max|grad|={scale:.3f}", flush=True)
                check(err <= tol, f"{tag} {part}: kernel disagrees with the "
                                  "plain backward")
                worst = max(worst, err)
            res[tag] = worst
            share, per_level = path_share(counts)
            res[f"{tag}/tile_share"] = share
            res.setdefault("paths", counts.new_zeros(2 * LEVELS))
            res["paths"] += counts
            print(f"{tag:28s} (tile, level) pairs on the tile path: "
                  f"{100 * share:.1f}% ({per_level})", flush=True)
            if dtype == torch.bfloat16 and not name.startswith("ragged") \
                    and name.split("/")[1] in ("calibrated", "smooth"):
                k_ms = cuda_ms(lambda: corr._alt_corr_bwd_cuda(
                    f1, levels, cflat, g, RADIUS), reps=20)
                res[f"{tag}/ms"] = k_ms
                # per query and level: the (2r+2)^2 grid points' df1 and
                # df2 products of length C, a multiply-add each
                flops = 4 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                res[f"{tag}/bound"] = bound(
                    nbytes(f1, *levels, cflat, g, got[0], *got[1]), flops,
                    dtype)
                line = (f"{tag:28s} kernel {k_ms:.3f} ms, bound "
                        f"{res[f'{tag}/bound']['bound_ms']:.4f} ms "
                        f"({res[f'{tag}/bound']['bound_by']})")
                if tag == f"{main}/calibrated/bfloat16":
                    p_ms = cuda_ms(
                        lambda: corr.alt_corr_lookup_backward_reference(
                            f1, levels, cflat, g, RADIUS), reps=2, warmup=0)
                    res[f"{tag}/plain_ms"] = p_ms
                    line += f", plain {p_ms:.3f} ms"
                print(line + " per backward (4 levels)", flush=True)
            del got, ref
    paths = res["paths"]
    check(paths[:LEVELS].sum().item() > 0 and paths[LEVELS:].sum().item() > 0,
          "alt_corr_bwd: the cases did not take both paths "
          f"({paths.tolist()})")
    return res


def dcoords_phase(gen) -> dict:
    """B3: the lookup's coordinate gradient, driven through the op a user
    calls (``alt_corr_features`` with coords that require grad), then the
    kernel against its plain version on the same inputs."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print("== alt_corr_dcoords (B3) vs plain coordinate gradient (TF32 off) "
          "==", flush=True)
    res = {}
    b, h, w, c = B, H // 8, W // 8, 256
    n2 = (2 * RADIUS + 1) ** 2
    fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    g = torch.randn((b, h * w, LEVELS * n2), generator=gen, device="cuda")
    grid = ops.coords_grid(h, w, device="cuda")[None].expand(b, h, w, 2)
    noise = torch.randn((b, h, w, 2), generator=gen, device="cuda")
    far = grid + 2.0 * noise
    far[0, 0, :6] = torch.tensor(
        [[-1e30, 3.0], [3.0, 1e30], [1e30, -1e30], [-50.0, -50.0],
         [500.0, 500.0], [-3.5, -3.5]], device="cuda")
    cases = {"calibrated": grid + 2.0 * noise, "wild": grid + 150.0 * noise,
             "far": far, "integer": grid.clone()}

    # the op's coordinate-gradient path, the only one that launches B3
    coords = cases["calibrated"].clone().requires_grad_()
    ops.LAUNCH_COUNTS.clear()
    out = ops.alt_corr_features(fm1, fm2, coords, LEVELS, RADIUS,
                                compute_dtype=torch.bfloat16)
    out.backward(g.reshape(out.shape))
    torch.cuda.synchronize()
    n = {k: ops.LAUNCH_COUNTS[k] for k in
         ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords")}
    res["launches"] = n["alt_corr_dcoords"]
    check(n == {"alt_corr_fwd": 1, "alt_corr_bwd": 0, "alt_corr_dcoords": 1},
          f"coordinate gradient of alt_corr_features: launches {n}")
    f1b, lvb = corr.prepare_alt_corr(fm1, fm2, LEVELS, torch.bfloat16)
    ref = corr.alt_corr_coords_grad_reference(
        f1b, lvb, cases["calibrated"].reshape(b, h * w, 2), g, RADIUS)
    err = (coords.grad.reshape(ref.shape) - ref).abs().max().item()
    tol = DCOORDS_REL_TOL * ref.abs().max().item()
    print(f"alt_corr_features(coords.requires_grad) + backward: launches {n} "
          f"(no model path launches B3: RAFT detaches its coords every "
          f"iteration); coords.grad vs plain max_abs_err={err:.3e} "
          f"tol={tol:.3e}", flush=True)
    check(err <= tol, "op's coordinate gradient disagrees with plain version")
    del out, coords, ref

    for dtype in (torch.float32, torch.bfloat16):
        f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
        for name, cc in cases.items():
            cflat = cc.reshape(b, h * w, 2).contiguous()
            counts = torch.zeros(2 * LEVELS, dtype=torch.int32, device="cuda")
            got = corr._alt_corr_dcoords_cuda(f1, levels, cflat, g, RADIUS,
                                              path_counts=counts)
            again = corr._alt_corr_dcoords_cuda(f1, levels, cflat, g, RADIUS)
            ref = corr.alt_corr_coords_grad_reference(f1, levels, cflat, g,
                                                      RADIUS)
            b1 = torch.zeros_like(counts)
            corr._alt_corr_lookup_cuda(f1, levels, cflat, RADIUS,
                                       path_counts=b1)
            torch.cuda.synchronize()
            tag = f"main/{name}/{str(dtype).split('.')[-1]}"
            check(got.shape == ref.shape and got.dtype == torch.float32
                  and bool(torch.isfinite(got).all()),
                  f"{tag}: kernel output malformed")
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            tol = DCOORDS_REL_TOL * scale
            share, per_level = path_share(counts)
            print(f"{tag:32s} max_abs_err={err:.3e} tol={tol:.3e} "
                  f"max|dcoords|={scale:.3f}; tile path {100 * share:.1f}% "
                  f"({per_level}), alt_corr_fwd's "
                  f"{100 * path_share(b1)[0]:.1f}%", flush=True)
            check(err <= tol, f"{tag}: kernel disagrees with plain version")
            check(torch.equal(got, again),
                  f"{tag}: two launches are not bit-equal")
            check(torch.equal(counts, b1),
                  f"{tag}: (tile, level) paths {counts.tolist()}, "
                  f"alt_corr_fwd's {b1.tolist()}")
            res[f"{tag}/tile_share"] = share
            if name == "far":
                check(got[0, :5].abs().max().item() == 0,
                      f"{tag}: windows wholly outside got a gradient")
            res[tag] = err
            if name == "calibrated":
                k_ms = cuda_ms(lambda: corr._alt_corr_dcoords_cuda(
                    f1, levels, cflat, g, RADIUS), reps=20)
                p_ms = cuda_ms(lambda: corr.alt_corr_coords_grad_reference(
                    f1, levels, cflat, g, RADIUS), reps=3, warmup=1)
                res[f"{tag}/ms"], res[f"{tag}/plain_ms"] = k_ms, p_ms
                # per query and level: the (2r+2)^2 integer-grid dots of
                # length C, a multiply-add each (B1's work; the window
                # derivatives and the contraction with g are ~1 %)
                flops = 2 * (2 * RADIUS + 2) ** 2 * c * b * h * w * LEVELS
                res[f"{tag}/bound"] = bound(
                    nbytes(f1, *levels, cflat, g, got), flops, dtype)
                m = res[f"{tag}/bound"]
                print(f"{tag:32s} kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                      f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}; the "
                      f"kernel at {100 * m['bound_ms'] / k_ms:.1f}% of it) "
                      "per coordinate gradient (4 levels)", flush=True)
            del got, again, ref
    return res


def flow_stats(a: torch.Tensor, b: torch.Tensor):
    """(max abs difference, mean EPE / mean |b|) of two (..., 2) flows."""
    epe = torch.linalg.vector_norm(a - b, dim=-1).mean()
    mag = torch.linalg.vector_norm(b, dim=-1).mean()
    return (a - b).abs().max().item(), (epe / mag).item()


def model_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== RAFT-12 slice ==", flush=True)
    res = {}
    wild = fetch_model("RAFT", device="cuda", seed=0)
    cal = FlowModel("RAFT", scale_flow_head(wild.module, 0.05), wild.device)
    points = {"calibrated": cal, "wild": wild}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]

    # the main path: count the kernel's launches while serving
    flows = {}
    LAUNCH_COUNTS.clear()
    for point, model in points.items():
        for i, (a, b) in enumerate(requests):
            before = LAUNCH_COUNTS["alt_corr_fwd"]
            flow = predict_flow(model, a, b)
            torch.cuda.synchronize()
            check(tuple(flow.shape) == (B, H, W, 2),
                  f"{point} request {i}: flow shape {tuple(flow.shape)}")
            check(bool(torch.isfinite(flow).all()),
                  f"{point} request {i}: non-finite flow")
            check(LAUNCH_COUNTS["alt_corr_fwd"] - before == ITERS,
                  f"{point} request {i}: kernel launched "
                  f"{LAUNCH_COUNTS['alt_corr_fwd'] - before} times, not {ITERS}")
            flows[point, i] = flow
    res["launches"] = LAUNCH_COUNTS["alt_corr_fwd"]
    print(f"kernel launches while serving {len(points)}x{REQUESTS} requests: "
          f"{res['launches']} ({ITERS} per request)", flush=True)
    # which path B1 took for the coords of a request's 12 iterations
    for point, model in points.items():
        with path_counts("_alt_corr_lookup_cuda") as counts:
            predict_flow(model, *requests[0])
        share, per_level = path_share(counts)
        res[f"{point}/tile_share"] = share
        print(f"{point} request's own coords: (tile, level) pairs of "
              f"alt_corr_fwd on the tile path {100 * share:.1f}% ({per_level}, "
              f"summed over {ITERS} iterations)", flush=True)
    for point in points:
        mag = torch.stack([torch.linalg.vector_norm(flows[point, i], dim=-1).mean()
                           for i in range(REQUESTS)]).mean().item()
        res[f"{point}/mean_flow_px"] = mag
        print(f"{point}: mean |flow| = {mag:.3f} px", flush=True)
    cal_px = res["calibrated/mean_flow_px"]
    print(f"calibrated mean |flow| {'inside' if CAL_BAND[0] <= cal_px <= CAL_BAND[1] else 'outside'}"
          f" the {CAL_BAND} px band of trained checkpoints", flush=True)
    check(CAL_SANITY[0] < cal_px < CAL_SANITY[1],
          f"calibrated mean |flow| {cal_px:.3f} px outside {CAL_SANITY}")

    # the kernel against the plain lookup, end to end
    a, b = requests[0]
    for point, model in points.items():
        model.module.plain_lookup = True
        plain = predict_flow(model, a, b)
        model.module.plain_lookup = False
        mx, rel = flow_stats(flows[point, 0], plain)
        res[f"bf16/{point}/max_abs_px"], res[f"bf16/{point}/rel_epe"] = mx, rel
        print(f"bf16 {point}: kernel vs plain lookup max|dflow|={mx:.3e} px, "
              f"rel EPE={100 * rel:.4f}%", flush=True)
    check(res["bf16/calibrated/rel_epe"] <= BF16_REL_EPE_TOL,
          "bf16 calibrated: kernel vs plain lookup beyond the 1% bar")
    m32 = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", device="cuda", seed=0)
    m32 = FlowModel(m32.name, scale_flow_head(m32.module, 0.05), m32.device)
    got = predict_flow(m32, a, b)
    m32.module.plain_lookup = True
    plain = predict_flow(m32, a, b)
    mx, rel = flow_stats(got, plain)
    res["f32/calibrated/max_abs_px"] = mx
    print(f"f32 calibrated (TF32 off): kernel vs plain lookup "
          f"max|dflow|={mx:.3e} px (tol {F32_FLOW_TOL_PX}), "
          f"rel EPE={100 * rel:.6f}%", flush=True)
    check(mx <= F32_FLOW_TOL_PX, "f32: kernel vs plain lookup beyond bound")
    del m32, got, plain

    # steady-state throughput
    for point, model in points.items():
        for a, b in requests[:2]:
            predict_flow(model, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for _ in range(2):
            for a, b in requests:
                predict_flow(model, a, b)
                n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[f"{point}/pairs_per_s"] = B * n / dt
        print(f"{point}: {B * n / dt:.2f} pairs/s ({1e3 * dt / n:.1f} ms per "
              f"request of {B} pairs, {n} requests)", flush=True)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each f32 value (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def warp_flow(gen, b, h, w, kind):
    flow = torch.randn((b, 2, h, w), generator=gen, device="cuda")
    if kind == "smooth":  # a smooth field: x4 bilinear upsample of noise
        coarse = 3.0 * torch.randn((b, 2, h // 4 + 1, w // 4 + 1),
                                   generator=gen, device="cuda")
        return torch.nn.functional.interpolate(
            coarse, size=(h, w), mode="bilinear", align_corners=False)
    if kind == "wild":
        return 150.0 * flow
    far = torch.rand((b, 2, h, w), generator=gen, device="cuda") < 0.3
    return torch.where(far, torch.sign(flow) * 1e30, 3.0 * flow)


def grid_sample_call(img, flow, mode):
    """F.grid_sample on the warp's sample grid, for its time: the mode's
    normalised grid (align_corners=False), built once outside the timing.
    It computes the warp for "border" and "spynet"; for "zeros_mask" it
    leaves out the mask, and a bf16 image needs a bf16 grid, which rounds
    the coordinates."""
    from understanding_flow_robustness_tpu_torch.ops.interp import (
        warp_sample_coords,
    )

    x, y, _ = warp_sample_coords(flow, mode)
    h, w = img.shape[2:]
    grid = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1], dim=-1)
    grid = grid.to(img.dtype)
    pad = "border" if mode == "border" else "zeros"
    return lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode=pad, align_corners=False)


def warp_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch import ops

    print("== warp_fwd vs plain ==", flush=True)
    res = {}
    shapes = {"spynet": WARP_MAIN["spynet"][0],
              "pwc": WARP_MAIN["zeros_mask"][0], "ragged": (2, 5, 13, 21)}
    for shape_name, (b, c, h, w) in shapes.items():
        img32 = torch.rand((b, c, h, w), generator=gen, device="cuda")
        for kind in ("smooth", "wild", "far"):
            flow = warp_flow(gen, b, h, w, kind)
            for mode in ("border", "zeros_mask", "spynet"):
                for dtype in (torch.float32, torch.bfloat16):
                    img = img32.to(dtype)
                    got = ops.warp_backward(img, flow, mode)
                    # bf16: the plain version's f32 sample of the same
                    # bf16 values, before its rounding
                    ref = ops.warp_backward_reference(img.float(), flow, mode)
                    torch.cuda.synchronize()
                    tag = (f"{shape_name}/{kind}/{mode}/"
                           f"{str(dtype).split('.')[-1]}")
                    check(got.shape == img.shape and got.dtype == dtype
                          and not bool(torch.isnan(got).any()),
                          f"{tag}: kernel output malformed")
                    err = (got.float() - ref).abs()
                    if dtype == torch.float32:
                        tol = WARP_F32_REL_TOL * img32.abs().max().item()
                        ok = err.max().item() <= tol
                        bar = f"tol={tol:.1e}"
                    else:
                        ok = bool((err <= bf16_ulp(ref)).all())
                        bar = "tol=1 bf16 ulp"
                    print(f"{tag:38s} max_abs_err={err.max().item():.3e} "
                          f"{bar}", flush=True)
                    check(ok, f"{tag}: kernel disagrees with plain version")
                    res[tag] = err.max().item()
                    if WARP_MAIN.get(mode) == ((b, c, h, w), dtype) \
                            and kind == "smooth":
                        # the kernel and grid_sample replayed from a CUDA
                        # graph (device time), and the kernel launched
                        # from Python back to back
                        k_ms = graph_ms(lambda: ops.warp_backward(
                            img, flow, mode), reps=50)
                        launched_ms = cuda_ms(lambda: ops.warp_backward(
                            img, flow, mode), reps=50)
                        p_ms = cuda_ms(lambda: ops.warp_backward_reference(
                            img, flow, mode), reps=10)
                        l_ms = graph_ms(grid_sample_call(img, flow, mode),
                                        reps=50)
                        res[f"{mode}/main"] = {
                            "tag": tag, "max_abs_err": err.max().item(),
                            "ms": k_ms, "launched_ms": launched_ms,
                            "plain_ms": p_ms, "library_ms": l_ms,
                            # 4 taps per channel, a multiply-add each
                            **bound(nbytes(img, flow, got),
                                    8 * b * c * h * w, dtype)}
                        m = res[f"{mode}/main"]
                        print(f"{tag:38s} kernel {k_ms:.4f} ms ("
                              f"{launched_ms:.4f} launched from Python), "
                              f"plain {p_ms:.4f} ms, grid_sample {l_ms:.4f} "
                              "ms, "
                              f"bound {m['bound_ms']:.4f} ms ({m['bound_by']}"
                              "; the kernel at "
                              f"{100 * m['bound_ms'] / k_ms:.0f}% of it)",
                              flush=True)
                    del got, ref
            del flow
    return res


def corr_block_grid_sample(pyramid, coords, radius: int = RADIUS):
    """The reference CorrBlock's sampling (models/raft/corr.py:72-96) as one
    ``F.grid_sample(align_corners=True, padding_mode="zeros")`` per level
    over the (B*N, 1, Hl, Wl) level with a (B*N, n, n, 2) grid, for its
    time: the grids (row s, column t sampling (x/2^l - r + s,
    y/2^l - r + t), so the output is s-major) are built outside the
    timing.  A bf16 level needs a bf16 grid, which rounds the
    coordinates."""
    F = torch.nn.functional
    b, h, w, _ = coords.shape
    bn, n = b * h * w, 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=coords.device,
                     dtype=torch.float32)
    calls = []
    for lvl, p in enumerate(pyramid):
        hl, wl = p.shape[2:]
        c = coords.reshape(bn, 1, 1, 2) / 2 ** lvl
        x = (c[..., 0] + d[:, None]).expand(bn, n, n)  # [q, s, t]
        y = (c[..., 1] + d[None, :]).expand(bn, n, n)
        grid = torch.stack([2 * x / max(wl - 1, 1) - 1,
                            2 * y / max(hl - 1, 1) - 1], dim=-1).to(p.dtype)
        vol = p.reshape(bn, 1, hl, wl)
        calls.append((vol, grid))

    def run():  # the four sample calls, each (B*N, 1, 9, 9)
        return [F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for v, g in calls]
    return run


def needed_taps(pyramid, coords, radius: int = RADIUS) -> int:
    """The volume taps this run's windows need: per query and level, the
    (2r+2)^2 integer taps around the centre that lie inside the level
    (windows that straddle or leave the level need fewer)."""
    b, h, w, _ = coords.shape
    c = coords.reshape(-1, 2).double()
    total = 0
    offs = torch.arange(-radius, radius + 2, device=coords.device)
    for lvl, p in enumerate(pyramid):
        hl, wl = p.shape[2:]
        cx = (c[:, 0] / 2 ** lvl).clamp(-(radius + 2.0), wl + radius + 1.0)
        cy = (c[:, 1] / 2 ** lvl).clamp(-(radius + 2.0), hl + radius + 1.0)
        xs = cx.floor().long()[:, None] + offs
        ys = cy.floor().long()[:, None] + offs
        nx = ((xs >= 0) & (xs < wl)).sum(1)
        ny = ((ys >= 0) & (ys < hl)).sum(1)
        total += int((nx * ny).sum().item())
    return total


def volume_kernel_phase(gen) -> dict:
    from understanding_flow_robustness_tpu_torch import ops

    print("== corr_lookup_fwd vs plain, RAFT's volume pyramid ==", flush=True)
    res = {}
    n2 = (2 * RADIUS + 1) ** 2
    for name, b, h, w, c, coords in lookup_cases(gen, (B, H // 8, W // 8, 256)):
        fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        coords = coords.contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            pyr = ops.volume_pyramid(fm1, fm2, LEVELS,
                                     None if dtype == torch.float32 else dtype)
            got = ops.corr_lookup(pyr, coords)
            ref = ops.corr_lookup_reference(pyr, coords)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            check(tuple(got.shape) == (b, h, w, LEVELS * n2)
                  and got.dtype == torch.float32
                  and bool(torch.isfinite(got).all()),
                  f"{tag}: kernel output malformed")
            err = (got - ref).abs().max().item()
            print(f"{tag:32s} max_abs_err={err:.3e} tol={VOL_TOL:.0e} "
                  f"max|corr|={ref.abs().max().item():.3f}", flush=True)
            check(err <= VOL_TOL, f"{tag}: kernel disagrees with plain version")
            res[tag] = err
            if name == "main/calibrated":
                lib = corr_block_grid_sample(pyr, coords)
                k_ms = cuda_ms(lambda: ops.corr_lookup(pyr, coords), reps=50)
                p_ms = cuda_ms(lambda: ops.corr_lookup_reference(pyr, coords),
                               reps=5, warmup=1)
                l_ms = cuda_ms(lib, reps=20)
                lib_out = torch.cat([o.reshape(b, h, w, -1) for o in lib()], -1)
                lib_err = (lib_out.float() - got).abs().max().item()
                del lib_out
                taps = needed_taps(pyr, coords)
                # per output: 4 products and 3 sums, in f32
                res[f"{tag}/main"] = {
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    "library_ms": l_ms, "taps": taps,
                    **bound(taps * pyr[0].element_size()
                            + nbytes(coords, got),
                            7 * got.numel(), torch.float32)}
                m = res[f"{tag}/main"]
                print(f"{tag:32s} kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                      f"grid_sample x{LEVELS} {l_ms:.4f} ms (vs kernel "
                      f"{lib_err:.2e}), bound {m['bound_ms']:.4f} ms "
                      f"({m['bound_by']}, {taps} taps of "
                      f"{b * h * w * LEVELS * (2 * RADIUS + 2) ** 2})",
                      flush=True)
            del pyr, got, ref
    return res


def volume_model_phase(gen) -> dict:
    """RAFT-12 on its volume path, serving the model phase's workload."""
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== RAFT-12 volume path (corr_impl=\"volume\") ==", flush=True)
    res = {}
    wild = fetch_model("RAFT", device="cuda", seed=0, corr_impl="volume")
    cal = FlowModel("RAFT", scale_flow_head(wild.module, 0.05), wild.device)
    points = {"calibrated": cal, "wild": wild}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while serving
    flows = {}
    LAUNCH_COUNTS.clear()
    for point, model in points.items():
        for i, (a, b) in enumerate(requests):
            before = dict(LAUNCH_COUNTS)
            flow = predict_flow(model, a, b)
            torch.cuda.synchronize()
            n = {k: LAUNCH_COUNTS[k] - before.get(k, 0)
                 for k in ("corr_lookup_fwd", "alt_corr_fwd")}
            check(tuple(flow.shape) == (B, H, W, 2)
                  and bool(torch.isfinite(flow).all()),
                  f"{point} request {i}: flow malformed")
            check(n == {"corr_lookup_fwd": ITERS, "alt_corr_fwd": 0},
                  f"{point} request {i}: launches {n}, not {ITERS} of "
                  "corr_lookup_fwd and none of alt_corr_fwd")
            flows[point, i] = flow
    res["launches"] = LAUNCH_COUNTS["corr_lookup_fwd"]
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"corr_lookup_fwd launches while serving {len(points)}x{REQUESTS} "
          f"requests: {res['launches']} ({ITERS} per request), alt_corr_fwd "
          f"{LAUNCH_COUNTS['alt_corr_fwd']}; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)

    # against the plain lookup and the alt path, same weights
    a, b = requests[0]
    for point, model in points.items():
        model.module.plain_lookup = True
        plain = predict_flow(model, a, b)
        model.module.plain_lookup = False
        model.module.corr_impl = "alt"
        alt = predict_flow(model, a, b)
        model.module.corr_impl = "volume"
        for other, ref in (("plain", plain), ("alt", alt)):
            mx, rel = flow_stats(flows[point, 0], ref)
            res[f"bf16/{point}/vs_{other}_rel_epe"] = rel
            print(f"bf16 {point}: volume path vs {other} max|dflow|={mx:.3e} "
                  f"px, rel EPE={100 * rel:.4f}%", flush=True)
    check(res["bf16/calibrated/vs_plain_rel_epe"] <= BF16_REL_EPE_TOL
          and res["bf16/wild/vs_plain_rel_epe"] <= BF16_REL_EPE_TOL,
          "bf16: volume kernel vs plain lookup beyond the 1% bar")
    check(res["bf16/calibrated/vs_alt_rel_epe"] <= BF16_REL_EPE_TOL,
          "bf16 calibrated: volume path vs alt path beyond the 1% bar")
    m32 = fetch_model("RAFT_adv_kitti2012_ifgsm_l2_002", device="cuda", seed=0,
                      corr_impl="volume")
    m32 = FlowModel(m32.name, scale_flow_head(m32.module, 0.05), m32.device)
    vol = predict_flow(m32, a, b)
    m32.module.corr_impl = "alt"
    alt = predict_flow(m32, a, b)
    mx, rel = flow_stats(vol, alt)
    res["f32/calibrated/vs_alt_max_abs_px"] = mx
    print(f"f32 calibrated (TF32 off): volume path vs alt path "
          f"max|dflow|={mx:.3e} px (tol {F32_FLOW_TOL_PX}), rel EPE="
          f"{100 * rel:.6f}%", flush=True)
    check(mx <= F32_FLOW_TOL_PX, "f32: volume path vs alt path beyond bound")
    del m32, vol, alt

    # steady-state throughput
    for point, model in points.items():
        for a, b in requests[:2]:
            predict_flow(model, a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for _ in range(2):
            for a, b in requests:
                predict_flow(model, a, b)
                n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[f"{point}/pairs_per_s"] = B * n / dt
        print(f"volume {point}: {B * n / dt:.2f} pairs/s ({1e3 * dt / n:.1f} "
              f"ms per request of {B} pairs, {n} requests)", flush=True)
    return res


def taps_phase(gen) -> dict:
    """RAFT-12 with its feature taps, one request at full width."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        get_feature_map_keys,
        raft_model,
    )

    print("== RAFT-12 feature taps (return_features=True) ==", flush=True)
    model = fetch_model("RAFT", device="cuda", seed=0, return_features=True)
    a = torch.rand((B, H, W, 3), generator=gen, device="cuda") * 255.0
    b = torch.rand((B, H, W, 3), generator=gen, device="cuda") * 255.0
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    lookups = []

    def recording_lookup(*args):
        lookups.append(ops.corr_lookup(*args))
        return lookups[-1]

    h8, w8, n = H // 8, W // 8, (H // 8) * (W // 8)
    shapes = {"fmap1": (B, 256, h8, w8), "fmap2": (B, 256, h8, w8),
              "net": (B, 128, h8, w8), "inp": (B, 128, h8, w8)}
    shapes.update({f"corr_pyramid_{i}": (B, n, h8 >> i, w8 >> i)
                   for i in range(LEVELS)})
    for it in range(ITERS):
        shapes.update({
            f"idx_corr_vol_{it}": (B, LEVELS * (2 * RADIUS + 1) ** 2, h8, w8),
            f"net_{it}": (B, 128, h8, w8), f"motion_features_{it}": (B, 128, h8, w8),
            f"cor1_{it}": (B, 256, h8, w8), f"cor_{it}": (B, 192, h8, w8),
            f"cor_flo_{it}": (B, 256, h8, w8), f"flow_pred_{it}": (B, 2, H, W)})
    with torch.inference_mode():
        model.module(a, b)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        raft_model.corr_lookup = recording_lookup
        ops.LAUNCH_COUNTS.clear()
        try:
            t0 = time.perf_counter()
            _, flow_up, feats = model.module(a, b)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        finally:
            raft_model.corr_lookup = ops.corr_lookup
    launches = ops.LAUNCH_COUNTS["corr_lookup_fwd"]
    keys = get_feature_map_keys("RAFT")
    check(list(feats) == keys, "taps: keys differ from get_feature_map_keys")
    for k in keys:
        check(tuple(feats[k].shape) == shapes[k],
              f"taps: {k} is {tuple(feats[k].shape)}, not {shapes[k]}")
        check(bool(torch.isfinite(feats[k]).all()), f"taps: {k} not finite")
    check(launches == ITERS and len(lookups) == ITERS,
          f"taps: corr_lookup_fwd launched {launches} times, not {ITERS}")
    for it, out in enumerate(lookups):
        check(torch.equal(feats[f"idx_corr_vol_{it}"], out.permute(0, 3, 1, 2)),
              f"taps: idx_corr_vol_{it} is not the kernel's lookup output")
    check(torch.equal(feats[f"flow_pred_{ITERS - 1}"], flow_up),
          "taps: flow_pred of the last iteration is not flow_up")
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in feats.values()}
    held = sum(storages.values()) / 2 ** 30
    res = {"launches": launches, "ms": ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "taps_gib": held, "base_gib": base / 2 ** 30}
    print(f"taps: {len(keys)} keys, shapes and finiteness as expected, "
          f"idx_corr_vol_0..{ITERS - 1} equal to the kernel's output; "
          f"{launches} corr_lookup_fwd launches; request {ms:.1f} ms; taps "
          f"hold {held:.2f} GiB; peak memory {res['peak_mem_gib']:.2f} GiB "
          f"(model and inputs {res['base_gib']:.2f} GiB)", flush=True)
    return res


def wocontext_phase(gen) -> dict:
    """RAFT_FlowNetCEncoder_WoContext, calibrated, on its (alt) path."""
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    name = "RAFT_FlowNetCEncoder_WoContext"
    print(f"== {name} serving, calibrated ==", flush=True)
    m = fetch_model(name, device="cuda", seed=0)
    model = FlowModel(name, scale_flow_head(m.module, 0.05), m.device)
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    res = {}
    flows = []
    LAUNCH_COUNTS.clear()
    for i, (a, b) in enumerate(requests):
        before = dict(LAUNCH_COUNTS)
        flow = predict_flow(model, a, b)
        torch.cuda.synchronize()
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0)
             for k in ("alt_corr_fwd", "corr_lookup_fwd")}
        check(tuple(flow.shape) == (B, H, W, 2)
              and bool(torch.isfinite(flow).all()),
              f"{name} request {i}: flow malformed")
        check(n == {"alt_corr_fwd": ITERS, "corr_lookup_fwd": 0},
              f"{name} request {i}: launches {n}, not {ITERS} of alt_corr_fwd")
        flows.append(flow)
    res["launches"] = LAUNCH_COUNTS["alt_corr_fwd"]
    res["mean_flow_px"] = torch.stack(
        [torch.linalg.vector_norm(f, dim=-1).mean() for f in flows]).mean().item()
    a, b = requests[0]
    model.module.plain_lookup = True
    plain = predict_flow(model, a, b)
    model.module.plain_lookup = False
    mx, rel = flow_stats(flows[0], plain)
    res["rel_epe_vs_plain"] = rel
    print(f"alt_corr_fwd launches while serving {REQUESTS} requests: "
          f"{res['launches']} ({ITERS} per request); mean |flow| "
          f"{res['mean_flow_px']:.3f} px; kernel vs plain lookup "
          f"max|dflow|={mx:.3e} px, rel EPE={100 * rel:.4f}%", flush=True)
    check(rel <= BF16_REL_EPE_TOL, f"{name}: kernel vs plain lookup beyond "
                                   "the 1% bar")
    for a, b in requests[:2]:
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in requests * 2:
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res["pairs_per_s"] = B * 2 * REQUESTS / dt
    print(f"{name}: {res['pairs_per_s']:.2f} pairs/s ({1e3 * dt / (2 * REQUESTS):.1f}"
          f" ms per request of {B} pairs)", flush=True)
    return res


def warp_model_phase(gen, name: str, warps: int, corrs: int = 0) -> dict:
    """``name`` serving REQUESTS requests of B pairs at HxW through
    ``predict_flow``, each warp and each of its ``corrs`` correlations
    through the kernels; then the same model with the plain warp and the
    plain correlation together, and pairs/s, with ``corrs`` also with the
    plain correlation alone (the path before the correlation kernel)."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    model = fetch_model(name, device="cuda", seed=0)
    mixed = getattr(model.module, "mixed_precision", False)
    print(f"== {name} serving, batch {B} at {H}x{W}, "
          f"{'bf16 mixed' if mixed else 'f32'} ==", flush=True)
    res = {}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]

    # the main path: count the kernels' launches while serving
    flows = []
    LAUNCH_COUNTS.clear()
    expect = {"warp_fwd": warps, "spatial_corr_fwd": corrs}
    for i, (a, b) in enumerate(requests):
        before = dict(LAUNCH_COUNTS)
        flow = predict_flow(model, a, b)
        torch.cuda.synchronize()
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0) for k in expect}
        check(tuple(flow.shape) == (B, H, W, 2),
              f"{name} request {i}: flow shape {tuple(flow.shape)}")
        check(bool(torch.isfinite(flow).all()),
              f"{name} request {i}: non-finite flow")
        check(n == expect, f"{name} request {i}: launches {n}, not {expect}")
        flows.append(flow)
    res["launches"] = LAUNCH_COUNTS["warp_fwd"]
    res["corr_launches"] = LAUNCH_COUNTS["spatial_corr_fwd"]
    res["mean_flow_px"] = torch.stack(
        [torch.linalg.vector_norm(f, dim=-1).mean() for f in flows]
    ).mean().item()
    print(f"launches while serving {REQUESTS} requests: warp_fwd "
          f"{res['launches']} ({warps} per request), spatial_corr_fwd "
          f"{res['corr_launches']} ({corrs} per request); mean |flow| "
          f"{res['mean_flow_px']:.3f} px", flush=True)

    # the kernels against the plain warp and correlation, end to end
    a, b = requests[0]
    points = [(model, flows[0], mixed)]
    if mixed:  # PWC-Net's f32 configuration as well
        m32 = fetch_model(name, device="cuda", seed=0, mixed_precision=False)
        points.append((m32, predict_flow(m32, a, b), False))
    what = "warp and correlation kernels" if corrs else "warp kernel"
    for m, got, bf16 in points:
        m.module.plain_warp = True
        if corrs:
            m.module.plain_corr = True
        plain = predict_flow(m, a, b)
        m.module.plain_warp = False
        if corrs:
            m.module.plain_corr = False
        mx, rel = flow_stats(got, plain)
        key = "bf16" if bf16 else "f32"
        res[f"{key}/max_abs_px"], res[f"{key}/rel_epe"] = mx, rel
        bar = (f"rel EPE bound {100 * BF16_REL_EPE_TOL:g}%" if bf16
               else f"max bound {FLOW_F32_TOL_PX} px")
        print(f"{key}: {what} vs plain versions max|dflow|={mx:.3e} px, "
              f"rel EPE={100 * rel:.5f}% ({bar})", flush=True)
        check(rel <= BF16_REL_EPE_TOL if bf16 else mx <= FLOW_F32_TOL_PX,
              f"{name} {key}: {what} vs plain versions beyond bound")
    del points

    # steady-state throughput; with correlations also on the plain
    # correlation (the path before its kernel), the two in turns
    variants = ("kernel", "plain_corr") if corrs else ("kernel",)
    times = {v: [] for v in variants}
    for _ in range(2):
        for v in variants:
            if corrs:
                model.module.plain_corr = v == "plain_corr"
            for a, b in requests[:1]:
                predict_flow(model, a, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a, b in requests:
                predict_flow(model, a, b)
            torch.cuda.synchronize()
            times[v].append(time.perf_counter() - t0)
    if corrs:
        model.module.plain_corr = False
    for v, dts in times.items():
        dt, n = sum(dts), REQUESTS * len(dts)
        key = "pairs_per_s" if v == "kernel" else "plain_corr_pairs_per_s"
        res[key] = B * n / dt
        print(f"{name}{'' if v == 'kernel' else ' (plain correlation)'}: "
              f"{B * n / dt:.2f} pairs/s ({1e3 * dt / n:.1f} ms per request "
              f"of {B} pairs, {n} requests)", flush=True)
    return res


def corr_pairs(h: int, w: int, patch: int, dil: int) -> int:
    """The (pixel, displacement) pairs whose displaced pixel lies inside an
    h x w map: the products a correlation needs per image and channel."""
    r = (patch - 1) // 2
    offs = [(k - r) * dil for k in range(patch)]
    return (sum(max(0, h - abs(d)) for d in offs)
            * sum(max(0, w - abs(d)) for d in offs))


def _corr_err(got, ref, dtype) -> tuple:
    """(max abs error, whether it is within the bar CORR_REL_TOL states)."""
    err = (got.float() - ref.float()).abs()
    bar = CORR_REL_TOL * ref.float().abs().max().item()
    if dtype == torch.float32:
        return err.max().item(), err.max().item() <= bar
    return err.max().item(), bool(
        (err <= torch.clamp(bf16_ulp(ref.float()), min=bar)).all())


def spatial_corr_phase(gen) -> dict:
    """csrc/spatial_corr_fwd.cu and csrc/spatial_corr_bwd.cu against the
    plain version and its autograd on the same inputs, at the main paths'
    shapes and ragged ones; times at FlowNetC's serving and patch shapes
    and PWC-Net's level 2 (forward) and at FlowNetC's attack and patch
    shapes and PWC-Net's level 2 (backward)."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print("== spatial_corr_fwd / spatial_corr_bwd vs plain (TF32 off) ==",
          flush=True)
    res = {}
    for name, (shape, patch, dil, dtype) in {**CORR_MAIN, **CORR_PWC,
                                             **CORR_RAGGED}.items():
        # the patch shapes draw from generators of their own, so that the
        # other cases and later phases draw as before
        cg = torch.Generator(device="cuda").manual_seed(PATCH_SEED) \
            if name.startswith("patch") else gen
        f1 = torch.randn(shape, generator=cg, device="cuda").to(dtype)
        f2 = torch.randn(shape, generator=cg, device="cuda").to(dtype)
        g = torch.randn((shape[0], patch ** 2) + shape[2:], generator=cg,
                        device="cuda").to(dtype)
        got = ops.spatial_correlation(f1, f2, patch, dilation_patch=dil)
        ref = ops.spatial_correlation_reference(f1, f2, patch, dil)
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"{name}: spatial_corr_fwd output malformed")
        err, ok = _corr_err(got, ref, dtype)
        # the backward kernel (f32 sums written in the inputs' dtype)
        # against the plain version's autograd in f32 on the same values,
        # at the forward's bar
        dk = corr._spatial_corr_bwd_cuda(f1, f2, g, patch, dil)
        a, b = f1.float().requires_grad_(), f2.float().requires_grad_()
        dp = torch.autograd.grad(ops.spatial_correlation_reference(
            a, b, patch, dil), (a, b), g.float())
        torch.cuda.synchronize()
        bres = [_corr_err(k, p, dtype) for k, p in zip(dk, dp)]
        babs, bok = max(e for e, _ in bres), all(o for _, o in bres)
        berr = max((k.float() - p).abs().max().item() / p.abs().max().item()
                   for k, p in zip(dk, dp))
        bar = "1e-5 x max|plain|" if dtype == torch.float32 else \
            "1 bf16 ulp (1e-5 x max|plain| at cancellations)"
        print(f"{name:12s} {tuple(shape)} P={patch} d={dil} "
              f"{str(dtype).split('.')[-1]}: fwd max_abs_err={err:.3e}; "
              f"bwd max err / max|grad| = {berr:.2e} (bar {bar})", flush=True)
        check(ok, f"{name}: spatial_corr_fwd disagrees with the plain version")
        check(all(k.dtype == dtype for k in dk) and bok,
              f"{name}: spatial_corr_bwd disagrees with the plain version's "
              "autograd")
        res[name] = {"fwd_err": err, "bwd_err": babs, "bwd_rel_err": berr}
        pairs = corr_pairs(shape[2], shape[3], patch, dil) * shape[0] * shape[1]
        if name in ("flownetc", "patch", "pwc_l2"):
            k_ms = cuda_ms(lambda: ops.spatial_correlation(
                f1, f2, patch, dilation_patch=dil), reps=20)
            p_ms = cuda_ms(lambda: ops.spatial_correlation_reference(
                f1, f2, patch, dil), reps=3, warmup=1)
            # a multiply-add per pair inside the map and channel
            res[name].update(ms=k_ms, plain_ms=p_ms, **bound(
                nbytes(f1, f2, got), 2 * pairs, dtype))
            m = res[name]
            print(f"{name:12s} forward: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.3f} ms, bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}; the kernel at "
                  f"{100 * m['bound_ms'] / k_ms:.1f}% of it)", flush=True)
        if name in ("attack", "patch", "pwc_l2"):
            k_ms = cuda_ms(lambda: corr._spatial_corr_bwd_cuda(
                f1, f2, g, patch, dil), reps=20)
            a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
            out = ops.spatial_correlation_reference(a, b, patch, dil)
            p_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (a, b), g, retain_graph=True), reps=3, warmup=1)
            # two multiply-adds per pair and channel (df1 and df2); g read
            # and the gradients written once, in the inputs' dtype
            res[f"{name}/bwd"] = {"ms": k_ms, "plain_ms": p_ms, **bound(
                nbytes(f1, f2, g, *dk), 4 * pairs, dtype)}
            m = res[f"{name}/bwd"]
            print(f"{name:12s} backward: kernel {k_ms:.4f} ms, plain "
                  f"(autograd) {p_ms:.3f} ms, bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}; the kernel at "
                  f"{100 * m['bound_ms'] / k_ms:.1f}% of it)", flush=True)
            del out
        del f1, f2, g, got, ref, dk, dp
    return res


def flownet_phase(gen) -> dict:
    """The FlowNet family serving REQUESTS requests of B pairs at HxW
    through ``predict_flow``: launches of the correlation kernel per
    request, the flow against the same model with the plain correlation,
    pairs/s over the requests after the first; then one taps request on
    FlowNetC."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        get_feature_map_keys,
        predict_flow,
    )
    from understanding_flow_robustness_tpu_torch.models.flownet_family import (
        correlate_flownetc,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    res = {"launches": 0}
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    for name, corrs in FLOWNETS:
        print(f"== {name} serving, batch {B} at {H}x{W}, f32 ==", flush=True)
        model = fetch_model(name, device="cuda", seed=0)
        torch.cuda.synchronize()
        flows = []
        LAUNCH_COUNTS.clear()
        for i, (a, b) in enumerate(requests):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = LAUNCH_COUNTS["spatial_corr_fwd"]
            flows.append(predict_flow(model, a, b))
            n = LAUNCH_COUNTS["spatial_corr_fwd"] - before
            check(n == corrs, f"{name} request {i}: spatial_corr_fwd "
                              f"launched {n} times, not {corrs}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for i, flow in enumerate(flows):
            check(tuple(flow.shape) == (B, H, W, 2)
                  and bool(torch.isfinite(flow).all()),
                  f"{name} request {i}: flow malformed")
        res["launches"] += LAUNCH_COUNTS["spatial_corr_fwd"]
        pps = B * (REQUESTS - 1) / dt
        res[f"{name}/pairs_per_s"] = pps
        mag = torch.linalg.vector_norm(flows[0], dim=-1).mean().item()
        line = (f"{name}: {pps:.2f} pairs/s ({1e3 * dt / (REQUESTS - 1):.1f} "
                f"ms per request of {B} pairs, requests 2-{REQUESTS}); "
                f"spatial_corr_fwd {corrs} per request; mean |flow| "
                f"{mag:.3f} px")
        if corrs:
            model.module.plain_corr = True
            plain = predict_flow(model, *requests[0])
            model.module.plain_corr = False
            rel = ((flows[0] - plain).norm() / plain.norm()).item()
            res[f"{name}/rel_l2_vs_plain"] = rel
            line += (f"; kernel vs plain correlation rel L2 {rel:.2e} (bound "
                     f"{FLOW_F32_REL_L2:g})")
            check(rel <= FLOW_F32_REL_L2, f"{name}: flow with the kernel "
                                          "beyond bound of the plain one's")
        print(line, flush=True)
        del model, flows

    print("== FlowNetC feature taps (return_features=True), one request ==",
          flush=True)
    model = fetch_model("FlowNetC", device="cuda", seed=0,
                        return_features=True)
    a, b = (x.permute(0, 3, 1, 2) for x in requests[0])
    LAUNCH_COUNTS.clear()
    with torch.inference_mode():
        t0 = time.perf_counter()
        flow, feats = model.module(a, b)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        plain = correlate_flownetc(feats["conv3a"], feats["conv3b"],
                                   plain=True)
    h2, w2 = H // 2, W // 2
    shapes = {"conv1a": (B, 64, h2, w2), "conv1b": (B, 64, h2, w2),
              "conv2a": (B, 128, h2 // 2, w2 // 2),
              "conv2b": (B, 128, h2 // 2, w2 // 2),
              "conv3a": (B, 256, H // 8, W // 8),
              "conv3b": (B, 256, H // 8, W // 8),
              "corr": (B, 441, H // 8, W // 8),
              "conv_redir": (B, 32, H // 8, W // 8),
              "conv3_1": (B, 256, H // 8, W // 8)}
    keys = get_feature_map_keys("FlowNetC")
    check(sorted(feats) == sorted(keys), "FlowNetC taps: keys differ from "
                                         "get_feature_map_keys")
    for k in keys:
        check(tuple(feats[k].shape) == shapes[k]
              and bool(torch.isfinite(feats[k]).all()),
              f"FlowNetC taps: {k} is {tuple(feats[k].shape)}, not "
              f"{shapes[k]}, or not finite")
    err, ok = _corr_err(feats["corr"], plain, torch.float32)
    check(ok and LAUNCH_COUNTS["spatial_corr_fwd"] == 1,
          "FlowNetC taps: corr is not the kernel's correlation, or it was "
          f"launched {LAUNCH_COUNTS['spatial_corr_fwd']} times")
    res["launches"] += LAUNCH_COUNTS["spatial_corr_fwd"]
    check(tuple(flow.shape) == (B, 2, H, W), "FlowNetC taps: flow malformed")
    print(f"taps: {len(keys)} keys, shapes and finiteness as expected; corr "
          f"within {err:.2e} of the plain correlation; 1 spatial_corr_fwd "
          f"launch; request {ms:.1f} ms", flush=True)
    return res


def train_batch(gen, b: int, h: int = None, w: int = None) -> dict:
    h, w = h or TH, w or TW
    return {"image1": torch.rand((b, h, w, 3), generator=gen, device="cuda"),
            "image2": torch.rand((b, h, w, 3), generator=gen, device="cuda"),
            "flow": torch.randn((b, h, w, 2), generator=gen, device="cuda"),
            "valid": torch.ones((b, h, w), device="cuda")}


def train_phase(gen) -> dict:
    """The JAX package's bench train step (bench.py:281-321) on the card."""
    from understanding_flow_robustness_tpu_torch.models import fetch_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import (
        fetch_optimizer,
        make_train_step,
    )

    print(f"== RAFT-12 train step, batch {TB} at {TH}x{TW}, bf16 ==",
          flush=True)
    model = fetch_model("RAFT", device="cuda", seed=0)
    params = list(model.module.parameters())
    optimizer, scheduler = fetch_optimizer(params, lr=1e-4, num_steps=1000)
    step = make_train_step(model.module, optimizer, scheduler, is_raft=True)
    batches = [train_batch(gen, TB) for _ in range(2)]
    start = [p.detach().clone() for p in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while training
    LAUNCH_COUNTS.clear()
    losses = []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(LAUNCH_COUNTS)
        losses.append(step(batches[i % 2])["loss"])
        for k in TRAIN_KERNELS:
            n = LAUNCH_COUNTS[k] - before.get(k, 0)
            check(n == ITERS, f"train step {i}: {k} launched {n} times, "
                              f"not {ITERS}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # one more step: which path B2 took for the coords of its 12 iterations
    with path_counts("_alt_corr_bwd_cuda") as counts:
        losses.append(step(batches[0])["loss"])
    share, per_level = path_share(counts)
    print(f"train step's own coords: (tile, level) pairs of alt_corr_bwd on "
          f"the tile path {100 * share:.1f}% ({per_level}, summed over "
          f"{ITERS} iterations)", flush=True)
    res = {f"launches/{k}": LAUNCH_COUNTS[k] for k in TRAIN_KERNELS}
    res["tile_share"] = share
    print(f"kernel launches while training {TRAIN_WARMUP + TRAIN_STEPS + 1} "
          f"steps: " + ", ".join(f"{k} {LAUNCH_COUNTS[k]}" for k in TRAIN_KERNELS)
          + f" ({ITERS} each per step)", flush=True)
    print("losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    check(all(torch.isfinite(torch.tensor(losses)).tolist()),
          "non-finite train loss")
    moved = sum(not torch.equal(p, q) for p, q in zip(params, start))
    check(moved == len(params), f"only {moved} of {len(params)} parameter "
                                "tensors moved")
    res["frames_per_s"] = TB * TRAIN_STEPS / dt
    res["ms_per_step"] = 1e3 * dt / TRAIN_STEPS
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train: {res['frames_per_s']:.2f} frames/s, "
          f"{res['ms_per_step']:.1f} ms per step of {TB} frames "
          f"({TRAIN_STEPS} timed steps), peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    return res


def grad_phase(gen) -> dict:
    """One train-mode backward through the kernels against one through the
    plain lookup on a deep copy, same model and batch, calibrated point."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.training import sequence_loss

    print("== parameter gradients, kernels vs plain lookup ==", flush=True)
    res = {}
    batch = train_batch(gen, TB)
    for name, dtype, bound in (
            ("RAFT_adv_kitti2012_ifgsm_l2_002", "f32", GRAD_F32_REL_L2),
            ("RAFT", "bf16", GRAD_BF16_REL_L2)):
        kernel = scale_flow_head(
            fetch_model(name, device="cuda", seed=0).module, 0.05).train()
        plain = copy.deepcopy(kernel)
        plain.plain_lookup = True
        for module in (kernel, plain):
            preds = module(batch["image1"].permute(0, 3, 1, 2) * 255.0,
                           batch["image2"].permute(0, 3, 1, 2) * 255.0,
                           test_mode=False)
            loss, _ = sequence_loss([p.permute(0, 2, 3, 1) for p in preds],
                                    batch["flow"], batch["valid"])
            loss.backward()
        grads = [{n: p.grad for n, p in m.named_parameters()
                  if not NORMED_BIAS.search(n)} for m in (kernel, plain)]
        rels = sorted(((grads[0][n] - q).norm().item() / q.norm().item(), n)
                      for n, q in grads[1].items())
        total = math.sqrt(sum(((grads[0][n] - q) ** 2).sum().item()
                              for n, q in grads[1].items())
                          / sum((q ** 2).sum().item()
                                for q in grads[1].values()))
        res[f"{dtype}/worst_rel_l2"], res[f"{dtype}/total_rel_l2"] = \
            rels[-1][0], total
        print(f"{dtype} ({name}): per-tensor rel L2, worst three "
              + ", ".join(f"{r:.3e} ({n})" for r, n in rels[:-4:-1])
              + f"; median {rels[len(rels) // 2][0]:.3e} (bound "
              f"{bound[0]:g}); all parameters {total:.3e} (bound "
              f"{bound[1]:g}); {len(rels)} tensors", flush=True)
        check(rels[-1][0] <= bound[0] and total <= bound[1],
              f"{dtype}: gradients with the kernels beyond bound of the "
              "plain lookup's")
        del kernel, plain
    return res


def attack_phase() -> dict:
    """The global-attack path: I-FGSM with the CLI's defaults on RAFT at
    the attack geometry, then the image gradient against the plain lookup's
    and one FGSM on PWC-Net.  The images come from a generator of this
    phase's own (ATTACK_SEED), so that cases added to earlier phases leave
    them as they are: the image gradients' distance from the plain lookup's
    depends on the images (1e-4 to 3e-3 in f32, the same to five digits
    with either design of alt_corr_bwd; scripts/torch_kernel_ab.py --e2e)."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PerturbConfig,
        flow_attack_loss,
        make_attack,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== I-FGSM on RAFT-12, batch {AB} at {AH}x{AW}, {ATTACK_STEPS} "
          f"steps, eps {ATTACK_EPS}, l2 ==", flush=True)
    res = {}
    model = fetch_model("RAFT", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(ATTACK_SEED)
    a = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    b = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")

    def target(m, x, y):  # a synthetic GT offset from the clean flow
        flow = predict_flow(m, x, y)
        return torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    gt = target(model, a, b)
    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=ATTACK_EPS, n_step=ATTACK_STEPS)
    attack = make_attack(predict, cfg)
    with path_counts("_alt_corr_bwd_cuda") as counts:  # warm-up
        make_attack(predict, dataclasses.replace(cfg, n_step=2))(a, b, gt)
    share, per_level = path_share(counts)
    res["tile_share"] = share
    print(f"attack's own coords: (tile, level) pairs of alt_corr_bwd on the "
          f"tile path {100 * share:.1f}% ({per_level}, 2 steps)", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while attacking
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    n0, n1, adv0, adv1 = attack(a, b, gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: LAUNCH_COUNTS[k] for k in
         ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords")}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(n == {"alt_corr_fwd": ITERS * ATTACK_STEPS,
                "alt_corr_bwd": ITERS * ATTACK_STEPS, "alt_corr_dcoords": 0},
          f"attack: launches {n}, not {ITERS} of each lookup kernel per "
          "step and none of alt_corr_dcoords")
    res["ms_per_step"] = 1e3 * dt / ATTACK_STEPS
    res["steps_per_s"] = ATTACK_STEPS / dt
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    nmax = max(n0.abs().max().item(), n1.abs().max().item())
    check(nmax <= ATTACK_EPS + 1e-6, f"attack: noise {nmax} outside the "
                                     "eps-ball")
    check(0.0 <= min(adv0.min().item(), adv1.min().item())
          and max(adv0.max().item(), adv1.max().item()) <= 1.0,
          "attack: adversarial images outside [0, 1]")
    with torch.no_grad():
        before = flow_attack_loss(predict(a, b), gt, "l2").item()
        after = flow_attack_loss(predict(adv0, adv1), gt, "l2").item()
    res["loss_clean"], res["loss_attacked"] = before, after
    print(f"attack: launches {n} ({ITERS} of each lookup kernel per step); "
          f"max|noise|={nmax:.4f}; l2 loss {before:.3f} -> {after:.3f}; "
          f"{res['ms_per_step']:.2f} ms per step, {res['steps_per_s']:.2f} "
          f"steps/s ({ATTACK_STEPS} steps, {1e3 * dt:.0f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    check(after > before, "attack: the l2 loss did not grow")
    del n0, n1, adv0, adv1

    # one image gradient through the kernels against the plain lookup's
    for name, dtype, bnd in (
            ("RAFT_adv_kitti2012_ifgsm_l2_002", "f32", GRAD_F32_REL_L2),
            ("RAFT", "bf16", GRAD_BF16_REL_L2)):
        m = fetch_model(name, device="cuda", seed=0)
        kernel = FlowModel(name, scale_flow_head(m.module, 0.05), m.device)
        plain = FlowModel(name, copy.deepcopy(kernel.module), m.device)
        plain.module.plain_lookup = True
        gt = target(kernel, a, b)
        grads = []
        for mm in (kernel, plain):
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            loss = flow_attack_loss(predict_flow_differentiable(mm, x, y),
                                    gt, "l2")
            grads.append(torch.autograd.grad(loss, (x, y)))
        rels = [((k - p).norm() / p.norm()).item() for k, p in zip(*grads)]
        res[f"{dtype}/image_grad_rel_l2"] = max(rels)
        # the image gradients sit upstream of every layer, like the early
        # encoder layers that set the worst-tensor bound of grad_phase
        print(f"{dtype} ({name}, calibrated): image gradient with the kernels "
              f"vs plain lookup, rel L2 {rels[0]:.3e} / {rels[1]:.3e} "
              f"(bound {bnd[0]:g})", flush=True)
        check(max(rels) <= bnd[0], f"{dtype}: image gradient with the "
                                   "kernels beyond bound of the plain lookup's")
        del m, kernel, plain, grads

    # one FGSM on PWC-Net: the attack crosses the warp kernel and the
    # correlation's two kernels
    pwc = fetch_model("PWCNet", device="cuda", seed=0)
    gt = target(pwc, a, b)
    LAUNCH_COUNTS.clear()
    n0, n1, adv0, adv1 = make_attack(
        lambda x, y: predict_flow_differentiable(pwc, x, y),
        dataclasses.replace(cfg, perturb_method="fgsm"))(a, b, gt)
    torch.cuda.synchronize()
    res.update({f"pwc_launches/{k}": LAUNCH_COUNTS[k] for k in
                ("warp_fwd", "spatial_corr_fwd", "spatial_corr_bwd")})
    check(LAUNCH_COUNTS["warp_fwd"] == 4,
          f"PWC-Net FGSM: warp_fwd launched {LAUNCH_COUNTS['warp_fwd']} "
          "times, not 4")
    check(LAUNCH_COUNTS["spatial_corr_fwd"] == 5
          and LAUNCH_COUNTS["spatial_corr_bwd"] == 5,
          "PWC-Net FGSM: the correlation kernels launched "
          f"{LAUNCH_COUNTS['spatial_corr_fwd']} and "
          f"{LAUNCH_COUNTS['spatial_corr_bwd']} times, not 5 and 5")
    check(bool(torch.isfinite(n0).all()) and n0.abs().max().item() <= ATTACK_EPS
          + 1e-6 and 0.0 <= adv1.min().item() and adv1.max().item() <= 1.0,
          "PWC-Net FGSM: noise or images out of range")
    with torch.no_grad():
        before = flow_attack_loss(predict_flow(pwc, a, b), gt, "l2").item()
        after = flow_attack_loss(predict_flow(pwc, adv0, adv1), gt, "l2").item()
    print(f"PWC-Net FGSM: warp_fwd launches {res['pwc_launches/warp_fwd']} "
          f"(the gradient through the plain sampler), spatial_corr_fwd / "
          f"_bwd {res['pwc_launches/spatial_corr_fwd']} / "
          f"{res['pwc_launches/spatial_corr_bwd']}; l2 loss {before:.3f} -> "
          f"{after:.3f}", flush=True)
    return res


@contextlib.contextmanager
def leaky_relu_signs(module):
    """Every ``nn.LeakyReLU`` of ``module`` appends the sign of its input
    (``> 0``) to the yielded list at each forward inside."""
    signs = []
    hooks = [m.register_forward_hook(lambda m, i, o: signs.append(i[0] > 0))
             for m in module.modules() if isinstance(m, torch.nn.LeakyReLU)]
    try:
        yield signs
    finally:
        for h in hooks:
            h.remove()


def flownetc_attack_phase() -> dict:
    """I-FGSM with the attack CLI's defaults on ``fetch_model("FlowNetC")``
    (the CLI's default model, f32) at the attack geometry, each step's
    backward through ``spatial_corr_bwd``; then one image gradient with the
    kernels against one with the plain correlation."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PerturbConfig,
        flow_attack_loss,
        make_attack,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== I-FGSM on FlowNetC, batch {AB} at {AH}x{AW}, {ATTACK_STEPS} "
          f"steps, eps {ATTACK_EPS}, l2 ==", flush=True)
    res = {}
    model = fetch_model("FlowNetC", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(ATTACK_SEED)
    a = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    b = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    flow = predict_flow(model, a, b)
    gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=ATTACK_EPS, n_step=ATTACK_STEPS)
    make_attack(predict, dataclasses.replace(cfg, n_step=2))(a, b, gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while attacking
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    n0, n1, adv0, adv1 = make_attack(predict, cfg)(a, b, gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: LAUNCH_COUNTS[k] for k in ("spatial_corr_fwd", "spatial_corr_bwd")}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(n == {"spatial_corr_fwd": ATTACK_STEPS,
                "spatial_corr_bwd": ATTACK_STEPS},
          f"FlowNetC attack: launches {n}, not one of each per step")
    res["ms_per_step"] = 1e3 * dt / ATTACK_STEPS
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    nmax = max(n0.abs().max().item(), n1.abs().max().item())
    check(nmax <= ATTACK_EPS + 1e-6, f"FlowNetC attack: noise {nmax} outside "
                                     "the eps-ball")
    check(0.0 <= min(adv0.min().item(), adv1.min().item())
          and max(adv0.max().item(), adv1.max().item()) <= 1.0,
          "FlowNetC attack: adversarial images outside [0, 1]")
    with torch.no_grad():
        before = flow_attack_loss(predict(a, b), gt, "l2").item()
        after = flow_attack_loss(predict(adv0, adv1), gt, "l2").item()
    res["loss_clean"], res["loss_attacked"] = before, after
    print(f"FlowNetC attack: launches {n}; max|noise|={nmax:.4f}; l2 loss "
          f"{before:.3f} -> {after:.3f}; {res['ms_per_step']:.2f} ms per step "
          f"({ATTACK_STEPS} steps, {1e3 * dt:.0f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    check(after > before, "FlowNetC attack: the l2 loss did not grow")

    # one image gradient with the kernels, one with the plain correlation
    # (f32, TF32 off), held to the worst-tensor bound of RAFT's early layers
    # (GRAD_F32_REL_L2): the image gradient sits upstream of every layer.
    # Two witnesses of why it is not at the forward's 1e-5: the leaky-ReLU
    # inputs (nn.LeakyReLU, sign-preserving) whose sign differs between the
    # two forwards, where the slope flips between 1 and 0.1; and a third
    # gradient in f64 with the plain correlation, the one both f32 paths
    # round, with each path's distance to it
    signs = []
    grads = []
    for plain in (False, True):
        model.module.plain_corr = plain
        with leaky_relu_signs(model.module) as sign:
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            loss = flow_attack_loss(predict(x, y), gt, "l2")
            grads.append(torch.autograd.grad(loss, (x, y)))
        signs.append(sign)
    flips = sum(int((p != q).sum()) for p, q in zip(*signs))
    n_act = sum(p.numel() for p in signs[0])
    del signs
    model.module.plain_corr = True
    model.module.double()
    try:
        x, y = a.double().requires_grad_(), b.double().requires_grad_()
        loss = flow_attack_loss(predict(x, y), gt.double(), "l2")
        exact = torch.autograd.grad(loss, (x, y))
    finally:
        model.module.float()
        model.module.plain_corr = False

    def rel(u, v):
        return [((p.double() - q).norm() / q.norm()).item()
                for p, q in zip(u, v)]

    rels = rel(grads[0], grads[1])
    to_exact = [rel(grads[0], exact), rel(grads[1], exact)]
    res["image_grad_rel_l2"] = max(rels)
    res["image_grad_witness"] = {"leaky_relu_sign_flips": flips,
                                 "leaky_relu_inputs": n_act,
                                 "kernel_to_f64": to_exact[0],
                                 "plain_to_f64": to_exact[1]}
    print(f"f32 FlowNetC: image gradient with the kernels vs plain "
          f"correlation, rel L2 {rels[0]:.3e} / {rels[1]:.3e} (bound "
          f"{GRAD_F32_REL_L2[0]:g}); leaky-ReLU inputs of another sign in "
          f"the two forwards: {flips} of {n_act}; rel L2 to the f64 "
          f"gradient: kernels {to_exact[0][0]:.3e} / {to_exact[0][1]:.3e}, "
          f"plain {to_exact[1][0]:.3e} / {to_exact[1][1]:.3e}", flush=True)
    check(max(rels) <= GRAD_F32_REL_L2[0], "FlowNetC: image gradient with "
          "the kernels beyond bound of the plain correlation's")
    return res


def attack_cli_phase(flownet=None) -> dict:
    """The attack CLI with ``--perturb_method ifgsm --synthetic 2 --n_step
    3`` on ``flownet``, or without ``--flownet`` on its default
    (FlowNetC); FlowNet2 adds its four warps a forward."""
    from understanding_flow_robustness_tpu_torch.cli import run_perturb_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    name = flownet or run_perturb_model.build_parser().parse_args([]).flownet
    print(f"== attack CLI: {name}{'' if flownet else ' (the default)'}, "
          "I-FGSM, --synthetic 2 --n_step 3 ==", flush=True)
    out = Path(__file__).resolve().parent / "build" / "chip_smoke_attack"
    shutil.rmtree(out, ignore_errors=True)
    argv = (["--flownet", flownet] if flownet else []) + [
        "--perturb_method", "ifgsm", "--synthetic", "2", "--n_step", "3",
        "--output_path", str(out)]
    LAUNCH_COUNTS.clear()
    res = run_perturb_model.main(argv)
    # per pair: the clean, adversarial and noise-only flows and 3 steps,
    # each forward with RAFT's 12 lookups or FlowNetC's one correlation
    per, kernels = ((ITERS, ("alt_corr_fwd", "alt_corr_bwd")) if
                    name.startswith("RAFT") else
                    (1, ("spatial_corr_fwd", "spatial_corr_bwd")))
    expect = {kernels[0]: 2 * per * (3 + 3), kernels[1]: 2 * per * 3}
    if name == "FlowNet2":  # and its four border warps a forward
        expect["warp_fwd"] = 2 * 4 * (3 + 3)
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"attack CLI: launches {n}, not {expect}")
    path = out / "kitti2015" / name / "both" / "ifgsm_l2" / "0.02"
    keys = [line.split(":")[0] for line in
            (path / "results0.txt").read_text().splitlines()]
    check(keys == [k for k in res if k != "time_per_frame"] and len(keys) == 10,
          f"attack CLI: results0.txt keys {keys}")
    check(all(math.isfinite(v[0]) for v in res.values()),
          "attack CLI: non-finite metric")
    print(f"attack CLI: launches {n}; results0.txt with {len(keys)} keys; "
          f"epe {res['flow_epe_origin'][0]:.3f} -> {res['flow_epe'][0]:.3f}; "
          f"time_per_frame {res['time_per_frame'][0]:.3f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return {"launches/" + k: v for k, v in n.items()}


def cli_phase() -> dict:
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train

    print("== train CLI ==", flush=True)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--synthetic", "3", "--num_steps", "2", "--batch_size", "2",
            "--image_size", str(TH), str(TW), "--mixed_precision",
            "--name", "smoke", "--checkpoint_dir", str(ckpt),
            "--n_devices", "1"]
    out = cli_train.main(argv)
    check(out["total_steps"] == 3 and len(out["history"]) == 3,
          f"CLI took {out['total_steps']} batches, not 3")
    check(all(torch.isfinite(torch.tensor(m["loss"])).item()
              for m in out["history"]), "CLI: non-finite loss")
    for f in ("checkpoint.pth", "smoke.pth", "args.json"):
        check((ckpt / "smoke" / f).exists(), f"CLI wrote no {f}")
    again = cli_train.main(argv)
    check(again["total_steps"] == 3 and again["history"] == [],
          "CLI resume did not return as fully trained")
    print("CLI: 3 batches, checkpoint and weights written; the rerun resumed "
          "as fully trained without a step", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"final_loss": out["history"][-1]["loss"]}


@contextlib.contextmanager
def recording(module, name: str, builds_step: bool = False):
    """Wraps ``module.<name>`` so that every call appends its result to the
    yielded list; with ``builds_step`` (``make_patch_attack_step``,
    ``make_universal_attack_step``) every call of a step it builds appends
    (the step's result, its seconds with the device synchronised)."""
    results = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if not builds_step:
            results.append(out)
            return out

        def step(*sa):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = out(*sa)
            torch.cuda.synchronize()
            results.append((res, time.perf_counter() - t))
            return res
        return step

    setattr(module, name, wrapped)
    try:
        yield results
    finally:
        setattr(module, name, fn)


def patch_step_phase() -> dict:
    """The patch attack's inner loop on FlowNetC (f32) at the JAX bench's
    geometry: PATCH_ITERS iterations pinned by ``loss_threshold=0``, each a
    forward and a backward through the correlation kernels to both
    composited images, the canvas update and the host's read of the loss;
    then one iteration's update with the kernels against the plain
    correlation's and an f64 one's."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PatchAttackConfig,
        make_patch_attack_step,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== patch attack on FlowNetC, batch {PB} at {PH}x{PW}, 100x100 "
          f"mask, {PATCH_ITERS} inner iterations ==", flush=True)
    res = {}
    model = fetch_model("FlowNetC", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(PATCH_SEED)
    a = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    b = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    mask = torch.zeros_like(a)
    mask[:, 100:200, 100:200] = 1.0
    patch = torch.rand(a.shape, generator=gen, device="cuda") * mask

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    cfg = PatchAttackConfig(max_count=PATCH_ITERS, loss_threshold=0.0)
    one = dataclasses.replace(cfg, max_count=1)
    target = -1.0 * predict_flow(model, a, b)
    # warm-up; its one iteration's loss is the first loss of the main run
    first = make_patch_attack_step(predict, one)(a, b, patch, mask, patch,
                                                 target)[3].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches over the clean flow and
    # the inner loop
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    target = -1.0 * predict_flow(model, a, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adv_tgt, adv_ref, new, loss, count = make_patch_attack_step(
        predict, cfg)(a, b, patch, mask, patch, target)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    n = {k: LAUNCH_COUNTS[k] for k in ("spatial_corr_fwd", "spatial_corr_bwd")}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(count == PATCH_ITERS and n == {"spatial_corr_fwd": PATCH_ITERS + 1,
                                         "spatial_corr_bwd": PATCH_ITERS},
          f"patch step: {count} iterations, launches {n}, not "
          f"{PATCH_ITERS} and one of each per iteration plus the clean "
          "flow's forward")
    res["ms_per_iter"] = 1e3 * dt / PATCH_ITERS
    res["iters_per_s"] = PATCH_ITERS / dt
    res["clean_flow_ms"] = 1e3 * (t1 - t0)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    outside = mask == 0
    check(torch.equal(adv_tgt[outside], a[outside])
          and torch.equal(adv_ref[outside], b[outside]),
          "patch step: adversarial images differ from the clean ones outside "
          "the mask")
    check(0.0 <= min(adv_tgt.min().item(), adv_ref.min().item())
          and max(adv_tgt.max().item(), adv_ref.max().item()) <= 1.0,
          "patch step: adversarial images outside [0, 1]")
    last = loss.item()
    res["loss_first"], res["loss_last"] = first, last
    print(f"patch step: launches {n}; {count} iterations; cossim loss "
          f"{first:.6f} -> {last:.6f} (last one evaluated); "
          f"{res['ms_per_iter']:.2f} ms per inner iteration, "
          f"{res['iters_per_s']:.2f} iterations/s ({PATCH_ITERS} iterations, "
          f"{1e3 * dt:.0f} ms; clean flow {res['clean_flow_ms']:.1f} ms); "
          f"peak memory {res['peak_mem_gib']:.2f} GiB", flush=True)
    check(math.isfinite(last) and last < first,
          "patch step: the loss is not finite or did not fall")
    del adv_tgt, adv_ref, new

    # one iteration's update, 0.5 lr (g_tgt + g_ref) clamped, with the
    # kernels and with the plain correlation (f32, TF32 off), held to phase
    # 15's image-gradient bound, with its witnesses: the leaky-ReLU inputs
    # whose sign differs between the two forwards, and each update's
    # distance to the update in f64 with the plain correlation
    step = make_patch_attack_step(predict, one)
    signs, updates = [], []
    for plain in (False, True):
        model.module.plain_corr = plain
        with leaky_relu_signs(model.module) as sign:
            updates.append(step(a, b, patch, mask, patch, target)[2] - patch)
        signs.append(sign)
    flips = sum(int((p != q).sum()) for p, q in zip(*signs))
    n_act = sum(p.numel() for p in signs[0])
    del signs
    model.module.plain_corr = True
    model.module.double()
    try:
        d = [x.double() for x in (a, b, patch, mask, target)]
        exact = step(d[0], d[1], d[2], d[3], d[2], d[4])[2] - d[2]
    finally:
        model.module.float()
        model.module.plain_corr = False

    def rel(u, v):
        return ((u.double() - v.double()).norm() / v.double().norm()).item()

    r = rel(updates[0], updates[1])
    res["update_rel_l2"] = r
    res["update_witness"] = {"leaky_relu_sign_flips": flips,
                             "leaky_relu_inputs": n_act,
                             "kernel_to_f64": rel(updates[0], exact),
                             "plain_to_f64": rel(updates[1], exact)}
    clamped = (exact.abs() >= 2.0).double().mean().item()
    print(f"f32 FlowNetC patch update with the kernels vs plain correlation, "
          f"rel L2 {r:.3e} (bound {GRAD_F32_REL_L2[0]:g}); leaky-ReLU inputs "
          f"of another sign: {flips} of {n_act}; rel L2 to the f64 update: "
          f"kernels {res['update_witness']['kernel_to_f64']:.3e}, plain "
          f"{res['update_witness']['plain_to_f64']:.3e}; share of the canvas "
          f"at the +-2 clamp {clamped:.2e}", flush=True)
    check(updates[1].abs().max().item() > 0 and r <= GRAD_F32_REL_L2[0],
          "patch step: update with the kernels beyond bound of the plain "
          "correlation's")
    return res


def patch_cli_phase() -> dict:
    """The patch CLI on FlowNetC at the reference's largest patch (0.4 of
    384: a 153-pixel circle), 2 epochs of 3 synthetic 384x1280 batches;
    then test_patch on its epoch-1 patch in the default, --true_motion and
    --different_pos modes."""
    from understanding_flow_robustness_tpu_torch.cli import (
        patch_attack as cli_patch,
    )
    from understanding_flow_robustness_tpu_torch.cli import test_patch
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== patch CLI: FlowNetC, --synthetic 3 at {PH}x{PW}, --patch-size "
          "0.4, --epochs 2 --max-count 2 ==", flush=True)
    out = PATCH_OUT / "flownetc"
    shutil.rmtree(out, ignore_errors=True)
    res = {}
    argv = ["--flownet", "FlowNetC", "--synthetic", "3", "--synthetic-size",
            str(PH), str(PW), "--image-size", "384", "--patch-size", "0.4",
            "--epochs", "2", "--max-count", "2", "--output", str(out),
            "--name", "run"]
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    with recording(cli_patch, "make_patch_attack_step", True) as steps, \
            recording(cli_patch, "validate_patch") as metrics:
        patch, _ = cli_patch.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = [r[4] for r, _ in steps]
    # the steps after the first (which runs the backward's first, tuning
    # pass): ms per inner iteration inside the CLI
    res["cli_ms_per_iter"] = (1e3 * sum(t for _, t in steps[1:])
                              / sum(counts[1:]))
    # per epoch: 3 batches of a clean forward and their inner iterations,
    # 1 validation sample of a clean and an adversarial forward
    expect = {"spatial_corr_fwd": len(counts) + sum(counts) + 2 * 2,
              "spatial_corr_bwd": sum(counts)}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(len(counts) == 6 and n == expect,
          f"patch CLI: {len(counts)} batches of {counts} iterations, "
          f"launches {n}, not {expect}")
    for e in (0, 1):
        f = out / "run" / "patches" / f"epoch_{e}.npy"
        check(f.exists() and np.load(f).shape == (1, 153, 153, 3),
              f"patch CLI: {f.name} missing or not (1, 153, 153, 3)")
    check(len(metrics) == 2 and all(math.isfinite(v) for m in metrics
                                    for v in m.values()),
          f"patch CLI: validation metrics {metrics}")
    print(f"patch CLI: {len(counts)} batches of {counts} inner iterations "
          f"({res['cli_ms_per_iter']:.2f} ms each after the first batch); "
          f"launches {n}; patches/epoch_{{0,1}}.npy (1, 153, 153, 3); epoch "
          f"1 epe {metrics[1]['epe']:.3f} adv_epe {metrics[1]['adv_epe']:.3f} "
          f"cos_sim {metrics[1]['cos_sim']:.3f} adv_cos_sim "
          f"{metrics[1]['adv_cos_sim']:.3f}; {dt:.1f} s", flush=True)
    check(patch.shape == (1, 153, 153, 3), "patch CLI: patch malformed")

    for mode, suffix in (([], ""), (["--true_motion"], "_true_motion"),
                         (["--different_pos"], "_different_pos")):
        LAUNCH_COUNTS.clear()
        avg = test_patch.main([
            "--patch_path", str(out / "run" / "patches" / "epoch_1.npy"),
            "--synthetic", "2", "--synthetic-size", str(PH), str(PW),
            "--no_viz", "--output", str(out)] + mode)
        n = LAUNCH_COUNTS["spatial_corr_fwd"]
        res["launches/spatial_corr_fwd"] += n
        d = out / "test_patch"
        rows = (d / f"test_result_scenes{suffix}.csv").read_text().splitlines()
        check(n == 4 and len(rows) == 3 and len(avg) == 4
              and all(math.isfinite(v) for v in avg)
              and (d / f"test_results{suffix}.csv").exists(),
              f"test_patch{suffix}: launches {n}, {len(rows)} CSV rows, "
              f"averages {avg}")
        print(f"test_patch{suffix or ' (default)'}: 2 scenes, launches "
              f"{n}; epe {avg[0]:.3f} adv_epe {avg[1]:.3f} cos_sim "
              f"{avg[2]:.3f} adv_cos_sim {avg[3]:.3f}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return res


def patch_lookup_phase() -> tuple:
    """B1 and B2 against their plain versions at the feature shape the
    RAFT patch CLI gives them (batch PB at PHxPW: (1, 48, 160, 256)), with
    calibrated, wild, edge and smooth centres, from a generator of this
    phase's own."""
    gen = torch.Generator(device="cuda").manual_seed(PATCH_SEED + 1)
    shape = (PB, PH // 8, PW // 8, 256)
    return (kernel_phase(gen, shape, main="patch", ragged=False),
            backward_phase(gen, shape, more=(), main="patch", ragged=False))


def patch_cli_raft_phase() -> dict:
    """The patch CLI on RAFT (mixed precision): 12 launches of each lookup
    kernel per inner iteration, none of the coordinate gradient's; then one
    inner iteration's update with the kernels against the plain lookup's
    at phase 16's geometry, bf16 and f32, and the f64 witness: both f32
    updates' distance to the update in f64 with the plain lookup."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PatchAttackConfig,
        make_patch_attack_step,
    )
    from understanding_flow_robustness_tpu_torch.cli import (
        patch_attack as cli_patch,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        predict_flow,
        predict_flow_differentiable,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== patch CLI: RAFT, --synthetic 2 at {PH}x{PW}, --patch-size 0.4, "
          "--epochs 1 --max-count 2 ==", flush=True)
    out = PATCH_OUT / "raft"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--flownet", "RAFT", "--synthetic", "2", "--synthetic-size",
            str(PH), str(PW), "--patch-size", "0.4", "--epochs", "1",
            "--max-count", "2", "--output", str(out)]
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    with recording(cli_patch, "make_patch_attack_step", True) as steps, \
            recording(cli_patch, "validate_patch") as metrics:
        cli_patch.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = [r[4] for r, _ in steps]
    ms_per_iter = 1e3 * steps[-1][1] / counts[-1]
    expect = {"alt_corr_fwd": ITERS * (len(counts) + sum(counts) + 2),
              "alt_corr_bwd": ITERS * sum(counts), "alt_corr_dcoords": 0}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(len(counts) == 2 and sum(counts) > 0 and n == expect,
          f"RAFT patch CLI: {len(counts)} batches of {counts} iterations, "
          f"launches {n}, not {expect}")
    check(len(metrics) == 1 and all(math.isfinite(v) for v in
                                    metrics[0].values()),
          f"RAFT patch CLI: validation metrics {metrics}")
    print(f"RAFT patch CLI: {counts} inner iterations ({ms_per_iter:.2f} ms "
          f"each in the second batch); launches {n} ({ITERS} of each lookup "
          f"kernel per iteration); epe {metrics[0]['epe']:.3f} adv_epe "
          f"{metrics[0]['adv_epe']:.3f}; {dt:.1f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    res = {"ms_per_iter": ms_per_iter,
           **{f"launches/{k}": v for k, v in n.items()}}

    # one inner iteration's update, 0.5 lr (g_tgt + g_ref) clamped, with
    # the kernels and with the plain lookup, batch 1 at 384x1280 with phase
    # 16's images, mask and patch, in bf16 autocast (how the CLI serves
    # RAFT) and in f32 (TF32 off), with the CLI's own seeded weights (their
    # ~150 px iterates put the lookups' centres far off the grid) and with
    # the flow head scaled to trained magnitudes (calibrated).  Held, as
    # attack_phase holds the image gradient: the calibrated l2 update, f32
    # and bf16.  Printed: the CLI's cossim loss, which starts at its
    # stationary point (the target is -flow), so its update is the small
    # flow change the patch makes and carries each path's rounding; and
    # each bf16 update's distance to the f32 plain one.  The witness: the
    # same update in f64 with the plain lookup (the module, images, patch
    # and target in f64), and both f32 updates' distance to it; a kernels'
    # update more than 2x farther from it than the plain one's would be a
    # fault of the window kernels, not chaotic growth
    gen = torch.Generator(device="cuda").manual_seed(PATCH_SEED)
    a = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    b = torch.rand((PB, PH, PW, 3), generator=gen, device="cuda")
    mask = torch.zeros_like(a)
    mask[:, 100:200, 100:200] = 1.0
    patch = torch.rand(a.shape, generator=gen, device="cuda") * mask
    bases = {"bf16": fetch_model("RAFT", device="cuda", seed=0),
             "f32": fetch_model("RAFT", device="cuda", seed=0,
                                mixed_precision=False)}

    def rel(u, v):
        return ((u - v).norm() / v.norm()).item()

    for kind in ("cli_weights", "calibrated"):
        models = {}
        for prec, base in bases.items():
            module = (base.module if kind == "cli_weights"
                      else scale_flow_head(base.module, 0.05))
            models[prec, "kernels"] = FlowModel("RAFT", module, base.device)
            models[prec, "plain"] = FlowModel("RAFT", copy.deepcopy(module),
                                              base.device)
            models[prec, "plain"].module.plain_lookup = True
        exact_model = FlowModel(
            "RAFT", copy.deepcopy(models["f32", "plain"].module).double(),
            bases["f32"].device)
        target = -1.0 * predict_flow(models["bf16", "kernels"], a, b)
        for loss in ("l2", "cossim"):
            cfg = PatchAttackConfig(max_count=1, loss_threshold=0.0,
                                    l2=loss == "l2")
            u = {}
            for key, mm in models.items():
                step = make_patch_attack_step(
                    lambda x, y, mm=mm: predict_flow_differentiable(mm, x, y),
                    cfg)
                u[key] = step(a, b, patch, mask, patch, target)[2] - patch
                check(bool(torch.isfinite(u[key]).all())
                      and u[key].abs().max().item() > 0,
                      f"RAFT patch update ({kind}, {loss}, {key}): not "
                      "finite or zero")
            step = make_patch_attack_step(
                lambda x, y: predict_flow_differentiable(exact_model, x, y),
                cfg)
            d = [x.double() for x in (a, b, patch, mask, target)]
            exact = step(d[0], d[1], d[2], d[3], d[2], d[4])[2] - d[2]
            to64 = (rel(u["f32", "kernels"], exact),
                    rel(u["f32", "plain"], exact))
            del d, exact
            r16 = rel(u["bf16", "kernels"], u["bf16", "plain"])
            r32 = rel(u["f32", "kernels"], u["f32", "plain"])
            ref = u["f32", "plain"]
            w = (rel(u["bf16", "kernels"], ref), rel(u["bf16", "plain"], ref))
            held = kind == "calibrated" and loss == "l2"
            tag = f"{kind}/{loss}"
            res[f"update_rel_l2/{tag}/bf16"] = r16
            res[f"update_rel_l2/{tag}/f32"] = r32
            res[f"update_to_f32/{tag}"] = w
            res[f"update_to_f64/{tag}"] = to64
            print(f"RAFT patch update ({kind}, {loss}), kernels vs plain "
                  f"lookup: bf16 rel L2 {r16:.3e} (bound "
                  f"{GRAD_BF16_REL_L2[0]:g}), f32 {r32:.3e} (bound "
                  f"{GRAD_F32_REL_L2[0]:g}){'' if held else ', not held'}; "
                  f"bf16 to the f32 plain update: kernels {w[0]:.3e}, "
                  f"plain {w[1]:.3e}; share at the +-2 clamp "
                  f"{(ref.abs() >= 2.0).float().mean().item():.2e}; f32 to "
                  f"the f64 plain update: kernels {to64[0]:.3e}, plain "
                  f"{to64[1]:.3e} (ratio {to64[0] / to64[1]:.3f})",
                  flush=True)
            if held:
                check(r16 <= GRAD_BF16_REL_L2[0]
                      and r32 <= GRAD_F32_REL_L2[0],
                      "RAFT patch update with the kernels beyond bound of "
                      "the plain lookup's")
            del u
        del models, exact_model
    return res


def universal_phase() -> dict:
    """The universal-perturbation CLI on FlowNetC at its defaults (256x640,
    ifgsm, cossim, eps 0.02) for one epoch of 2 synthetic batches of 3
    steps; then the attack CLI's --universal_evaluation of its snapshot;
    then the CLI once more with --flow_loss l2, each batch's steps checked
    to lower the loss."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        flow_attack_loss,
    )
    from understanding_flow_robustness_tpu_torch.cli import (
        run_perturb_model,
        universal_perturbation,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== universal perturbation CLI: FlowNetC, --synthetic 2 --epochs 1 "
          "--n_step 3 ==", flush=True)
    out = PATCH_OUT / "universal"
    shutil.rmtree(out, ignore_errors=True)
    res = {}
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    with recording(universal_perturbation, "make_universal_attack_step",
                   True) as steps:
        n0, n1 = universal_perturbation.main([
            "--synthetic", "2", "--epochs", "1", "--n_step", "3", "--seed",
            "1", "--output_path", str(out)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # the second batch's 3 steps (the first runs the backward's first,
    # tuning pass)
    res["ms_per_step"] = 1e3 * steps[-1][1] / 3
    # per batch a clean forward and 3 steps; the epoch's report 2 forwards
    expect = {"spatial_corr_fwd": 2 * (1 + 3) + 2, "spatial_corr_bwd": 2 * 3}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    res.update({f"launches/{k}": v for k, v in n.items()})
    nmax = max(np.abs(n0).max(), np.abs(n1).max())
    check(n == expect, f"universal CLI: launches {n}, not {expect}")
    check(0 < nmax <= 0.02 + 1e-6, f"universal CLI: max|noise| {nmax}")
    run_dir = (out / "kitti2015" / "FlowNetC" / "universal" / "both"
               / "ifgsm_cossim" / "0.02" / "0.002_3_1")
    snap = np.load(run_dir / "perturbations" / "epoch_0.npy")
    check(snap.shape == (1, 2, 256, 640, 3), f"universal CLI: snapshot "
                                             f"{snap.shape}")
    print(f"universal CLI: launches {n} (one spatial_corr_bwd per step); "
          f"max|noise| {nmax:.4f} (eps 0.02); snapshot {snap.shape}; "
          f"{res['ms_per_step']:.2f} ms per step (second batch); {dt:.1f} s "
          "with the model's build", flush=True)

    LAUNCH_COUNTS.clear()
    ev = run_perturb_model.main([
        "--universal_evaluation", "--folder_name", "0.002_3_1",
        "--epoch_number", "0", "--perturb_method", "ifgsm", "--flow_loss",
        "cossim", "--synthetic", "2", "--output_path", str(out)])
    n = LAUNCH_COUNTS["spatial_corr_fwd"]
    res["launches/spatial_corr_fwd"] += n
    check(n == 2 * 3 and LAUNCH_COUNTS["spatial_corr_bwd"] == 0
          and (run_dir / "results0.txt").exists()
          and all(math.isfinite(v[0]) for v in ev.values()),
          f"universal evaluation: launches {n}, results0.txt "
          f"{(run_dir / 'results0.txt').exists()}")
    print(f"universal evaluation: read perturbations/epoch_0.npy; epe "
          f"{ev['flow_epe_origin'][0]:.3f} -> {ev['flow_epe'][0]:.3f}; "
          f"results0.txt written; spatial_corr_fwd {n}", flush=True)

    # the defaults' cossim descent toward -flow starts at cossim's
    # stationary point, where the gradient is rounding noise: run the CLI
    # once more in l2, where each batch's 3 steps must lower the loss
    losses = []
    make = universal_perturbation.make_universal_attack_step

    def make_checked(predict, cfg):
        step = make(predict, cfg)

        def loss(x, y, target):
            with torch.no_grad():
                return flow_attack_loss(predict(x, y), target, "l2").item()

        def checked(img0, img1, n0, n1, target):
            before = loss(torch.clamp(img0 + n0, 0.0, 1.0),
                          torch.clamp(img1 + n1, 0.0, 1.0), target)
            adv = step(img0, img1, n0, n1, target)
            losses.append((before, loss(adv[0], adv[1], target)))
            return adv
        return checked

    universal_perturbation.make_universal_attack_step = make_checked
    try:
        universal_perturbation.main([
            "--synthetic", "2", "--epochs", "1", "--n_step", "3", "--seed",
            "1", "--flow_loss", "l2", "--output_path", str(out)])
    finally:
        universal_perturbation.make_universal_attack_step = make
    res["l2_losses"] = losses
    print("universal CLI, --flow_loss l2: per batch the l2 loss to -flow "
          "before -> after its 3 steps: " + "; ".join(
              f"{u:.4f} -> {v:.4f}" for u, v in losses), flush=True)
    check(len(losses) == 2 and all(v < u for u, v in losses),
          f"universal CLI, l2: the steps did not lower the loss ({losses})")
    shutil.rmtree(out, ignore_errors=True)
    return res


def flownet2_phase(gen) -> tuple:
    """FlowNet2 serving REQUESTS requests of B pairs at HxW through
    ``predict_flow``: 4 ``warp_fwd`` and 1 ``spatial_corr_fwd`` launches a
    request, the flow against the same model with the plain warp and the
    plain correlation, pairs/s over the requests after the first, peak
    memory; then ``warp_fwd`` in border mode at FlowNet2's warp shape
    against its plain version, timed.  Returns (results, the model)."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== FlowNet2 serving, batch {B} at {H}x{W}, f32 ==", flush=True)
    res = {}
    model = fetch_model("FlowNet2", device="cuda", seed=0)
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while serving
    expect = {"warp_fwd": 4, "spatial_corr_fwd": 1}
    flows = []
    LAUNCH_COUNTS.clear()
    for i, (a, b) in enumerate(requests):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(LAUNCH_COUNTS)
        flows.append(predict_flow(model, a, b))
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0) for k in expect}
        check(n == expect, f"FlowNet2 request {i}: launches {n}, not "
                           f"{expect}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res.update({f"launches/{k}": LAUNCH_COUNTS[k] for k in expect})
    for i, flow in enumerate(flows):
        check(tuple(flow.shape) == (B, H, W, 2)
              and bool(torch.isfinite(flow).all()),
              f"FlowNet2 request {i}: flow malformed")
    res["pairs_per_s"] = B * (REQUESTS - 1) / dt
    res["ms_per_request"] = 1e3 * dt / (REQUESTS - 1)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    mag = torch.linalg.vector_norm(flows[0], dim=-1).mean().item()

    model.module.plain_warp = model.module.plain_corr = True
    plain = predict_flow(model, *requests[0])
    model.module.plain_warp = model.module.plain_corr = False
    diff = flows[0] - plain
    rel = (diff.norm() / plain.norm()).item()
    res["rel_l2_vs_plain"] = rel
    res["max_abs_px_vs_plain"] = diff.abs().max().item()
    print(f"FlowNet2: {res['pairs_per_s']:.2f} pairs/s "
          f"({res['ms_per_request']:.1f} ms per request of {B} pairs, "
          f"requests 2-{REQUESTS}); per request warp_fwd 4, "
          f"spatial_corr_fwd 1; mean |flow| {mag:.3f} px; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB; kernels vs plain warp and "
          f"correlation rel L2 {rel:.2e} (bound {FLOWNET2_REL_L2:g}), max "
          f"|dflow| {res['max_abs_px_vs_plain']:.2e} px", flush=True)
    check(rel <= FLOWNET2_REL_L2, "FlowNet2: flow with the kernels beyond "
                                  "bound of the plain versions'")
    del flows, plain, diff, requests

    # B4 in border mode at FlowNet2's warp shape: a smooth flow, f32
    b, c, h, w = WARP_FLOWNET2
    img = torch.rand((b, c, h, w), generator=gen, device="cuda")
    flow = warp_flow(gen, b, h, w, "smooth")
    got = ops.warp_backward(img, flow, "border")
    ref = ops.warp_backward_reference(img, flow, "border")
    err = (got - ref).abs().max().item()
    tol = WARP_F32_REL_TOL * img.abs().max().item()
    check(err <= tol, f"warp_fwd border at {WARP_FLOWNET2}: {err} > {tol}")
    k_ms = graph_ms(lambda: ops.warp_backward(img, flow, "border"), reps=50)
    p_ms = cuda_ms(lambda: ops.warp_backward_reference(img, flow, "border"),
                   reps=10)
    l_ms = graph_ms(grid_sample_call(img, flow, "border"), reps=50)
    res["warp"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                   "library_ms": l_ms,
                   **bound(nbytes(img, flow, got), 8 * b * c * h * w,
                           torch.float32)}
    wb = res["warp"]
    print(f"warp_fwd border {WARP_FLOWNET2} f32: max_abs_err={err:.3e} "
          f"(tol {tol:.1e}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"grid_sample {l_ms:.4f} ms, bound {wb['bound_ms']:.4f} ms "
          f"({wb['bound_by']}; the kernel at "
          f"{100 * wb['bound_ms'] / k_ms:.0f}% of it)", flush=True)
    return res, model


def flownet2_attack_phase(model) -> dict:
    """I-FGSM with the attack CLI's defaults on FlowNet2 (f32) at the
    attack geometry: per step 4 ``warp_fwd``, 1 ``spatial_corr_fwd`` and 1
    ``spatial_corr_bwd``; then one image gradient with the kernels against
    one with the plain warp and correlation; then the attack CLI on
    FlowNet2."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        PerturbConfig,
        flow_attack_loss,
        make_attack,
    )
    from understanding_flow_robustness_tpu_torch.models import (
        predict_flow,
        predict_flow_differentiable,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== I-FGSM on FlowNet2, batch {AB} at {AH}x{AW}, {ATTACK_STEPS} "
          f"steps, eps {ATTACK_EPS}, l2 ==", flush=True)
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(ATTACK_SEED)
    a = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    b = torch.rand((AB, AH, AW, 3), generator=gen, device="cuda")
    flow = predict_flow(model, a, b)
    gt = torch.cat([flow + 1.0, torch.ones_like(flow[..., :1])], -1)

    def predict(x, y):
        return predict_flow_differentiable(model, x, y)

    cfg = PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                        output_norm=ATTACK_EPS, n_step=ATTACK_STEPS)
    make_attack(predict, dataclasses.replace(cfg, n_step=2))(a, b, gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: count the kernels' launches while attacking
    expect = {"warp_fwd": 4 * ATTACK_STEPS,
              "spatial_corr_fwd": ATTACK_STEPS,
              "spatial_corr_bwd": ATTACK_STEPS}
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    n0, n1, adv0, adv1 = make_attack(predict, cfg)(a, b, gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    res.update({f"launches/{k}": v for k, v in n.items()})
    check(n == expect, f"FlowNet2 attack: launches {n}, not {expect}")
    res["ms_per_step"] = 1e3 * dt / ATTACK_STEPS
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    nmax = max(n0.abs().max().item(), n1.abs().max().item())
    check(nmax <= ATTACK_EPS + 1e-6, f"FlowNet2 attack: noise {nmax} outside "
                                     "the eps-ball")
    check(0.0 <= min(adv0.min().item(), adv1.min().item())
          and max(adv0.max().item(), adv1.max().item()) <= 1.0,
          "FlowNet2 attack: adversarial images outside [0, 1]")
    with torch.no_grad():
        before = flow_attack_loss(predict(a, b), gt, "l2").item()
        after = flow_attack_loss(predict(adv0, adv1), gt, "l2").item()
    res["loss_clean"], res["loss_attacked"] = before, after
    print(f"FlowNet2 attack: launches {n}; max|noise|={nmax:.4f}; l2 loss "
          f"{before:.3f} -> {after:.3f}; {res['ms_per_step']:.2f} ms per step "
          f"({ATTACK_STEPS} steps, {1e3 * dt:.0f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    check(after > before, "FlowNet2 attack: the l2 loss did not grow")

    # one image gradient with the kernels, one with the plain warp and
    # correlation (f32, TF32 off)
    grads = []
    for plain in (False, True):
        model.module.plain_warp = model.module.plain_corr = plain
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        loss = flow_attack_loss(predict(x, y), gt, "l2")
        grads.append(torch.autograd.grad(loss, (x, y)))
    model.module.plain_warp = model.module.plain_corr = False
    rels = [((p - q).norm() / q.norm()).item() for p, q in zip(*grads)]
    check(all(bool(torch.isfinite(g).all()) for g in grads[0]),
          "FlowNet2: non-finite image gradient")
    res["image_grad_rel_l2"] = max(rels)
    print(f"f32 FlowNet2: image gradient with the kernels vs plain warp and "
          f"correlation, rel L2 {rels[0]:.3e} / {rels[1]:.3e} (bound "
          f"{FLOWNET2_GRAD_REL_L2:g})", flush=True)
    check(max(rels) <= FLOWNET2_GRAD_REL_L2, "FlowNet2: image gradient with "
          "the kernels beyond bound of the plain versions'")
    del grads
    cli = attack_cli_phase("FlowNet2")
    res.update({f"cli_{k}": v for k, v in cli.items()})
    return res


def corruption_phase() -> dict:
    """The attack CLI's corruption sweep on its default FlowNetC:
    ``--perturb_method gaussian_noise --synthetic 2``, severities 1-5 on
    the host, one ``spatial_corr_fwd`` per forward (the clean, corrupted
    and noise-only flows of each pair), the five results folders."""
    from understanding_flow_robustness_tpu_torch.cli import run_perturb_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== corruption sweep: FlowNetC, gaussian_noise, severities 1-5, "
          "--synthetic 2 ==", flush=True)
    out = PATCH_OUT / "corruption"
    shutil.rmtree(out, ignore_errors=True)
    seen = []
    run = run_perturb_model.run

    def timed_run(predict, samples, cfg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run(predict, samples, cfg)
        torch.cuda.synchronize()
        seen.append((cfg.output_path, r, time.perf_counter() - t))
        return r

    LAUNCH_COUNTS.clear()
    run_perturb_model.run = timed_run
    try:
        run_perturb_model.main(["--perturb_method", "gaussian_noise",
                                "--synthetic", "2", "--output_path",
                                str(out)])
    finally:
        run_perturb_model.run = run
    expect = {"spatial_corr_fwd": 5 * 2 * 3, "spatial_corr_bwd": 0}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"corruption sweep: launches {n}, not {expect}")
    base = out / "kitti2015" / "FlowNetC" / "both" / "gaussian_noise"
    check([Path(p) for p, _, _ in seen] == [base / str(s)
                                             for s in range(1, 6)],
          f"corruption sweep: folders {[p for p, _, _ in seen]}")
    for p, r, _ in seen:
        check((Path(p) / "results0.txt").exists()
              and all(math.isfinite(v[0]) for v in r.values()),
              f"corruption sweep: {p} has no results0.txt or a non-finite "
              "metric")
    l1 = [r["noise0_l1pix"][0] for _, r, _ in seen]
    check(all(u < v for u, v in zip(l1, l1[1:])),
          f"corruption sweep: the noise does not grow with the severity {l1}")
    secs = [t for _, _, t in seen]
    print(f"corruption sweep: launches {n}; results0.txt in 5 folders; "
          "mean |noise| by severity " + ", ".join(f"{v:.4f}" for v in l1)
          + "; epe " + ", ".join(f"{r['flow_epe'][0]:.3f}" for _, r, _ in seen)
          + "; seconds per severity (2 pairs, host corruption included) "
          + ", ".join(f"{t:.2f}" for t in secs), flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return {"launches/spatial_corr_fwd": n["spatial_corr_fwd"],
            "s_per_severity": secs}


def adv_train_phase() -> dict:
    """The train CLI's adversarial training on RAFT (the registry's, mixed
    precision) at the attack geometry, batch 1, ADV_TRAIN_STEPS I-FGSM
    steps and ADV_INNER updates a batch: the launches of the lookup
    kernels (12 a forward or backward, none of ``alt_corr_dcoords``),
    the train step on the doubled batch, finite losses, moved parameters,
    ms per batch."""
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train
    from understanding_flow_robustness_tpu_torch.models import fetch_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import (
        checkpoint,
        trainer,
    )

    print(f"== adversarial train CLI: RAFT, batch {AB} at {AH}x{AW}, "
          f"{ADV_TRAIN_STEPS} I-FGSM steps, {ADV_TRAIN_BATCHES} batches ==",
          flush=True)
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_adv"
    shutil.rmtree(ckpt, ignore_errors=True)
    shapes, stamps, counts = [], [], []
    make_step = trainer.make_train_step

    def spy_step(*a, **k):
        step = make_step(*a, **k)

        def run(batch):
            shapes.append(tuple(batch["image1"].shape))
            out = step(batch)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts.append({k: LAUNCH_COUNTS[k] for k in
                           ("alt_corr_fwd", "alt_corr_bwd",
                            "alt_corr_dcoords")})
            return out
        return run

    argv = ["--model", "RAFT", "--adversarial", "--synthetic",
            str(ADV_TRAIN_BATCHES), "--num_steps",
            str(ADV_TRAIN_BATCHES - 1), "--batch_size", str(AB),
            "--image_size", str(AH), str(AW), "--perturb_n_step",
            str(ADV_TRAIN_STEPS), "--name", "adv", "--checkpoint_dir",
            str(ckpt), "--n_devices", "1"]
    LAUNCH_COUNTS.clear()
    trainer.make_train_step = spy_step
    try:
        out = cli_train.main(argv)
    finally:
        trainer.make_train_step = make_step
    per_batch = (ADV_TRAIN_STEPS + ADV_INNER) * ITERS
    expect = {"alt_corr_fwd": ADV_TRAIN_BATCHES * per_batch,
              "alt_corr_bwd": ADV_TRAIN_BATCHES * per_batch,
              "alt_corr_dcoords": 0}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"adversarial train CLI: launches {n}, not {expect}")
    # per batch: the attack's steps before its first update
    first = counts[ADV_INNER]["alt_corr_fwd"] - counts[ADV_INNER - 1][
        "alt_corr_fwd"]
    check(first == (ADV_TRAIN_STEPS + 1) * ITERS,
          f"adversarial train CLI: {first} alt_corr_fwd launches between "
          "batches, not the attack's and one update's")
    check(out["total_steps"] == ADV_TRAIN_BATCHES
          and len(shapes) == ADV_TRAIN_BATCHES * ADV_INNER
          and all(sh == (2 * AB, AH, AW, 3) for sh in shapes),
          f"adversarial train CLI: {out['total_steps']} batches, train-step "
          f"batches {shapes}")
    check(all(math.isfinite(m["loss"]) for m in out["history"]),
          "adversarial train CLI: non-finite loss")
    init = fetch_model("RAFT", device="cpu", seed=1234).module.state_dict()
    trained = checkpoint.load_weights(str(ckpt / "adv" / "adv.pth"),
                                      fetch_model("RAFT", device="cpu")
                                      .module).state_dict()
    moved = sum(not torch.equal(init[k], trained[k]) for k in init
                if init[k].is_floating_point() and "running" not in k)
    n_params = sum(1 for k in init if init[k].is_floating_point()
                   and "running" not in k)
    # AdamW moves every weight its gradient or its decay reaches; a zero
    # bias with an exactly zero gradient would stay
    check(moved >= 0.9 * n_params, f"adversarial train CLI: {moved} of "
                                   f"{n_params} parameter tensors moved")
    ms = 1e3 * (stamps[2 * ADV_INNER - 1] - stamps[ADV_INNER - 1])
    print(f"adversarial train CLI: launches {n} ({per_batch} of each lookup "
          f"kernel a batch: {ADV_TRAIN_STEPS} attack steps and {ADV_INNER} "
          f"updates of {ITERS} iterations); train step on {shapes[0]}; "
          f"losses " + ", ".join(f"{m['loss']:.3f}" for m in out["history"])
          + f"; {moved} of {n_params} parameter tensors moved; {ms:.1f} ms "
          "for the second batch (attack and 3 updates)", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"launches/alt_corr_fwd": n["alt_corr_fwd"],
            "launches/alt_corr_bwd": n["alt_corr_bwd"], "ms_per_batch": ms}


def encode_png_filtered(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit PNG whose rows cycle through filter types 0-4 (None, Sub,
    Up, Average, Paeth), as an encoder that picks a filter per row writes
    them; the forward filters read the unfiltered neighbours, so numpy
    computes each row at once."""
    img = img if img.ndim == 3 else img[..., None]
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    preds = (np.zeros_like(x), a, b, (a + b) // 2,
             np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc)))
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = np.arange(h) % 5
    for t in range(5):
        rows = raw[:, 0] == t
        raw[rows, 1:] = (x[rows] - preds[t][rows]) % 256

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I4s", len(body), kind) + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(kind))))

    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def kitti_frame(gen, h: int, w: int) -> np.ndarray:
    """A (h, w, 3) u8 frame: smooth random structure plus fine noise, so
    that it compresses like a photograph rather than like white noise."""
    coarse = torch.rand((1, 3, h // 16 + 2, w // 16 + 2), generator=gen,
                        device="cuda")
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic",
                                        align_corners=False)
    x = x + 0.03 * torch.rand((1, 3, h, w), generator=gen, device="cuda")
    return (x.clamp(0, 1) * 255).to(torch.uint8)[0].permute(1, 2, 0).cpu(
        ).numpy()


def io_phase(gen) -> dict:
    """The port's PNG codec at KITTI 2015's resolution on the host: a u8
    RGB frame and a 16-bit flow PNG with a sparse valid mask round-trip bit
    for bit; a frame whose rows cycle through all five filter types decodes
    to its samples; decode and encode ms per frame."""
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio

    print("== PNG codec at 375x1242 ==", flush=True)
    d = DATA_OUT / "io"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    h, w = KITTI_SIZES[0]
    frame = kitti_frame(gen, h, w)
    flow = (torch.randn((h, w, 2), generator=gen, device="cuda") * 30).cpu(
        ).numpy()
    valid = (torch.rand((h, w), generator=gen, device="cuda") < 0.3).float(
        ).cpu().numpy()
    res = {}
    t = time.perf_counter()
    fio.write_image(str(d / "frame.png"), frame)
    res["encode_ms"] = 1e3 * (time.perf_counter() - t)
    fio.write_flow_png(str(d / "flow.png"), flow, valid)
    (d / "filtered.png").write_bytes(encode_png_filtered(frame))
    check(np.array_equal(fio.read_samples(str(d / "frame.png")), frame),
          "PNG: the frame does not round-trip")
    got_flow, got_valid = fio.read_flow_png(str(d / "flow.png"))
    want = (64.0 * flow.astype(np.float64) + 2 ** 15).astype(np.uint16)
    check(np.array_equal(got_flow, (want.astype(np.float32) - 2 ** 15) / 64)
          and np.array_equal(got_valid, valid),
          "PNG: the 16-bit flow and its valid mask do not round-trip")
    check(np.array_equal(fio.read_samples(str(d / "filtered.png")), frame),
          "PNG: the file with filter types 0-4 decodes wrong")
    for name in ("frame", "filtered"):
        fio.read_samples(str(d / f"{name}.png"))  # the library is loaded
        t = time.perf_counter()
        for _ in range(10):
            fio.read_samples(str(d / f"{name}.png"))
        res[f"decode_ms/{name}"] = 100 * (time.perf_counter() - t)
    res["frame_bytes"] = (d / "filtered.png").stat().st_size
    print(f"PNG: frame and sparse 16-bit flow bit-equal after a round trip; "
          f"filter types 0-4 decoded; decode {res['decode_ms/filtered']:.2f} "
          f"ms per 375x1242 frame with filters 0-4 "
          f"({res['frame_bytes'] / 1e6:.2f} MB), "
          f"{res['decode_ms/frame']:.2f} ms with filter 0; encode "
          f"{res['encode_ms']:.2f} ms (host)", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return res


def replicate_pad(x: torch.Tensor, pad: tuple) -> torch.Tensor:
    """Replicate-pad NHWC by (top, bottom, left, right): the scorer's own
    padding, by index clamping on the card, apart from the host padding
    the CLIs use."""
    t, b, l, r = pad
    H, W = x.shape[1:3]
    ys = torch.arange(-t, H + b, device=x.device).clamp(0, H - 1)
    xs = torch.arange(-l, W + r, device=x.device).clamp(0, W - 1)
    return x[:, ys][:, :, xs]


def write_kitti_layout(gen, root: Path, model) -> None:
    """A KITTI 2015 ``training/`` layout of KITTI_SCENES scenes at the four
    KITTI sizes: frames _09/_10/_11 written with filters 0-4, flow_occ = the
    f32 model's own flow plus 2 px of noise on a 40 % valid mask, and
    disp_occ_0.  ``model`` runs with the plain lookup, so the GT's
    forwards launch no kernel."""
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio
    from understanding_flow_robustness_tpu_torch.models import predict_flow
    from understanding_flow_robustness_tpu_torch.ops.interp import (
        compute_pad,
        remove_pad,
    )

    base = root / "training"
    for sub in ("image_2", "flow_occ", "disp_occ_0"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    model.module.plain_lookup = True
    for i in range(KITTI_SCENES):
        h, w = KITTI_SIZES[i % len(KITTI_SIZES)]
        frames = [kitti_frame(gen, h, w) for _ in range(3)]
        for f, img in zip(("09", "10", "11"), frames):
            (base / "image_2" / f"{i:06d}_{f}.png").write_bytes(
                encode_png_filtered(img))
        pad = compute_pad(h, w, mode="kitti")
        a, b = (replicate_pad(torch.from_numpy(x).cuda()[None].float() / 255,
                              pad) for x in frames[1:])
        flow = remove_pad(predict_flow(model, a, b), pad)[0]
        flow = flow + 2.0 * torch.randn(flow.shape, generator=gen,
                                        device="cuda")
        valid = torch.rand((h, w), generator=gen, device="cuda") < 0.4
        fio.write_flow_png(str(base / "flow_occ" / f"{i:06d}_10.png"),
                           flow.cpu().numpy(), valid.float().cpu().numpy())
        fio.write_image(str(base / "disp_occ_0" / f"{i:06d}_10.png"),
                        (torch.rand((h, w), generator=gen, device="cuda")
                         * 20000).to(torch.int32).cpu().numpy().astype(
                             np.uint16))
    model.module.plain_lookup = False


def infer_phase(gen) -> dict:
    """``cli.infer`` serving 8 KITTI-size pairs (375x1242, written with
    filters 0-4) through RAFT-12 (calibrated seeded weights, ``--pretrained``)
    at batch 8 into .flo, 16-bit KITTI PNG and the colour wheel: 12 launches
    of ``alt_corr_fwd`` a batch; every .flo bit-equal to ``predict_flow`` on
    the decoded, padded frames, unpadded, and the 8 flows within
    BF16_REL_EPE_TOL of the plain lookup's on the same batch; every flow PNG
    within 1/64 of round(64 flow) / 64; pairs/s with decode and writing,
    and the model's share of the wall time.  A first run warms the process;
    the second is the one measured and counted."""
    from understanding_flow_robustness_tpu_torch.cli import infer
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.native import (
        batch_u8_to_float01_pad,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.ops.interp import (
        compute_pad,
        remove_pad,
    )
    from understanding_flow_robustness_tpu_torch.training.checkpoint import (
        save_weights,
    )

    h, w = KITTI_SIZES[0]
    print(f"== infer CLI: RAFT-12, 8 pairs at {h}x{w}, batch 8, "
          "--save flo,png,viz ==", flush=True)
    d = DATA_OUT / "infer"
    shutil.rmtree(d, ignore_errors=True)
    (d / "image_2").mkdir(parents=True)
    for i in range(8):
        for f in ("10", "11"):
            (d / "image_2" / f"{i:06d}_{f}.png").write_bytes(
                encode_png_filtered(kitti_frame(gen, h, w)))
    # the serving phase's calibrated point: the wild weights' bf16 flows
    # part from the plain lookup's by more than the 1 % bar (model_phase)
    model = fetch_model("RAFT")
    model.module = scale_flow_head(model.module, 0.05)
    pth = d / "raft12_calibrated.pth"
    save_weights(str(pth), model.module)
    argv = ["--flownet", "RAFT", "--pretrained", str(pth), "--dir",
            str(d / "image_2"), "--batch_size", "8", "--save", "flo,png,viz",
            "--output_dir", str(d / "out")]
    infer.main(argv)
    LAUNCH_COUNTS.clear()
    out = infer.main(argv)
    n = LAUNCH_COUNTS["alt_corr_fwd"]
    check(out["pairs"] == 8 and n == ITERS,
          f"infer CLI: {out['pairs']} pairs, {n} alt_corr_fwd launches, "
          f"not 8 and {ITERS}")
    res = {"launches": n, "pairs_per_s": out["pairs"] / out["seconds"],
           "model_share": out["model_seconds"] / out["seconds"]}
    # the same with .flo alone: what the PNG and colour-wheel writers cost
    flo = infer.main(argv[:-3] + ["flo", "--output_dir", str(d / "flo")])
    res["flo_pairs_per_s"] = flo["pairs"] / flo["seconds"]

    pad = compute_pad(h, w, mode="kitti", multiple=model.size_multiple)
    frames = [np.stack([fio.read_samples(str(d / "image_2" /
                                             f"{i:06d}_{f}.png"))
                        for i in range(8)]) for f in ("10", "11")]
    a, b = (torch.from_numpy(batch_u8_to_float01_pad(
        x, h + pad[0] + pad[1], w + pad[2] + pad[3], pad[0], pad[2])).cuda()
        for x in frames)
    want = remove_pad(predict_flow(model, a, b).float().cpu().numpy(), pad)
    model.module.plain_lookup = True
    plain = remove_pad(predict_flow(model, a, b).float(), pad)
    model.module.plain_lookup = False
    got = torch.from_numpy(np.stack([
        fio.read_flo(str(d / "out" / f"{i:06d}.flo")) for i in range(8)])
        ).cuda()
    mx, rel = flow_stats(got, plain)
    res["vs_plain_max_abs_px"], res["vs_plain_rel_epe"] = mx, rel
    check(rel <= BF16_REL_EPE_TOL,
          f"infer CLI: flows vs the plain lookup's rel EPE {100 * rel:.4f} % "
          f"(max|dflow| {mx:.3e} px), beyond the 1 % bar")
    for i in range(8):
        got = fio.read_flo(str(d / "out" / f"{i:06d}.flo"))
        check(np.array_equal(got, want[i]),
              f"infer CLI: {i:06d}.flo is not predict_flow's flow "
              f"(max diff {np.abs(got - want[i]).max():.3e})")
        png, valid = fio.read_flow_png(str(d / "out" / f"{i:06d}_flow.png"))
        check(bool(valid.all()) and float(np.abs(
            png - np.round(64 * want[i]) / 64).max()) <= 1 / 64,
            f"infer CLI: {i:06d}_flow.png off round(64 flow) / 64")
        check(fio.read_samples(str(d / "out" / f"{i:06d}_viz.png")).shape
              == (h, w, 3), f"infer CLI: {i:06d}_viz.png malformed")
    print(f"infer CLI: 8 pairs, {n} alt_corr_fwd launches ({ITERS} a batch); "
          "every .flo bit-equal to predict_flow, every flow PNG within 1/64; "
          f"vs the plain lookup max|dflow|={mx:.3e} px, rel EPE="
          f"{100 * rel:.4f}% (bar {100 * BF16_REL_EPE_TOL:g}%); "
          f"{res['pairs_per_s']:.2f} pairs/s with decode and writing, the "
          f"model {100 * res['model_share']:.1f} % of the wall time "
          f"({out['seconds']:.3f} s); {res['flo_pairs_per_s']:.2f} pairs/s "
          "with --save flo alone", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return res


def kitti_scores(model, root: Path) -> tuple:
    """KITTI EPE (mean of per-scene means), F1 (% outliers: EPE > 3 px
    and EPE / |gt| > 5 %, over the valid pixels of all scenes) and the
    flows of ``predict_flow`` on each scene's frames replicate-padded on
    their own (kitti mode), computed here from the files."""
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio
    from understanding_flow_robustness_tpu_torch.models import predict_flow
    from understanding_flow_robustness_tpu_torch.ops.interp import (
        compute_pad,
        remove_pad,
    )

    epes, outliers, n_valid, flows = [], 0, 0, []
    base = root / "training"
    for i in range(KITTI_SCENES):
        # / 255 on the host, as the CLI divides: a CUDA division by a
        # Python number multiplies by the reciprocal, one ulp away at times,
        # and 24 iterations carry that to ~2e-4 px
        a, b = (torch.from_numpy(fio.read_samples(
            str(base / "image_2" / f"{i:06d}_{f}.png")).astype(
                np.float32)[None] / 255.0).cuda() for f in ("10", "11"))
        pad = compute_pad(a.shape[1], a.shape[2], mode="kitti")
        flow = remove_pad(predict_flow(model, replicate_pad(a, pad),
                                       replicate_pad(b, pad)), pad)[0]
        flow = flow.float().cpu().numpy()
        flows.append(flow)
        gt, valid = fio.read_flow_png(str(base / "flow_occ" / f"{i:06d}_10.png"))
        epe = np.sqrt(np.sum((flow - gt) ** 2, axis=-1))
        mag = np.sqrt(np.sum(gt ** 2, axis=-1))
        v = valid >= 0.5
        epes.append(epe[v].mean())
        outliers += int(((epe > 3.0) & (epe / np.maximum(mag, 1e-9) > 0.05))
                        [v].sum())
        n_valid += int(v.sum())
    return float(np.mean(epes)), 100 * (outliers / n_valid), flows


def evaluate_phase(gen) -> dict:
    """``cli.evaluate --dataset kitti`` on a written KITTI 2015 training
    layout (8 scenes at the four KITTI sizes, each padded on its own) with
    a seeded, calibrated RAFT ``.pth``: f32, 24 iterations, batch 1; 24
    ``alt_corr_fwd`` launches a scene; its EPE and F1 equal to those
    computed here from ``predict_flow`` on the same files; every scene's
    flow within F32_FLOW_TOL_PX (max abs) of the plain lookup's, which
    holds B1's f32 path at the four KITTI feature maps (47 rows: edge
    tiles); seconds per scene."""
    from understanding_flow_robustness_tpu_torch.cli import evaluate
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import (
        evaluate as ev,
    )
    from understanding_flow_robustness_tpu_torch.training.checkpoint import (
        save_weights,
    )

    print(f"== evaluate CLI: RAFT f32, {EVAL_ITERS} iterations, KITTI 2015 "
          f"layout of {KITTI_SCENES} scenes at {KITTI_SIZES} ==", flush=True)
    root = DATA_OUT / "kitti"
    shutil.rmtree(root, ignore_errors=True)
    model = fetch_model("RAFT", mixed_precision=False, iters=EVAL_ITERS)
    model.module = scale_flow_head(model.module, 0.05)
    pth = DATA_OUT / "raft_calibrated.pth"
    save_weights(str(pth), model.module)
    write_kitti_layout(gen, root, model)

    argv = ["--model", str(pth), "--dataset", "kitti", "--data_roots",
            json.dumps({"kitti": str(root)})]
    seconds = []
    validate = ev.validate_kitti

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = validate(*a, **k)
        seconds.append(time.perf_counter() - t)
        return out

    ev.validate_kitti = timed
    try:
        LAUNCH_COUNTS.clear()
        with recording(ev, "_predict_padded") as cli_flows:
            got = evaluate.main(argv)
        n = LAUNCH_COUNTS["alt_corr_fwd"]
    finally:
        ev.validate_kitti = validate
    check(n == EVAL_ITERS * KITTI_SCENES,
          f"evaluate CLI: {n} alt_corr_fwd launches, not "
          f"{EVAL_ITERS} x {KITTI_SCENES}")
    epe, f1, flows = kitti_scores(model, root)
    diffs = [float(np.abs(a[0] - b).max()) for a, b in zip(cli_flows, flows)]
    check(got == {"kitti-epe": epe, "kitti-f1": f1},
          f"evaluate CLI: EPE/F1 {got} are not predict_flow's "
          f"{epe!r}/{f1!r}; max |dflow| a scene {diffs}")
    model.module.plain_lookup = True
    plain_epe, plain_f1, plain_flows = kitti_scores(model, root)
    vs_plain = [float(np.abs(a - b).max()) for a, b in zip(flows, plain_flows)]
    check(max(vs_plain) <= F32_FLOW_TOL_PX,
          f"evaluate: max|dflow| a scene, kernel vs plain lookup, {vs_plain} "
          f"px, beyond {F32_FLOW_TOL_PX}")
    res = {"launches": n, "epe": epe, "f1": f1, "plain_epe": plain_epe,
           "plain_f1": plain_f1, "vs_plain_max_abs_px": max(vs_plain),
           "s_per_scene": seconds[0] / KITTI_SCENES}
    print(f"evaluate CLI: EPE {epe:.4f} F1 {f1:.3f} %, equal to the phase's "
          f"own from predict_flow; plain lookup EPE {plain_epe:.4f} F1 "
          f"{plain_f1:.3f} %; kernel vs plain lookup max|dflow| "
          f"{max(vs_plain):.3e} px over the {KITTI_SCENES} scenes (tol "
          f"{F32_FLOW_TOL_PX}); {n} alt_corr_fwd launches; "
          f"{res['s_per_scene']:.3f} s per scene (validate_kitti: decode, "
          "pad, RAFT, metrics)", flush=True)
    return res


def dataset_attack_phase() -> dict:
    """The dataset branches on the KITTI layout of ``evaluate_phase``:
    ``run_perturb_model`` on a ``kitti_scene_flow_train_*.txt`` list of 2
    pairs (FlowNetC I-FGSM, 3 steps, 256x640 with the sparse-aware GT), and
    ``test_patch --valset kitti2015`` on scenes 1 and 2 (384x1280, a 100 px
    patch); both correlation kernels' launches."""
    from understanding_flow_robustness_tpu_torch.cli import (
        run_perturb_model,
        test_patch,
    )
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== the dataset branches: run_perturb_model on 2 KITTI pairs, "
          "test_patch on 2 KITTI scenes (FlowNetC) ==", flush=True)
    root = DATA_OUT / "kitti"
    lists = DATA_OUT / "lists"
    lists.mkdir(parents=True, exist_ok=True)
    for name, sub, f in (("image0", "image_2", "_10"),
                         ("image1", "image_2", "_11"),
                         ("flow", "flow_occ", "_10")):
        fio.write_paths(str(lists / f"kitti_scene_flow_train_{name}.txt"),
                        [str(root / "training" / sub / f"{i:06d}{f}.png")
                         for i in range(2)])
    out = DATA_OUT / "attack"
    LAUNCH_COUNTS.clear()
    res = run_perturb_model.main(["--data_list_dir", str(lists),
                                  "--perturb_method", "ifgsm", "--n_step",
                                  "3", "--output_path", str(out)])
    # per pair: the clean, adversarial and noise-only forwards and 3 steps
    expect = {"spatial_corr_fwd": 2 * (3 + 3), "spatial_corr_bwd": 2 * 3}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"attack CLI on KITTI pairs: launches {n}, not "
          f"{expect}")
    check(all(math.isfinite(v[0]) for v in res.values())
          and (out / "kitti2015" / "FlowNetC" / "both" / "ifgsm_l2" / "0.02"
               / "results0.txt").exists(),
          f"attack CLI on KITTI pairs: {res}")
    print(f"attack CLI on 2 KITTI pairs: launches {n}; epe "
          f"{res['flow_epe_origin'][0]:.3f} -> {res['flow_epe'][0]:.3f} "
          "against the full-resolution GT", flush=True)
    patch = DATA_OUT / "patch.npy"
    np.save(patch, np.random.RandomState(PATCH_SEED).rand(1, 100, 100, 3)
            .astype(np.float32))
    avgs = []
    for example in (1, 2):
        LAUNCH_COUNTS.clear()
        avgs.append(test_patch.main([
            "--patch_path", str(patch), "--valset", "kitti2015",
            "--kitti-dir", str(root), "--example", str(example), "--no_viz",
            "--output", str(out)]))
        k = LAUNCH_COUNTS["spatial_corr_fwd"]
        check(k == 2 and all(math.isfinite(v) for v in avgs[-1]),
              f"test_patch on KITTI scene {example}: {k} launches, "
              f"{avgs[-1]}")
        n["spatial_corr_fwd"] += k
    print(f"test_patch on KITTI scenes 1 and 2 at 384x1280: 2 launches of "
          f"spatial_corr_fwd each; epe/adv_epe {avgs[0][0]:.3f}/"
          f"{avgs[0][1]:.3f} and {avgs[1][0]:.3f}/{avgs[1][1]:.3f}",
          flush=True)
    shutil.rmtree(DATA_OUT, ignore_errors=True)
    return {"launches/" + k: v for k, v in n.items()}


FILES_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_files"
CHAIRS_PAIRS, CHAIRS_SIZE = 16, (384, 512)
LOADER_WORKERS = 4
LOADER_REPEAT = 4        # the KITTI tree's 8 scenes, 4 times: 32 samples
FILES_STEPS, FILES_VAL_FREQ = 6, 3   # --stage kitti: batches, validations
CHAIRS_BATCH = 6         # the train CLI's default batch, at 256x640
# the train CLI's rate from files: RATE_STEPS batches at the bench's
# geometry, one epoch of a KITTI tree grown to RATE_STEPS * TB scenes (the
# written ones, copied), so that only the first batch starts the loader
RATE_STEPS = 20
SUB64 = (2, 56, 88)      # RAFT below 64 px: H/8 = 7, levels 7, 3, 1, 0 rows


def jpeg_phase() -> dict:
    """The host library's JPEG decoder on the committed KITTI-raw fixtures
    (375x1242, 4:2:0, quality 75): each frame's samples against the sha256
    of PIL's decode recorded beside them; host ms per frame."""
    import hashlib

    from understanding_flow_robustness_tpu_torch import native
    from understanding_flow_robustness_tpu_torch.data import fixtures_dir

    root = Path(fixtures_dir("kitti_raw_jpeg"))
    hashes = json.loads((root / "decoded_sha256.json").read_text())
    print(f"== JPEG: {len(hashes)} fixture frames ==", flush=True)
    times = []
    for rel, want in sorted(hashes.items()):
        data = (root / rel).read_bytes()
        img = native.decode_jpeg(data)
        check(img.shape == (375, 1242, 3)
              and hashlib.sha256(img.tobytes()).hexdigest() == want,
              f"JPEG {rel}: {img.shape}, not PIL's decode")
        for _ in range(5):
            t = time.perf_counter()
            native.decode_jpeg(data)
            times.append(time.perf_counter() - t)
    ms = 1e3 * float(np.median(times))
    print(f"JPEG: {len(hashes)} frames equal PIL's decode (sha256); "
          f"{ms:.2f} ms per 375x1242 frame on the host (median of "
          f"{len(times)})", flush=True)
    return {"decode_ms": ms, "frames": len(hashes)}


def write_chairs_tree(gen, root: Path) -> None:
    """FlyingChairs' layout under root: CHAIRS_PAIRS pairs of .ppm frames and
    a .flo each, and ``datasets/chairs_split.txt`` (all training) where the
    datasets read it, relative to the working directory."""
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio

    data = root / "datasets" / "FlyingChairs_release" / "data"
    data.mkdir(parents=True, exist_ok=True)
    h, w = CHAIRS_SIZE
    for i in range(CHAIRS_PAIRS):
        for k in (1, 2):
            fio.write_image(str(data / f"{i + 1:05d}_img{k}.ppm"),
                            kitti_frame(gen, h, w))
        flow = 4.0 * torch.randn((h, w, 2), generator=gen, device="cuda")
        fio.write_flo(str(data / f"{i + 1:05d}_flow.flo"), flow.cpu().numpy())
    (root / "datasets" / "chairs_split.txt").write_text(
        "1\n" * CHAIRS_PAIRS)


def loader_phase(gen, tres) -> dict:
    """Writes the trees the files phases read -- FlyingChairs (CHAIRS_PAIRS
    pairs at 384x512) and a KITTI 2015 training layout (write_kitti_layout)
    under FILES_OUT/datasets -- then times the host's training data path:
    one pass at num_workers=0 split into decode, colour jitter, spatial
    transform (resize, flips, crop) and collate; samples/s of the
    DataLoader at LOADER_WORKERS threads, against what phase 8's synthetic
    train step consumes."""
    from understanding_flow_robustness_tpu_torch.data import (
        DataLoader,
        Subset,
        augmentor,
        fetch_dataset,
    )
    from understanding_flow_robustness_tpu_torch.data import loader as dl
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio
    from understanding_flow_robustness_tpu_torch.models import fetch_model

    print(f"== training data path: FlyingChairs {CHAIRS_PAIRS} pairs at "
          f"{CHAIRS_SIZE}, KITTI 2015 {KITTI_SCENES} scenes at {KITTI_SIZES}"
          f", DataLoader({LOADER_WORKERS} workers) ==", flush=True)
    shutil.rmtree(FILES_OUT, ignore_errors=True)
    write_chairs_tree(gen, FILES_OUT)
    model = fetch_model("RAFT", mixed_precision=False, iters=ITERS)
    write_kitti_layout(gen, FILES_OUT / "datasets" / "KITTI" / "2015", model)
    del model

    timers = {}

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            timers[key] = timers.get(key, 0.0) + time.perf_counter() - t
            return out
        return fn, wrapped

    res = {}
    # the train runs' geometries: chairs at the CLI's defaults, KITTI at
    # the JAX bench's
    stages = (("chairs", (256, 640), CHAIRS_BATCH), ("kitti", (TH, TW), TB))
    with contextlib.chdir(FILES_OUT):
        for stage, size, batch in stages:
            ds = fetch_dataset(stage, size)
            n = len(ds)
            patches = [
                (fio, "read_gen", "decode"), (fio, "read_flow_png", "decode"),
                (augmentor.ColorJitter, "__call__", "jitter"),
                (augmentor.FlowAugmentor, "spatial_transform", "spatial"),
                (augmentor.SparseFlowAugmentor, "spatial_transform",
                 "spatial"),
                (dl.DataLoader, "_collate", "collate")]
            saved = []
            timers.clear()
            for owner, name, key in patches:
                fn, wrapped = timed(owner, name, key)
                saved.append((owner, name, fn))
                setattr(owner, name, wrapped)
            try:
                t = time.perf_counter()
                seen = sum(b["image1"].shape[0] for b in DataLoader(
                    ds, batch_size=1, num_workers=0, seed=1))
                total = time.perf_counter() - t
            finally:
                for owner, name, fn in saved:
                    setattr(owner, name, fn)
            check(seen == n, f"{stage}: {seen} of {n} samples loaded")
            split = {k: 1e3 * v / n for k, v in timers.items()}
            split["total"] = 1e3 * total / n
            rep = Subset(ds, list(range(n)) * LOADER_REPEAT)
            loader = DataLoader(rep, batch_size=batch,
                                num_workers=LOADER_WORKERS, seed=2)
            t = time.perf_counter()
            shapes = [b["image1"].shape for b in loader]
            dt = time.perf_counter() - t
            count = sum(s[0] for s in shapes)
            check(count == len(loader) * batch and all(
                s == (batch, *size, 3) for s in shapes),
                f"{stage} loader: batches {shapes}")
            sps = count / dt
            res[stage] = {"samples_per_s": sps, "ms_per_sample": split}
            print(f"{stage} at {size}: one thread, ms per sample "
                  + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                  + f"; DataLoader({LOADER_WORKERS} workers, batch {batch}) "
                  f"{sps:.1f} samples/s over {count} samples; the synthetic "
                  f"train step (phase 8) takes {tres['frames_per_s']:.1f} "
                  f"frames/s: the loader "
                  + ("outruns it" if sps > tres["frames_per_s"] else
                     "does NOT keep up"), flush=True)
    return res


def _spy_train_steps(trainer, stamps, counts):
    """Wraps ``trainer.make_train_step`` so each step records when it ended
    and the lookup kernels' launch counts then; returns the original."""
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    make_step = trainer.make_train_step

    def spy(*a, **k):
        step = make_step(*a, **k)

        def run(batch):
            out = step(batch)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            counts.append({k: LAUNCH_COUNTS[k] for k in
                           ("alt_corr_fwd", "alt_corr_bwd")})
            return out
        return run
    trainer.make_train_step = spy
    return make_step


def train_files_phase(tres) -> dict:
    """The train CLI from the files loader_phase wrote, run from their
    parent directory (chairs' split file and --validation's default roots
    are relative to it): ``--stage kitti`` at the JAX bench's geometry
    (batch 4, 288x960, mixed precision) for FILES_STEPS batches with
    ``--validation kitti`` every FILES_VAL_FREQ; ``--stage chairs`` at the
    CLI's defaults for 2 batches; ``--stage kitti2015 --adversarial`` on 2
    KITTI pairs of written path lists (batch 1, 256x640, 3 attack steps);
    ``--stage kitti`` again, without validation, for RATE_STEPS batches
    of one epoch.  B1 and B2 launch 12 times per forward or backward: per
    step or update, per attack step, and B1 per validation scene; losses
    finite.  The last run's frames/s with the loader -- batches 2..N over
    the wall time from the end of the first to the end of the last --
    against phase 8's synthetic train step; the median time between two
    batches' ends (validation excluded) of every run."""
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import (
        evaluate as ev,
    )
    from understanding_flow_robustness_tpu_torch.training import trainer

    ckpt = FILES_OUT / "checkpoints"
    lists = FILES_OUT / "lists"
    lists.mkdir(parents=True, exist_ok=True)
    base = FILES_OUT / "datasets" / "KITTI" / "2015" / "training"
    for name, sub, f in (("image0", "image_2", "_10"),
                         ("image1", "image_2", "_11"),
                         ("flow", "flow_occ", "_10")):
        fio.write_paths(str(lists / f"kitti_scene_flow_train_{name}.txt"),
                        [str(base / sub / f"{i:06d}{f}.png")
                         for i in range(ADV_TRAIN_BATCHES)])
    vals = []
    validate = ev.validate_kitti

    def timed_validate(*a, **k):
        t = time.perf_counter()
        out = validate(*a, **k)
        torch.cuda.synchronize()
        vals.append((t, time.perf_counter(), out))
        return out

    runs = (
        ("kitti", TB, ["--stage", "kitti", "--image_size", str(TH), str(TW),
                       "--batch_size", str(TB), "--mixed_precision",
                       "--num_steps", str(FILES_STEPS - 1), "--validation",
                       "kitti", "--val_freq", str(FILES_VAL_FREQ)], 1),
        ("chairs", 6, ["--stage", "chairs", "--num_steps", "1"], 1),
        ("kitti2015", 1, ["--stage", "kitti2015", "--adversarial",
                          "--batch_size", "1", "--image_size", str(AH),
                          str(AW), "--num_steps",
                          str(ADV_TRAIN_BATCHES - 1), "--perturb_n_step",
                          str(ADV_TRAIN_STEPS), "--data_list_dir",
                          str(lists)], ADV_INNER),
        ("kitti_rate", TB, ["--stage", "kitti", "--image_size", str(TH),
                            str(TW), "--batch_size", str(TB),
                            "--mixed_precision", "--num_steps",
                            str(RATE_STEPS - 1)], 1))
    res = {"launches/alt_corr_fwd": 0, "launches/alt_corr_bwd": 0}
    for name, batch, argv, inner in runs:
        if name == "kitti_rate":  # grow the tree to one epoch of the run
            for i in range(KITTI_SCENES, RATE_STEPS * TB):
                for sub, f in (("image_2", "_10"), ("image_2", "_11"),
                               ("flow_occ", "_10")):
                    shutil.copyfile(
                        base / sub / f"{i % KITTI_SCENES:06d}{f}.png",
                        base / sub / f"{i:06d}{f}.png")
        print(f"== train CLI from files: {' '.join(argv)} ==", flush=True)
        stamps, counts = [], []
        vals.clear()
        LAUNCH_COUNTS.clear()
        make_step = _spy_train_steps(trainer, stamps, counts)
        ev.validate_kitti = timed_validate
        try:
            with contextlib.chdir(FILES_OUT):
                out = cli_train.main(argv + [
                    "--checkpoint_dir", str(ckpt), "--name", name,
                    "--n_devices", "1"])
        finally:
            trainer.make_train_step = make_step
            ev.validate_kitti = validate
        steps = out["total_steps"]
        attack = ADV_TRAIN_STEPS if "--adversarial" in argv else 0
        scenes = KITTI_SCENES * len(vals)
        expect = {"alt_corr_fwd": ITERS * (steps * (inner + attack) + scenes),
                  "alt_corr_bwd": ITERS * steps * (inner + attack)}
        n = {k: LAUNCH_COUNTS[k] for k in expect}
        check(n == expect, f"train CLI --stage {name}: launches {n}, not "
                           f"{expect}")
        want_vals = (FILES_STEPS // FILES_VAL_FREQ if name == "kitti" else 0)
        check(len(vals) == want_vals and all(
            math.isfinite(v) for _, _, r in vals for v in r.values()),
            f"train CLI --stage {name}: validations {vals}")
        losses = [m["loss"] for m in out["history"]]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"train CLI --stage {name}: losses {losses}")
        for k in expect:
            res[f"launches/{k}"] += n[k]
        # the ends of the batches' last updates; the median time between
        # two, validation excluded, after the first batch
        ends = stamps[inner - 1::inner]
        gaps = []
        for a, b in zip(ends, ends[1:]):
            gaps.append(b - a - sum(t1 - t0 for t0, t1, _ in vals
                                    if a <= t0 < b))
        ms = 1e3 * float(np.median(gaps))
        res[name] = {"median_ms_per_batch": ms, "losses": losses}
        line = (f"train CLI --stage {name}: {steps} batches of {batch}, "
                f"launches {n}; losses " + " ".join(f"{x:.3f}" for x in losses)
                + f"; median {ms:.1f} ms between two batches' ends")
        if name == "kitti_rate":
            fps = (len(ends) - 1) * batch / (ends[-1] - ends[0])
            res[name]["frames_per_s"] = fps
            line += (f"; {fps:.2f} frames/s with the loader over batches 2.."
                     f"{len(ends)} (synthetic train step, phase 8: "
                     f"{tres['frames_per_s']:.2f} frames/s at batch {TB}, "
                     f"{TH}x{TW})")
        if vals:
            line += (f"; validation at steps {FILES_VAL_FREQ - 1} and "
                     f"{2 * FILES_VAL_FREQ - 1}: " + ", ".join(
                         f"epe {r['kitti-epe']:.2f} f1 {r['kitti-f1']:.1f}"
                         for _, _, r in vals))
        print(line, flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return res


def chairs_lookup_phase() -> tuple:
    """B1 and B2 against their plain versions at the feature shape
    ``--stage chairs`` gives them at the train CLI's defaults (batch
    CHAIRS_BATCH at 256x640: (6, 32, 80, 256)), f32 and bf16, with
    calibrated, wild, edge and smooth centres, from a generator of this
    phase's own."""
    gen = torch.Generator(device="cuda").manual_seed(PATCH_SEED + 2)
    shape = (CHAIRS_BATCH, 256 // 8, 640 // 8, 256)
    return (kernel_phase(gen, shape, main="chairs", ragged=False),
            backward_phase(gen, shape, more=(), main="chairs", ragged=False))


@contextlib.contextmanager
def valset_cut_to(n: int):
    """``data.get_evaluation_set`` cut to the n scenes the phase wrote (of
    KITTI's 200), as the CLIs' tests cut it."""
    from understanding_flow_robustness_tpu_torch import data

    fn = data.get_evaluation_set

    def cut(valset, args):
        ds = fn(valset, args)
        ds.N = n
        return ds
    data.get_evaluation_set = cut
    try:
        yield
    finally:
        data.get_evaluation_set = fn


def patch_files_phase() -> dict:
    """The patch CLI (FlowNetC) for one epoch of SequenceFolder training on
    the committed JPEG fixtures (a 256 px crop: --patch-size 0.3) with the
    KITTI 2015 valset loader_phase wrote, at 384x1280; then again from a
    patch and a mask in PNG files the phase writes.  The universal CLI for
    one epoch from the same fixtures (256x640) with its valset sweep.
    Launches of both correlation kernels, the files and metrics each CLI
    writes."""
    from understanding_flow_robustness_tpu_torch.cli import (
        patch_attack as cli_patch,
    )
    from understanding_flow_robustness_tpu_torch.cli import (
        universal_perturbation,
    )
    from understanding_flow_robustness_tpu_torch.data import fixtures_dir
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    fixture = fixtures_dir("kitti_raw_jpeg")
    kitti = str(FILES_OUT / "datasets" / "KITTI" / "2015")
    out = FILES_OUT / "attacks"
    rng = np.random.RandomState(PATCH_SEED)
    png = str(FILES_OUT / "patch.png")
    mask_png = str(FILES_OUT / "mask.png")
    fio.write_image(png, (rng.rand(120, 120, 3) * 255).astype(np.uint8))
    fio.write_image(mask_png, np.full((120, 120, 3), 255, np.uint8))
    res = {"launches/spatial_corr_fwd": 0, "launches/spatial_corr_bwd": 0}
    for name, extra, side in (
            ("run", ["--patch-size", "0.3", "--log-output"], 115),
            ("from_png", ["--patch-size", "0.05", "--patch-path", png,
                          "--mask-path", mask_png], 85)):
        print(f"== patch CLI from files: FlowNetC, SequenceFolder fixtures, "
              f"KITTI valset of {KITTI_SCENES} scenes, {' '.join(extra)} ==",
              flush=True)
        LAUNCH_COUNTS.clear()
        t0 = time.perf_counter()
        with recording(cli_patch, "make_patch_attack_step", True) as steps, \
                recording(cli_patch, "validate_patch") as metrics, \
                valset_cut_to(KITTI_SCENES):
            patch, mask = cli_patch.main([
                "--flownet", "FlowNetC", "--data", fixture, "--kitti-data",
                kitti, "--epochs", "1", "--max-count", "2", "--output",
                str(out), "--name", name] + extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = [r[4] for r, _ in steps]
        # per train sample a clean forward and its inner iterations; per
        # validation scene a clean and an adversarial forward
        expect = {"spatial_corr_fwd": len(counts) + sum(counts)
                  + 2 * KITTI_SCENES, "spatial_corr_bwd": sum(counts)}
        n = {k: LAUNCH_COUNTS[k] for k in expect}
        check(len(counts) == 2 and n == expect,
              f"patch CLI {name}: {len(counts)} samples of {counts} "
              f"iterations, launches {n}, not {expect}")
        files = ["args.json", "patches/epoch_0.npy"] + (
            ["patches/epoch_0.png"] if "--log-output" in extra else [])
        check(all((out / name / f).exists() for f in files)
              and patch.shape == mask.shape == (1, side, side, 3)
              and np.load(out / name / "patches" / "epoch_0.npy").shape
              == patch.shape,
              f"patch CLI {name}: files {files}, patch {patch.shape}")
        check(len(metrics) == 1 and all(math.isfinite(v) for v in
                                        metrics[0].values()),
              f"patch CLI {name}: validation metrics {metrics}")
        for k in expect:
            res[f"launches/{k}"] += n[k]
        m = metrics[0]
        print(f"patch CLI {name}: 2 samples of {counts} inner iterations, "
              f"launches {n}; {', '.join(files)}; KITTI valset epe "
              f"{m['epe']:.3f} adv_epe {m['adv_epe']:.3f} cos_sim "
              f"{m['cos_sim']:.3f} adv_cos_sim {m['adv_cos_sim']:.3f}; "
              f"{dt:.1f} s", flush=True)

    print(f"== universal CLI from files: FlowNetC, SequenceFolder fixtures, "
          f"KITTI valset of {KITTI_SCENES} scenes ==", flush=True)
    epes = []
    compute_epe = universal_perturbation.compute_epe

    def recorded_epe(gt, flow):
        epes.append(float(compute_epe(gt, flow)))
        return compute_epe(gt, flow)
    LAUNCH_COUNTS.clear()
    universal_perturbation.compute_epe = recorded_epe
    try:
        with valset_cut_to(KITTI_SCENES):
            n0, n1 = universal_perturbation.main([
                "--data", fixture, "--kitti_dir", kitti, "--epochs", "1",
                "--n_step", "3", "--seed", "1", "--output_path", str(out)])
    finally:
        universal_perturbation.compute_epe = compute_epe
    # per train sample a clean forward and 3 steps; per scene 2 forwards
    expect = {"spatial_corr_fwd": 2 * (1 + 3) + 2 * KITTI_SCENES,
              "spatial_corr_bwd": 2 * 3}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(n == expect, f"universal CLI from files: launches {n}, not "
                       f"{expect}")
    snap = (out / "kitti2015" / "FlowNetC" / "universal" / "both"
            / "ifgsm_cossim" / "0.02" / "0.002_3_1" / "perturbations"
            / "epoch_0.npy")
    nmax = max(np.abs(n0).max(), np.abs(n1).max())
    check(snap.exists() and np.load(snap).shape == (1, 2, 256, 640, 3)
          and 0 < nmax <= 0.02 + 1e-6
          and len(epes) == 2 * KITTI_SCENES and all(map(math.isfinite, epes)),
          f"universal CLI from files: snapshot {snap.exists()}, max|noise| "
          f"{nmax}, valset EPEs {epes}")
    for k in expect:
        res[f"launches/{k}"] += n[k]
    print(f"universal CLI from files: launches {n}; max|noise| {nmax:.4f}; "
          f"perturbations/epoch_0.npy (1, 2, 256, 640, 3); valset sweep "
          f"mean epe {np.mean(epes[0::2]):.3f} clean, "
          f"{np.mean(epes[1::2]):.3f} adversarial", flush=True)
    shutil.rmtree(FILES_OUT, ignore_errors=True)
    return res


def sub64_phase(gen) -> dict:
    """RAFT (f32, seeded weights, calibrated as in evaluate_phase) on 56x88
    frames, whose fourth pyramid level is empty: the kernels (alt path: B1;
    volume path: B5) against the plain lookup within F32_FLOW_TOL_PX; then
    the lookups (B1 and its backward B2, B5) on levels that include the
    empty one, against their plain versions, and the wrappers refusing
    that level."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import (
        LAUNCH_COUNTS,
        correlation,
    )

    b, h, w = SUB64
    print(f"== RAFT below 64 px: batch {b} at {h}x{w}, f32 ==", flush=True)
    img1 = torch.rand((b, h, w, 3), generator=gen, device="cuda")
    img2 = torch.roll(img1, 2, dims=2)
    res = {}
    for impl, kernel in (("alt", "alt_corr_fwd"),
                         ("volume", "corr_lookup_fwd")):
        model = fetch_model("RAFT", mixed_precision=False, iters=ITERS,
                            corr_impl=impl)
        # raw init iterates at ~100 px, where 12 f32 iterations amplify a
        # summation order's ulps; a trained checkpoint's 5-40 px do not
        model.module = scale_flow_head(model.module, 0.05)
        LAUNCH_COUNTS.clear()
        flow = predict_flow(model, img1, img2)
        n = LAUNCH_COUNTS[kernel]
        model.module.plain_lookup = True
        plain = predict_flow(model, img1, img2)
        mx = float((flow - plain).abs().max())
        check(n == ITERS and flow.shape == (b, h, w, 2)
              and bool(torch.isfinite(flow).all()) and mx <= F32_FLOW_TOL_PX,
              f"RAFT {impl} at {h}x{w}: {n} launches of {kernel}, max|dflow| "
              f"{mx:.3e}")
        res[f"launches/{kernel}"] = n
        res[f"{impl}/max_abs_flow"] = mx
        print(f"RAFT {impl} path at {h}x{w}: {n} launches of {kernel}; "
              f"max|dflow| {mx:.3e} px against the plain lookup (tol "
              f"{F32_FLOW_TOL_PX}); mean|flow| {float(flow.abs().mean()):.3f}",
              flush=True)
        del model
    # the lookups on levels that include the empty one, against the
    # plain versions: the kernels read the three live levels
    f1 = torch.randn((b, (h // 8) * (w // 8), 256), generator=gen,
                     device="cuda") / 16
    fmap2 = torch.randn((b, h // 8, w // 8, 256), generator=gen,
                        device="cuda")
    levels = correlation.pool_fmap_levels(fmap2, 4)
    check(levels[3].shape[1] == 0, f"levels {[l.shape for l in levels]}")
    coords = (torch.rand((b, f1.shape[1], 2), generator=gen, device="cuda")
              * torch.tensor([w // 8, h // 8], device="cuda"))
    LAUNCH_COUNTS.clear()
    got = correlation.alt_corr_lookup(f1, levels, coords, 4)
    ref = correlation.alt_corr_lookup_reference(f1, levels, coords, 4)
    e_fwd = float((got - ref).abs().max())
    g = torch.randn(got.shape, generator=gen, device="cuda")
    ins = [t.clone().requires_grad_() for t in (f1, *levels)]
    df1, *dl = torch.autograd.grad(
        correlation.alt_corr_lookup(ins[0], ins[1:], coords, 4), ins, g)
    rf1, rl = correlation.alt_corr_lookup_backward_reference(f1, levels,
                                                             coords, g, 4)
    e_bwd = max(float((df1 - rf1).abs().max()), *[
        float((a - r).abs().max()) if a.numel() else 0.0
        for a, r in zip(dl, rl)])
    fmap1 = torch.randn(fmap2.shape, generator=gen, device="cuda")
    pyramid = correlation.volume_pyramid(fmap1, fmap2, 4)
    c4 = coords.reshape(b, h // 8, w // 8, 2)
    got_v = correlation.corr_lookup(pyramid, c4, 4)
    ref_v = correlation.corr_lookup_reference(pyramid, c4, 4)
    e_vol = float((got_v - ref_v).abs().max())
    n = {k: LAUNCH_COUNTS[k] for k in ("alt_corr_fwd", "alt_corr_bwd",
                                       "corr_lookup_fwd")}
    check(n == {"alt_corr_fwd": 2, "alt_corr_bwd": 1, "corr_lookup_fwd": 1}
          and dl[3].shape == levels[3].shape
          and got[..., 3 * 81:].abs().max() == 0
          and got_v[..., 3 * 81:].abs().max() == 0 and e_fwd <= VOL_TOL
          and e_vol <= VOL_TOL and e_bwd <= 1e-4,
          f"empty level: launches {n}, fwd {e_fwd:.3e}, bwd {e_bwd:.3e}, "
          f"volume {e_vol:.3e}")
    # a wrapper passed the empty level refuses it, launching nothing
    vol = [p.reshape(b * f1.shape[1], *p.shape[2:]) for p in pyramid]
    refused = 0
    for call in (
            lambda: correlation._alt_corr_lookup_cuda(f1, levels, coords, 4),
            lambda: correlation._alt_corr_bwd_cuda(f1, levels, coords, g, 4),
            lambda: correlation.corr_lookup_fwd(vol, coords.reshape(-1, 2))):
        try:
            call()
        except ValueError:
            refused += 1
    check(refused == 3 and n == {k: LAUNCH_COUNTS[k] for k in n},
          f"the wrappers took an empty level ({refused} of 3 refused)")
    print(f"empty fourth level: alt_corr_fwd max abs err {e_fwd:.3e}, "
          f"alt_corr_bwd {e_bwd:.3e}, corr_lookup_fwd {e_vol:.3e} against "
          "the plain versions; the level's taps are zeros; the wrappers "
          "refuse the empty level", flush=True)
    return res


# --- the patch analyses and the training of the other families ------------

ANALYSIS_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_analyses"
# the moving patch: the bench's 100 px patch swept with stride 100 over a
# 384x1280 frame: rows range(0, 284, 100) x columns range(0, 1180, 100),
# 3 x 12 locations, each one RAFT forward beside the clean one
MOVING_PATCH = MOVING_STRIDE = 100
MOVING_GRID = (3, 12)
# feature replacement on FlowNetC: 2 samples, every subset of three keys
REPLACE_SAMPLES = 2
REPLACE_KEYS = ("corr", "conv_redir", "conv3_1")
EMBED_SAMPLES = 8
# embeddings: per model the taps whose channel means are compared
EMBED_KEYS = {"FlowNetC": ("conv3a", "corr", "conv_redir", "conv3_1"),
              "PWCNet": ("c13", "corr6", "corr3", "conv2_4", "dc_conv6")}
# the train CLI on each family it now trains, at its defaults (batch 6 at
# 256x640, JAX cli/train.py:48-49; FlowNet2, 162M parameters, at batch 2):
# (ID, batch, launches of each kernel a train step)
FAMILY_TRAIN = (
    ("FlowNetS", 6, {}),
    ("FlowNetC", 6, {"spatial_corr_fwd": 1, "spatial_corr_bwd": 1}),
    ("FlowNetCFlexLarger_k3_reps3", 6,
     {"spatial_corr_fwd": 1, "spatial_corr_bwd": 1}),
    ("PWCNet", 6, {"spatial_corr_fwd": 5, "spatial_corr_bwd": 5,
                   "warp_fwd": 4}),
    ("SpyNet", 6, {"warp_fwd": 6}),
    ("FlowNet2", 2, {"spatial_corr_fwd": 1, "spatial_corr_bwd": 1,
                     "warp_fwd": 4}))
FAMILY_KERNELS = ("spatial_corr_fwd", "spatial_corr_bwd", "warp_fwd")
FAMILY_BATCHES = 4       # batches of each run; ms per step: median of 2..4
FTH, FTW = 256, 640
# a family's first train step with the kernels against the same step with
# their plain versions (plain_corr, plain_warp), relative: the loss and
# the global gradient norm.  f32 (TF32 off): the correlation sums its
# products in another order (FLOW_F32_REL_L2 of the serving flows), the
# warp's coordinates and weights are the plain version's (max|d| 1e-5 x
# max|img|), so the loss parts by ~1e-6; the gradient by more, through the
# backward's sums and FlowNet2's chained warps, whose gradient jumps where
# a coordinate crosses an integer (FLOWNET2_GRAD_REL_L2).  PWC-Net mixed:
# the kernel and the plain version each round their f32 sums to bf16 once,
# one bf16 ulp apart where they differ, carried through five levels (its
# serving flows part by up to BF16_REL_EPE_TOL).  Measured on an H100
# over three runs: f32 losses <= 1.6e-7 apart, gradient norms <= 2.6e-4
# (FlowNet2); PWC-Net 6.8e-7 and 3.1e-5
TRAIN_LOSS_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
TRAIN_GRAD_REL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# adversarial training on the two robust models of the paper: 2 batches of
# batch 1 at the attack geometry, ADV_TRAIN_STEPS attack steps, ADV_INNER
# updates; (ID, spatial correlations and warps a forward)
FAMILY_ADV = (("FlowNetCFlexLarger_k3_reps3", 1, 0), ("PWCNet", 5, 4))


def read_csv(path: Path) -> tuple:
    """(header, rows) of a ``CsvLogger`` file, the rows as lists of
    strings."""
    lines = path.read_text().splitlines()
    check(len(lines) >= 1, f"{path}: empty")
    rows = [line.split(",") for line in lines]
    return rows[0], rows[1:]


def _floats(row, path) -> list:
    vals = [float(x) for x in row]
    check(all(math.isfinite(v) for v in vals), f"{path}: non-finite {row}")
    return vals


def moving_patch_files(out: Path, scenes: int, grid: tuple) -> dict:
    """What ``test_moving_patch`` wrote under ``out``: the averages of
    ``moving_results.csv`` (epe, adv_epe, cos_sim, adv_cos_sim), a row per
    scene of ``moving_result_scenes.csv``, and each scene's heat map
    ``vis/adv_epe_image_###.npy`` of ``grid`` locations, finite, whose
    mean and maximum are the scene row's adv_epe_avg and adv_epe_max (the
    CSV rounds to 4 decimals).  Where matplotlib rendered the map as
    ``.jpg`` there is no array to read."""
    head, rows = read_csv(out / "moving_results.csv")
    check(head == ["epe", "adv_epe", "cos_sim", "adv_cos_sim"]
          and len(rows) == 1, f"moving_results.csv: {head} {rows}")
    averages = _floats(rows[0], "moving_results.csv")
    head, rows = read_csv(out / "moving_result_scenes.csv")
    check(len(head) == 11 and head[:2] == ["scene", "epe"]
          and len(rows) == scenes,
          f"moving_result_scenes.csv: {head}, {len(rows)} rows")
    table = np.array([_floats(r, "moving_result_scenes.csv") for r in rows])
    heats = []
    for i, row in enumerate(table):
        npy = out / "vis" / f"adv_epe_image_{i:03d}.npy"
        if not npy.exists():
            check((out / "vis" / f"adv_epe_image_{i:03d}.jpg").exists(),
                  f"moving patch: no heat map of scene {i}")
            continue
        heat = np.load(npy)
        check(heat.shape == grid and np.isfinite(heat).all(),
              f"{npy.name}: {heat.shape}, finite {np.isfinite(heat).all()}")
        check(abs(float(heat.mean()) - row[2]) <= 1e-4 + 1e-6 * row[2]
              and abs(float(heat.max()) - row[5]) <= 1e-4 + 1e-6 * row[5],
              f"{npy.name}: mean {heat.mean()} max {heat.max()} against "
              f"the scene row's {row[2]} {row[5]}")
        heats.append(heat)
    return {"averages": averages, "scenes": table, "heat": heats}


def replace_features_files(out: Path, key_sets: list) -> dict:
    """What ``test_replace_features`` wrote under ``out``: ``key_sets.json``
    equal to ``key_sets`` and a row of ``results.csv`` per key set in its
    order, six finite metrics each; returns {"a+b": [epe, adv_epe,
    replaced_epe, cos_sim, adv_cos_sim, replaced_cos_sim]}."""
    got = json.loads((out / "key_sets.json").read_text())
    check(got == [list(k) for k in key_sets],
          f"key_sets.json: {got}, not {key_sets}")
    head, rows = read_csv(out / "results.csv")
    check(head == ["keys", "epe", "adv_epe", "replaced_epe", "cos_sim",
                   "adv_cos_sim", "replaced_cos_sim"]
          and [r[0] for r in rows] == ["+".join(k) for k in key_sets],
          f"results.csv: {head}, keys {[r[0] for r in rows]}")
    return {r[0]: _floats(r[1:], "results.csv") for r in rows}


def embedding_files(out: Path, keys, points: int) -> dict:
    """What ``test_patch_embeddings`` wrote under ``out``: a row of
    ``mmd.csv`` per key, finite and not negative beyond rounding, and each
    key's t-SNE points ``tsne_{key}.npy`` (``points`` x 2, finite; a
    ``.pdf`` where matplotlib drew them); returns {key: MMD}."""
    head, rows = read_csv(out / "mmd.csv")
    check(head == ["layer", "mmd"] and [r[0] for r in rows] == list(keys),
          f"mmd.csv: {head}, layers {[r[0] for r in rows]}")
    mmd = {r[0]: _floats(r[1:], "mmd.csv")[0] for r in rows}
    check(all(v >= -1e-6 for v in mmd.values()), f"mmd.csv: {mmd}")
    for k in keys:
        npy = out / f"tsne_{k}.npy"
        if not npy.exists():
            check((out / f"tsne_{k}.pdf").exists(), f"no t-SNE of {k}")
            continue
        pts = np.load(npy)
        check(pts.shape == (points, 2) and np.isfinite(pts).all(),
              f"{npy.name}: {pts.shape}, finite {np.isfinite(pts).all()}")
    return mmd


@contextlib.contextmanager
def timed_predictions(models):
    """Wraps ``models.predict_flow`` (the CLIs import it when they run):
    yields the list of (seconds at its return, the flow) of every call."""
    calls = []
    predict = models.predict_flow

    def wrapped(*a, **k):
        flow = predict(*a, **k)
        calls.append((time.perf_counter(), flow))
        return flow

    models.predict_flow = wrapped
    try:
        yield calls
    finally:
        models.predict_flow = predict


def device_activity(prof) -> tuple:
    """(busy s, span s) of the device in a ``torch.profiler`` run: the
    union of its kernels' and copies' intervals (not the host ops that
    launched them, cli/profile.py), from the first kernel's start (the
    copies of a model's weights before it are left out) to the last
    interval's end."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.name.startswith(
                       ("cuda", "aten", "Command Buffer")))
    first = next(s for s, _, name in spans
                 if not name.startswith(("Memcpy", "Memset")))
    busy, end = 0.0, first
    for start, stop, _ in spans:
        if stop <= first:
            continue
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    return busy / 1e6, (end - first) / 1e6


def moving_patch_phase() -> dict:
    """``test_moving_patch`` on RAFT (the registry's mixed precision, at
    the calibrated point: ``scale_flow_head(0.05)`` saved as a ``.pth``)
    over one synthetic 384x1280 frame pair, the bench's 100 px patch with
    stride 100: 36 locations, 12 ``alt_corr_fwd`` launches per forward;
    seconds per location and the device's idle share over the sweep
    (``torch.profiler``, device activity only); each location's
    adversarial flow and EPE against the same sweep with the plain lookup;
    the CSVs and heat maps."""
    from torch.profiler import ProfilerActivity, profile

    from understanding_flow_robustness_tpu_torch import models
    from understanding_flow_robustness_tpu_torch.cli import test_moving_patch
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training.checkpoint import (
        save_weights,
    )

    locations = MOVING_GRID[0] * MOVING_GRID[1]
    print(f"== moving patch: RAFT (mixed, calibrated), 1 pair at {PH}x{PW},"
          f" {MOVING_PATCH} px patch, stride {MOVING_STRIDE}: {locations} "
          "locations ==", flush=True)
    out = ANALYSIS_OUT / "moving"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    model = models.fetch_model("RAFT", iters=ITERS)
    pth = out / "raft_calibrated.pth"
    save_weights(str(pth), models.scale_flow_head(model.module, 0.05))
    del model
    argv = ["--flownet", "RAFT", "--pretrained_path", str(pth),
            "--random_patch", "uniform", "--patch_size", str(MOVING_PATCH),
            "--stride", str(MOVING_STRIDE), "--synthetic", "1",
            "--synthetic-size", str(PH), str(PW), "--no_viz"]

    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    with timed_predictions(models) as calls, \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        avg = test_moving_patch.main(argv + ["--output", str(out),
                                             "--name", "kernel"])
        torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    n = LAUNCH_COUNTS["alt_corr_fwd"]
    check(n == ITERS * (locations + 1),
          f"moving patch: {n} alt_corr_fwd launches, not {ITERS} x "
          f"{locations + 1}")
    check(len(calls) == locations + 1, f"moving patch: {len(calls)} "
                                       "forwards")
    t0 = time.perf_counter()
    busy, wall = device_activity(prof)
    t_trace = time.perf_counter() - t0
    # from the clean flow's return to the last location's
    s_per_loc = (calls[-1][0] - calls[0][0]) / locations
    files = moving_patch_files(out / "kernel", 1, MOVING_GRID)
    check(np.allclose(avg, files["averages"], rtol=0, atol=1e-4 + 1e-6),
          f"moving patch: returned {avg}, moving_results.csv "
          f"{files['averages']}")

    # the same sweep with the plain lookup: the same seeded placements
    fetch = models.fetch_model

    def plain(*a, **k):
        m = fetch(*a, **k)
        m.module.plain_lookup = True
        return m

    models.fetch_model = plain
    t0 = time.perf_counter()
    try:
        with timed_predictions(models) as plain_calls:
            test_moving_patch.main(argv + ["--output", str(out),
                                           "--name", "plain"])
    finally:
        models.fetch_model = fetch
    t_plain = time.perf_counter() - t0
    plain_files = moving_patch_files(out / "plain", 1, MOVING_GRID)
    worst_rel, worst_epe = 0.0, 0.0
    for (_, f), (_, p) in zip(calls, plain_calls):
        d = torch.linalg.vector_norm(f - p, dim=-1).mean().item()
        mag = torch.linalg.vector_norm(p, dim=-1).mean().item()
        worst_rel = max(worst_rel, d / mag)
    heat, plain_heat = files["heat"], plain_files["heat"]
    if heat and plain_heat:
        # |EPE(gt, f) - EPE(gt, p)| <= mean |f - p| (all GT valid here)
        worst_epe = float(np.abs(heat[0] - plain_heat[0]).max())
    check(worst_rel <= BF16_REL_EPE_TOL,
          f"moving patch: a location's flow, kernel vs plain lookup, "
          f"{worst_rel:.3e} mean EPE / mean |flow| (tol {BF16_REL_EPE_TOL})")
    mean_flow = float(np.mean([torch.linalg.vector_norm(
        p, dim=-1).mean().item() for _, p in plain_calls]))
    check(worst_epe <= BF16_REL_EPE_TOL * mean_flow,
          f"moving patch: adversarial EPE kernel vs plain lookup "
          f"{worst_epe:.4f} px apart at a location")
    res = {"launches/alt_corr_fwd": n, "s_per_location": s_per_loc,
           "idle_share": max(0.0, 1.0 - busy / wall), "busy_s": busy,
           "wall_s": wall, "vs_plain_rel_epe": worst_rel,
           "vs_plain_adv_epe_px": worst_epe, "averages": files["averages"]}
    scene = files["scenes"][0]
    print(f"moving patch: {n} alt_corr_fwd launches; clean EPE "
          f"{scene[1]:.3f}, adversarial EPE over the {locations} locations "
          f"avg {scene[2]:.3f} min {scene[3]:.3f} max {scene[5]:.3f}; "
          f"{s_per_loc:.4f} s per location (placement, composite, RAFT-12, "
          f"two host reads), device idle {100 * res['idle_share']:.1f} % of "
          f"the {wall:.3f} s from the clean forward's first kernel to the "
          f"last ({busy:.3f} s busy); kernel vs plain lookup: worst "
          f"location {worst_rel:.3e} mean EPE / mean |flow|, adversarial EPE "
          f"{worst_epe:.4f} px apart; the CLI run {t_run:.1f} s under the "
          f"profiler, reading its trace {t_trace:.1f} s, the plain run "
          f"{t_plain:.1f} s", flush=True)
    return res


def replace_features_phase() -> dict:
    """``test_replace_features`` on FlowNetC (f32) over 2 synthetic
    384x1280 pairs, ``-fk corr conv_redir conv3_1 --all_key_subsets``: 7
    key sets x 4 forwards x 2 samples ``spatial_corr_fwd`` launches, the
    files; then, apart, injecting a test-patch pair's own captured maps
    gives back its flow bit for bit."""
    from understanding_flow_robustness_tpu_torch import models
    from understanding_flow_robustness_tpu_torch.cli import (
        test_replace_features,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    key_sets = [k for r in range(1, len(REPLACE_KEYS) + 1)
                for k in itertools.combinations(REPLACE_KEYS, r)]
    print(f"== replace features: FlowNetC f32, {REPLACE_SAMPLES} pairs at "
          f"{PH}x{PW}, {len(key_sets)} key sets ==", flush=True)
    out = ANALYSIS_OUT / "replace"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--flownet", "FlowNetC", "--random_patch", "uniform",
            "--patch_size", str(MOVING_PATCH), "--synthetic",
            str(REPLACE_SAMPLES), "--synthetic-size", str(PH), str(PW),
            "-fk", *REPLACE_KEYS, "--all_key_subsets", "--output", str(out),
            "--name", "flownetc"]
    LAUNCH_COUNTS.clear()
    t0 = time.perf_counter()
    test_replace_features.main(argv)
    seconds = time.perf_counter() - t0
    n = LAUNCH_COUNTS["spatial_corr_fwd"]
    expect = len(key_sets) * 4 * REPLACE_SAMPLES
    check(n == expect, f"replace features: {n} spatial_corr_fwd launches, "
                       f"not {expect}")
    rows = replace_features_files(out / "flownetc", key_sets)

    # injecting a pair's own maps changes nothing: bit for bit with cuDNN's
    # deterministic convolutions (its default choice may sum f32 in an
    # order that changes from call to call: ~1e-5 px)
    model = models.fetch_model("FlowNetC", return_features=True)
    pair = torch.rand((2, 1, PH, PW, 3), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(7))
    torch.backends.cudnn.deterministic = True
    try:
        flow, feats = models.predict_flow_with_features(model, pair[0],
                                                        pair[1])
        for keys in key_sets:
            again = models.predict_flow(model, pair[0], pair[1],
                                        overrides={k: feats[k] for k in keys})
            check(torch.equal(again, flow),
                  f"replace features: injecting its own {keys} moved the "
                  f"flow by {float((again - flow).abs().max()):.3e}")
    finally:
        torch.backends.cudnn.deterministic = False
    moved = {k: abs(v[2] - v[1]) for k, v in rows.items()}
    print(f"replace features: {n} spatial_corr_fwd launches in "
          f"{seconds:.2f} s; adv EPE -> replaced EPE per key set: " + ", ".join(
              f"{k} {v[1]:.3f} -> {v[2]:.3f}" for k, v in rows.items())
          + "; a pair's own maps injected give its flow bit for bit",
          flush=True)
    return {"launches/spatial_corr_fwd": n, "seconds": seconds,
            "moved": moved}


def embeddings_phase() -> dict:
    """``test_patch_embeddings`` on FlowNetC (f32) and PWC-Net (mixed) over
    EMBED_SAMPLES synthetic 384x1280 pairs: the launches (FlowNetC one
    ``spatial_corr_fwd`` a forward; PWC-Net's taps 5 and 4 ``warp_fwd``),
    the MMD per key, the t-SNE points."""
    from understanding_flow_robustness_tpu_torch.cli import (
        test_patch_embeddings,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    res = {"launches/spatial_corr_fwd": 0, "launches/warp_fwd": 0}
    for name, (corrs, warps) in (("FlowNetC", (1, 0)), ("PWCNet", (5, 4))):
        keys = EMBED_KEYS[name]
        print(f"== embeddings: {name}, {EMBED_SAMPLES} pairs at {PH}x{PW}, "
              f"taps {keys} ==", flush=True)
        out = ANALYSIS_OUT / "embeddings"
        shutil.rmtree(out / name, ignore_errors=True)
        LAUNCH_COUNTS.clear()
        t0 = time.perf_counter()
        test_patch_embeddings.main([
            "--flownet", name, "--random_patch", "uniform", "--patch_size",
            str(MOVING_PATCH), "--synthetic", str(EMBED_SAMPLES),
            "--max_samples", str(EMBED_SAMPLES), "--synthetic-size", str(PH),
            str(PW), "--feature_keys", *keys, "--output", str(out),
            "--name", name])
        seconds = time.perf_counter() - t0
        n = {k: LAUNCH_COUNTS[k] for k in ("spatial_corr_fwd", "warp_fwd")}
        expect = {"spatial_corr_fwd": 2 * EMBED_SAMPLES * corrs,
                  "warp_fwd": 2 * EMBED_SAMPLES * warps}
        check(n == expect, f"embeddings {name}: launches {n}, not {expect}")
        mmd = embedding_files(out / name, keys, 2 * EMBED_SAMPLES)
        for k in n:
            res[f"launches/{k}"] += n[k]
        res[name] = mmd
        print(f"embeddings {name}: launches {n}; MMD " + ", ".join(
            f"{k} {v:.6f}" for k, v in mmd.items())
            + f"; {seconds:.2f} s with t-SNE", flush=True)
    return res


def _first_step(model, batch: dict, pwc: bool) -> tuple:
    """(loss, global gradient norm) of one train-mode forward and backward
    of ``model`` on ``batch``, with the train step's loss."""
    from understanding_flow_robustness_tpu_torch.training import sequence_loss

    module = model.module.train()
    module.zero_grad(set_to_none=True)
    img1 = batch["image1"].permute(0, 3, 1, 2)
    img2 = batch["image2"].permute(0, 3, 1, 2)
    preds = module(img1, img2, train=True)
    preds = list(preds) if isinstance(preds, (list, tuple)) else [preds]
    loss, _ = sequence_loss([p.permute(0, 2, 3, 1) for p in preds],
                            batch["flow"], batch["valid"], flownetc=True,
                            pwc=pwc)
    loss.backward()
    norm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(p.grad) for p in module.parameters()
        if p.grad is not None]))
    return float(loss.detach()), float(norm)


@contextlib.contextmanager
def spied_train_steps(trainer):
    """Wraps ``trainer.make_train_step``: yields the list of (seconds of
    each step with the device synchronised, the launch counts after it)."""
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    steps = []
    make_step = trainer.make_train_step

    def spy(*a, **k):
        step = make_step(*a, **k)

        def run(batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t,
                          {k: LAUNCH_COUNTS[k] for k in FAMILY_KERNELS}))
            return out
        return run

    trainer.make_train_step = spy
    try:
        yield steps
    finally:
        trainer.make_train_step = make_step


def family_train_phase() -> dict:
    """The train CLI with ``--synthetic`` on FlowNetS, FlowNetC,
    FlowNetCFlexLarger_k3_reps3 (f32), PWC-Net (mixed), SpyNet (f32) and
    FlowNet2 (f32, batch 2) at the CLI's 256x640: launches of the
    correlation and warp kernels per step, finite losses, ms per step
    (median of steps 2..4), frames/s, peak memory; then each family's
    first step (the CLI's initial weights, its first batch) with the
    kernels against the plain versions: the loss and the gradient norm."""
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import trainer

    res = {f"launches/{k}": 0 for k in FAMILY_KERNELS}
    ckpt = ANALYSIS_OUT / "train"
    fetch = cli_train.fetch_model
    for name, batch, per_step in FAMILY_TRAIN:
        print(f"== train CLI: {name}, batch {batch} at {FTH}x{FTW}, "
              f"{FAMILY_BATCHES} synthetic batches ==", flush=True)
        shutil.rmtree(ckpt, ignore_errors=True)
        built = {}

        def keep(*a, _fetch=fetch, **k):
            built["model"] = _fetch(*a, **k)
            built["init"] = copy.deepcopy(built["model"].module.state_dict())
            return built["model"]

        cli_train.fetch_model = keep
        LAUNCH_COUNTS.clear()
        torch.cuda.reset_peak_memory_stats()
        try:
            with spied_train_steps(trainer) as steps:
                out = cli_train.main([
                    "--model", name, "--synthetic", str(FAMILY_BATCHES),
                    "--num_steps", str(FAMILY_BATCHES - 1), "--batch_size",
                    str(batch), "--image_size", str(FTH), str(FTW),
                    "--name", "fam", "--checkpoint_dir", str(ckpt),
                    "--n_devices", "1"])
        finally:
            cli_train.fetch_model = fetch
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = {k: LAUNCH_COUNTS[k] for k in FAMILY_KERNELS}
        expect = {k: FAMILY_BATCHES * per_step.get(k, 0)
                  for k in FAMILY_KERNELS}
        check(n == expect, f"train CLI {name}: launches {n}, not {expect}")
        check(len(steps) == FAMILY_BATCHES
              and all(math.isfinite(m["loss"]) for m in out["history"]),
              f"train CLI {name}: {len(steps)} steps, losses "
              f"{[m['loss'] for m in out['history']]}")
        ms = 1e3 * float(np.median([s for s, _ in steps[1:]]))
        for k in FAMILY_KERNELS:
            res[f"launches/{k}"] += n[k]

        # the first step again, kernels and plain versions, from the CLI's
        # initial weights on its first batch
        model = built["model"]
        model.module.load_state_dict(built["init"])
        first = next(cli_train._synthetic_batches(
            1, batch, FTH, FTW, 1234)())
        dev = {k: torch.as_tensor(v, device="cuda") for k, v in first.items()}
        LAUNCH_COUNTS.clear()
        loss_k, norm_k = _first_step(model, dev, "PWC" in name)
        for flag in ("plain_corr", "plain_warp"):
            if hasattr(model.module, flag):
                setattr(model.module, flag, True)
        loss_p, norm_p = _first_step(model, dev, "PWC" in name)
        dtype = torch.bfloat16 if name == "PWCNet" else torch.float32
        d_loss = abs(loss_k - loss_p) / abs(loss_p)
        d_norm = abs(norm_k - norm_p) / norm_p
        check(d_loss <= TRAIN_LOSS_REL[dtype] and d_norm <= TRAIN_GRAD_REL[dtype],
              f"train {name}: first step, kernels vs plain: loss {loss_k} "
              f"vs {loss_p} ({d_loss:.2e}), grad norm {norm_k} vs {norm_p} "
              f"({d_norm:.2e})")
        cli_loss = out["history"][0]["loss"]
        check(abs(cli_loss - loss_k) <= 1e-5 * abs(loss_k),
              f"train {name}: the CLI's first loss {cli_loss} is not the "
              f"phase's {loss_k}")
        res[name] = {"ms_per_step": ms, "frames_per_s": 1e3 * batch / ms,
                     "peak_gib": peak, "launches": n,
                     "loss_rel": d_loss, "grad_norm_rel": d_norm}
        print(f"train CLI {name}: launches {n} ({per_step} a step); losses "
              + ", ".join(f"{m['loss']:.3f}" for m in out["history"])
              + f"; {ms:.1f} ms per step (median of steps 2..{FAMILY_BATCHES}"
              f"), {1e3 * batch / ms:.1f} frames/s, peak {peak:.2f} GiB; "
              f"first step kernels vs plain: loss {d_loss:.2e}, grad norm "
              f"{d_norm:.2e} (relative)", flush=True)
        del model, built
        torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    return res


def family_adv_train_phase() -> dict:
    """``cli.train --adversarial`` on FlowNetCFlexLarger_k3_reps3 (f32) and
    PWC-Net (mixed): 2 batches of batch 1 at the attack geometry, each an
    eval-mode I-FGSM of ADV_TRAIN_STEPS steps and ADV_INNER updates on the
    doubled batch: every forward and backward launches the model's
    correlation kernels (and PWC-Net's warps), finite losses, ms per
    batch."""
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import trainer

    res = {f"launches/{k}": 0 for k in FAMILY_KERNELS}
    ckpt = ANALYSIS_OUT / "adv"
    for name, corrs, warps in FAMILY_ADV:
        print(f"== adversarial train CLI: {name}, batch {AB} at {AH}x{AW}, "
              f"{ADV_TRAIN_STEPS} I-FGSM steps, {ADV_TRAIN_BATCHES} batches "
              "==", flush=True)
        shutil.rmtree(ckpt, ignore_errors=True)
        LAUNCH_COUNTS.clear()
        with spied_train_steps(trainer) as steps:
            t0 = time.perf_counter()
            out = cli_train.main([
                "--model", name, "--adversarial", "--synthetic",
                str(ADV_TRAIN_BATCHES), "--num_steps",
                str(ADV_TRAIN_BATCHES - 1), "--batch_size", str(AB),
                "--image_size", str(AH), str(AW), "--perturb_n_step",
                str(ADV_TRAIN_STEPS), "--name", "adv", "--checkpoint_dir",
                str(ckpt), "--n_devices", "1"])
            seconds = time.perf_counter() - t0
        passes = ADV_TRAIN_BATCHES * (ADV_TRAIN_STEPS + ADV_INNER)
        expect = {"spatial_corr_fwd": passes * corrs,
                  "spatial_corr_bwd": passes * corrs,
                  "warp_fwd": passes * warps}
        n = {k: LAUNCH_COUNTS[k] for k in FAMILY_KERNELS}
        check(n == expect, f"adversarial train {name}: launches {n}, not "
                           f"{expect}")
        check(out["total_steps"] == ADV_TRAIN_BATCHES
              and len(steps) == ADV_TRAIN_BATCHES * ADV_INNER
              and all(math.isfinite(m["loss"]) for m in out["history"]),
              f"adversarial train {name}: {out['total_steps']} batches, "
              f"{len(steps)} updates, losses {out['history']}")
        for k in FAMILY_KERNELS:
            res[f"launches/{k}"] += n[k]
        res[name] = {"launches": n, "seconds": seconds}
        print(f"adversarial train CLI {name}: launches {n}; losses "
              + ", ".join(f"{m['loss']:.3f}" for m in out["history"])
              + f"; {seconds:.2f} s for the run", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return res


# the train steps' shapes of the spatial correlation and the warp, batch 6
# at the train CLI's 256x640: FlowNetC's (21, 2) correlation on the conv3
# maps (f32), PWC-Net's level 2 (bf16 under its autocast), SPyNet's finest
# warp (f32, mode "spynet") and PWC-Net's level-2 warp (bf16, zeros_mask)
CORR_TRAIN = {"flownetc_train": ((6, 256, FTH // 8, FTW // 8), 21, 2,
                                 torch.float32),
              "pwc_train_l2": ((6, 32, FTH // 4, FTW // 4), 9, 1,
                               torch.bfloat16)}
WARP_TRAIN = {"spynet_train": ((6, 3, FTH, FTW), "spynet", torch.float32,
                               False),
              "pwc_train_l2": ((6, 32, FTH // 4, FTW // 4), "zeros_mask",
                               torch.bfloat16, True)}
TRAIN_SHAPES_SEED = 300


def corr_rows(gen, shapes: dict) -> dict:
    """``spatial_corr_fwd`` / ``spatial_corr_bwd`` at each of ``shapes``
    ({name: ((B, C, H, W), patch, dilation, dtype)}) against the plain
    version and its autograd at spatial_corr_phase's bars, with the times
    of kernel, plain version and bound: {"corr/<name>": forward,
    "corr/<name>/bwd": backward}."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    res = {}
    for name, (shape, patch, dil, dtype) in shapes.items():
        f1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        f2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn((shape[0], patch ** 2) + shape[2:], generator=gen,
                        device="cuda").to(dtype)
        got = ops.spatial_correlation(f1, f2, patch, dilation_patch=dil)
        ref = ops.spatial_correlation_reference(f1, f2, patch, dil)
        err, ok = _corr_err(got, ref, dtype)
        dk = corr._spatial_corr_bwd_cuda(f1, f2, g, patch, dil)
        a, b = f1.float().requires_grad_(), f2.float().requires_grad_()
        dp = torch.autograd.grad(ops.spatial_correlation_reference(
            a, b, patch, dil), (a, b), g.float())
        bres = [_corr_err(k, p, dtype) for k, p in zip(dk, dp)]
        check(ok and all(o for _, o in bres),
              f"{name}: the spatial correlation's kernels disagree with the "
              f"plain version (fwd {err:.3e}, bwd {bres})")
        pairs = corr_pairs(shape[2], shape[3], patch, dil) * shape[0] * shape[1]
        fwd = {"max_abs_err": err, "ms": cuda_ms(lambda: ops.spatial_correlation(
            f1, f2, patch, dilation_patch=dil), reps=20),
               "plain_ms": cuda_ms(lambda: ops.spatial_correlation_reference(
                   f1, f2, patch, dil), reps=3, warmup=1),
               **bound(nbytes(f1, f2, got), 2 * pairs, dtype)}
        a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        out = ops.spatial_correlation_reference(a, b, patch, dil)
        bwd = {"max_abs_err": max(e for e, _ in bres),
               "ms": cuda_ms(lambda: corr._spatial_corr_bwd_cuda(
                   f1, f2, g, patch, dil), reps=20),
               "plain_ms": cuda_ms(lambda: torch.autograd.grad(
                   out, (a, b), g, retain_graph=True), reps=3, warmup=1),
               **bound(nbytes(f1, f2, g, *dk), 4 * pairs, dtype)}
        res[f"corr/{name}"], res[f"corr/{name}/bwd"] = fwd, bwd
        for tag, m in (("forward", fwd), ("backward", bwd)):
            print(f"{name:16s} {tuple(shape)} P={patch} d={dil} "
                  f"{str(dtype).split('.')[-1]} {tag}: max_abs_err "
                  f"{m['max_abs_err']:.3e}, kernel {m['ms']:.4f} ms, plain "
                  f"{m['plain_ms']:.3f} ms, bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}; the kernel at "
                  f"{100 * m['bound_ms'] / m['ms']:.1f}% of it)", flush=True)
        del f1, f2, g, got, ref, dk, dp, out
    return res


def train_shapes_phase() -> dict:
    """``spatial_corr_fwd`` / ``spatial_corr_bwd`` and ``warp_fwd`` at the
    train steps' shapes (CORR_TRAIN, WARP_TRAIN) against their plain
    versions at the bars of spatial_corr_phase and warp_phase, with the
    times of kernel, plain version and bound; beside the warp kernel the
    time of its gradient, the plain sampler's autograd (into the flow, and
    into PWC-Net's features, which the train step differentiates too)."""
    from understanding_flow_robustness_tpu_torch import ops

    print("== the train shapes: spatial_corr_fwd/bwd and warp_fwd vs plain "
          "==", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SHAPES_SEED)
    res = corr_rows(gen, CORR_TRAIN)
    for name, ((b, c, h, w), mode, dtype, img_grad) in WARP_TRAIN.items():
        img = torch.rand((b, c, h, w), generator=gen, device="cuda").to(dtype)
        flow = warp_flow(gen, b, h, w, "smooth")
        got = ops.warp_backward(img, flow, mode)
        ref = ops.warp_backward_reference(img.float(), flow, mode)
        err = (got.float() - ref).abs()
        ok = (err.max().item() <= WARP_F32_REL_TOL
              * img.float().abs().max().item() if dtype == torch.float32
              else bool((err <= bf16_ulp(ref)).all()))
        check(ok, f"{name}: warp_fwd disagrees with the plain version "
                  f"({err.max().item():.3e})")
        i = img.clone().requires_grad_(img_grad)
        f = flow.clone().requires_grad_()
        out = ops.warp_backward(i, f, mode)
        gout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        wrt = (i, f) if img_grad else (f,)
        m = {"max_abs_err": err.max().item(),
             "ms": graph_ms(lambda: ops.warp_backward(img, flow, mode),
                            reps=50),
             "plain_ms": cuda_ms(lambda: ops.warp_backward_reference(
                 img, flow, mode), reps=10),
             "library_ms": graph_ms(grid_sample_call(img, flow, mode),
                                    reps=50),
             "grad_plain_ms": cuda_ms(lambda: torch.autograd.grad(
                 out, wrt, gout, retain_graph=True), reps=10),
             **bound(nbytes(img, flow, got), 8 * b * c * h * w, dtype)}
        res[f"warp/{name}"] = m
        print(f"{name:16s} {(b, c, h, w)} {mode} "
              f"{str(dtype).split('.')[-1]}: max_abs_err "
              f"{m['max_abs_err']:.3e}, kernel {m['ms']:.4f} ms (graph "
              f"replay), plain {m['plain_ms']:.4f} ms, grid_sample "
              f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
              f"({m['bound_by']}); its gradient (the plain sampler's "
              f"autograd) {m['grad_plain_ms']:.4f} ms", flush=True)
        del img, flow, got, ref, i, f, out, gout
    return res


# small RAFT (raft_model.py:762-770): radius 3 over 128-channel fmaps; its
# feature shapes (B, H/8, W/8, C) when serving and training
SMALL_RADIUS = 3
SMALL_SERVE = (B, H // 8, W // 8, 128)
SMALL_TRAIN = (TB, TH // 8, TW // 8, 128)
# every radius the window kernels are instantiated for (csrc/radius.cuh)
RADII = range(1, 8)


def radius_centres(gen, b, h, w) -> dict:
    """Centres of the radius phase: calibrated (2 px of noise), wild
    (150 px), far (+-1e30 and hand-placed ones off the level among
    calibrated ones) and exactly integer."""
    from understanding_flow_robustness_tpu_torch.ops import coords_grid

    grid = coords_grid(h, w, device="cuda")[None].expand(b, h, w, 2)
    noise = torch.randn((b, h, w, 2), generator=gen, device="cuda")
    far = grid + 2.0 * noise
    far[0, 0, :6] = torch.tensor(
        [[-1e30, 3.0], [3.0, 1e30], [1e30, -1e30], [-50.0, -50.0],
         [500.0, 500.0], [-3.5, -3.5]], device="cuda")
    return {"calibrated": grid + 2.0 * noise, "wild": grid + 150.0 * noise,
            "far": far, "integer": grid.clone()}


def radius_phase(gen) -> dict:
    """B1, B2, B3 and B5 at every radius 1..7 against their plain versions,
    at small RAFT's serving shape (B1, B3, B5), its train shape (B2) and a
    ragged one (all four), f32 and bf16, for calibrated, wild, far and
    integer centres, under the bounds of the r = 4 phases; r = 0 and 8
    refused by the wrappers and by the kernels' entry points.  B3 also
    launches twice for bit-equal results and counts the same (tile, level)
    paths as B1 on the same inputs.  At small RAFT's r = 3: each kernel's
    time, its plain version's and its bound at the main shapes, and the
    tile-path shares of B1, B2 and B3."""
    from understanding_flow_robustness_tpu_torch import ops
    from understanding_flow_robustness_tpu_torch.ops import correlation as corr

    print("== the window kernels at every radius 1..7 vs plain (TF32 off) ==",
          flush=True)
    res = {"worst": {}}
    shapes = (("serving", SMALL_SERVE), ("train", SMALL_TRAIN),
              ("ragged", (2, 13, 21, 64)))
    paths = {k: torch.zeros(2 * LEVELS, dtype=torch.int32, device="cuda")
             for k in ("fwd", "bwd", "dcoords")}

    def hold(kernel, tag, got, ref, tol):
        """Each output of ``got`` against ``ref``'s within tol(max|ref|)."""
        worst = 0.0
        for k, r in zip(got, ref):
            check(k.shape == r.shape and k.dtype == torch.float32
                  and bool(torch.isfinite(k).all()),
                  f"{kernel} {tag}: kernel output malformed")
            err = (k - r).abs().max().item()
            bar = tol(r.abs().max().item())
            check(err <= bar, f"{kernel} {tag}: kernel disagrees with the "
                              f"plain version ({err:.3e} > {bar:.3e})")
            worst = max(worst, err)
        res["worst"][kernel] = max(res["worst"].get(kernel, 0.0), worst)
        return worst

    def timed(name, kernel_fn, plain_fn, moved, flops, dtype, extra=None):
        k_ms = cuda_ms(kernel_fn, reps=20)
        p_ms = cuda_ms(plain_fn, reps=3, warmup=1)
        res[name] = {"ms": k_ms, "plain_ms": p_ms, **bound(moved, flops, dtype),
                     **(extra or {})}
        m = res[name]
        print(f"r={SMALL_RADIUS} {name:22s} kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}; "
              f"the kernel at {100 * m['bound_ms'] / k_ms:.1f}% of it)"
              + "".join(f", {k} {v:.4f}" for k, v in (extra or {}).items()
                        if isinstance(v, float)), flush=True)

    f32_tol = lambda scale: F32_TOL  # noqa: E731
    for r in RADII:
        n2 = (2 * r + 1) ** 2
        for shape_name, (b, h, w, c) in shapes:
            fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
            fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
            cases = radius_centres(gen, b, h, w)
            g = torch.randn((b, h * w, LEVELS * n2), generator=gen,
                            device="cuda")
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).split(".")[-1]
                f1, levels = corr.prepare_alt_corr(fm1, fm2, LEVELS, dtype)
                pyr = (ops.volume_pyramid(fm1, fm2, LEVELS, dtype)
                       if shape_name != "train" else None)
                for case, coords in cases.items():
                    tag = f"r={r}/{shape_name}/{case}/{dt}"
                    cflat = coords.reshape(b, h * w, 2).contiguous()
                    if shape_name != "train":  # B1, B3, B5
                        cnt = torch.zeros_like(paths["fwd"])
                        got = corr._alt_corr_lookup_cuda(f1, levels, cflat, r,
                                                         path_counts=cnt)
                        ref = corr.alt_corr_lookup_reference(f1, levels,
                                                             cflat, r)
                        hold("B1", tag, [got], [ref],
                             f32_tol if dtype == torch.float32
                             else lambda sc: BF16_REL_TOL * sc)
                        if r == SMALL_RADIUS:
                            paths["fwd"] += cnt
                            res[f"B1/{shape_name}/{case}/{dt}/tile_share"] = (
                                path_share(cnt)[0])
                        b1 = cnt
                        cnt = torch.zeros_like(paths["dcoords"])
                        got = corr._alt_corr_dcoords_cuda(f1, levels, cflat,
                                                          g, r,
                                                          path_counts=cnt)
                        again = corr._alt_corr_dcoords_cuda(f1, levels,
                                                            cflat, g, r)
                        ref = corr.alt_corr_coords_grad_reference(
                            f1, levels, cflat, g, r)
                        hold("B3", tag, [got], [ref],
                             lambda sc: DCOORDS_REL_TOL * sc)
                        check(torch.equal(got, again),
                              f"B3 {tag}: two launches are not bit-equal")
                        check(torch.equal(cnt, b1),
                              f"B3 {tag}: (tile, level) paths {cnt.tolist()},"
                              f" B1's {b1.tolist()}")
                        if r == SMALL_RADIUS:
                            paths["dcoords"] += cnt
                            res[f"B3/{shape_name}/{case}/{dt}/tile_share"] = (
                                path_share(cnt)[0])
                        del again
                        got = ops.corr_lookup(pyr, coords.contiguous(), r)
                        ref = ops.corr_lookup_reference(pyr, coords, r)
                        hold("B5", tag, [got], [ref], lambda sc: VOL_TOL)
                    if shape_name != "serving":  # B2
                        cnt = torch.zeros_like(paths["bwd"])
                        got = corr._alt_corr_bwd_cuda(f1, levels, cflat, g, r,
                                                      path_counts=cnt)
                        ref = corr.alt_corr_lookup_backward_reference(
                            f1, levels, cflat, g, r)
                        hold("B2", tag, [got[0], *got[1]],
                             [ref[0], *ref[1]],
                             lambda sc: BWD_REL_TOL * sc)
                        if r == SMALL_RADIUS:
                            paths["bwd"] += cnt
                            res[f"B2/{shape_name}/{case}/{dt}/tile_share"] = (
                                path_share(cnt)[0])
                    del got, ref
                    torch.cuda.synchronize()
                if r != SMALL_RADIUS or dtype != torch.bfloat16 \
                        or shape_name == "ragged":
                    continue
                # small RAFT's r = 3 at its main shapes: times and bounds
                cflat = cases["calibrated"].reshape(b, h * w, 2).contiguous()
                n = b * h * w * LEVELS
                if shape_name == "serving":
                    out = corr._alt_corr_lookup_cuda(f1, levels, cflat, r)
                    timed("B1/serving",
                          lambda: corr._alt_corr_lookup_cuda(f1, levels,
                                                             cflat, r),
                          lambda: corr.alt_corr_lookup_reference(
                              f1, levels, cflat, r),
                          nbytes(f1, *levels, cflat, out),
                          2 * (2 * r + 2) ** 2 * c * n, dtype)
                    dc = corr._alt_corr_dcoords_cuda(f1, levels, cflat, g, r)
                    timed("B3/serving",
                          lambda: corr._alt_corr_dcoords_cuda(f1, levels,
                                                              cflat, g, r),
                          lambda: corr.alt_corr_coords_grad_reference(
                              f1, levels, cflat, g, r),
                          nbytes(f1, *levels, cflat, g, dc),
                          2 * (2 * r + 2) ** 2 * c * n, dtype)
                    cc = cases["calibrated"].contiguous()
                    vout = ops.corr_lookup(pyr, cc, r)
                    lib = corr_block_grid_sample(pyr, cc, r)
                    timed("B5/serving", lambda: ops.corr_lookup(pyr, cc, r),
                          lambda: ops.corr_lookup_reference(pyr, cc, r),
                          needed_taps(pyr, cc, r) * pyr[0].element_size()
                          + nbytes(cc, vout), 7 * vout.numel(),
                          torch.float32,
                          {"library_ms": cuda_ms(lib, reps=20)})
                    del out, dc, vout, lib
                else:
                    out = corr._alt_corr_lookup_cuda(f1, levels, cflat, r)
                    timed("B1/train",
                          lambda: corr._alt_corr_lookup_cuda(f1, levels,
                                                             cflat, r),
                          lambda: corr.alt_corr_lookup_reference(
                              f1, levels, cflat, r),
                          nbytes(f1, *levels, cflat, out),
                          2 * (2 * r + 2) ** 2 * c * n, dtype)
                    grads = corr._alt_corr_bwd_cuda(f1, levels, cflat, g, r)
                    timed("B2/train",
                          lambda: corr._alt_corr_bwd_cuda(f1, levels, cflat,
                                                          g, r),
                          lambda: corr.alt_corr_lookup_backward_reference(
                              f1, levels, cflat, g, r),
                          nbytes(f1, *levels, cflat, g, grads[0], *grads[1]),
                          4 * (2 * r + 2) ** 2 * c * n, dtype)
                    del out, grads
            del fm1, fm2, g, f1, levels, pyr
        print(f"r={r}: B1, B3, B5 ({SMALL_SERVE}, ragged) and B2 "
              f"({SMALL_TRAIN}, ragged) agree with their plain versions, "
              "f32 and bf16, calibrated, wild, far and integer centres; "
              "worst abs errors so far " + ", ".join(
                  f"{k} {v:.2e}" for k, v in sorted(res["worst"].items())),
              flush=True)
    for k, cnt in paths.items():
        share, per_level = path_share(cnt)
        res[f"{k}/tile_share"] = share
        print(f"r={SMALL_RADIUS} alt_corr_{k}: (tile, level) pairs on the tile "
              f"path over its cases {100 * share:.1f}% ({per_level})",
              flush=True)
        check(cnt[:LEVELS].sum().item() > 0 and cnt[LEVELS:].sum().item() > 0,
              f"alt_corr_{k} at r={SMALL_RADIUS}: the cases did not take both "
              f"paths ({cnt.tolist()})")
    print(f"r={SMALL_RADIUS} tile-path share, calibrated bf16: B1 serving "
          f"{100 * res['B1/serving/calibrated/bfloat16/tile_share']:.1f}%, "
          f"B2 train {100 * res['B2/train/calibrated/bfloat16/tile_share']:.1f}%"
          f", B3 serving "
          f"{100 * res['B3/serving/calibrated/bfloat16/tile_share']:.1f}%",
          flush=True)

    # B3's op-level path at small RAFT's radius: the coordinate gradient of
    # alt_corr_features at its serving shape, the only path that launches it
    b, h, w, c = SMALL_SERVE
    fm1 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    fm2 = torch.randn((b, h, w, c), generator=gen, device="cuda")
    coords = radius_centres(gen, b, h, w)["calibrated"].requires_grad_()
    g = torch.randn((b, h, w, LEVELS * (2 * SMALL_RADIUS + 1) ** 2),
                    generator=gen, device="cuda")
    ops.LAUNCH_COUNTS.clear()
    out = ops.alt_corr_features(fm1, fm2, coords, LEVELS, SMALL_RADIUS,
                                compute_dtype=torch.bfloat16)
    out.backward(g)
    torch.cuda.synchronize()
    n = {k: ops.LAUNCH_COUNTS[k] for k in
         ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords")}
    check(n == {"alt_corr_fwd": 1, "alt_corr_bwd": 0, "alt_corr_dcoords": 1},
          f"coordinate gradient at r={SMALL_RADIUS}: launches {n}")
    res["B3/launches"] = n["alt_corr_dcoords"]
    f1b, lvb = corr.prepare_alt_corr(fm1, fm2, LEVELS, torch.bfloat16)
    ref = corr.alt_corr_coords_grad_reference(
        f1b, lvb, coords.detach().reshape(b, h * w, 2),
        g.reshape(b, h * w, -1), SMALL_RADIUS)
    err = (coords.grad.reshape(ref.shape) - ref).abs().max().item()
    check(err <= DCOORDS_REL_TOL * ref.abs().max().item(),
          f"coordinate gradient at r={SMALL_RADIUS} disagrees with the plain "
          "version")
    print(f"alt_corr_features(coords.requires_grad) at r={SMALL_RADIUS}, "
          f"{SMALL_SERVE}: launches {n}; coords.grad vs plain max_abs_err="
          f"{err:.3e}", flush=True)
    del fm1, fm2, coords, g, out, ref

    # r = 0 and 8: the wrappers raise, and so do the kernels' entry points
    # when the wrappers' check is widened (corr._RADII)
    b, h, w, c = 2, 13, 21, 64
    fm = torch.randn((b, h, w, c), generator=gen, device="cuda")
    f1, levels = corr.prepare_alt_corr(fm, fm, LEVELS, torch.bfloat16)
    cflat = radius_centres(gen, b, h, w)["calibrated"].reshape(b, h * w, 2)
    pyr = [p.reshape(b * h * w, *p.shape[2:]).contiguous()
           for p in ops.volume_pyramid(fm, fm, LEVELS, torch.bfloat16)]
    radii = corr._RADII
    for bad in (0, 8):
        g = torch.zeros((b, h * w, LEVELS * (2 * bad + 1) ** 2),
                        device="cuda")
        calls = {
            "alt_corr_fwd": lambda: corr._alt_corr_lookup_cuda(
                f1, levels, cflat, bad),
            "alt_corr_bwd": lambda: corr._alt_corr_bwd_cuda(
                f1, levels, cflat, g, bad),
            "alt_corr_dcoords": lambda: corr._alt_corr_dcoords_cuda(
                f1, levels, cflat, g, bad),
            "corr_lookup_fwd": lambda: corr.corr_lookup_fwd(
                pyr, cflat.reshape(-1, 2), bad)}
        for name, call in calls.items():
            for widened, want in ((False, ValueError), (True, RuntimeError)):
                corr._RADII = range(0, 9) if widened else radii
                try:
                    call()
                    raised = None
                except (ValueError, RuntimeError) as e:
                    raised = e
                finally:
                    corr._RADII = radii
                check(type(raised) is want,
                      f"{name} at r={bad} ({'entry point' if widened else 'wrapper'}):"
                      f" {raised!r}, not {want.__name__}")
    torch.cuda.synchronize()
    print("r=0 and r=8: the four wrappers raise ValueError, and with their "
          "check widened the kernels' entry points refuse the launch "
          "(RuntimeError, cudaErrorInvalidValue)", flush=True)
    return res


# the spatial mode's train shape: its lookup upsamples each pyramid level
# back to the 1/8 grid, so H and W must be multiples of 64 (TH = 288 is
# not); the nearest such to the train step's 288x960
SPATIAL_TH, SPATIAL_TW = 320, 960
# relative L2 of the parameter gradients of the configurations' first f32
# train step, kernels vs plain lookup (worst tensor, all parameters
# together): as GRAD_F32_REL_L2, summation order only.  Measured on an
# H100 over two runs: small RAFT 0.7-1.2e-3 worst, the spatial mode
# 1.8-2.0e-3 (fnet.conv2.bias, a sum over the whole map of a difference of
# the correlation's gradient, or a GRU gate's weight), WoContext 1.4-1.6e-4;
# all parameters together at most 1.4e-5, 2.1e-5 and 1.2e-6.  A wrong or
# missing gradient is off by O(1)
CONFIG_GRAD_F32_REL_L2 = (5e-3, 5e-5)
# small RAFT's calibrated operating point: its FlowHead scaled so that
# the seeded model's flow lands near trained-checkpoint magnitudes (its
# head is smaller than RAFT's, so it needs a larger scale than RAFT's 0.05)
SMALL_CAL_SCALE = 0.3
# the configurations of the remaining-configurations slice, by name:
# (registry ID, model kwargs, FlowHead scale)
CONFIGS = {"small": ("RAFT", {"small": True}, SMALL_CAL_SCALE),
           "small_volume": ("RAFT", {"small": True, "corr_impl": "volume"},
                            SMALL_CAL_SCALE),
           "spatial": ("RAFT", {"compute_spatial": True}, 0.05),
           "wocontext": ("RAFT_FlowNetCEncoder_WoContext", {}, 0.05)}
# a forward's launches per kernel on each configuration's path
CONFIG_LAUNCHES = {
    "small": {"alt_corr_fwd": ITERS, "corr_lookup_fwd": 0,
              "spatial_corr_fwd": 0},
    "small_volume": {"alt_corr_fwd": 0, "corr_lookup_fwd": ITERS,
                     "spatial_corr_fwd": 0},
    "spatial": {"alt_corr_fwd": 0, "corr_lookup_fwd": 0,
                "spatial_corr_fwd": 1},
    "wocontext": {"alt_corr_fwd": ITERS, "corr_lookup_fwd": 0,
                  "spatial_corr_fwd": 0}}
# and a train step's (forward and backward)
CONFIG_TRAIN_LAUNCHES = {
    "small": {"alt_corr_fwd": ITERS, "alt_corr_bwd": ITERS,
              "spatial_corr_fwd": 0, "spatial_corr_bwd": 0},
    "spatial": {"alt_corr_fwd": 0, "alt_corr_bwd": 0,
                "spatial_corr_fwd": 1, "spatial_corr_bwd": 1},
    "wocontext": {"alt_corr_fwd": ITERS, "alt_corr_bwd": ITERS,
                  "spatial_corr_fwd": 0, "spatial_corr_bwd": 0}}


def config_model(config: str, **extra):
    """The seeded, calibrated model of ``config`` (CONFIGS) on the card."""
    from understanding_flow_robustness_tpu_torch.models import (
        FlowModel,
        fetch_model,
        scale_flow_head,
    )

    name, kw, scale = CONFIGS[config]
    m = fetch_model(name, device="cuda", seed=0, **kw, **extra)
    return FlowModel(name, scale_flow_head(m.module, scale), m.device)


def config_serve_phase(gen, config: str) -> dict:
    """``config`` (mixed precision, calibrated) serving REQUESTS requests of
    B pairs at HxW through ``predict_flow``: each forward's launches, the
    flow against the same model with the plain lookup (the plain spatial
    correlation in the spatial mode) within the 1 % bar, pairs/s and the
    peak memory."""
    from understanding_flow_robustness_tpu_torch.models import predict_flow
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== {config} serving ({CONFIGS[config][:2]}), calibrated, batch "
          f"{B} at {H}x{W} ==", flush=True)
    model = config_model(config)
    want = CONFIG_LAUNCHES[config]
    requests = [(torch.rand((B, H, W, 3), generator=gen, device="cuda"),
                 torch.rand((B, H, W, 3), generator=gen, device="cuda"))
                for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    flows = []
    for i, (a, b) in enumerate(requests):
        before = dict(LAUNCH_COUNTS)
        flow = predict_flow(model, a, b)
        torch.cuda.synchronize()
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0) for k in want}
        check(tuple(flow.shape) == (B, H, W, 2)
              and bool(torch.isfinite(flow).all()),
              f"{config} request {i}: flow malformed")
        check(n == want, f"{config} request {i}: launches {n}, not {want}")
        flows.append(flow)
    res = {f"launches/{k}": LAUNCH_COUNTS[k] for k in want}
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["mean_flow_px"] = torch.stack(
        [torch.linalg.vector_norm(f, dim=-1).mean() for f in flows]
    ).mean().item()
    model.module.plain_lookup = True
    plain = predict_flow(model, *requests[0])
    model.module.plain_lookup = False
    mx, rel = flow_stats(flows[0], plain)
    res["rel_epe_vs_plain"] = rel
    print(f"{config}: launches per request {want} over {REQUESTS} requests; "
          f"mean |flow| {res['mean_flow_px']:.3f} px; kernels vs plain "
          f"max|dflow|={mx:.3e} px, rel EPE={100 * rel:.4f}%; peak memory "
          f"{res['peak_mem_gib']:.2f} GiB", flush=True)
    check(CAL_SANITY[0] < res["mean_flow_px"] < CAL_SANITY[1],
          f"{config}: calibrated mean |flow| {res['mean_flow_px']:.3f} px "
          f"outside {CAL_SANITY}")
    check(rel <= BF16_REL_EPE_TOL,
          f"{config}: kernels vs plain beyond the 1% bar")
    for a, b in requests[:2]:
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in requests * 2:
        predict_flow(model, a, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res["pairs_per_s"] = B * 2 * REQUESTS / dt
    print(f"{config}: {res['pairs_per_s']:.2f} pairs/s ({1e3 * dt / (2 * REQUESTS):.1f}"
          f" ms per request of {B} pairs)", flush=True)
    return res


def config_train_phase(gen, config: str, steps=(2, 3)) -> dict:
    """``config`` (mixed precision) taking steps[0] + steps[1] AdamW/OneCycle
    steps at batch TB, THxTW (the spatial mode SPATIAL_THxSPATIAL_TW)
    through ``make_train_step``: each step's launches, finite losses, moved
    parameters, frames/s over the last steps[1]; before them, on the first
    batch, one train-mode backward of the f32 model (TF32 off) with the
    kernels against one with the plain lookup on a deep copy: the loss
    within TRAIN_LOSS_REL and the parameter gradients within
    CONFIG_GRAD_F32_REL_L2, both paths summing the same products in other
    orders (in bf16 the convolutions round each difference, and the
    spatial mode's worst tensor reads 0.12 of GRAD_BF16_REL_L2's 0.15)."""
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training import (
        fetch_optimizer,
        make_train_step,
        sequence_loss,
    )

    h, w = (SPATIAL_TH, SPATIAL_TW) if config == "spatial" else (TH, TW)
    print(f"== {config} train step ({CONFIGS[config][:2]}), batch {TB} at "
          f"{h}x{w}, bf16 ==", flush=True)
    batches = [train_batch(gen, TB, h, w) for _ in range(2)]
    want = CONFIG_TRAIN_LAUNCHES[config]

    # the kernels against the plain lookup on the first batch, in f32
    kernel = config_model(config, mixed_precision=False).module.train()
    plain = copy.deepcopy(kernel)
    plain.plain_lookup = True
    losses = []
    for m in (kernel, plain):
        preds = m(batches[0]["image1"].permute(0, 3, 1, 2) * 255.0,
                  batches[0]["image2"].permute(0, 3, 1, 2) * 255.0,
                  test_mode=False)
        loss, _ = sequence_loss([p.permute(0, 2, 3, 1) for p in preds],
                                batches[0]["flow"], batches[0]["valid"])
        loss.backward()
        losses.append(loss.item())
    grads = [{n: p.grad for n, p in m.named_parameters()
              if p.grad is not None and not NORMED_BIAS.search(n)}
             for m in (kernel, plain)]
    rels = sorted((((grads[0][n] - q).norm() / q.norm()).item(), n)
                  for n, q in grads[1].items() if q.norm() > 0)
    total = math.sqrt(sum(((grads[0][n] - q) ** 2).sum().item()
                          for n, q in grads[1].items())
                      / sum((q ** 2).sum().item() for q in grads[1].values()))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"{config}: first step in f32, kernels vs plain: loss "
          f"{losses[0]:.6f} vs {losses[1]:.6f}; parameter gradients rel L2 "
          f"worst {rels[-1][0]:.3e} ({rels[-1][1]}), all {total:.3e} (bounds "
          f"{CONFIG_GRAD_F32_REL_L2})", flush=True)
    check(loss_rel <= TRAIN_LOSS_REL[torch.float32]
          and rels[-1][0] <= CONFIG_GRAD_F32_REL_L2[0]
          and total <= CONFIG_GRAD_F32_REL_L2[1],
          f"{config}: the first step with the kernels beyond the plain "
          "lookup's bounds")
    del kernel, plain, grads

    module = config_model(config).module.train()

    params = list(module.parameters())
    optimizer, scheduler = fetch_optimizer(params, lr=1e-4, num_steps=1000)
    step = make_train_step(module, optimizer, scheduler, is_raft=True)
    start = [p.detach().clone() for p in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCH_COUNTS.clear()
    losses = []
    for i in range(sum(steps)):
        if i == steps[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(LAUNCH_COUNTS)
        losses.append(step(batches[i % 2])["loss"])
        n = {k: LAUNCH_COUNTS[k] - before.get(k, 0) for k in want}
        check(n == want, f"{config} train step {i}: launches {n}, not {want}")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in losses),
          f"{config}: non-finite train loss {losses}")
    moved = sum(not torch.equal(p, q) for p, q in zip(params, start))
    check(moved == len(params),
          f"{config}: only {moved} of {len(params)} parameter tensors moved")
    res = {f"launches/{k}": LAUNCH_COUNTS[k] for k in want}
    res.update(ms_per_step=1e3 * dt / steps[1],
               frames_per_s=TB * steps[1] / dt,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               first_step_grad_rel_l2=total)
    print(f"{config}: launches per step {want}; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; {res['frames_per_s']:.2f} frames/s, {res['ms_per_step']:.1f} "
          f"ms per step, peak memory {res['peak_mem_gib']:.2f} GiB",
          flush=True)
    return res


CONFIG_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_configs"
# the spatial mode's correlation at its train step's shape (its serving
# shape, (B, 256, H/8, W/8) f32, is FlowNetC's, CORR_MAIN["flownetc"])
CORR_RAFT_SPATIAL = {"raft_spatial_train": (
    (TB, 256, SPATIAL_TH // 8, SPATIAL_TW // 8), 21, 2, torch.float32)}
SPATIAL_SHAPES_SEED = 400


def spatial_mode_shapes_phase() -> dict:
    """``spatial_corr_fwd`` / ``spatial_corr_bwd`` at the spatial mode's
    train shape against their plain versions, timed with their bounds."""
    print("== the spatial mode's train shape: spatial_corr_fwd/bwd vs plain "
          "==", flush=True)
    return corr_rows(torch.Generator(device="cuda").manual_seed(
        SPATIAL_SHAPES_SEED), CORR_RAFT_SPATIAL)


def config_cli_phase(gen) -> dict:
    """The CLIs on the new configurations: ``cli.train --synthetic 3``
    (batch 2 at THxTW, the spatial mode at SPATIAL_THxSPATIAL_TW) with
    ``--small``, ``--compute_spatial`` and
    ``--model RAFT_FlowNetCEncoder_WoContext``; ``cli.evaluate --small``
    (f32, EVAL_ITERS iterations) on a written KITTI 2015 layout, its EPE
    and F1 equal to the phase's own from ``predict_flow``; ``cli.parity
    --synthetic 2`` over a written zoo directory holding RAFT's and small
    RAFT's calibrated weights under the JAX registry's file names."""
    from understanding_flow_robustness_tpu_torch.cli import evaluate, parity
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        registry,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training.checkpoint import (
        save_weights,
    )

    print("== the CLIs on small RAFT, the spatial mode and WoContext ==",
          flush=True)
    shutil.rmtree(CONFIG_OUT, ignore_errors=True)
    res = {}
    runs = {"small": (["--small"], {"alt_corr_fwd": ITERS,
                                    "alt_corr_bwd": ITERS}, (TH, TW)),
            "spatial": (["--compute_spatial"], {"spatial_corr_fwd": 1,
                                                "spatial_corr_bwd": 1},
                        (SPATIAL_TH, SPATIAL_TW)),
            "wocontext": (["--model", "RAFT_FlowNetCEncoder_WoContext"],
                          {"alt_corr_fwd": ITERS, "alt_corr_bwd": ITERS},
                          (TH, TW))}
    for name, (flags, per_step, (h, w)) in runs.items():
        LAUNCH_COUNTS.clear()
        t0 = time.perf_counter()
        out = cli_train.main(flags + [
            "--synthetic", "3", "--num_steps", "2", "--batch_size", "2",
            "--image_size", str(h), str(w), "--name", name,
            "--checkpoint_dir", str(CONFIG_OUT / "train"),
            "--n_devices", "1"])
        torch.cuda.synchronize()
        n = {k: LAUNCH_COUNTS[k] for k in per_step}
        check(out["total_steps"] == 3 and len(out["history"]) == 3
              and all(math.isfinite(m["loss"]) for m in out["history"]),
              f"train CLI {flags}: {out['total_steps']} batches, losses "
              f"{[m['loss'] for m in out['history']]}")
        check(n == {k: 3 * v for k, v in per_step.items()},
              f"train CLI {flags}: launches {n} over 3 steps")
        check((CONFIG_OUT / "train" / name / f"{name}.pth").exists(),
              f"train CLI {flags}: no weights written")
        res[f"train/{name}"] = {**{f"launches/{k}": v for k, v in n.items()},
                                "s": time.perf_counter() - t0}
        print(f"train CLI {' '.join(flags)}: 3 batches, launches {n}, "
              f"{res[f'train/{name}']['s']:.1f} s", flush=True)

    # evaluate --small on a written KITTI layout
    root = CONFIG_OUT / "kitti"
    small = config_model("small", mixed_precision=False, iters=EVAL_ITERS)
    pth = CONFIG_OUT / "raft_small.pth"
    save_weights(str(pth), small.module)
    write_kitti_layout(gen, root, small)
    LAUNCH_COUNTS.clear()
    got = evaluate.main(["--model", str(pth), "--dataset", "kitti",
                         "--small", "--data_roots",
                         json.dumps({"kitti": str(root)})])
    n = LAUNCH_COUNTS["alt_corr_fwd"]
    epe, f1, _ = kitti_scores(small, root)
    check(n == EVAL_ITERS * KITTI_SCENES,
          f"evaluate --small: {n} alt_corr_fwd launches")
    # cuDNN's f32 convolutions are not bit-reproducible from call to call
    check(abs(got["kitti-epe"] - epe) <= 1e-4 * epe
          and abs(got["kitti-f1"] - f1) <= 0.1,
          f"evaluate --small: {got}, not predict_flow's {epe!r}/{f1!r}")
    res["evaluate_small"] = {"launches": n, "epe": epe, "f1": f1}
    print(f"evaluate CLI --small: EPE {epe:.4f} F1 {f1:.3f} % on "
          f"{KITTI_SCENES} scenes, equal to the phase's own; {n} "
          "alt_corr_fwd launches", flush=True)

    # parity over a written zoo
    zoo = CONFIG_OUT / "zoo"
    zoo.mkdir()
    for rid in ("RAFT", "RAFT_FlowNetCEncoder_WoContext"):
        m = fetch_model(rid, device="cuda", seed=1)
        torch.save(scale_flow_head(m.module, 0.05).state_dict(),
                   zoo / registry._SPECS[rid].checkpoint)
    LAUNCH_COUNTS.clear()
    rc = parity.main(["--models", "RAFT,RAFT_FlowNetCEncoder_WoContext",
                      "--valsets", "kitti2015", "--synthetic", "2",
                      "--img_height", str(AH), "--img_width", str(AW),
                      "--attack_steps", "3", "--zoo", str(zoo),
                      "--out", str(CONFIG_OUT / "parity")])
    table = json.loads((CONFIG_OUT / "parity" / "parity.json").read_text())[
        "table"]
    check(rc == 0 and set(table) == {"RAFT", "RAFT_FlowNetCEncoder_WoContext"},
          f"parity CLI: rc {rc}, table {table}")
    for rid, rows in table.items():
        row = rows["kitti2015"]
        check(all(math.isfinite(v) for v in row.values())
              and row["ifgsm_epe"] > row["epe"],
              f"parity CLI {rid}: {row}")
    res["parity"] = {"table": table,
                     "launches/alt_corr_fwd": LAUNCH_COUNTS["alt_corr_fwd"],
                     "launches/alt_corr_bwd": LAUNCH_COUNTS["alt_corr_bwd"]}
    print(f"parity CLI over the zoo: {table}; launches alt_corr_fwd "
          f"{LAUNCH_COUNTS['alt_corr_fwd']}, alt_corr_bwd "
          f"{LAUNCH_COUNTS['alt_corr_bwd']}", flush=True)
    shutil.rmtree(CONFIG_OUT, ignore_errors=True)
    return res


def radius_keys(rres: dict, kernel: str, shapes) -> dict:
    """The kernel line's keys of small RAFT's r = 3 rows: time, plain
    version's time, bound (and the library call's, B5) at each shape, and
    the worst error over every radius 1..7."""
    out = {"radii": f"{RADII[0]}..{RADII[-1]}",
           "radii_max_abs_err": rres["worst"][kernel]}
    for shape in shapes:
        r = rres[f"{kernel}/{shape}"]
        for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if k in r:
                out[f"r{SMALL_RADIUS}_{shape}_{k}"] = r[k]
    return out


HOST_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_host"
# the corruptions the JAX copy takes from cv2 (and PIL: pixelate)
HOST_CORRUPTIONS = ("defocus_blur", "frost", "brightness", "saturate",
                    "elastic_transform", "jpeg_compression", "spatter",
                    "pixelate")
HOST_H, HOST_W = 384, 1280
CIRCLE_PATCH = 153


def cv_digest_phase() -> dict:
    """The host library's OpenCV / Pillow operations on the seeded cases of
    ``native/cv_cases.py``: the SHA-256 digest of every output against
    ``data/fixtures/cv_digests.json``, which cv2 and PIL wrote on a
    machine that has them; a mismatch fails."""
    from understanding_flow_robustness_tpu_torch import native
    from understanding_flow_robustness_tpu_torch.native import cv_cases

    print("== host ops: digests of the cv2 / PIL ports against the "
          "fixture ==", flush=True)
    native.load()
    t = time.perf_counter()
    got = cv_cases.port_digests()
    dt = time.perf_counter() - t
    want = cv_cases.load_fixture()
    bad = sorted(k for k in want if got.get(k) != want[k])
    check(sorted(got) == sorted(want) and not bad,
          f"host ops: the digests of {bad or sorted(set(got) ^ set(want))} "
          "differ from data/fixtures/cv_digests.json")
    kinds = sorted({k.split("/")[0] for k in want})
    print(f"host ops: {len(want)} digests equal cv2's and PIL's ("
          + ", ".join(kinds) + f") in {dt:.2f} s", flush=True)
    return {"cases": len(want), "s": dt}


def host_corruption_phase() -> dict:
    """The attack CLI's corruption sweep on its default FlowNetC for each
    corruption the JAX copy takes from cv2 or PIL: severities 1-5 on 2
    synthetic pairs at 384x1280, one ``spatial_corr_fwd`` a forward, a
    results0.txt in each folder; then one I-FGSM run with --write_out and
    --show_evolve whose PNGs and GIFs the port's own readers read back."""
    from understanding_flow_robustness_tpu_torch.cli import run_perturb_model
    from understanding_flow_robustness_tpu_torch.flowviz.gif import (
        decode_gif,
    )
    from understanding_flow_robustness_tpu_torch.flowviz.png import (
        decode_png,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== host corruptions: {len(HOST_CORRUPTIONS)} sweeps on FlowNetC "
          f"at {HOST_H}x{HOST_W}, --synthetic 2; I-FGSM with --write_out "
          "--show_evolve ==", flush=True)
    out = HOST_OUT / "perturb"
    shutil.rmtree(out, ignore_errors=True)
    size = ["--n_height", str(HOST_H), "--n_width", str(HOST_W)]
    run = run_perturb_model.run
    res = {"launches/spatial_corr_fwd": 0, "launches/spatial_corr_bwd": 0,
           "s_per_severity": {}}
    for name in HOST_CORRUPTIONS:
        seen = []

        def timed_run(predict, samples, cfg):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = run(predict, samples, cfg)
            torch.cuda.synchronize()
            seen.append((cfg.output_path, r, time.perf_counter() - t))
            return r

        LAUNCH_COUNTS.clear()
        run_perturb_model.run = timed_run
        try:
            run_perturb_model.main(["--perturb_method", name, "--synthetic",
                                    "2", "--output_path", str(out)] + size)
        finally:
            run_perturb_model.run = run
        expect = {"spatial_corr_fwd": 5 * 2 * 3, "spatial_corr_bwd": 0}
        n = {k: LAUNCH_COUNTS[k] for k in expect}
        check(n == expect, f"{name} sweep: launches {n}, not {expect}")
        res["launches/spatial_corr_fwd"] += n["spatial_corr_fwd"]
        base = out / "kitti2015" / "FlowNetC" / "both" / name
        check([Path(p) for p, _, _ in seen] == [base / str(s)
                                                 for s in range(1, 6)],
              f"{name} sweep: folders {[p for p, _, _ in seen]}")
        for p, r, _ in seen:
            check((Path(p) / "results0.txt").exists()
                  and all(math.isfinite(v[0]) for v in r.values())
                  and r["noise0_l1pix"][0] > 0,
                  f"{name} sweep: {p} has no results0.txt, a non-finite "
                  "metric or no change to the frames")
        secs = [t for _, _, t in seen]
        res["s_per_severity"][name] = secs
        print(f"{name}: launches {n}; results0.txt in 5 folders; mean "
              "|noise| by severity " + ", ".join(
                  f"{r['noise0_l1pix'][0]:.4f}" for _, r, _ in seen)
              + "; seconds per severity (2 pairs) "
              + ", ".join(f"{t:.2f}" for t in secs), flush=True)

    LAUNCH_COUNTS.clear()
    run_perturb_model.main(["--perturb_method", "ifgsm", "--synthetic", "1",
                            "--n_step", "3", "--write_out", "--show_evolve",
                            "--output_path", str(out)] + size)
    for k in ("spatial_corr_fwd", "spatial_corr_bwd"):
        res[f"launches/{k}"] += LAUNCH_COUNTS[k]
    pngs = sorted(out.rglob("*.png"))
    gifs = sorted(out.rglob("*.gif"))
    check(len(pngs) >= 7 and len(gifs) == 2,
          f"--write_out / --show_evolve: {len(pngs)} PNGs, {len(gifs)} GIFs")
    for f in pngs:
        px = decode_png(f.read_bytes())
        check(px.dtype == np.uint8 and px.shape == (HOST_H, HOST_W, 3)
              and px.std() > 0, f"{f.name}: {px.dtype} {px.shape} read back")
    for f in gifs:
        g = decode_gif(f.read_bytes())
        check(len(g["frames"]) == 3 and g["loop"] == 0
              and all(fr.shape == (HOST_H, HOST_W, 3) and fr.std() > 0
                      for fr in g["frames"]),
              f"{f.name}: {len(g['frames'])} frames, loop {g['loop']}")
    print(f"I-FGSM --write_out --show_evolve: {len(pngs)} PNGs and "
          f"{len(gifs)} GIFs of 3 frames at {HOST_H}x{HOST_W}, read back by "
          "flowviz.png / flowviz.gif; launches "
          f"spatial_corr_fwd {LAUNCH_COUNTS['spatial_corr_fwd']}, "
          f"spatial_corr_bwd {LAUNCH_COUNTS['spatial_corr_bwd']}",
          flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return res


def circle_patch_phase() -> dict:
    """``test_patch --self_correlated_patch circle --patch_size 153`` on
    RAFT-12 (mixed precision) over 2 synthetic scenes at 384x1280 with the
    viz panels on: B1's launches, the CSVs, and the ``viz###.jpg`` panels
    read back by the port's JPEG decoder."""
    from understanding_flow_robustness_tpu_torch import native
    from understanding_flow_robustness_tpu_torch.cli import test_patch
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print(f"== test_patch: RAFT, circle patch {CIRCLE_PATCH}, --synthetic 2 "
          f"at {HOST_H}x{HOST_W}, viz on ==", flush=True)
    out = HOST_OUT / "circle"
    shutil.rmtree(out, ignore_errors=True)
    LAUNCH_COUNTS.clear()
    t = time.perf_counter()
    avg = test_patch.main([
        "--flownet", "RAFT", "--self_correlated_patch", "circle",
        "--patch_size", str(CIRCLE_PATCH), "--synthetic", "2",
        "--synthetic-size", str(HOST_H), str(HOST_W), "--output", str(out)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    n = {k: LAUNCH_COUNTS[k] for k in ("alt_corr_fwd", "alt_corr_bwd")}
    d = out / "test_patch"
    rows = (d / "test_result_scenes.csv").read_text().splitlines()
    check(n["alt_corr_fwd"] > 0 and n["alt_corr_fwd"] % ITERS == 0
          and n["alt_corr_bwd"] == 0 and len(rows) == 3 and len(avg) == 4
          and all(math.isfinite(v) for v in avg),
          f"circle test_patch: launches {n}, {len(rows)} CSV rows, "
          f"averages {avg}")
    viz = sorted((d / "images_test").glob("viz*.jpg"))
    check(len(viz) == 2, f"circle test_patch: {len(viz)} viz panels")
    for f in viz:
        px = native.decode_jpeg(f.read_bytes())
        check(px.dtype == np.uint8 and px.ndim == 3 and px.shape[2] == 3
              and px.std() > 0, f"{f.name}: {px.dtype} {px.shape}")
    print(f"circle test_patch: launches {n} ({ITERS} alt_corr_fwd a "
          f"forward); epe {avg[0]:.3f} adv_epe {avg[1]:.3f}; viz000.jpg, "
          f"viz001.jpg {px.shape} decoded; {dt:.1f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return {f"launches/{k}": v for k, v in n.items()}


def host_time_phase() -> dict:
    """Host seconds per severity of each of the 19 corruptions on one
    384x1280 frame (frost's first severity builds its procedural
    texture)."""
    from understanding_flow_robustness_tpu_torch.attacks.corruptions import (
        corrupt,
        get_corruption_names,
    )
    from understanding_flow_robustness_tpu_torch.native import cv_cases

    print(f"== host time of the corruptions at {HOST_H}x{HOST_W} ==",
          flush=True)
    img = cv_cases._image(HOST_H, HOST_W, seed=1)
    res = {}
    for name in get_corruption_names("all"):
        rng = np.random.RandomState(0)
        secs = []
        for severity in range(1, 6):
            t = time.perf_counter()
            out = corrupt(img, name, severity, rng=rng)
            secs.append(time.perf_counter() - t)
            check(out.shape == img.shape and out.dtype == np.uint8,
                  f"{name} {severity}: {out.dtype} {out.shape}")
        res[name] = secs
        print(f"host s per severity, {name}: "
              + " ".join(f"{v:.4f}" for v in secs), flush=True)
    return res


MSGPACK_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_msgpack"
# model -> the kernels' launches of one request of B pairs (phases 6, 7, 20)
MSGPACK_MODELS = {"RAFT": {"alt_corr_fwd": ITERS},
                  "PWCNet": {"warp_fwd": 4, "spatial_corr_fwd": 5},
                  "FlowNet2": {"warp_fwd": 4, "spatial_corr_fwd": 1}}
MSGPACK_TRAIN_STEPS = 2


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic convolutions, for bit-for-bit comparisons of
    two models (its default f32 algorithms differ from call to call)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def msgpack_serve_phase(gen) -> dict:
    """The JAX package's ``.msgpack`` on the card.  Seeded RAFT-12
    (calibrated), PWC-Net and FlowNet2 saved as ``.pth`` and converted by
    the port's ``cli.convert``; ``fetch_model(pretrained_path=x.msgpack)``
    and ``fetch_model(pretrained_path=x.pth)`` on the card each serve one
    request of B pairs at HxW: the same weights, the flows bit-equal
    (cuDNN deterministic), the kernels' launches of a request as phases 6,
    7 and 20 count them on the .msgpack model.  Host seconds to read and
    decode each file, and of each ``fetch_model``."""
    from understanding_flow_robustness_tpu_torch.cli import convert
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training.checkpoint import (
        save_weights,
    )
    from understanding_flow_robustness_tpu_torch.utils import msgpack

    shutil.rmtree(MSGPACK_OUT, ignore_errors=True)
    MSGPACK_OUT.mkdir(parents=True)
    res = {"launches": {}}
    with cudnn_deterministic():
        for name, expect in MSGPACK_MODELS.items():
            print(f"== {name} from a .msgpack: cli.convert, fetch_model, "
                  f"{B} pairs at {H}x{W} ==", flush=True)
            src = fetch_model(name, seed=0)
            if name == "RAFT":  # the serving phase's calibrated point
                scale_flow_head(src.module, 0.05)
            pth, mp = MSGPACK_OUT / f"{name}.pth", MSGPACK_OUT / f"{name}.msgpack"
            save_weights(str(pth), src.module)
            del src
            t = time.perf_counter()
            convert.main(["--flownet", name, "--src", str(pth),
                          "--dst", str(mp)])
            r = {"convert_s": time.perf_counter() - t,
                 "msgpack_mb": mp.stat().st_size / 1e6}
            t = time.perf_counter()
            tree = msgpack.unpackb(mp.read_bytes())
            r["msgpack_decode_s"] = time.perf_counter() - t
            t = time.perf_counter()
            sd = torch.load(pth, map_location="cpu", weights_only=True)
            r["pth_decode_s"] = time.perf_counter() - t
            del tree, sd
            models = {}
            for kind, path in (("msgpack", mp), ("pth", pth)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                models[kind] = fetch_model(name, pretrained_path=str(path),
                                           seed=1)
                torch.cuda.synchronize()
                r[f"{kind}_fetch_s"] = time.perf_counter() - t
            want = models["pth"].module.state_dict()
            for k, v in models["msgpack"].module.state_dict().items():
                # PWC-Net's dead deconv2 is not in a .msgpack: seeded init
                if not (name == "PWCNet" and k.startswith("deconv2.")):
                    check(torch.equal(v, want[k]),
                          f"{name}: {k} from the .msgpack is not the .pth's")
            a, b = (torch.rand((B, H, W, 3), generator=gen, device="cuda")
                    for _ in range(2))
            LAUNCH_COUNTS.clear()
            flow = predict_flow(models["msgpack"], a, b)
            torch.cuda.synchronize()
            n = {k: LAUNCH_COUNTS[k] for k in expect}
            check(n == expect, f"{name} from the .msgpack: launches {n}, "
                               f"not {expect}")
            ref = predict_flow(models["pth"], a, b)
            check(tuple(flow.shape) == (B, H, W, 2)
                  and bool(torch.isfinite(flow).all()),
                  f"{name} from the .msgpack: flow malformed")
            check(torch.equal(flow, ref),
                  f"{name}: the .msgpack's flow is not the .pth's, max "
                  f"|dflow| {(flow - ref).abs().max().item():.3e}")
            for k, v in n.items():
                res["launches"][k] = res["launches"].get(k, 0) + v
            res[name] = r
            print(f"{name}: {r['msgpack_mb']:.1f} MB .msgpack (cli.convert "
                  f"{r['convert_s']:.2f} s); host s to read and decode: "
                  f".msgpack {r['msgpack_decode_s']:.3f}, .pth (torch.load) "
                  f"{r['pth_decode_s']:.3f}; fetch_model on the card: "
                  f".msgpack {r['msgpack_fetch_s']:.3f}, .pth "
                  f"{r['pth_fetch_s']:.3f}; the same weights, the flows "
                  f"bit-equal; launches a request {n}", flush=True)
            del models, flow, ref
            torch.cuda.empty_cache()
    return res


def msgpack_cli_phase(gen) -> dict:
    """The CLIs on RAFT's ``.msgpack`` of ``msgpack_serve_phase``:
    ``cli.infer --pretrained`` over 8 pairs at 375x1242 (every .flo the
    same bytes as from the ``.pth``, 12 ``alt_corr_fwd`` launches);
    ``cli.evaluate --model`` on a written KITTI layout (EPE and F1 those of
    the ``.pth``, EVAL_ITERS launches a scene); ``cli.train
    --restore_ckpt`` from a params-only ``.msgpack`` (the JAX trainer's
    export): its weights restored, 2 steps, 12 ``alt_corr_fwd`` and 12
    ``alt_corr_bwd`` launches each.  The layout stays for
    ``prepare_phase``."""
    from understanding_flow_robustness_tpu_torch.cli import evaluate, infer
    from understanding_flow_robustness_tpu_torch.cli import train as cli_train
    from understanding_flow_robustness_tpu_torch.models import fetch_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.training.checkpoint import (
        save_weights_msgpack,
    )

    pth, mp = MSGPACK_OUT / "RAFT.pth", MSGPACK_OUT / "RAFT.msgpack"
    res = {"launches": {"alt_corr_fwd": 0, "alt_corr_bwd": 0}}
    h, w = KITTI_SIZES[0]
    print(f"== infer CLI from the .msgpack: RAFT-12, 8 pairs at {h}x{w} ==",
          flush=True)
    pairs = MSGPACK_OUT / "pairs"
    pairs.mkdir()
    for i in range(8):
        for f in ("10", "11"):
            (pairs / f"{i:06d}_{f}.png").write_bytes(
                encode_png_filtered(kitti_frame(gen, h, w)))
    with cudnn_deterministic():
        for kind, path in (("msgpack", mp), ("pth", pth)):
            LAUNCH_COUNTS.clear()
            out = infer.main(["--flownet", "RAFT", "--pretrained", str(path),
                              "--dir", str(pairs), "--batch_size", "8",
                              "--output_dir", str(MSGPACK_OUT / kind)])
            n = LAUNCH_COUNTS["alt_corr_fwd"]
            check(out["pairs"] == 8 and n == ITERS,
                  f"infer CLI from the {kind}: {out['pairs']} pairs, {n} "
                  "alt_corr_fwd launches")
            if kind == "msgpack":
                res["launches"]["alt_corr_fwd"] += n
        for i in range(8):
            f = f"{i:06d}.flo"
            check((MSGPACK_OUT / "msgpack" / f).read_bytes()
                  == (MSGPACK_OUT / "pth" / f).read_bytes(),
                  f"infer CLI: {f} from the .msgpack is not the .pth's")
        print(f"infer CLI: 8 .flo from the .msgpack equal the .pth's, byte "
              f"for byte; {ITERS} alt_corr_fwd launches", flush=True)

        print(f"== evaluate CLI from the .msgpack: RAFT f32, {EVAL_ITERS} "
              f"iterations, {KITTI_SCENES} KITTI scenes ==", flush=True)
        root = MSGPACK_OUT / "kitti"
        model = fetch_model("RAFT", pretrained_path=str(pth),
                            mixed_precision=False, iters=EVAL_ITERS)
        write_kitti_layout(gen, root, model)
        del model
        scores = {}
        for kind, path in (("msgpack", mp), ("pth", pth)):
            LAUNCH_COUNTS.clear()
            scores[kind] = evaluate.main([
                "--model", str(path), "--dataset", "kitti", "--data_roots",
                json.dumps({"kitti": str(root)})])
            n = LAUNCH_COUNTS["alt_corr_fwd"]
            check(n == EVAL_ITERS * KITTI_SCENES,
                  f"evaluate CLI from the {kind}: {n} alt_corr_fwd launches")
            if kind == "msgpack":
                res["launches"]["alt_corr_fwd"] += n
        check(scores["msgpack"] == scores["pth"] and all(
            math.isfinite(v) for v in scores["msgpack"].values()),
            f"evaluate CLI: {scores['msgpack']} from the .msgpack, "
            f"{scores['pth']} from the .pth")
        res["evaluate"] = scores["msgpack"]
        print(f"evaluate CLI: {scores['msgpack']} from the .msgpack, equal "
              "to the .pth's", flush=True)

    print(f"== train CLI --restore_ckpt params-only .msgpack: RAFT, "
          f"{MSGPACK_TRAIN_STEPS} steps at batch 2, {TH}x{TW} ==", flush=True)
    params = MSGPACK_OUT / "RAFT_params.msgpack"
    src = fetch_model("RAFT", pretrained_path=str(pth), device="cpu")
    save_weights_msgpack(str(params), src.module)
    restored = []
    load = cli_train.load_variables

    def snapshot(path, module):
        out = load(path, module)
        restored.append({k: v.detach().cpu().clone()
                         for k, v in module.state_dict().items()})
        return out

    ckpt = MSGPACK_OUT / "ckpt"
    cli_train.load_variables = snapshot
    try:
        LAUNCH_COUNTS.clear()
        out = cli_train.main([
            "--restore_ckpt", str(params), "--synthetic", "3",
            "--num_steps", str(MSGPACK_TRAIN_STEPS - 1), "--batch_size", "2",
            "--image_size", str(TH), str(TW), "--mixed_precision",
            "--name", "msgpack", "--checkpoint_dir", str(ckpt),
            "--n_devices", "1"])
    finally:
        cli_train.load_variables = load
    n = {k: LAUNCH_COUNTS[k] for k in TRAIN_KERNELS}
    expect = {k: ITERS * MSGPACK_TRAIN_STEPS for k in TRAIN_KERNELS}
    check(n == expect and len(out["history"]) == MSGPACK_TRAIN_STEPS
          and all(math.isfinite(m["loss"]) for m in out["history"]),
          f"train CLI from the .msgpack: launches {n}, history "
          f"{out['history']}")
    want = src.module.state_dict()
    check(len(restored) == 1 and all(
        torch.equal(v, want[k]) for k, v in restored[0].items()),
        "train CLI: the weights restored are not the .msgpack's")
    for k in TRAIN_KERNELS:
        res["launches"][k] += n[k]
    print(f"train CLI: {MSGPACK_TRAIN_STEPS} steps from the params-only "
          f".msgpack (its weights restored, batch norm at init), losses "
          + ", ".join(f"{m['loss']:.4f}" for m in out["history"])
          + f"; launches {n}", flush=True)
    return res


PREP_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_prepare"
# drive -> its frames' OXTS speeds (m/s): 2 and 3 static frames
PREP_DRIVES = {"2011_09_26_drive_0001_sync": [5.0, 0.3, 6.0, 7.0, 0.5, 8.0,
                                              8.5, 9.0],
               "2011_09_26_drive_0002_sync": [0.1, 3.0, 3.5, 0.2, 4.0, 4.5,
                                              0.8, 5.0]}
PREP_P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                    [0.0, 721.5377, 172.854, 0.2163791],
                    [0.0, 0.0, 1.0, 0.002745884]])


def write_raw_tree(gen, root: Path) -> None:
    """A KITTI raw date: calib_cam_to_cam.txt and the PREP_DRIVES, each
    with image_02/data/*.png frames at KITTI's 375x1242 and
    oxts/data/*.txt packets (30 fields; vf, vl, vu at 8-10)."""
    from understanding_flow_robustness_tpu_torch.flowviz import io as fio

    date = root / "2011_09_26"
    date.mkdir(parents=True)
    (date / "calib_cam_to_cam.txt").write_text(
        "calib_time: 09-Jan-2012 13:57:47\nP_rect_02: "
        + " ".join(f"{v:e}" for v in PREP_P2.ravel()) + "\n")
    rng = np.random.RandomState(PATCH_SEED)
    h, w = KITTI_SIZES[0]
    for drive, speeds in PREP_DRIVES.items():
        imgs, oxts = date / drive / "image_02" / "data", date / drive / "oxts" / "data"
        imgs.mkdir(parents=True)
        oxts.mkdir(parents=True)
        for i, v in enumerate(speeds):
            fio.write_image(str(imgs / f"{i:010d}.png"), kitti_frame(gen, h, w))
            vals = rng.randn(30)
            vals[8:11] = np.array([0.8, 0.36, 0.48]) * v
            np.savetxt(oxts / f"{i:010d}.txt", vals[None], fmt="%.6f")


def prepare_phase(gen) -> dict:
    """KITTI raw preparation on the card's machine, then patch training on
    its dump.  ``cli.prepare_train_data`` at its defaults (128x416) on two
    written drives of 8 frames at 375x1242 with static frames: the scenes,
    the kept frames, each JPEG's size, ``cam.txt`` (P_rect_02 scaled) and
    the split; host ms per frame of reading, resizing, encoding and in
    all.  Then a 384x1280 dump of the same tree, on which the patch CLI
    (FlowNetC) trains 2 batches through ``SequenceFolder`` and validates
    on one scene of ``msgpack_cli_phase``'s KITTI layout: both correlation
    kernels' launches."""
    from understanding_flow_robustness_tpu_torch.cli import (
        patch_attack as cli_patch,
    )
    from understanding_flow_robustness_tpu_torch.cli import (
        prepare_train_data,
    )
    from understanding_flow_robustness_tpu_torch.native import decode_jpeg
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS

    print("== prepare_train_data: 2 KITTI raw drives of 8 frames at "
          f"{KITTI_SIZES[0]}, static frames ==", flush=True)
    shutil.rmtree(PREP_OUT, ignore_errors=True)
    write_raw_tree(gen, PREP_OUT / "raw")
    kept = {d: sum(v >= 1.0 for v in s) for d, s in PREP_DRIVES.items()}
    dump = PREP_OUT / "dump"
    t = time.perf_counter()
    out = prepare_train_data.main(["--dataset_dir", str(PREP_OUT / "raw"),
                                   "--dump_root", str(dump)])
    wall = time.perf_counter() - t
    frames = sum(kept.values())
    check(out["scenes"] == sorted(PREP_DRIVES) and out["frames"] == frames,
          f"prepare: scenes {out['scenes']}, {out['frames']} frames, not "
          f"{sorted(PREP_DRIVES)} and {frames}")
    for drive, n in kept.items():
        jpgs = sorted((dump / drive).glob("*.jpg"))
        check(len(jpgs) == n and all(
            decode_jpeg(p.read_bytes()).shape == (128, 416, 3) for p in jpgs),
            f"prepare: {drive} holds {len(jpgs)} frames, not {n} of 128x416")
        k = np.genfromtxt(dump / drive / "cam.txt", delimiter=",")
        h, w = KITTI_SIZES[0]
        want = PREP_P2[:, :3] * np.array([[416 / w], [128 / h], [1]])
        check(np.allclose(k, want, rtol=1e-6), f"prepare: cam.txt {k}")
    check((dump / "train.txt").read_text() == sorted(PREP_DRIVES)[1] + "\n"
          and (dump / "val.txt").read_text() == sorted(PREP_DRIVES)[0] + "\n",
          "prepare: train.txt / val.txt split")
    res = {f"{k}_ms": 1e3 * v / frames for k, v in out["seconds"].items()}
    res["total_ms"] = 1e3 * wall / frames
    print(f"prepare: {frames} frames of {sum(map(len, PREP_DRIVES.values()))}"
          f" kept in 2 scenes; host ms per frame: read {res['read_ms']:.2f}, "
          f"resize {res['resize_ms']:.2f}, encode {res['encode_ms']:.2f} "
          f"(summed over the threads), wall {res['total_ms']:.2f} over the "
          "8-thread pool", flush=True)

    print("== patch CLI on the prepared dump: FlowNetC, 2 batches through "
          "SequenceFolder ==", flush=True)
    full = PREP_OUT / "dump_384"
    prepare_train_data.main(["--dataset_dir", str(PREP_OUT / "raw"),
                             "--dump_root", str(full), "--height", "384",
                             "--width", "1280"])
    LAUNCH_COUNTS.clear()
    with recording(cli_patch, "make_patch_attack_step", True) as steps, \
            recording(cli_patch, "validate_patch") as metrics, \
            valset_cut_to(1):
        patch, mask = cli_patch.main([
            "--flownet", "FlowNetC", "--data", str(full), "--kitti-data",
            str(MSGPACK_OUT / "kitti"), "--epochs", "1", "--epoch-size",
            "2", "--patch-size", "0.3", "--output", str(PREP_OUT / "attack"),
            "--name", "prepared"])
    counts = [r[4] for r, _ in steps]
    expect = {"spatial_corr_fwd": len(counts) + sum(counts) + 2,
              "spatial_corr_bwd": sum(counts)}
    n = {k: LAUNCH_COUNTS[k] for k in expect}
    check(len(counts) == 2 and n == expect and len(metrics) == 1
          and all(math.isfinite(v) for v in metrics[0].values()),
          f"patch CLI on the dump: {len(counts)} batches of {counts} "
          f"iterations, launches {n}, not {expect}; metrics {metrics}")
    res.update({f"launches/{k}": v for k, v in n.items()})
    print(f"patch CLI on the dump: 2 batches of {counts} inner iterations, "
          f"launches {n}; epe {metrics[0]['epe']:.3f} adv_epe "
          f"{metrics[0]['adv_epe']:.3f}", flush=True)
    shutil.rmtree(PREP_OUT, ignore_errors=True)
    shutil.rmtree(MSGPACK_OUT, ignore_errors=True)
    return res


def profile_phase(gen) -> dict:
    """One RAFT-12 request (8 pairs at HxW, calibrated seeded weights)
    inside ``utils.profile_trace``: the Chrome trace is written and names
    the ``alt_corr_fwd`` kernel; 12 launches; the device's idle share over
    the request."""
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.utils import profile_trace

    print(f"== profile_trace of one RAFT-12 request, {B} pairs at {H}x{W} ==",
          flush=True)
    log = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
    shutil.rmtree(log, ignore_errors=True)
    model = fetch_model("RAFT")
    scale_flow_head(model.module, 0.05)
    a, b = (torch.rand((B, H, W, 3), generator=gen, device="cuda")
            for _ in range(2))
    predict_flow(model, a, b)  # warm-up
    torch.cuda.synchronize()
    LAUNCH_COUNTS.clear()
    with profile_trace(str(log)) as prof:
        flow = predict_flow(model, a, b)
        torch.cuda.synchronize()
    n = LAUNCH_COUNTS["alt_corr_fwd"]
    files = sorted(log.glob("*.pt.trace.json"))
    check(len(files) == 1, f"profile_trace wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "alt_corr_fwd" in e.get("name", "")]
    check(n == ITERS and len(kernels) == ITERS
          and bool(torch.isfinite(flow).all()),
          f"profile_trace: {n} launches, {len(kernels)} alt_corr_fwd kernel "
          "events in the trace")
    busy, span = device_activity(prof)
    res = {"launches": n, "trace_mb": files[0].stat().st_size / 1e6,
           "idle_share": 1 - busy / span}
    print(f"profile_trace: {files[0].name} ({res['trace_mb']:.1f} MB) names "
          f"alt_corr_fwd in {len(kernels)} kernel events "
          f"({kernels[0]['name'][:60]}...); device idle "
          f"{100 * res['idle_share']:.1f} % of the request", flush=True)
    shutil.rmtree(log, ignore_errors=True)
    return res


# the data-parallel phase: one process per rank (parallel.launch); its
# KITTI tree and inputs from a generator of its own, after every other
# phase, so that theirs stay as they were
DP_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
DP_SEED = 500
DP_TIMED = 5             # timed steps of each world-1 step, in turns
DP_ATTACK_STEPS = 1      # the compared I-FGSM (batch 2): one sign step,
DP_NO_CUDNN_STEPS = 3    # and three with cuDNN off
# world 1 (NCCL) against the plain step, world 2 (gloo, one card) against
# the plain step on the full batch, at the calibrated point (the flow head
# x 0.05, as phase 9): two runs of the same step already part (B2's
# atomics land in another order each run) and the sharded one sums in
# other orders.  The loss and the running statistics within
# TRAIN_LOSS_REL's bars.  The gradients: all parameters within phase 9's
# bars (GRAD_BF16_REL_L2, GRAD_F32_REL_L2), the worst tensor within twice
# what the first chip run of this phase measured (H100 80GB HBM3, 700 W):
# 0.152 bf16 (a cnet batch norm's bias) and 2.95e-3 f32 (a batch norm's
# weight), where two runs of the same bf16 step part by 5.5e-3 (fnet).
# The worst tensors are the batch norms' own parameters, whose gradients
# are sums of cancelling terms that the shards and the all-reduce
# reorder; a wrong gradient is off by O(1) in all parameters together
DP_LOSS_REL = {"bf16": 1e-3, "f32": 1e-5}
DP_STATS_REL = {"bf16": 1e-3, "f32": 1e-5}
DP_GRAD_BARS = {"bf16": (0.3, GRAD_BF16_REL_L2[1]),
                "f32": (1e-2, GRAD_F32_REL_L2[1])}
# explicit bf16 transport against explicit f32: the gradients rounded to
# bf16 (half an ulp, 2^-9 relative) on top of the run-to-run noise above
# (measured 5.6e-3 worst, 2.3e-3 all)
DP_BF16_GRAD_REL_L2 = 1e-2
DP_LOSS_REL["transport"] = DP_LOSS_REL["bf16"]
DP_STATS_REL["transport"] = DP_STATS_REL["bf16"]
DP_GRAD_BARS["transport"] = (DP_BF16_GRAD_REL_L2, DP_BF16_GRAD_REL_L2)
# sharded validation (f32, 24 iterations) at world 2 against one rank: the
# same per-sample work on the same card; f32 cuDNN convolutions are not
# bit-reproducible from call to call (~1e-5 px)
DP_EPE_REL = 1e-5
# the sharded I-FGSM against the unsharded one (f32 RAFT, 24 iterations):
# elements apart by more than 1e-6 at most this share, none by more than
# 2 lr a step (a near-zero image gradient whose sign the two batch sizes'
# sums flip moves a pixel by 2 lr).  With cuDNN, whose convolutions sum in
# another order at batch 1 than at batch 2, one step: 1.0e-6 of the
# elements measured; later steps amplify such flips as they amplify a
# one-ulp nudge of the input (scripts/torch_dp_attack_cause.py).  With
# cuDNN off the unsharded attack on each half alone equals the whole
# batch's over 3 steps (the same script), so three steps are compared
DP_ATTACK_SHARE = 1e-3


def dp_attacks() -> dict:
    """(e)'s attacks: {name: (configuration, cuDNN on)}."""
    from understanding_flow_robustness_tpu_torch.attacks import PerturbConfig

    def ifgsm(steps):
        return PerturbConfig(perturb_method="ifgsm", flow_loss="l2",
                             output_norm=ATTACK_EPS, n_step=steps)

    return {"ifgsm": (ifgsm(DP_ATTACK_STEPS), True),
            "ifgsm_no_cudnn": (ifgsm(DP_NO_CUDNN_STEPS), False),
            "gaussian": (PerturbConfig(perturb_method="gaussian",
                                       output_norm=ATTACK_EPS), True)}


@contextlib.contextmanager
def cudnn_enabled(on: bool):
    old = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = on
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = old


def _dp_flags() -> None:
    """A rank starts with PyTorch's defaults: TF32 off, as in main()."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dp_step(mesh, state: dict, batch: dict, mode: str = "pjit",
            steps: int = 1, precision: str = "bf16") -> dict:
    """``steps`` steps of RAFT-12 (``precision``: mixed, or f32; ``state``)
    through
    ``make_train_step`` on this rank's slice of ``batch`` (CPU tensors), in
    ``mode``; ``mesh=None`` is the plain one-device step.  Returns the
    first step's loss, the gradients it gave the optimizer (before the
    clip; on the host), the running statistics after it, the bytes it
    all-reduced, the B1/B2 launches of all steps and the ms per step of
    the steps after the first."""
    from understanding_flow_robustness_tpu_torch.models import fetch_model
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.parallel import shard_batch
    from understanding_flow_robustness_tpu_torch.training import (
        fetch_optimizer,
        make_train_step,
    )

    dev = mesh.device if mesh is not None else torch.device("cuda")
    module = fetch_model("RAFT", device=dev, seed=0,
                         mixed_precision=precision == "bf16").module
    module.load_state_dict(state)
    optimizer, scheduler = fetch_optimizer(list(module.parameters()),
                                           lr=1e-4, num_steps=1000)
    step = make_train_step(module, optimizer, scheduler, is_raft=True,
                           mesh=mesh, explicit=mode != "pjit",
                           grad_transport="bf16" if mode == "bf16" else "f32")
    local = {k: v.to(dev) for k, v in shard_batch(mesh, batch).items()}
    grads = {}
    real_clip = torch.nn.utils.clip_grad_norm_

    def record(params, clip):
        if not grads:
            grads.update({n: p.grad.detach().float().cpu()
                          for n, p in module.named_parameters()
                          if p.grad is not None})
        return real_clip(params, clip)

    torch.nn.utils.clip_grad_norm_ = record
    LAUNCH_COUNTS.clear()
    try:
        metrics = step(local)
        stats = {k: v.detach().cpu().clone()
                 for k, v in module.state_dict().items() if "running" in k}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            step(local)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / max(steps - 1, 1)
    finally:
        torch.nn.utils.clip_grad_norm_ = real_clip
    return {"loss": metrics["loss"], "grads": grads, "stats": stats,
            "sent": step.sent_bytes, "ms": ms,
            "launches": {k: LAUNCH_COUNTS[k] for k in TRAIN_KERNELS}}


def dp_world1_rank(mesh, state: dict, batch: dict) -> dict:
    """(a): the plain step and the NCCL world-1 step from the same weights
    on the same batch, then both timed in turns (plain, mesh, mesh, plain,
    plain, mesh)."""
    _dp_flags()
    out = {"plain": dp_step(None, state, batch),
           "mesh": dp_step(mesh, state, batch)}
    times = {"plain": [], "mesh": []}
    out["launches"] = dict(out["mesh"]["launches"])
    for kind in ("plain", "mesh", "mesh", "plain", "plain", "mesh"):
        r = dp_step(mesh if kind == "mesh" else None, state, batch,
                    steps=DP_TIMED + 1)
        times[kind].append(r["ms"])
        if kind == "mesh":
            for k, n in r["launches"].items():
                out["launches"][k] += n
    out["ms"] = {k: float(np.mean(v)) for k, v in times.items()}
    out["ms_turns"] = times
    return out


def dp_world2_rank(mesh, state: dict, batch: dict, job: dict) -> dict:
    """(b)-(e) on this rank: the three step modes (the pjit one also timed),
    sharded KITTI validation, the sharded attacks.  Rank 0 returns its own
    results and every rank's launches."""
    from understanding_flow_robustness_tpu_torch.attacks import (
        make_sharded_attack,
    )
    from understanding_flow_robustness_tpu_torch.data import KITTI
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow_differentiable,
    )
    from understanding_flow_robustness_tpu_torch.ops import LAUNCH_COUNTS
    from understanding_flow_robustness_tpu_torch.parallel import (
        all_gather,
        gather_objects,
        shard_batch,
    )
    from understanding_flow_robustness_tpu_torch.training import evaluate

    _dp_flags()
    out = {mode: dp_step(mesh, state, batch, mode,
                         steps=DP_TIMED + 1 if mode == "pjit" else 1)
           for mode in ("pjit", "explicit", "bf16")}
    out["pjit_f32"] = dp_step(mesh, state, batch, precision="f32")
    launches = {f"{k}/{mode}": v for mode in out
                for k, v in out[mode]["launches"].items()}
    if job is None:
        return out
    model = fetch_model("RAFT", mixed_precision=False, iters=EVAL_ITERS,
                        device=mesh.device)
    model.module.load_state_dict(job["eval_state"])
    LAUNCH_COUNTS.clear()
    out["validate"] = evaluate.validate_kitti(
        model, KITTI(root=job["kitti"]), mesh=mesh)
    launches["alt_corr_fwd/validate"] = LAUNCH_COUNTS["alt_corr_fwd"]
    attacks = {}
    for name, (cfg, cudnn) in dp_attacks().items():
        gen = torch.Generator(device=mesh.device).manual_seed(DP_SEED)
        run = make_sharded_attack(
            lambda a, b: predict_flow_differentiable(model, a, b), cfg, mesh)
        LAUNCH_COUNTS.clear()
        with cudnn_enabled(cudnn):
            res = run(*(x.to(mesh.device) for x in shard_batch(
                mesh, job["attack"])), gen)
            torch.cuda.synchronize()
        for k in TRAIN_KERNELS:
            launches[f"{k}/{name}"] = LAUNCH_COUNTS[k]
        attacks[name] = [all_gather(mesh, x).cpu() for x in res]
    out["attacks"] = attacks
    out["launches"] = gather_objects(mesh, launches)
    return out


def dp_phase(gen) -> dict:
    """Data parallelism, one process per rank (``parallel.launch``):
    (a) RAFT-12's train step (batch TB at THxTW, mixed precision, B1 and
    B2) at world 1 over NCCL against the plain one-device step from the
    same weights on the same batch, and both timed in turns; (b) the step
    at world 2 over gloo with both ranks on cuda:0 against the plain step
    on the full batch (the gradients before the optimizer, the loss, the
    batch-norm running statistics); (c) the explicit step with bf16
    gradient transport against the explicit f32 one; (d) sharded KITTI
    validation (f32, 24 iterations) at world 2 on a KITTI tree of the
    evaluate phase's layout against one rank's; (e) ``make_sharded_attack``
    (I-FGSM on f32 RAFT, one step with cuDNN and three without it; gaussian
    noise) at world 2 against the unsharded attack.  With two cards, (b) over NCCL on two cards too.  Every mesh
    step, validation sample and attack step counts its B1/B2 launches."""
    from understanding_flow_robustness_tpu_torch.attacks import make_attack
    from understanding_flow_robustness_tpu_torch.data import KITTI
    from understanding_flow_robustness_tpu_torch.models import (
        fetch_model,
        predict_flow_differentiable,
        scale_flow_head,
    )
    from understanding_flow_robustness_tpu_torch.parallel import (
        launch,
        make_mesh,
    )
    from understanding_flow_robustness_tpu_torch.training import evaluate

    print(f"== data parallelism: RAFT-12 train step, batch {TB} at "
          f"{TH}x{TW}, bf16; world 1 over NCCL, world 2 over gloo on one "
          "card; sharded validation and attack ==", flush=True)
    dgen = torch.Generator(device="cuda").manual_seed(DP_SEED)
    state = {k: v.cpu() for k, v in scale_flow_head(fetch_model(
        "RAFT", device="cuda", seed=0).module, 0.05).state_dict().items()}
    batch = {k: v.cpu() for k, v in train_batch(dgen, TB).items()}
    ref = {"bf16": dp_step(None, state, batch),
           "f32": dp_step(None, state, batch, precision="f32")}
    shutil.rmtree(DP_OUT, ignore_errors=True)
    eval_model = fetch_model("RAFT", mixed_precision=False, iters=EVAL_ITERS)
    eval_model.module = scale_flow_head(eval_model.module, 0.05)
    write_kitti_layout(dgen, DP_OUT / "kitti", eval_model)
    attack_in = [torch.rand((2, AH, AW, 3), generator=dgen, device="cuda"),
                 torch.rand((2, AH, AW, 3), generator=dgen, device="cuda"),
                 torch.cat([3 * torch.randn((2, AH, AW, 2), generator=dgen,
                                            device="cuda"),
                            torch.ones((2, AH, AW, 1), device="cuda")], -1)]
    job = {"eval_state": {k: v.cpu() for k, v in
                          eval_model.module.state_dict().items()},
           "kitti": str(DP_OUT / "kitti"),
           "attack": [x.cpu() for x in attack_in]}
    res = {}

    def compare(name, got, want, precision):
        loss_rel, stats_rel = DP_LOSS_REL[precision], DP_STATS_REL[precision]
        grad_bars = DP_GRAD_BARS[precision]
        dl = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        ds = max(float((got["stats"][k] - v).norm() / v.norm())
                 for k, v in want["stats"].items())
        rels = sorted((float((got["grads"][n] - g).norm() / g.norm()), n)
                      for n, g in want["grads"].items()
                      if not NORMED_BIAS.search(n))
        total = math.sqrt(sum(float(((got["grads"][n] - g) ** 2).sum())
                              for n, g in want["grads"].items()
                              if not NORMED_BIAS.search(n))
                          / sum(float((g ** 2).sum())
                                for n, g in want["grads"].items()
                                if not NORMED_BIAS.search(n)))
        res[name] = {"loss_rel": dl, "stats_rel": ds,
                     "grad_worst_rel_l2": rels[-1][0],
                     "grad_total_rel_l2": total}
        print(f"{name}: loss {got['loss']:.6f} vs {want['loss']:.6f} (rel "
              f"{dl:.2e}, bar {loss_rel:g}); running statistics rel L2 "
              f"worst {ds:.2e} (bar {stats_rel:g}); gradients rel L2 worst "
              f"{rels[-1][0]:.2e} ({rels[-1][1]}), all {total:.2e} (bars "
              f"{grad_bars})", flush=True)
        check(dl <= loss_rel and ds <= stats_rel and rels[-1][0]
              <= grad_bars[0] and total <= grad_bars[1],
              f"{name}: beyond its bars")

    # (a) world 1 over NCCL
    w1 = launch(dp_world1_rank, 1, state, batch, device="cuda")
    n_params = sum(g.numel() for g in ref["f32"]["grads"].values())
    check(w1["mesh"]["sent"] == 4 * n_params,
          f"world 1: {w1['mesh']['sent']} bytes all-reduced")
    compare("(a) world 1 NCCL vs plain step, bf16", w1["mesh"], w1["plain"],
            "bf16")
    launches = dict(w1["launches"])
    for k in TRAIN_KERNELS:  # the compared step, then three timed runs
        check(launches[k] == ITERS * (1 + 3 * (DP_TIMED + 1)),
              f"(a): {k} launched {launches[k]} times")

    # (b)-(e) world 2 over gloo, both ranks on cuda:0
    w2 = launch(dp_world2_rank, 2, state, batch, job, device="cuda",
                backend="gloo", devices=[0, 0])
    for precision, mode in (("bf16", "pjit"), ("f32", "pjit_f32")):
        compare(f"(b) world 2 gloo one card vs plain step, full batch, "
                f"{precision}", w2[mode], ref[precision], precision)
    compare("(c) explicit bf16 transport vs explicit f32", w2["bf16"],
            w2["explicit"], "transport")
    check(w2["pjit"]["sent"] == 4 * n_params
          and w2["bf16"]["sent"] == 2 * n_params,
          f"world 2: {w2['pjit']['sent']} / {w2['bf16']['sent']} bytes")
    for rank, counts in enumerate(w2["launches"]):
        for mode in ("pjit", "explicit", "bf16", "pjit_f32"):
            steps = DP_TIMED + 1 if mode == "pjit" else 1
            for k in TRAIN_KERNELS:
                n = counts[f"{k}/{mode}"]
                check(n == ITERS * steps, f"rank {rank} {mode}: {k} "
                                          f"launched {n} times")
        n = counts["alt_corr_fwd/validate"]
        check(n == EVAL_ITERS * (KITTI_SCENES // 2),
              f"rank {rank}: validation launched alt_corr_fwd {n} times")
        for name in ("ifgsm", "ifgsm_no_cudnn"):
            steps = dp_attacks()[name][0].n_step
            for k in TRAIN_KERNELS:  # a forward and a backward a step
                n = counts[f"{k}/{name}"]
                check(n == EVAL_ITERS * steps,
                      f"rank {rank}: the sharded {name} launched {k} {n} "
                      "times")
        for k in TRAIN_KERNELS:
            launches[k] += sum(v for key, v in counts.items()
                               if key.startswith(k + "/"))

    # (d) against one rank's sharded validation
    one = evaluate.validate_kitti(eval_model, KITTI(root=job["kitti"]),
                                  mesh=make_mesh(1))
    d_epe = abs(w2["validate"]["kitti-epe"] - one["kitti-epe"]) \
        / one["kitti-epe"]
    ds = KITTI(root=job["kitti"])
    n_valid = sum(int((ds[i][3] >= 0.5).sum()) for i in range(len(ds)))
    d_out = abs(w2["validate"]["kitti-f1"] - one["kitti-f1"]) / 100 * n_valid
    print(f"(d) sharded KITTI validation, world 2 vs one rank: EPE "
          f"{w2['validate']['kitti-epe']:.6f} vs {one['kitti-epe']:.6f} (rel "
          f"{d_epe:.2e}, bar {DP_EPE_REL:g}), F1 "
          f"{w2['validate']['kitti-f1']:.4f} vs {one['kitti-f1']:.4f} % "
          f"({d_out:.1f} outlier pixels apart over {len(ds)} frames)",
          flush=True)
    check(d_epe <= DP_EPE_REL and d_out <= len(ds),
          "(d) sharded validation beyond its bars")
    res["validate"] = {"epe_rel": d_epe, "outliers_apart": d_out}

    # (e) against the unsharded attacks
    for name, (cfg, cudnn) in dp_attacks().items():
        gen1 = torch.Generator(device="cuda").manual_seed(DP_SEED)
        with cudnn_enabled(cudnn):
            want = make_attack(lambda a, b: predict_flow_differentiable(
                eval_model, a, b), cfg)(*attack_in, gen1)
        diffs = [(g - w.cpu()).abs() for g, w in zip(w2["attacks"][name],
                                                      want)]
        share = max(float((d > 1e-6).float().mean()) for d in diffs)
        worst = max(float(d.max()) for d in diffs)
        print(f"(e) sharded {name} vs unsharded: max |d| {worst:.2e}, share "
              f"of elements apart {share:.2e}", flush=True)
        if name == "gaussian":
            check(worst == 0.0, "(e) gaussian noise not the unsharded draw")
        else:
            check(share <= DP_ATTACK_SHARE
                  and worst <= 2 * cfg.n_step * cfg.learning_rate + 1e-6,
                  f"(e) sharded {name} beyond its bars")
        res[f"attack/{name}"] = {"max_abs": worst, "share": share}

    if torch.cuda.device_count() >= 2:
        w2n = launch(dp_world2_rank, 2, state, batch, None, device="cuda")
        for precision, mode in (("bf16", "pjit"), ("f32", "pjit_f32")):
            compare(f"(b) world 2 NCCL two cards vs plain step, full batch, "
                    f"{precision}", w2n[mode], ref[precision], precision)
    else:
        print("(b) over NCCL across two cards: not run (this machine has "
              f"{torch.cuda.device_count()} card)", flush=True)
    res.update({f"launches/{k}": v for k, v in launches.items()})
    res.update({"world1_plain_ms": w1["ms"]["plain"],
                "world1_nccl_ms": w1["ms"]["mesh"],
                "world2_one_card_ms": w2["pjit"]["ms"],
                "f32_bytes": w2["pjit"]["sent"],
                "bf16_bytes": w2["bf16"]["sent"]})
    print(f"data parallelism ({gpu_line()}): world-1 step over NCCL "
          f"{res['world1_nccl_ms']:.1f} ms against the plain step's "
          f"{res['world1_plain_ms']:.1f} ms ({3 * DP_TIMED} steps each, in "
          "turns of " + ", ".join(
              f"{k} " + " / ".join(f"{t:.1f}" for t in v)
              for k, v in w1["ms_turns"].items())
          + f" ms); gradient all-reduce {res['f32_bytes'] / 1e6:.2f} MB a "
          f"step in f32, {res['bf16_bytes'] / 1e6:.2f} MB in bf16; world 2 "
          f"on one card over gloo {res['world2_one_card_ms']:.1f} ms a step "
          "of each rank (two ranks share one card: not a scaling number); "
          f"B1 {launches['alt_corr_fwd']}, B2 {launches['alt_corr_bwd']} "
          "launches", flush=True)
    shutil.rmtree(DP_OUT, ignore_errors=True)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: torch.cuda.is_available() is False")
    from understanding_flow_robustness_tpu_torch.ops import _build

    # f32 comparisons in full f32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    KERNELS = _build.KERNELS
    _build.build_libraries(KERNELS)
    for k in KERNELS:
        _build.load_library(k)
    print(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s, "
          "in parallel (nvcc "
          + ", ".join(f"{k} {_build.BUILD_SECONDS.get(k, 0.0):.2f} s"
                      for k in KERNELS) + ")", flush=True)
    for k in KERNELS:
        print(_build.library_path(k).with_suffix(".log").read_text().strip(),
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"-- phase {fn.__name__}{args[1:]} took "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        return out

    kres = phase(kernel_phase, gen)
    bres = phase(backward_phase, gen)
    dres = phase(dcoords_phase, gen)
    wres = phase(warp_phase, gen)
    vkres = phase(volume_kernel_phase, gen)
    mres = phase(model_phase, gen)
    vres = phase(volume_model_phase, gen)
    fres = phase(taps_phase, gen)
    cres = phase(wocontext_phase, gen)
    sres = phase(warp_model_phase, gen, "SpyNet", 6)
    pres = phase(warp_model_phase, gen, "PWCNet", 4, 5)
    tres = phase(train_phase, gen)
    phase(grad_phase, gen)
    scres = phase(spatial_corr_phase, gen)
    fnres = phase(flownet_phase, gen)
    ares = phase(attack_phase)
    fares = phase(flownetc_attack_phase)
    acres = phase(attack_cli_phase, "RAFT")
    afres = phase(attack_cli_phase)
    phase(cli_phase)
    psres = phase(patch_step_phase)
    pcres = phase(patch_cli_phase)
    plres, pbres = phase(patch_lookup_phase)
    prres = phase(patch_cli_raft_phase)
    ures = phase(universal_phase)
    f2res, flownet2 = phase(flownet2_phase, gen)
    f2ares = phase(flownet2_attack_phase, flownet2)
    del flownet2
    crres = phase(corruption_phase)
    atres = phase(adv_train_phase)
    t_slice = time.perf_counter()
    iores = phase(io_phase, gen)
    inres = phase(infer_phase, gen)
    evres = phase(evaluate_phase, gen)
    dares = phase(dataset_attack_phase)
    t_slice = time.perf_counter() - t_slice
    t_files = time.perf_counter()
    jres = phase(jpeg_phase)
    ldres = phase(loader_phase, gen, tres)
    trfres = phase(train_files_phase, tres)
    clres, cbres = phase(chairs_lookup_phase)
    pfres = phase(patch_files_phase)
    s64res = phase(sub64_phase, gen)
    t_files = time.perf_counter() - t_files
    t_analyses = time.perf_counter()
    mpres = phase(moving_patch_phase)
    rfres = phase(replace_features_phase)
    emres = phase(embeddings_phase)
    tsres = phase(train_shapes_phase)
    ftres = phase(family_train_phase)
    fvres = phase(family_adv_train_phase)
    t_analyses = time.perf_counter() - t_analyses
    t_configs = time.perf_counter()
    rres = phase(radius_phase, gen)
    cfg_serve = {c: phase(config_serve_phase, gen, c)
                 for c in ("small", "small_volume", "spatial")}
    cfg_train = {c: phase(config_train_phase, gen, c)
                 for c in ("small", "spatial", "wocontext")}
    ccres = phase(config_cli_phase, gen)
    spres = phase(spatial_mode_shapes_phase)
    t_configs = time.perf_counter() - t_configs
    t_host = time.perf_counter()
    dgres = phase(cv_digest_phase)
    hcres = phase(host_corruption_phase)
    cpres = phase(circle_patch_phase)
    htres = phase(host_time_phase)
    t_host = time.perf_counter() - t_host
    t_ckpt = time.perf_counter()
    msres = phase(msgpack_serve_phase, gen)
    mcres = phase(msgpack_cli_phase, gen)
    prepres = phase(prepare_phase, gen)
    profres = phase(profile_phase, gen)
    t_ckpt = time.perf_counter() - t_ckpt
    dpres = phase(dp_phase, gen)
    print(f"all phases, build included: {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(f"patch attack, FlowNetC, batch {PB} at {PH}x{PW} ({card}): "
          f"{psres['ms_per_iter']:.3f} ms per inner iteration, "
          f"{psres['iters_per_s']:.2f} iterations/s; in the CLI "
          f"{pcres['cli_ms_per_iter']:.3f} ms; RAFT "
          f"{prres['ms_per_iter']:.3f} ms; universal step on FlowNetC at "
          f"256x640 {ures['ms_per_step']:.3f} ms", flush=True)
    print(f"FlowNet2, batch {B} at {H}x{W} ({card}): "
          f"{f2res['pairs_per_s']:.2f} pairs/s; its I-FGSM at {AH}x{AW} "
          f"{f2ares['ms_per_step']:.2f} ms per step; adversarial train "
          f"batch on RAFT at {AH}x{AW} {atres['ms_per_batch']:.1f} ms",
          flush=True)
    print(f"evaluation and file serving ({card}): infer CLI "
          f"{inres['pairs_per_s']:.2f} pairs/s at 375x1242 with decode and "
          f"writing (model {100 * inres['model_share']:.1f} % of it); PNG "
          f"decode {iores['decode_ms/filtered']:.2f} ms per 375x1242 frame "
          f"(host); evaluate {evres['s_per_scene']:.3f} s per KITTI scene "
          f"(f32, {EVAL_ITERS} iterations); the four phases "
          f"{t_slice:.1f} s", flush=True)
    print(f"training from files ({card}): JPEG decode {jres['decode_ms']:.2f}"
          f" ms per 375x1242 frame (host); DataLoader({LOADER_WORKERS}) "
          f"{ldres['kitti']['samples_per_s']:.1f} KITTI samples/s at {TH}x{TW}"
          f", {ldres['chairs']['samples_per_s']:.1f} chairs samples/s at "
          f"256x640; train CLI --stage kitti "
          f"{trfres['kitti_rate']['frames_per_s']:.2f} frames/s with the "
          f"loader over {RATE_STEPS} batches against "
          f"{tres['frames_per_s']:.2f} synthetic (phase 8); the six phases "
          f"{t_files:.1f} s", flush=True)
    print(f"patch analyses and family training ({card}): moving patch on "
          f"RAFT {mpres['s_per_location']:.4f} s per location, device idle "
          f"{100 * mpres['idle_share']:.1f} %; train CLI at batch 6, "
          f"{FTH}x{FTW} (FlowNet2 batch 2), ms per step: " + ", ".join(
              f"{name} {ftres[name]['ms_per_step']:.1f}"
              for name, _, _ in FAMILY_TRAIN)
          + f"; the six phases {t_analyses:.1f} s", flush=True)

    print(f"the remaining RAFT configurations ({card}): at r=4 (RAFT's "
          f"shapes) B1 {kres['main/calibrated/bfloat16/ms']:.4f} ms, B2 "
          f"{bres['main/calibrated/bfloat16/ms']:.4f} ms, B5 "
          f"{vkres['main/calibrated/bfloat16/main']['ms']:.4f} ms, B3 "
          f"{dres['main/calibrated/bfloat16/ms']:.4f} ms; at r=3 (small "
          "RAFT's shapes) " + ", ".join(
              f"{k} {rres[k]['ms']:.4f} ms (bound {rres[k]['bound_ms']:.4f})"
              for k in ("B1/serving", "B1/train", "B2/train", "B5/serving",
                        "B3/serving"))
          + "; pairs/s " + ", ".join(f"{c} {r['pairs_per_s']:.2f}"
                                     for c, r in cfg_serve.items())
          + "; train ms per step " + ", ".join(
              f"{c} {r['ms_per_step']:.1f}" for c, r in cfg_train.items())
          + f"; the phases {t_configs:.1f} s", flush=True)

    print(f"cv2 / PIL host paths ({card}): {dgres['cases']} host-op "
          "digests equal; seconds per severity on FlowNetC, 2 pairs at "
          f"{HOST_H}x{HOST_W}, host corruption included: " + ", ".join(
              f"{k} {np.mean(v):.2f}"
              for k, v in hcres["s_per_severity"].items())
          + "; host s per severity of one frame: " + ", ".join(
              f"{k} {np.mean(v):.4f}" for k, v in htres.items())
          + f"; the phases {t_host:.1f} s", flush=True)

    print(f".msgpack checkpoints, KITTI raw preparation ({card}): host s "
          "to read and decode / fetch_model on the card, .msgpack vs .pth: "
          + ", ".join(f"{m} {msres[m]['msgpack_decode_s']:.3f} / "
                      f"{msres[m]['msgpack_fetch_s']:.3f} vs "
                      f"{msres[m]['pth_decode_s']:.3f} / "
                      f"{msres[m]['pth_fetch_s']:.3f} "
                      f"({msres[m]['msgpack_mb']:.1f} MB)"
                      for m in MSGPACK_MODELS)
          + f"; prepare ms per 375x1242 frame: read {prepres['read_ms']:.2f},"
          f" resize {prepres['resize_ms']:.2f}, encode "
          f"{prepres['encode_ms']:.2f}, wall {prepres['total_ms']:.2f}; "
          f"the phases {t_ckpt:.1f} s", flush=True)

    print(card)  # name, power limit: nvidia-smi's own line

    def shape_err(r, shape="patch"):  # the worst case at a path's shape
        return max(v for k, v in r.items() if k.startswith(f"{shape}/")
                   and k.count("/") == 2)
    fwd = "main/calibrated/bfloat16"
    warp = wres["spynet/main"]
    vol = vkres["main/calibrated/bfloat16/main"]
    print(json.dumps({"kernels": [{
        "name": "alt_corr_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:91",
        "launches": (mres["launches"] + cres["launches"]
                     + tres["launches/alt_corr_fwd"]
                     + ares["launches/alt_corr_fwd"]
                     + acres["launches/alt_corr_fwd"]
                     + prres["launches/alt_corr_fwd"]
                     + atres["launches/alt_corr_fwd"]
                     + inres["launches"] + evres["launches"]
                     + trfres["launches/alt_corr_fwd"]
                     + s64res["launches/alt_corr_fwd"]
                     + mpres["launches/alt_corr_fwd"]
                     + rres["B3/launches"]
                     + cfg_serve["small"]["launches/alt_corr_fwd"]
                     + sum(r["launches/alt_corr_fwd"]
                           for r in cfg_train.values())
                     + sum(ccres[f"train/{c}"].get("launches/alt_corr_fwd", 0)
                           for c in ("small", "wocontext"))
                     + ccres["evaluate_small"]["launches"]
                     + ccres["parity"]["launches/alt_corr_fwd"]
                     + cpres["launches/alt_corr_fwd"]
                     + msres["launches"]["alt_corr_fwd"]
                     + mcres["launches"]["alt_corr_fwd"]
                     + profres["launches"]
                     + dpres["launches/alt_corr_fwd"]),
        "max_abs_err": kres[fwd],
        "ms": kres[f"{fwd}/ms"],
        "plain_ms": kres[f"{fwd}/plain_ms"],
        **kres[f"{fwd}/bound"],
        "library_ms": None,
        "smooth_ms": kres["main/smooth/bfloat16/ms"],
        "wild_ms": kres["main/wild/bfloat16/ms"],
        "serving_tile_share": mres["calibrated/tile_share"],
        "serving_wild_tile_share": mres["wild/tile_share"],
        "patch_shape_max_abs_err": shape_err(plres),
        "chairs_shape_max_abs_err": shape_err(clres, "chairs"),
        "patch_shape_ms": plres["patch/calibrated/bfloat16/ms"],
        "patch_shape_plain_ms": plres["patch/calibrated/bfloat16/plain_ms"],
        "patch_shape_bound_ms":
            plres["patch/calibrated/bfloat16/bound"]["bound_ms"],
        **radius_keys(rres, "B1", ("serving", "train")),
    }, {
        "name": "alt_corr_bwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_bwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:571",
        "launches": (tres["launches/alt_corr_bwd"]
                     + ares["launches/alt_corr_bwd"]
                     + acres["launches/alt_corr_bwd"]
                     + prres["launches/alt_corr_bwd"]
                     + atres["launches/alt_corr_bwd"]
                     + trfres["launches/alt_corr_bwd"]
                     + sum(r["launches/alt_corr_bwd"]
                           for r in cfg_train.values())
                     + sum(ccres[f"train/{c}"].get("launches/alt_corr_bwd", 0)
                           for c in ("small", "wocontext"))
                     + ccres["parity"]["launches/alt_corr_bwd"]
                     + mcres["launches"]["alt_corr_bwd"]
                     + dpres["launches/alt_corr_bwd"]),
        "max_abs_err": bres[fwd],
        "ms": bres[f"{fwd}/ms"],
        "plain_ms": bres[f"{fwd}/plain_ms"],
        **bres[f"{fwd}/bound"],
        "library_ms": None,
        "smooth_ms": bres["main/smooth/bfloat16/ms"],
        "attack_ms": bres["attack/calibrated/bfloat16/ms"],
        "attack_bound_ms":
            bres["attack/calibrated/bfloat16/bound"]["bound_ms"],
        "train_step_tile_share": tres["tile_share"],
        "patch_shape_max_abs_err": shape_err(pbres),
        "chairs_shape_max_abs_err": shape_err(cbres, "chairs"),
        "patch_shape_ms": pbres["patch/calibrated/bfloat16/ms"],
        "patch_shape_plain_ms": pbres["patch/calibrated/bfloat16/plain_ms"],
        "patch_shape_bound_ms":
            pbres["patch/calibrated/bfloat16/bound"]["bound_ms"],
        "raft_patch_update_rel_l2_bf16":
            prres["update_rel_l2/calibrated/l2/bf16"],
        "raft_patch_update_rel_l2_f32":
            prres["update_rel_l2/calibrated/l2/f32"],
        "raft_patch_update_f32_to_f64": {
            tag: prres[f"update_to_f64/{tag}"] for tag in (
                "cli_weights/l2", "cli_weights/cossim", "calibrated/l2",
                "calibrated/cossim")},
        **radius_keys(rres, "B2", ("train",)),
    }, {
        "name": "alt_corr_dcoords",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/alt_corr_dcoords.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/alt_corr.py:91",
        "launches": dres["launches"] + rres["B3/launches"],
        "max_abs_err": dres[fwd],
        "ms": dres[f"{fwd}/ms"],
        "plain_ms": dres[f"{fwd}/plain_ms"],
        **dres[f"{fwd}/bound"],
        "library_ms": None,
        "tile_share": dres[f"{fwd}/tile_share"],
        "wild_tile_share": dres["main/wild/bfloat16/tile_share"],
        "f32_ms": dres["main/calibrated/float32/ms"],
        "f32_plain_ms": dres["main/calibrated/float32/plain_ms"],
        "f32_bound_ms":
            dres["main/calibrated/float32/bound"]["bound_ms"],
        "r3_serving_tile_share":
            rres["B3/serving/calibrated/bfloat16/tile_share"],
        **radius_keys(rres, "B3", ("serving",)),
    }, {
        "name": "warp_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/warp_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/warp_tile.py:53",
        "launches": (sres["launches"] + pres["launches"]
                     + ares["pwc_launches/warp_fwd"]
                     + f2res["launches/warp_fwd"]
                     + f2ares["launches/warp_fwd"]
                     + f2ares["cli_launches/warp_fwd"]
                     + emres["launches/warp_fwd"]
                     + ftres["launches/warp_fwd"]
                     + fvres["launches/warp_fwd"]
                     + msres["launches"]["warp_fwd"]),
        "max_abs_err": warp["max_abs_err"],
        "ms": warp["ms"],
        "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"],
        "bound_by": warp["bound_by"],
        "library_ms": warp["library_ms"],
        "grid_sample_ms": warp["library_ms"],
        "launched_ms": warp["launched_ms"],
        "flownet2_border_max_abs_err": f2res["warp"]["max_abs_err"],
        "flownet2_border_ms": f2res["warp"]["ms"],
        "flownet2_border_plain_ms": f2res["warp"]["plain_ms"],
        "flownet2_border_bound_ms": f2res["warp"]["bound_ms"],
        "flownet2_border_grid_sample_ms": f2res["warp"]["library_ms"],
        **{f"{name}_{k}": tsres[f"warp/{name}"][k]
           for name in WARP_TRAIN for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "library_ms",
                                            "grad_plain_ms")},
    }, {
        "name": "corr_lookup_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/corr_lookup_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/pallas/corr_lookup_fused.py:59",
        "launches": (vres["launches"] + fres["launches"]
                     + s64res["launches/corr_lookup_fwd"]
                     + cfg_serve["small_volume"]["launches/corr_lookup_fwd"]),
        "max_abs_err": vol["max_abs_err"],
        "ms": vol["ms"],
        "plain_ms": vol["plain_ms"],
        "bound_ms": vol["bound_ms"],
        "bound_by": vol["bound_by"],
        "library_ms": vol["library_ms"],
        "grid_sample_ms": vol["library_ms"],
        **radius_keys(rres, "B5", ("serving",)),
    }, {
        "name": "spatial_corr_fwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/spatial_corr_fwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/correlation.py:56",
        "launches": (fnres["launches"] + pres["corr_launches"]
                     + ares["pwc_launches/spatial_corr_fwd"]
                     + fares["launches/spatial_corr_fwd"]
                     + afres["launches/spatial_corr_fwd"]
                     + psres["launches/spatial_corr_fwd"]
                     + pcres["launches/spatial_corr_fwd"]
                     + ures["launches/spatial_corr_fwd"]
                     + f2res["launches/spatial_corr_fwd"]
                     + f2ares["launches/spatial_corr_fwd"]
                     + f2ares["cli_launches/spatial_corr_fwd"]
                     + crres["launches/spatial_corr_fwd"]
                     + dares["launches/spatial_corr_fwd"]
                     + pfres["launches/spatial_corr_fwd"]
                     + rfres["launches/spatial_corr_fwd"]
                     + emres["launches/spatial_corr_fwd"]
                     + ftres["launches/spatial_corr_fwd"]
                     + fvres["launches/spatial_corr_fwd"]
                     + cfg_serve["spatial"]["launches/spatial_corr_fwd"]
                     + cfg_train["spatial"]["launches/spatial_corr_fwd"]
                     + ccres["train/spatial"]["launches/spatial_corr_fwd"]
                     + hcres["launches/spatial_corr_fwd"]
                     + msres["launches"]["spatial_corr_fwd"]
                     + prepres["launches/spatial_corr_fwd"]),
        "max_abs_err": scres["flownetc"]["fwd_err"],
        "ms": scres["flownetc"]["ms"],
        "plain_ms": scres["flownetc"]["plain_ms"],
        "bound_ms": scres["flownetc"]["bound_ms"],
        "bound_by": scres["flownetc"]["bound_by"],
        "library_ms": None,
        "pwc_l2_ms": scres["pwc_l2"]["ms"],
        "pwc_l2_plain_ms": scres["pwc_l2"]["plain_ms"],
        "pwc_l2_bound_ms": scres["pwc_l2"]["bound_ms"],
        "patch_shape_max_abs_err": scres["patch"]["fwd_err"],
        "patch_shape_ms": scres["patch"]["ms"],
        "patch_shape_plain_ms": scres["patch"]["plain_ms"],
        "patch_shape_bound_ms": scres["patch"]["bound_ms"],
        "patch_256_max_abs_err": scres["patch_256"]["fwd_err"],
        **{f"{name}_{k}": tsres[f"corr/{name}"][k]
           for name in CORR_TRAIN for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms")},
        **{f"{name}_{k}": spres[f"corr/{name}"][k]
           for name in CORR_RAFT_SPATIAL for k in ("max_abs_err", "ms",
                                                   "plain_ms", "bound_ms")},
    }, {
        "name": "spatial_corr_bwd",
        "route": "cuda",
        "source": "understanding_flow_robustness_tpu_torch/csrc/spatial_corr_bwd.cu",
        "replaces": "understanding_flow_robustness_tpu/ops/correlation.py:56",
        "launches": (ares["pwc_launches/spatial_corr_bwd"]
                     + fares["launches/spatial_corr_bwd"]
                     + afres["launches/spatial_corr_bwd"]
                     + psres["launches/spatial_corr_bwd"]
                     + pcres["launches/spatial_corr_bwd"]
                     + ures["launches/spatial_corr_bwd"]
                     + f2ares["launches/spatial_corr_bwd"]
                     + f2ares["cli_launches/spatial_corr_bwd"]
                     + dares["launches/spatial_corr_bwd"]
                     + pfres["launches/spatial_corr_bwd"]
                     + ftres["launches/spatial_corr_bwd"]
                     + fvres["launches/spatial_corr_bwd"]
                     + cfg_train["spatial"]["launches/spatial_corr_bwd"]
                     + ccres["train/spatial"]["launches/spatial_corr_bwd"]
                     + hcres["launches/spatial_corr_bwd"]
                     + prepres["launches/spatial_corr_bwd"]),
        "max_abs_err": scres["attack"]["bwd_err"],
        "ms": scres["attack/bwd"]["ms"],
        "plain_ms": scres["attack/bwd"]["plain_ms"],
        "bound_ms": scres["attack/bwd"]["bound_ms"],
        "bound_by": scres["attack/bwd"]["bound_by"],
        "library_ms": None,
        "pwc_l2_ms": scres["pwc_l2/bwd"]["ms"],
        "pwc_l2_plain_ms": scres["pwc_l2/bwd"]["plain_ms"],
        "pwc_l2_bound_ms": scres["pwc_l2/bwd"]["bound_ms"],
        "patch_shape_max_abs_err": scres["patch"]["bwd_err"],
        "patch_shape_ms": scres["patch/bwd"]["ms"],
        "patch_shape_plain_ms": scres["patch/bwd"]["plain_ms"],
        "patch_shape_bound_ms": scres["patch/bwd"]["bound_ms"],
        "patch_256_max_abs_err": scres["patch_256"]["bwd_err"],
        **{f"{name}_{k}": tsres[f"corr/{name}/bwd"][k]
           for name in CORR_TRAIN for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms")},
        **{f"{name}_{k}": spres[f"corr/{name}/bwd"][k]
           for name in CORR_RAFT_SPATIAL for k in ("max_abs_err", "ms",
                                                   "plain_ms", "bound_ms")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
