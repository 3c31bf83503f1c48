#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (facenet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when its check fails:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels csrc/pair_below_counts.cu, dense_warp.cu,
     pnet_pyramid.cu, pnet_level.cu, stem_fused.cu and crop_resize.cu, and
     the copy
     yardstick csrc/copy_roof.cu, for sm_90a (one nvcc each, all started
     together);
  3. kernel vs its plain PyTorch version at N=4096/D=512 (metrics 0 and 1),
     at the main path's fold sizes N=936 and N=104 (D=512), and at
     N=1000/D=17: cumulative counts agree to rtol 1e-6, beyond the weight
     of pairs whose float64 similarity lies within 1e-6 of a cutoff
     (float32 sums in another order may put exactly those on either side);
     then the kernel's product itself (3xTF32 on the tensor cores, through
     pair_similarities) against the float64 product at N=1024, D=512 and
     D=17, pairs at s ~ 0.5 and duplicated rows included: max |s - s64| <=
     5e-7, the float32 torch.matmul's figure beside it;
  4. full-width Inception-ResNet-v1 (default config, 512-d, random weights
     from init_variables(seed=0)) served by FaceNet in bf16 at batch 128:
     finite unit-norm embeddings, min cosine >= 0.995 against the unfused
     float32 module (no TF32), and embeddings/s;
  5. the main path: FaceNet embeddings of 1,040 synthetic images (40 classes
     x 26) -> 10-fold FaceToFaceValidation on the card, with the kernel's
     launch count reset just before and read just after (30 expected: 10
     folds x one sweep + two test calls); then the card's report on
     well-separated embeddings equals the CPU report to 1e-6;
  6. at the reference validation's sweep shape (N=23,840, D=512, T=100):
     the same kernel-vs-plain check, then the times of the kernel, the
     plain version, and the float32 torch.matmul of the full N x N product
     (twice the pairs, nothing binned: a yardstick for the product alone),
     beside both bounds (the FP32 pipes; three TF32 products on the tensor
     cores, which the kernel is held to); the kernel again at T=1 (the
     test folds' call) and at D=32 (the epilogue with almost no main loop);
     then the wall time of a whole 10-fold validation at the reference
     eval size (26,489 x 512, synthetic clustered embeddings);
  7. ptxas registers, shared memory and spills of the two detection
     kernels;
  8. the dense warp (B2) kernel vs its plain version: 32 crops 240 -> 160
     with random rotations, scales and translations that push samples off
     the edge, the identity, a non-square output, one channel, and 16
     crops as the landmark alignment makes them for faces turned by 45 and
     by 30 degrees; bound 1e-3 (0-255 scale);
  9. the whole-pyramid P-Net (B3) kernel vs its plain version: the
     10-level 480x640 pyramid at batch 16 and a 3-level pyramid of odd
     sizes; bounds probs 0.02, reg 0.05;
 10. the detection main path: FacePipeline (full-width IRv1 from
     init_variables(seed=0), bundled MTCNN weights, 480x640, landmark
     alignment, 2 faces per scene) on 64 synthetic scenes in batches of 16,
     with every kernel's launch count reset just before and read just
     after (4 B3, 4 B2, 12 crop, 0 B1 expected: the crop kernel runs for
     R-Net, O-Net and the alignment's intermediates); finite unit-norm
     embeddings; then
     4 of the scenes through the same stages on the CPU, the warp by its
     plain version (cascade -> align_by_landmarks(method='dense') ->
     FaceNet): identical valid masks, boxes and landmarks within 1.5 px,
     scores within 0.02, embedding cosine >= 0.99;
 11. the bundled detector's quality gate on the card: 32 held-out
     256x256 scenes (seed 555): recall >= 0.97, precision >= 0.97, mean
     IoU >= 0.5;
 12. times with CUDA events: B3 at batch 16 x 10 levels beside its plain
     version and the cuDNN P-Net ('flax') over the same levels; B2 on the
     main path's own inputs (the 32 240x240 intermediates and matrices that
     the landmark alignment builds for a batch of 16 scenes, checked
     against the plain version first), in copies that rotate through more
     than the card's L2, beside its plain version, F.grid_sample and
     copies of the same bytes, the practical roof at this size (the
     yardstick csrc/copy_roof.cu with 1, 2 and 4 float4 loads in flight a
     thread, and the library's Tensor.copy_ of the same total), its bound
     counting only the source pixels the taps read; then B2 and the
     copies on the four batches' 128 crops in one call
     (these in device time, each call's host enqueue time beside: a 20 us
     kernel launched back to back from Python otherwise reads the host's
     launch rate); the
     pipeline per batch of 16 scenes (scenes/s, embedding slots/s and
     aligned embeddings of detected faces/s) and its stages alone, host
     included; and a torch.profiler breakdown of one pipeline batch;
 13. ptxas registers, shared memory and spills of the fused stem (B5, the
     persistent kernel) and the one-level P-Net kernels (B4, B6 with its
     three weight parts, B7, and B6's accuracy probe in both summation
     orders);
 14. the fused stem (B5) kernel vs its plain version with the full-width
     IRv1's weights: batch 8 (one image of constant 0, one of 255, six of
     noise) and batch 128 of uint8 noise through image_processing; bound
     max |d| <= 0.01 max |plain| (both round to bf16 after each conv, so one
     rounding, at most 2^-7 of a value, may differ);
 15. the one-level P-Net kernels vs the plain version: B4 on planes at a
     pitch rounded up to 128 with N(0, 3) noise past the true width, B6
     with float32 weights, B7 on NHWC pixels with raw heads out, at
     (24, 100), (61, 83), (40, 129) and at level 0 of the 480x640 pyramid
     (288x384, batch 16); bounds probs 0.02, reg and raw heads 0.05; B6
     must lie nearer (mean |d| of probs and of reg) to the plain version on
     its unrounded weights than to the one on their bf16 rounding; then,
     once, B6's conv3 sums against float64 sums of the same activations
     and weights (three mma a step chained on the accumulator, summed from
     zero as B6 runs, and float32 fused multiply-adds in a CUDA-core loop's
     order);
 16. this slice's main paths, every launch count reset just before each
     and read just after: (a) FastEmbedder(stem='fused'), full-width IRv1,
     4 batches of 128 (exactly 4 B5 launches; finite unit-norm embeddings;
     min cosine >= 0.999 against stem='cudnn'); (b) the cascade with
     pnet_impl='flat' through FaceDetector at 480x640 on phase 10's 64
     scenes in batches of 16 (exactly 40 B4 and 8 crop launches, no B3;
     the same valid
     masks as the 'pyramid' cascade, boxes and landmarks within 1.5 px,
     scores within 0.02); (c) the B6 tool and (d) the B7 tool, each
     through its main();
 17. times (device time, host enqueue beside): B5 per 128 images, rotating
     through inputs larger than the L2, beside its plain version and the
     cuDNN prefix (F.conv2d x3 + F.max_pool2d), with its schedule's shared
     loads per mma and weight bytes staged per image against the design it
     replaced; serving per 128 under each
     stem in turns (cudnn, fused, fused, cudnn), as the host issues it and
     as the device's busy time under torch.profiler; B4, B6 and B7 at level 0,
     batch 16, beside the plain version, the cuDNN P-Net on that level and
     the whole-pyramid kernel's share for that level's operations, and B6's
     bound at three bf16 mma a multiply-add; the
     cascade alone under 'flax', 'flat' and 'pyramid', host included and
     as the device's busy time;
 18. extraction: an in-memory identity set of 64 classes x 16 160x160
     images (a seeded base image a class plus noise an image) through
     BatchLoader(shuffle=False) with an array loader, batch 128, into
     evaluate_embeddings with phase 4's FaceNet: rows in order, unit norms,
     min cosine >= 0.99999 against FaceNet.evaluate on the same batches;
     the embeddings app's npz and TFRecord writers round-trip the result
     exactly; embeddings/s as issued, the loader alone beside it; no
     kernel launch (the serving forward is cuDNN work);
 19. the embeddings app's pipeline mode: phase 10's 64 scenes in batches
     of 16 through FacePipeline (1 face a scene) under align='crop' and
     'landmarks', then the app's kept_rows; launch counts reset just before
     each run and read just after: exactly 4 B3, no B2 and 12 crop under
     'crop', 4 B3, 4 B2 and 12 crop under 'landmarks'; both modes keep the
     same scenes, whose
     embeddings are finite and unit-norm; scenes/s of each;
 20. validate-on-LFW at protocol scale: LFW-shaped counts (5,749
     identities, 13,233 images) as empty placeholder files in a temporary
     directory, generate_pairs(10 folds x 300, seed 0) -> 6,000 pairs,
     get_paths resolves all 12,000 paths; pixels made from each path in
     numpy (seeded per identity and per image, no decode); the app's embed
     with flip at batch 256 -> 12,000 x 1,024; LfwValidation (metric 0, 10
     folds, far_target 1e-3, subtract_mean): every report number finite;
     the flip half equals FaceNet on the flipped arrays (cosine >=
     0.99999); 64 rows match the unfused float32 module on the CPU (cosine
     >= 0.995); wall seconds of image making, forwards and the report;
 21. the port's bench through its main() (32 chunks x 128 back to back,
     facenet_tpu_torch/bench.py), int8 first, then bf16: its two
     device-busy lines and its last JSON line (value > 0, the faster path's
     rate, serving 'int8' or 'bf16') printed here;
 22. the int8 GEMM (im2col + torch._int_mm, ops/int8_conv.py) against its
     plain version (F.conv2d in float64) on every distinct int8 conv shape
     of full-width IRv1 (every conv quantized) and IRv2, as their int8
     forwards run them, at batch 8 with random int8 inputs and weights:
     the int32 sums equal, max |d| = 0; then, at batch 128, the device ms
     of the three costliest shapes' quantize, im2col, GEMM and rescale,
     the whole int8 conv, and cuDNN's bf16 conv of the same shape;
 23. full-width IRv1 int8 serving through FaceNet(quantize='int8'),
     calibrated on 32 images, built from phase 4's bundle, under
     stem='cudnn' and 'fused', 4 batches of 128, every launch count reset
     just before each and read just after: exactly 4 B5 launches under
     'fused' and none under 'cudnn'; finite unit-norm rows; the min cosine
     against bf16 under the same stem; per batch of 128, in turns, host-
     issued ms and device busy ms of the four (bf16 and int8 under each
     stem); a profiler breakdown of one int8 forward;
 24. full-width IRv2 (default config, 512-d, init_variables(seed=0))
     through FaceNet in bf16 and int8 at batch 128: no kernel launch;
     finite unit-norm rows; bf16 against the unfused float32 module (no
     TF32) at min cosine >= 0.995; int8 against bf16 (printed); host-issued
     and device busy ms per batch of 128 of both;
 25. training: full-width IRv1 (default config, 512-d, the backbone from
     init_variables(seed=0)) with the 8,631-way head of VGGFace2's train
     identities, train_softmax.yaml's defaults (Adam eps 0.1, lr 0.05,
     L2 5e-4), bf16 compute with float32 weights; 400 images (50
     identities x 8) in 4 batches of 100, cycled for 20 softmax steps with
     every launch count reset just before and read just after (none
     expected): finite losses, the mean cross-entropy of the last 5 steps
     below that of the first 5 (the total also holds the L2 term, which
     falls with the weights alone); ms a step as the host issues it and as
     the device's busy time, img/s, max_memory_allocated, a profiler
     breakdown of one step;
 26. one step with center_factor 0.01 (the centers table moves in every
     row of the batch's identities) and one triplet-only step on a
     PKPipeline batch of 20 identities x 5 drawn from noise images (no
     identity closer to itself than to the others): triplet loss > 0,
     every BatchNorm bias of the backbone moved (the L2 term skips biases
     and softmax_factor is 0, so their gradient is the triplet term's) and
     the head's bias kept;
 27. one step of the same state on the card and on the CPU at batch 8
     (cuDNN and cuBLAS without TF32), once in float32: every metric within
     1e-4 relative, every leaf of the updated state within half its
     largest update on the CPU (+1e-6), the float32 backward through
     train-mode BatchNorm being ill-conditioned; once in float64 (weights,
     statistics and Adam too; the losses keep their float32 casts): every
     metric within 1e-5 relative, every leaf within 1e-5 of its largest
     update (+1e-12);
 28. checkpoint and resume under cudnn.deterministic: 2 steps from a
     shuffled BatchLoader, save with its cursor, the next step; restore
     into a fresh trainer: the cursor's next batch is the same batch, and
     the next step's loss (rtol 1e-6) and parameters (1e-6) equal the
     uninterrupted run's;
 29. ValidateCallback on phase 25's state, 1,040 held-out images, 10 folds,
     with the launch counts reset just before and read just after: exactly
     30 B1 launches; finite report;
 30. save_model of the trained backbone, load_model, FaceNet on the card:
     min cosine >= 0.995 against the trainer's embedding_forward, no
     kernel launch;
 31. the process grid at world size 1 under NCCL (parallel.launch.spawn):
     SoftmaxTrainer(mesh=create_mesh(1, 1)) takes 5 bf16 steps at batch
     100 with the 8,631-way head under cudnn.deterministic; every leaf
     within 1e-6 of the trainer's without a process group; ms a step (as
     issued) beside phase 25's; no collective made (so no NCCL share of the
     busy time); its ValidateCallback launches B1 exactly 30 times;
 32. two ranks sharing the card under gloo with CUDA tensors (NCCL refuses
     two ranks on one device): one float64 step (TF32 off) at global batch
     8 on (data=2, model=1) with the 8,631-way head, softmax + center and
     triplet, and on (data=1, model=2) with the 85,742-way head of MS1MV2,
     each against the same step on one rank (train.softmax.
     grid_step_check): metrics at rtol 1e-5, every leaf within 1e-5 of its
     update (+1e-12); then 3 bf16 steps on (2, 1) at global batch 100 and
     their ms (gloo stages every collective through the host: no
     multi-GPU rate);
 33. pair statistics on the two ranks at phase 6's shape (23,840 x 512,
     T=100): each rank passing its own half of the rows (the sharded
     path), the cumulative counts equal B1's under phase 3's rule; each
     passing the full set (the validate path), one B1 launch on each rank
     and the counts of B1 on one rank; the ms of both paths beside B1's;
 34. evaluate_embeddings(mesh=) on the two ranks: 1,000 images in batches
     of 111 through the full-width IRv1 in float32 (no TF32): the rows
     in order, at cosine >= 0.99999 to one rank's;
 35. the Faster-RCNN through FaceDetector(detector='frcnnv3') with the
     bundled weights at 480x640 on 64 synthetic scenes in batches of 16
     (proposals 256, outputs 32), 4 crop launches (RoIAlign) and no other;
     4 scenes on the
     card and on the CPU matched by IoU: boxes within 1.5 px, scores
     within 0.02; ms a batch as issued, device busy, crop_and_resize's
     ms (CUDA events: the profiler's key averages leave out a kernel
     launched through ctypes), a profiler top 10;
 36. the bundled Faster-RCNN's quality gate on the card (32 held-out
     256x256 scenes, seed 555): recall >= 0.97, precision >= 0.86, mean
     IoU >= 0.5;
 37. FasterRCNNTrainer: 20 bf16 steps at batch 8 of 480x640 scenes (1-3
     faces): finite losses, rpn_cls falling; ms a step as issued, device
     busy, launches a step, peak memory; one float32 step (TF32 off) card
     vs CPU from the trained state: losses at rtol 1e-4, Adam's first
     moment within 1e-3 of each leaf's largest entry;
 38. MTCNNTrainer for P-, R- and O-Net: 20 bf16 steps each at batch 256 of
     generate_training_crops samples: finite losses, cls_loss falling; ms
     a step; one float32 step card vs CPU per net under phase 37's bound;
 39. ClassifierTrainer at 500 identities x 50 x 512-d (P = 500, K = 5),
     2 epochs x 250 steps for both classifiers: loss falling; the
     ConfusionMatrix on the card and on the CPU within 1e-6;
 40. the trained trees of 37 and 38 through FaceDetector(params=...) on
     the card, one batch each: finite outputs.
     The crop kernel is the only hand-written kernel on the paths of
     35-40: the Faster-RCNN's RoIAlign (4 launches in 35, one a step in 37)
     and the cascade's crops (3 launches in 40).
 41. import -> export -> compiled serving of full-width IRv1 (default
     config, 512-d, init_variables(seed=0) with BatchNorm statistics and
     biases moved off their init): the reference's folded units
     (export_ref_h5 -> import_h5_weights where h5py is installed, else
     the same units in memory, reference_units -> import_units), served by
     FaceNet at cosine >= 0.999 against the original tree; the
     export_model app (--import-h5 with --h5 where h5py is installed,
     else --model-dir of the imported bundle) writes model.pt2;
     load_compiled on the card at batches 1, 3 and 128 against FaceNet
     (stem='cudnn'): cosine >= 0.9999; the int8 program that
     save_compiled would write (export_program, 32 calibration images),
     run without its file round trip (model.pt2's above is the same code):
     finite unit-norm rows at cosine >= 0.999 against FaceNet int8; ms per
     128 of the artifact, issued and device busy, beside FaceNet's (the
     int8 pair issued); the op histogram's top 5; no launch of the seven
     kernels;
 42. full-width Inception-ResNet-v2 training from the zoo's
     inception_resnet_v2.yaml (keep 0.5, 512-d) with the 8,631-way head at
     batch 100, bf16: 20 steps on phase 25's in-memory images with a
     falling cross-entropy; ms a step as issued, img/s, peak memory; the
     trained backbone served by FaceNet (IRv2, bf16) at cosine >= 0.995
     against its float32 eval forward;
 43. one TINY IRv2 step in float64 at keep 1.0, TF32 off, card vs CPU
     through step_on_devices: metrics at rtol 1e-5, every leaf within
     1e-5 of its update + 1e-12; then the same at keep 0.5 (finite loss,
     the mask drawn on the host from the same generator), and the kept
     share of a 100 x 1536 mask within 5 binomial standard deviations;
 44. profiling.trace around 3 of phase 42's steps, each in an annotate
     span: the trace file exists and names the spans; StepTimer's items/s;
     from the trace, the step's device busy time and img/s at it, its
     launches and its top 10 kernels.
     No hand-written kernel lies on the paths of 41-44 either.
 45. the port's native image library (facenet_tpu_torch/native): the
     probe (g++, the system headers the system build includes, the
     libjpeg and libpng Pillow carries) is printed on an early line; the
     library must build (against the system's libraries, else against
     Pillow's with the port's headers; a failed build fails the run with
     both builds' messages), and its library_source() and files are
     printed; letterbox_array equals the numpy restatement (letterbox.py)
     at max |d| = 0 on sizes with 1-pixel sides, a PNG written here with
     zlib decodes to the written array, and the native decode equals
     PIL's (which decodes with the same libjpeg-turbo where the library
     links Pillow's) at max |d| = 0: 64 of phase 46's JPEGs at full size
     and letterboxed into 96x96, and phase 48's 32 1080x1440 JPEGs
     letterboxed into 480x640, both at the DCT scale 1/2;
 46. validate from files: 2,000 250x250 JPEGs (LFW's file size) in 100
     identity folders -> Database -> BatchLoader(ImageLoader(160)) ->
     phase 4's FaceNet -> evaluate_embeddings -> 10-fold
     FaceToFaceValidation, with the launch counts and the library's row
     count reset just before and read just after: exactly 30 B1 launches;
     the rows in order at cosine >= 0.99999 to FaceNet on the same files
     decoded one by one; rows went through the library; the loader's
     img/s alone, and with the library turned off (PIL), and the chain's
     as issued, beside phase 18's;
 47. train from files: PKPipeline (20 x 5) over the same tree feeding
     SoftmaxTrainer (full-width IRv1, the 8,631-way head, bf16, batch
     100) for 20 steps: the cross-entropy falling, no kernel launch, the
     row count as in 46; the loader's img/s alone, and with the library
     off (PIL, which decodes nothing ahead), the steps' img/s from files
     beside phase 25's in memory, the loader's wait a step;
 48. detect from files: 32 of phase 10's scenes as 480x640 JPEGs and 32
     540x720 scenes upscaled to 1080x1440 JPEGs (decoded at libjpeg's DCT
     scale 1/2) through FaceDetector(image_shapes=[480x640, 540x720])
     .detect_files in batches of 16 (two deep): exactly 4 B3 launches (two
     batches a bucket) and 8 crop; the faces, boxes (2 px after rounding)
     and scores (0.02) of the cascade run one batch at a time on the same
     decoded canvases, IoU-matched; the canvases equal those of PIL's decode
     (the library off) at max |d| = 0; scenes/s, the decode ms of a batch
     with the library and without beside the cascade's; then
     FacePipeline.process_files (align='landmarks') on the 480x640 half
     in batches of 8: exactly 4 B3, 4 B2 and 12 crop launches, the valid
     slots and
     embeddings (cosine >= 0.999) of process_batch on the decoded scenes;
     scenes/s. Each file phase prints which decoder ran.
 49. the crop kernel (csrc/crop_resize.cu, which replaces no TPU kernel)
     against its plain version at the benchmark's pipeline cells' crop
     shapes on 480x640 scenes of noise: crowd-b8's R-Net (8 x 64 crops of
     24 px), O-Net (8 x 32 of 48 px) and alignment intermediates (8 x 32
     of 240 px), single-b64's R-Net (64 x 64), O-Net (64 x 32) and box
     crops (64 x 1 of 160 px), boxes of 12-300 px that cross the edges:
     max |d| <= 1e-3; each timed in device time beside its bound (the
     crops written and the distinct source pixels the taps read, at 3.35
     TB/s), the plain version (CUDA events) and F.grid_sample at the same
     positions (the library's sampler, channels first), and a batch's sum
     for each cell; then one FacePipeline batch in each align mode:
     exactly 3 crop launches (R-Net, O-Net, the alignment or box crop).
 50. the greedy NMS kernel (csrc/nms_greedy.cu, which replaces no TPU
     kernel: JAX's loop compiles into one XLA program) against the loop it
     replaces (`ops.nms.greedy_keep_plain` on the card) at RetinaFace's
     shape (8 frames x 5,000 candidates of 16-300 px on 1080x1920, IoU
     0.4, +1 areas, keep 750) and MTCNN's O-Net shape (16 frames x 32,
     'min', IoU 0.7): keep masks and kept counts equal; the kernel in
     device time beside its bound (the float32 operations of the pair
     tests greedy NMS needs, not of every pair the kernel tests, at 67
     TFLOP/s, `nms_work`), the loop by CUDA events as the host issues
     it; then one FacePipeline batch of 8 1080x1920 frames through
     RetinaFace-R50 (random weights): exactly 1 NMS, 1 crop and 1 B2
     launch, no P-Net, and its wall time.

The GPU machine may lack yaml, h5py, sklearn and click, so nothing here
imports them at module level: the model bundle is built in memory, and
phase 41 takes the in-memory form of the h5 import when h5py is missing.
Phases 18-20 hand the port's loaders arrays through a callable; phases
45-48 write files and decode them through the native library, and
through PIL only to compare (PIL is imported only where a file is
written or decoded; without it the files are PNGs written with zlib).

The line before the last is the JSON list of kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

H100_FP32_FLOPS = 67e12     # FP32 outside the tensor cores, H100 SXM
H100_BF16_FLOPS = 989e12    # dense bf16 tensor cores, H100 SXM
H100_TF32_FLOPS = 495e12    # dense TF32 tensor cores, H100 SXM
H100_INT8_OPS = 1979e12     # dense int8 tensor cores, H100 SXM
H100_HBM_BYTES = 3.35e12    # HBM3 bytes/s, H100 SXM
SCENE = (480, 640)          # the cascade's default geometry
# the second bucket of phase 48: 1080x1440 files letterbox into it at 1/2,
# so libjpeg decodes them at its DCT scale 1/2
BIG_SCENE = (540, 720)
ROTATE = 6                  # B2 input copies: 6 x 22 MB, past the 50 MB L2


class SmokeFailure(Exception):
    pass


def require(condition, message):
    if not condition:
        raise SmokeFailure(message)


def clustered(rng, n_classes, per_class, dim, spread):
    """Unit-norm float32 embeddings around random unit class centres; the
    noise has norm about `spread`."""
    centres = rng.standard_normal((n_classes, dim))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    labels = np.repeat(np.arange(n_classes), per_class)
    noise = rng.standard_normal((labels.size, dim)) / np.sqrt(dim)
    emb = centres[labels] + spread * noise
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb.astype(np.float32), labels


def compare_kernel_plain(pair_counts, inputs, label):
    """Kernel vs plain cumulative counts on prepared inputs; returns the max
    abs difference. Rows of the float64 reference go in chunks, so the
    check runs at the full validation size too."""
    import torch
    kern = pair_counts.pair_histogram(inputs)
    torch.cuda.synchronize()
    plain = pair_counts.pair_histogram_plain(inputs)
    torch.cuda.synchronize()
    kern_cum, plain_cum = kern.cumsum(1), plain.cumsum(1)
    allowed = near_cutoff_weight(inputs)
    diff = (kern_cum - plain_cum).abs()
    limit = allowed + 1e-6 * plain_cum.abs() + 1e-12
    require(not bool((diff > limit).any()),
            f'kernel != plain ({label}): max excess '
            f'{float((diff - limit).max()):.3e}')
    t = inputs.cutoffs.numel()
    ambiguous = int((allowed[:, :t] > 0).sum())
    err = float(diff.max())
    print(f'  N={inputs.embeddings.shape[0]} D={inputs.embeddings.shape[1]} '
          f'{label}: max |kernel-plain| {err:.3e}, total pos '
          f'{float(plain_cum[0, -1]):.6f} neg {float(plain_cum[1, -1]):.6f}, '
          f'{ambiguous} (side, cutoff) cells with pairs within 1e-6')
    return err


def near_cutoff_weight(inputs):
    """[2, T + 1] weight of the positive and negative pairs whose float64
    similarity lies within 1e-6 of each cutoff: pairs a float32 rounding
    may put on either side of it. Rows of the float64 product go in
    chunks, so it runs at the full validation size too."""
    import torch
    e64 = inputs.embeddings.double()
    lab = inputs.labels
    cut64 = inputs.cutoffs.double()
    t = cut64.numel()
    n = e64.shape[0]
    device = e64.device
    allowed = torch.zeros(2, t + 1, dtype=torch.float64, device=device)
    for start in range(0, n, 2048):
        stop = min(start + 2048, n)
        sims = torch.clamp(e64[start:stop] @ e64.T, -1.0, 1.0)
        rows = torch.arange(start, stop, device=device)[:, None]
        upper = rows < torch.arange(n, device=device)[None, :]
        pos = lab[start:stop, None] == lab[None, :]
        w_pos = torch.where(pos & upper, inputs.w_pos[start:stop, None], 0.0)
        w_neg = torch.where(~pos & upper, inputs.inv_n[start:stop, None]
                            * inputs.inv_n[None, :], 0.0)
        for k in range(t):
            near = (sims - cut64[k]).abs() <= 1e-6
            allowed[0, k] += (w_pos * near).sum()
            allowed[1, k] += (w_neg * near).sum()
    return allowed


def prepared(pair_counts, emb, labels, metric, t=100):
    """Kernel inputs on the card for FaceToFaceValidation's threshold grid."""
    import torch
    hi = 4.0 if metric == 0 else np.pi
    return pair_counts.prepare(torch.from_numpy(emb).cuda(), labels,
                               np.linspace(0, hi, t), metric)


def pair_split_times(pair_counts, emb, labels, t=100):
    """B1's time (ms, device) on unit-norm `emb` at three shapes that split
    it between main loop and epilogue: (D, T) as given; (D, 1), the test
    folds' call, where every pair lands on one of two bins; (32, T), the
    epilogue with almost no main loop. Returns {label: (median, windows)}."""
    import torch

    from facenet_tpu_torch.utils.timing import cuda_ms
    narrow = emb[:, :32] / np.linalg.norm(emb[:, :32], axis=1, keepdims=True)
    cases = {
        f'D={emb.shape[1]} T={t}': prepared(pair_counts, emb, labels, 0, t),
        f'D={emb.shape[1]} T=1': pair_counts.prepare(
            torch.from_numpy(emb).cuda(), labels, np.array([1.0]), 0),
        f'D=32 T={t}': prepared(pair_counts, narrow.astype(np.float32),
                                labels, 0, t)}
    return {label: cuda_ms(lambda: pair_counts.pair_histogram(inputs), reps=5)
            for label, inputs in cases.items()}


def synthetic_batches(rng, n_classes, per_class, batch, size=160):
    """uint8 face-sized images, class base image + noise, in batches."""
    base = rng.integers(0, 256, (n_classes, size, size, 3)).astype(np.float32)
    labels = np.repeat(np.arange(n_classes), per_class).astype(np.int32)
    for start in range(0, labels.size, batch):
        lab = labels[start:start + batch]
        noise = rng.standard_normal((lab.size, size, size, 3), np.float32)
        yield (np.clip(base[lab] + 8.0 * noise, 0, 255).astype(np.uint8),
               lab)


def print_ptxas(lib):
    for line in lib.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
            print('  ptxas:', line.strip())


def _launch_counters():
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.ops import crop, nms, pair_counts, stem, warp
    from facenet_tpu_torch.tools import try_pnet_v3
    return {'pair_below_counts': pair_counts.pair_histogram,
            'dense_warp': warp.dense_warp,
            'crop_resize': crop.crop_and_resize,
            'nms_greedy': nms.greedy_keep,
            'pnet_pyramid': pnet.pnet_forward_pyramid,
            'stem_fused': stem.stem_forward,
            'pnet_flat': pnet.pnet_forward_flat,
            'pnet_level': pnet.pnet_forward_level,
            'pnet_trunk_nhwc': try_pnet_v3.pnet_trunk_nhwc}


def reset_launches():
    for fn in _launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _launch_counters().items()}


def only(**launches):
    """The launch counts of a path that ran these kernels and no other."""
    return {name: launches.get(name, 0) for name in _launch_counters()}


def warp_cases(rng):
    """(label, source [N, H, W, 3], matrices [N, 2, 3], out size) on the
    card; the 32 random similarity warps push samples off every edge, and
    the landmark alignment's crops of faces turned by 45 and 30 degrees
    have the largest footprints."""
    import torch

    from facenet_tpu_torch.utils.synthetic import alignment_inputs
    n, t = 32, 240
    src = rng.uniform(0, 255, (n, t, t, 3)).astype(np.float32)
    th = rng.uniform(-0.7, 0.7, n)
    sc = rng.uniform(0.7, 2.0, n)
    m = np.zeros((n, 2, 3), np.float32)
    m[:, 0, 0] = m[:, 1, 1] = sc * np.cos(th)
    m[:, 0, 1] = -sc * np.sin(th)
    m[:, 1, 0] = sc * np.sin(th)
    m[:, :, 2] = rng.uniform(-80, 160, (n, 2))
    src_t = torch.from_numpy(src).cuda()
    mats = torch.from_numpy(m).cuda()
    eye = torch.eye(2, 3).repeat(4, 1, 1).cuda()
    cases = [('32 crops 240->160', src_t, mats, (160, 160)),
             ('identity 240->240', src_t[:4].contiguous(), eye, (240, 240)),
             ('non-square 240->96x200', src_t[:8].contiguous(),
              mats[:8].contiguous(), (96, 200)),
             ('1 channel 240->160', src_t[:8, ..., :1].contiguous(),
              mats[:8].contiguous(), (160, 160))]
    for degrees in (45, 30):
        rot_src, rot_mats = alignment_inputs(8, degrees, 'cuda', degrees)
        cases.append((f'{degrees} degrees, alignment crops 240->160',
                      rot_src, rot_mats, (160, 160)))
    return cases


def _warp_coords(mats, size):
    """Unclamped source coords (sx, sy) [N, oh, ow] of every output pixel,
    rounded as the B2 kernel rounds them."""
    import torch
    ys, xs = torch.meshgrid(
        torch.arange(size[0], dtype=torch.float32, device=mats.device),
        torch.arange(size[1], dtype=torch.float32, device=mats.device),
        indexing='ij')
    m = mats[:, :, :, None, None]
    return (m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2],
            m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2])


def off_edge_share(mats, size, t):
    """Share of output pixels whose source lies outside [0, t - 1]."""
    sx, sy = _warp_coords(mats, size)
    return float(((sx < 0) | (sx > t - 1) | (sy < 0) | (sy > t - 1))
                 .float().mean())


def warp_touched_pixels(mats, size, h, w):
    """Source pixels, summed over the crops, that some output pixel's
    two-tap sample reads with a nonzero weight: what the warp must read."""
    import torch
    sx, sy = _warp_coords(mats, size)
    sx, sy = sx.clamp(0, w - 1), sy.clamp(0, h - 1)
    x0, y0 = sx.floor(), sy.floor()
    wx, wy = sx - x0, sy - y0
    base = torch.arange(mats.shape[0], device=mats.device)[:, None, None] * h * w
    touched = torch.zeros(mats.shape[0] * h * w, dtype=torch.bool,
                          device=mats.device)
    for yi, ty in ((y0, None), (y0 + 1, wy)):
        for xi, tx in ((x0, None), (x0 + 1, wx)):
            keep = torch.ones_like(wx, dtype=torch.bool)
            if ty is not None:
                keep &= ty > 0
            if tx is not None:
                keep &= tx > 0
            touched[(base + yi.long() * w + xi.long())[keep]] = True
    return int(touched.sum())


def copy_roof_kernel():
    """The copy yardstick csrc/copy_roof.cu, not a kernel of the port."""
    import ctypes

    from facenet_tpu_torch.ops.cuda_build import CudaKernel
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    return CudaKernel('copy_roof.cu', {
        'copy_roof_launch': [ptr, i64, ptr, i64, ctypes.c_int, ptr]})


def copy_roofs(lib, read_bytes, write_bytes, copies):
    """{label: callable}: ways to move `read_bytes` in and `write_bytes`
    out of device memory, rotating over `copies` buffer pairs so that the
    reads come from HBM when their total exceeds the L2. The yardstick
    kernel with 1 and with 4 float4 loads in flight a thread, and the
    library's device-to-device copy (Tensor.copy_, a cudaMemcpyAsync) of
    (read + write) / 2 bytes each way, the same total traffic."""
    import torch

    from facenet_tpu_torch.ops.cuda_build import check
    n_in, n_out = -(-read_bytes // 16) * 4, -(-write_bytes // 16) * 4
    n_lib = (n_in + n_out) // 2
    pairs = [(torch.rand(max(n_in, n_lib), device='cuda'),
              torch.empty(max(n_out, n_lib), device='cuda'))
             for _ in range(copies)]

    def kernel(loads):
        cycle = itertools.cycle(pairs)

        def run():
            src, dst = next(cycle)
            check(lib.copy_roof_launch(
                src.data_ptr(), n_in, dst.data_ptr(), n_out, loads,
                torch.cuda.current_stream().cuda_stream), 'copy_roof')
        return run

    cycle = itertools.cycle(pairs)

    def library():
        src, dst = next(cycle)
        dst[:n_lib].copy_(src[:n_lib])
    return {'float4 copy': kernel(1),
            'float4 copy, 2 loads in flight': kernel(2),
            'float4 copy, 4 loads in flight': kernel(4),
            'Tensor.copy_ of the same total': library}


def rotating(fn, args):
    """fn over the argument tuples in turn, one tuple per call."""
    cycle = itertools.cycle(args)
    return lambda: fn(*next(cycle))


def pnet_work(levels):
    """(flops, bytes) of the P-Net over these levels: multiply-adds of
    the three convs and the heads (x2), inputs read once, heads written
    once, weights read once."""
    from facenet_tpu_torch.detectors.mtcnn import pnet
    flops = nbytes = 0
    for level in levels:
        b, _, sh, sw = level.shape
        h1, w1 = sh - 2, sw - 2
        hp, wp = -(-h1 // 2), -(-w1 // 2)
        gh, gw = pnet.out_geometry(sh, sw)
        macs = (h1 * w1 * 10 * 27 + (hp - 2) * (wp - 2) * 16 * 90
                + gh * gw * (32 * 144 + 6 * 32))
        flops += 2 * b * macs
        nbytes += b * (3 * sh * sw * 2 + gh * gw * 5 * 4)
    return flops, nbytes + pnet.N_WEIGHTS * 4


def compare_pnet(pnet, net, levels, label):
    """Kernel vs plain heads on the same levels; returns the max abs
    differences (probs, reg)."""
    import torch
    kern = pnet.pnet_forward_pyramid(net, levels)
    torch.cuda.synchronize()
    plain = pnet.pnet_forward_pyramid_plain(net, levels)
    dp = max(float((a - b).abs().max()) for (a, _), (b, _) in zip(kern, plain))
    dr = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(kern, plain))
    shapes = ' '.join(f'{lv.shape[2]}x{lv.shape[3]}' for lv in levels)
    print(f'  {label} (batch {levels[0].shape[0]}; {shapes}): max |kernel - '
          f'plain| probs {dp:.3e} reg {dr:.3e}')
    require(dp < 0.02 and dr < 0.05,
            f'pnet_pyramid kernel != plain ({label}): {dp} {dr}')
    return dp, dr


def device_breakdown(fn, top=12):
    """torch.profiler over one call of fn(): kernel time by name and the
    device's busy share of the call's wall time."""
    from facenet_tpu_torch.utils.timing import device_busy
    busy_ms, wall_ms, rows = device_busy(fn)
    if busy_ms <= 0:
        print('  profiler: no device time recorded (not measured)')
        return
    print(f'  profiler: {len(rows)} kernel names, '
          f'{sum(e.count for e in rows)} launches, device busy '
          f'{busy_ms:.3f} ms of {wall_ms:.3f} ms wall '
          f'({busy_ms / wall_ms:.3f} busy share)')
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f'    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} '
              f'{e.key[:90]}')


def detection_phases(rng, libs, bundle):
    """Phases 7-12 (see the module docstring) with the full-width IRv1
    `bundle`; returns the kernels-line entries of B3 and B2, and what the
    later phases reuse: the 64 scenes, the 'pyramid' cascade, the pyramid
    levels of the first 16 scenes and B3's time on them."""
    import torch
    import torch.nn.functional as F

    from facenet_tpu_torch import FaceNet
    from facenet_tpu_torch.detectors import evaluation
    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.detectors.mtcnn.networks import normalize_crops
    from facenet_tpu_torch.ops import warp
    from facenet_tpu_torch.ops.image_ops import (align_by_landmarks,
                                                 dense_warp_inputs)
    from facenet_tpu_torch.pipeline import FacePipeline
    from facenet_tpu_torch.utils.synthetic import render_scene
    from facenet_tpu_torch.utils.timing import cuda_ms, device_ms
    from facenet_tpu_torch.utils.timing import spread as _spread

    # 7. the detection kernels' build report
    print('[7] ptxas of the detection kernels')
    for name in ('dense_warp', 'pnet_pyramid'):
        print(f'  {name}:')
        print_ptxas(libs[name])

    # 8. B2 kernel vs plain
    print('[8] dense_warp kernel vs plain')
    cases = warp_cases(rng)
    warp_errs = []
    for label, src, mats, size in cases:
        kern = warp.dense_warp(src, mats, size)
        torch.cuda.synchronize()
        plain = warp.dense_warp_plain(src, mats, size)
        err = float((kern - plain).abs().max())
        warp_errs.append(err)
        print(f'  {label}: max |kernel - plain| {err:.3e}, '
              f'{off_edge_share(mats, size, src.shape[1]):.3f} of samples '
              'off the edge')
        require(err < 1e-3, f'dense_warp kernel != plain ({label}): {err}')

    # 9. B3 kernel vs plain
    print('[9] pnet_pyramid kernel vs plain')
    scene_rng = np.random.RandomState(2)
    scenes = [render_scene(scene_rng, shape=SCENE,
                           n_faces=scene_rng.randint(1, 4), min_face=40,
                           max_face=200) for _ in range(64)]
    images = np.stack([scene[0] for scene in scenes])
    truth = [scene[1] for scene in scenes]
    facenet = FaceNet(device='cuda', bundle=bundle)
    pipe = FacePipeline(facenet, image_shape=SCENE, align='landmarks',
                        num_faces=2)
    det = pipe.backend
    batch = torch.from_numpy(images[:16]).cuda()
    with torch.inference_mode():
        levels = det.pyramid_levels(
            normalize_crops(batch.float()).to(torch.bfloat16))
    pnet_errs = list(compare_pnet(pnet, det.pnet, levels,
                                  f'{len(levels)}-level {SCENE} pyramid'))
    odd = [torch.from_numpy(rng.integers(0, 256, (3, 3, sh, sw))
                            .astype(np.float32)).cuda() for sh, sw in
           ((41, 57), (29, 39), (14, 18))]
    odd = [normalize_crops(x).to(torch.bfloat16).contiguous() for x in odd]
    pnet_errs += compare_pnet(pnet, det.pnet, odd, '3-level odd pyramid')

    # 10. the detection main path
    print('[10] main path: FacePipeline (MTCNN -> landmark warp -> IRv1), '
          '64 scenes in batches of 16 (cuda)')
    reset_launches()
    t0 = time.monotonic()
    outs = [pipe.process_batch(images[i:i + 16]) for i in range(0, 64, 16)]
    path_s = time.monotonic() - t0
    counts = read_launches()
    print(f'  {path_s:.2f} s, kernel launches {counts}')
    require(counts == only(dense_warp=4, pnet_pyramid=4, crop_resize=12,
                           nms_greedy=4),
            f'expected 4 pnet_pyramid, 4 dense_warp, 12 crop_resize and 4 '
            f'nms_greedy launches, got {counts}')
    valid = np.concatenate([o['valid'] for o in outs])
    emb = np.concatenate([o['embeddings'] for o in outs])
    boxes = np.concatenate([o['boxes'] for o in outs])
    require(emb.shape == (64, 2, 512), f'bad embeddings {emb.shape}')
    norms = np.linalg.norm(emb[valid], axis=-1)
    require(np.isfinite(emb[valid]).all() and np.abs(norms - 1).max() < 1e-5,
            'valid embeddings are not finite and unit-norm')
    matched = sum(evaluation.match_detections(gt, b[v])[0]
                  for gt, b, v in zip(truth, boxes, valid))
    findable = sum(min(len(gt), 2) for gt in truth)
    print(f'  {int(valid.sum())} valid faces in 64 scenes; {matched} of '
          f'{findable} ground-truth faces (at most 2 a scene) matched at '
          'IoU 0.5')
    require(valid[:, 0].mean() >= 0.75, 'most scenes gave no detection')

    # the same stages on the CPU, the warp through its plain version
    t0 = time.monotonic()
    cpu_det = FaceDetector(image_shape=SCENE, device='cpu').backend_for(SCENE)
    with torch.inference_mode():
        x = torch.from_numpy(images[:4])
        found = cpu_det._detect(x)
        crops = align_by_landmarks(x.float(), found['landmarks'][:, :2], 160,
                                   method='dense')
        ref_emb = FaceNet(device='cpu', bundle=bundle).dispatch(
            torch.clamp(crops + 0.5, 0, 255).to(torch.uint8)
            .reshape(8, 160, 160, 3)).reshape(4, 2, -1)
    ref = {k: found[k][:, :2].numpy()
           for k in ('valid', 'boxes', 'landmarks', 'scores')}
    ref['embeddings'] = ref_emb.numpy()
    card = {k: v[:4] for k, v in outs[0].items()}
    v = ref['valid']
    require(np.array_equal(card['valid'], v), 'valid masks differ from CPU')
    d_box = float(np.abs(card['boxes'][v] - ref['boxes'][v]).max())
    d_lmk = float(np.abs(card['landmarks'][v] - ref['landmarks'][v]).max())
    d_score = float(np.abs(card['scores'][v] - ref['scores'][v]).max())
    cos = (card['embeddings'][v] * ref['embeddings'][v]).sum(-1)
    print(f'  card vs CPU (plain versions), 4 scenes, {v.sum()} valid, '
          f'{time.monotonic() - t0:.1f} s on the CPU: boxes {d_box:.3e} px, '
          f'landmarks {d_lmk:.3e} px, scores {d_score:.3e}, min cosine '
          f'{cos.min():.6f}')
    require(d_box < 1.5 and d_lmk < 1.5 and d_score < 0.02
            and cos.min() >= 0.99, 'card pipeline != CPU pipeline')

    # 11. the detector's quality gate on the card
    print('[11] bundled MTCNN quality gate (32 held-out 256x256 scenes)')
    gate_rng = np.random.RandomState(555)
    held = [render_scene(gate_rng, shape=(256, 256),
                         n_faces=gate_rng.randint(1, 4), min_face=32,
                         max_face=160) for _ in range(32)]
    m = evaluation.evaluate_detector(
        FaceDetector(image_shape=(256, 256), device='cuda'),
        [h[0] for h in held], [h[1] for h in held], iou_threshold=0.5,
        batch_size=16)
    print('  ' + ' '.join(f'{k}={v:.4f}' if isinstance(v, float) else
                          f'{k}={v}' for k, v in m.items()))
    require(m['recall'] >= 0.97 and m['precision'] >= 0.97
            and m['mean_iou'] >= 0.5, f'quality gate failed: {m}')

    # 12. times
    print('[12] times (CUDA events; median of 3 windows; kernels and their '
          'yardsticks in device time, host enqueue per call beside)')
    with torch.inference_mode():
        b3_ms, b3_all, b3_host = device_ms(
            lambda: pnet.pnet_forward_pyramid(det.pnet, levels), 20)
        b3_plain, b3_plain_all, b3_plain_host = device_ms(
            lambda: pnet.pnet_forward_pyramid_plain(det.pnet, levels), 5)
        b3_lib, b3_lib_all, b3_lib_host = device_ms(
            lambda: [det.pnet.forward_nchw(lv) for lv in levels], 10)
    flops, nbytes = pnet_work(levels)
    b3_ops, b3_bytes = (flops / H100_BF16_FLOPS * 1e3,
                        nbytes / H100_HBM_BYTES * 1e3)
    b3_bound = max(b3_ops, b3_bytes)
    print(f'  pnet_pyramid, batch 16 x {len(levels)} levels: kernel '
          f'{b3_ms:.4f} ms ({_spread(b3_all)}; host {b3_host:.4f}), plain '
          f'{b3_plain:.4f} ms ({_spread(b3_plain_all)}; host '
          f'{b3_plain_host:.4f}), cuDNN P-Net {b3_lib:.4f} ms '
          f'({_spread(b3_lib_all)}; host {b3_lib_host:.4f}), bound '
          f'{b3_bound:.4f} ms ({flops:.4e} flop, {nbytes:.4e} bytes)')

    # B2 on the main path's own inputs: what the landmark alignment hands
    # the warp for one batch of 16 scenes
    scenes16 = torch.from_numpy(images[16:32]).cuda()
    size = (160, 160)
    with torch.inference_mode():
        lmk = det._detect(scenes16)['landmarks'][:, :2]
        src, mats = dense_warp_inputs(scenes16.float(), lmk, size[0])
    n, t, c = src.shape[0], src.shape[1], src.shape[-1]
    err = float((warp.dense_warp(src, mats, size)
                 - warp.dense_warp_plain(src, mats, size)).abs().max())
    warp_errs.append(err)
    require(err < 1e-3, f'dense_warp kernel != plain (main path): {err}')
    touched = warp_touched_pixels(mats, size, t, t)
    sx, sy = _warp_coords(mats, size)
    grid = torch.stack([2 * sx / (t - 1) - 1, 2 * sy / (t - 1) - 1], -1)
    copies = [(src.clone(), mats.clone()) for _ in range(ROTATE)]
    lib_copies = [(s.permute(0, 3, 1, 2).contiguous(), grid.clone())
                  for s, _ in copies]

    def grid_sample(src_nchw, grid):
        return F.grid_sample(src_nchw, grid, mode='bilinear',
                             padding_mode='border', align_corners=True)

    lib_err = float((grid_sample(*lib_copies[0]).permute(0, 2, 3, 1)
                     - warp.dense_warp(src, mats, size)).abs().max())
    b2_ms, b2_all, b2_host = device_ms(
        rotating(lambda s, m: warp.dense_warp(s, m, size), copies), 60, 6)
    b2_plain, b2_plain_all, b2_plain_host = device_ms(
        rotating(lambda s, m: warp.dense_warp_plain(s, m, size), copies), 6)
    b2_lib, b2_lib_all, b2_lib_host = device_ms(
        rotating(grid_sample, lib_copies), 60, 6)
    b2_bytes_n = (touched * c + mats.numel() + n * size[0] * size[1] * c) * 4
    b2_flops = n * size[0] * size[1] * (8 + 9 * c)
    b2_ops, b2_bytes = (b2_flops / H100_FP32_FLOPS * 1e3,
                        b2_bytes_n / H100_HBM_BYTES * 1e3)
    b2_bound = max(b2_ops, b2_bytes)
    print(f'  dense_warp, main-path inputs ({n} crops {t}->{size[0]}, '
          f'{off_edge_share(mats, size, t):.3f} of samples off the edge, '
          f'{touched / src[..., 0].numel():.3f} of source pixels read, max '
          f'|kernel - plain| {err:.3e}; {ROTATE} rotating copies, '
          f'{ROTATE * src.numel() * 4 / 1e6:.0f} MB of sources): kernel '
          f'{b2_ms:.4f} ms ({_spread(b2_all)}; host {b2_host:.4f}), plain '
          f'{b2_plain:.4f} ms ({_spread(b2_plain_all)}; host '
          f'{b2_plain_host:.4f}), grid_sample {b2_lib:.4f} ms '
          f'({_spread(b2_lib_all)}; host {b2_lib_host:.4f}; max |grid_sample '
          f'- kernel| {lib_err:.3e}), bound {b2_bound:.4f} ms '
          f'({b2_bytes_n:.4e} bytes)')
    write_n = n * size[0] * size[1] * c * 4
    print(f'    {b2_bound / b2_ms:.3f} of its bound; copies of the same bytes '
          f'(the practical roof at this size):')
    for label, run in copy_roofs(libs['copy_roof'], b2_bytes_n - write_n,
                                 write_n, ROTATE).items():
        ms, windows, _ = device_ms(run, 60, 6)
        print(f'      {label} {ms:.4f} ms ({_spread(windows)}); B2 '
              f'{b2_ms / ms:.3f} of it')
    del copies, lib_copies

    # B2 at 128 crops: the four batches' crops in one call, to split the
    # fixed cost of a launch from the cost per byte
    with torch.inference_mode():
        scenes64 = torch.from_numpy(images).cuda()
        lmk128 = torch.cat([det._detect(scenes64[i:i + 16])['landmarks'][:, :2]
                            for i in range(0, 64, 16)])
        src128, mats128 = dense_warp_inputs(scenes64.float(), lmk128, size[0])
    del scenes64
    err = float((warp.dense_warp(src128, mats128, size)
                 - warp.dense_warp_plain(src128, mats128, size)).abs().max())
    warp_errs.append(err)
    require(err < 1e-3, f'dense_warp kernel != plain (128 crops): {err}')
    n128 = src128.shape[0]
    write128 = n128 * size[0] * size[1] * c * 4
    bytes128 = (warp_touched_pixels(mats128, size, t, t) * c
                + mats128.numel()) * 4 + write128
    copies = [(src128.clone(), mats128.clone()) for _ in range(2)]
    del src128
    ms128, all128, host128 = device_ms(
        rotating(lambda s, m: warp.dense_warp(s, m, size), copies), 30, 4)
    bound128 = bytes128 / H100_HBM_BYTES * 1e3
    print(f'  dense_warp, the 4 batches\' {n128} crops in one call (2 '
          f'rotating copies): kernel {ms128:.4f} ms ({_spread(all128)}; host '
          f'{host128:.4f}), bound {bound128:.4f} ms ({bytes128:.4e} bytes; '
          f'{bound128 / ms128:.3f} of it); copies of the same bytes:')
    for label, run in copy_roofs(libs['copy_roof'], bytes128 - write128,
                                 write128, 2).items():
        ms, windows, _ = device_ms(run, 30, 4)
        print(f'      {label} {ms:.4f} ms ({_spread(windows)}); B2 '
              f'{ms128 / ms:.3f} of it')
    del copies

    pipe_ms, pipe_all = cuda_ms(lambda: pipe.dispatch(scenes16), 5, 2)
    faces16 = int(pipe.dispatch(scenes16)['valid'].sum())
    t0 = time.perf_counter()
    for _ in range(5):
        pipe.dispatch(scenes16)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    cascade_ms, cascade_all = cuda_ms(lambda: det._detect(scenes16), 5, 2)
    with torch.inference_mode():
        base = normalize_crops(scenes16.float()).to(torch.bfloat16)
        pyramid_ms, _ = cuda_ms(lambda: det.pyramid_levels(base), 10, 2)
        f32 = scenes16.float()
        align_ms, _ = cuda_ms(lambda: align_by_landmarks(f32, lmk, 160), 10, 2)
        crops = torch.clamp(align_by_landmarks(f32, lmk, 160) + 0.5, 0, 255) \
            .to(torch.uint8).reshape(32, 160, 160, 3)
    embed_ms, _ = cuda_ms(lambda: facenet.dispatch(crops), 10, 2)
    print(f'  pipeline, batch of 16 {SCENE} scenes, 2 faces each: '
          f'{pipe_ms:.3f} ms ({_spread(pipe_all)}) = '
          f'{16e3 / pipe_ms:.1f} scenes/s = {32e3 / pipe_ms:.1f} embedding '
          f'slots/s; {faces16} of the 32 slots are detected faces = '
          f'{faces16 * 1e3 / pipe_ms:.1f} aligned embeddings of detected '
          f'faces/s; host enqueue {host_ms:.3f} ms per batch')
    print(f'  stages alone: cascade {cascade_ms:.3f} ms '
          f'({_spread(cascade_all)}) [pyramid resize {pyramid_ms:.3f}, '
          f'P-Net kernel {b3_ms:.3f}], landmark alignment {align_ms:.3f} ms, '
          f'IRv1 embedding of 32 crops {embed_ms:.3f} ms')
    device_breakdown(lambda: pipe.dispatch(scenes16))

    context = {'images': images, 'det': det, 'levels': levels,
               'pyramid_ms': b3_ms}
    return context, [{
        'name': 'pnet_pyramid',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/pnet_pyramid.cu',
        'replaces': 'facenet_tpu/detectors/mtcnn/pallas_pnet.py:658',
        'launches': counts['pnet_pyramid'],
        'max_abs_err': max(pnet_errs),
        'ms': b3_ms,
        'plain_ms': b3_plain,
        'bound_ms': b3_bound,
        'bound_by': 'operations' if b3_ops >= b3_bytes else 'bytes',
        'library_ms': b3_lib,
    }, {
        'name': 'dense_warp',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/dense_warp.cu',
        'replaces': 'facenet_tpu/ops/pallas_warp.py:45',
        'launches': counts['dense_warp'],
        'max_abs_err': max(warp_errs),
        'ms': b2_ms,
        'plain_ms': b2_plain,
        'bound_ms': b2_bound,
        'bound_by': 'operations' if b2_ops >= b2_bytes else 'bytes',
        'library_ms': b2_lib,
    }]


def stem_work(batch):
    """(flops, bytes) of the stem prefix on `batch` 160x160 images: the
    multiply-adds of the three convs (x2); images read once, pooled maps
    written once (bf16), packed weights read once."""
    from facenet_tpu_torch.ops import stem
    macs = 79 * 79 * 48 * 32 + 77 * 77 * 288 * 32 + 75 * 75 * 288 * 64
    nbytes = (batch * (160 * 160 * 3 + 37 * 37 * 64) + stem.N_HALFS) * 2
    return 2 * batch * macs, nbytes


# B5's three convs on an 8x8 pooled tile: (cells a side, depth steps of
# 16, output channels, shared loads of one cell tile's A fragment a step)
STEM_CONVS = ((21, 3, 32, 4), (19, 18, 32, 2), (17, 18, 64, 2))
# the design B5 replaced: one block per (image, tile), one 16-cell tile x
# 32 channels a warp's item
STEM_SCHEDULE_PER_TILE = ((1, 4), (1, 4), (1, 4))


def stem_fragment_loads(schedule, conv2b_tail=True):
    """(shared-memory fragment loads, mma) per 8x8 tile of a B5 schedule,
    (cell tiles MT, column tiles NT) of a warp's item per conv as
    `stem.SCHEDULE`; a weight fragment is one load a column tile and step.
    With `conv2b_tail`, conv2b's rows past its whole rounds of items on 8
    warps run as 1 x NT items, as csrc/stem_fused.cu does."""
    loads = mmas = 0
    for i, ((side, steps, channels, a_loads), (mt, nt)) in enumerate(
            zip(STEM_CONVS, schedule)):
        rows = side * side
        parts = [(rows, mt)]
        if conv2b_tail and i == len(STEM_CONVS) - 1:
            whole = rows - rows % (8 // (channels // (8 * nt)) * 16 * mt)
            parts = [(whole, mt), (rows - whole, 1)]
        for part_rows, part_mt in parts:
            items = (-(-part_rows // (16 * part_mt))
                     * (channels // (8 * nt)))
            loads += items * steps * (part_mt * a_loads + nt)
            mmas += items * steps * part_mt * nt
    return loads, mmas


def stem_schedule_line(sms):
    """B5's shared fragment loads per mma and weight bytes staged per image
    at batch 128 on `sms` SMs, beside the design it replaced."""
    from facenet_tpu_torch.ops import stem
    weight_bytes = stem.N_HALFS * 2
    ratio = ['{:.3f} ({} loads, {} mma a tile)'.format(loads / mmas, loads,
                                                       mmas)
             for loads, mmas in (stem_fragment_loads(stem.SCHEDULE),
                                 stem_fragment_loads(STEM_SCHEDULE_PER_TILE,
                                                     False))]
    return (f'  stem_fused schedule: shared fragment loads per mma '
            f'{ratio[0]} (one block per tile and one cell tile an item: '
            f'{ratio[1]}); weight bytes staged per image at batch 128 on '
            f'{sms} SMs {stem.launch_blocks(128, sms) * weight_bytes / 128:.1f}'
            f' (staged by every block of that design: '
            f'{stem.TILES ** 2 * weight_bytes})')


def flat_planes(rng, level, pitch):
    """A [B, 3, sh, sw] bf16 level as planes [B, 3, sh * pitch] with N(0, 3)
    noise in the columns past sw."""
    import torch
    b, _, sh, sw = level.shape
    pad = torch.from_numpy(rng.normal(0, 3, (b, 3, sh, pitch))
                           .astype(np.float32)).to(level.device,
                                                   torch.bfloat16)
    pad[..., :sw] = level
    return pad.reshape(b, 3, sh * pitch)


def compare_level_kernels(rng, net, level, label):
    """B4, B6 and B7 against the plain version on one level; returns the
    max abs differences {kernel name: worst of its outputs}."""
    import torch

    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.tools import try_pnet_v3
    b, _, sh, sw = level.shape
    pitch = -(-sw // 128) * 128
    rounded = pnet.packed_weights(net, level.device)
    unrounded = pnet.pack_level_weights(net).to(level.device)
    p4, r4 = pnet.pnet_forward_flat(net, flat_planes(rng, level, pitch), sh,
                                    pitch, sw)
    p6, r6 = pnet.pnet_forward_level(unrounded, level)
    z7 = try_pnet_v3.pnet_trunk_nhwc(level.permute(0, 2, 3, 1).contiguous(),
                                     rounded)
    torch.cuda.synchronize()
    pw, rw = pnet.level_plain(rounded, level)
    pu, ru = pnet.level_plain(unrounded, level)
    zw = pnet.level_plain(rounded, level, raw=True)

    def diff(a, b, reduce=torch.amax):
        require(a.shape == b.shape, f'{label}: shapes {a.shape} {b.shape}')
        return float(reduce((a - b).abs()))

    errs = {'pnet_flat': (diff(p4, pw), diff(r4, rw)),
            'pnet_level': (diff(p6, pu), diff(r6, ru)),
            'pnet_trunk_nhwc': (0.0, diff(z7, zw))}
    # B6 against the plain version on its unrounded weights and on their
    # bf16 rounding (what the hi part alone computes): mean |d|
    means = {name: (diff(p6, p, torch.mean), diff(r6, r, torch.mean))
             for name, (p, r) in (('unrounded', (pu, ru)),
                                  ('rounded', (pw, rw)))}
    print(f'  {label} (batch {b}, {sh}x{sw}, pitch {pitch}): max |kernel - '
          'plain| ' + ', '.join(f'{k} probs {p:.3e} reg/raw {r:.3e}'
                                for k, (p, r) in errs.items())
          + '; pnet_level mean |d| probs/reg to the unrounded plain '
          '{:.3e}/{:.3e}, to the rounded one {:.3e}/{:.3e}'.format(
              *means['unrounded'], *means['rounded']))
    for name, (dp, dr) in errs.items():
        require(dp < 0.02 and dr < 0.05,
                f'{name} kernel != plain ({label}): {dp} {dr}')
    require(all(u < r for u, r in zip(means['unrounded'], means['rounded'])),
            f'pnet_level is not nearer to its unrounded weights ({label}): '
            f'{means}')
    return {name: max(pair) for name, pair in errs.items()}


def slice3_phases(rng, libs, context):
    """Phases 13-17 (see the module docstring); returns the kernels-line
    entries of B5, B4, B6 and B7."""
    import torch

    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.models import irv1_fast
    from facenet_tpu_torch.ops import stem
    from facenet_tpu_torch.ops.preprocessing import image_processing
    from facenet_tpu_torch.tools import try_pallas_pnet, try_pnet_v3
    from facenet_tpu_torch.utils.timing import (cuda_ms, device_busy,
                                                 device_ms)
    from facenet_tpu_torch.utils.timing import spread as _spread

    smi = context['smi']
    images, det, levels = context['images'], context['det'], context['levels']

    # 13. the new kernels' build report
    print('[13] ptxas of the fused stem and the one-level P-Net kernels')
    for name in ('stem_fused', 'pnet_level'):
        print(f'  {name}:')
        print_ptxas(libs[name])

    # 14. B5 kernel vs plain, full-width weights
    print('[14] stem_fused kernel vs plain')
    fused = irv1_fast.FastEmbedder(context['variables'], device='cuda',
                                   stem='fused')
    cudnn = irv1_fast.FastEmbedder(context['variables'], device='cuda',
                                   stem='cudnn')
    params = fused.params
    stem_errs = []
    for batch in (8, 128):
        raw = rng.integers(0, 256, (batch, 160, 160, 3), dtype=np.uint8)
        if batch == 8:
            raw[0], raw[1] = 0, 255
        with torch.inference_mode():
            x = image_processing(torch.from_numpy(raw).cuda(), 160, 0,
                                 dtype=torch.bfloat16)
            got = stem.stem_forward(params, x)
            torch.cuda.synchronize()
            want = stem.stem_forward_plain(params, x)
        require(tuple(got.shape) == (batch, 64, 37, 37)
                and got.dtype == torch.bfloat16
                and got.is_contiguous(memory_format=torch.channels_last),
                f'stem output {got.dtype} {tuple(got.shape)} '
                f'strides {got.stride()}')
        # elementwise on the NCHW views: no copy into another layout
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        stem_errs.append(err)
        print(f'  batch {batch}: max |kernel - plain| {err:.3e} = '
              f'{err / scale:.3e} of max |plain| {scale:.3f}; '
              f'{float((got != want).float().mean()):.2e} of the values '
              'differ')
        require(scale > 0 and err <= 0.01 * scale,
                f'stem_fused kernel != plain (batch {batch}): {err} of '
                f'{scale}')
    x128 = x

    # 15. B4, B6, B7 kernels vs plain
    print('[15] one-level P-Net kernels vs plain')
    level_errs = {}
    odd = [torch.from_numpy(rng.integers(0, 256, (2, 3, sh, sw))
                            .astype(np.float32)).cuda()
           for sh, sw in ((24, 100), (61, 83), (40, 129))]
    from facenet_tpu_torch.detectors.mtcnn.networks import normalize_crops
    cases = [(normalize_crops(x).to(torch.bfloat16).contiguous(), 'odd level')
             for x in odd] + [(levels[0], f'level 0 of the {SCENE} pyramid')]
    for level, label in cases:
        for name, err in compare_level_kernels(rng, det.pnet, level,
                                               label).items():
            level_errs[name] = max(level_errs.get(name, 0.0), err)
    sums = try_pallas_pnet.conv_sum_errors(
        pnet.pack_level_weights(det.pnet).to(levels[0].device), levels[0])
    print("  pnet_level conv3 sums at level 0 against float64 sums of the "
          "same bf16 activations and float32 weights, max |s - s64| (max "
          f"|s64| {sums['scale']:.4f}): three mma a step chained on the "
          f"accumulator {sums['chained']:.3e}, each step summed from zero "
          f"(B6) {sums['step sums']:.3e}, float32 fused multiply-adds in a "
          f"CUDA-core loop's order {sums['fma chain']:.3e}")

    # 16. this slice's main paths
    print("[16a] main path: FastEmbedder(stem='fused'), full-width IRv1, "
          '4 batches of 128 (cuda)')
    batches = [torch.from_numpy(rng.integers(
        0, 256, (128, 160, 160, 3), dtype=np.uint8)).cuda() for _ in range(4)]
    reset_launches()
    t0 = time.monotonic()
    emb = torch.cat([fused(batch) for batch in batches])
    torch.cuda.synchronize()
    path_s = time.monotonic() - t0
    counts_a = read_launches()
    print(f'  {path_s:.3f} s, kernel launches {counts_a}')
    require(counts_a == only(stem_fused=4),
            f'expected 4 stem_fused launches alone, got {counts_a}')
    ref = torch.cat([cudnn(batch) for batch in batches])
    norms = emb.norm(dim=1)
    cos = float((emb * ref).sum(dim=1).min())
    require(tuple(emb.shape) == (512, 512) and bool(emb.isfinite().all())
            and float((norms - 1).abs().max()) < 1e-5,
            'fused-stem embeddings are not finite and unit-norm')
    print(f"  stem='fused' vs stem='cudnn': min cosine {cos:.6f}")
    require(cos >= 0.999, f'min cosine {cos} < 0.999')

    print("[16b] main path: MTCNN(pnet_impl='flat') through FaceDetector, 64 "
          'scenes in batches of 16 (cuda)')
    flat = FaceDetector(image_shape=SCENE, device='cuda',
                        pnet_impl='flat').backend_for(SCENE)
    reset_launches()
    t0 = time.monotonic()
    outs = [flat.detect_batch(images[i:i + 16]) for i in range(0, 64, 16)]
    path_s = time.monotonic() - t0
    counts_b = read_launches()
    print(f'  {path_s:.2f} s, kernel launches {counts_b}')
    require(len(levels) == 10
            and counts_b == only(pnet_flat=40, crop_resize=8, nms_greedy=4),
            f'expected 40 pnet_flat, 8 crop_resize and 4 nms_greedy '
            f'launches, got {counts_b}')
    refs = [det.detect_batch(images[i:i + 16]) for i in range(0, 64, 16)]
    got = {k: np.concatenate([o[k] for o in outs])
           for k in ('valid', 'boxes', 'landmarks', 'scores')}
    want = {k: np.concatenate([o[k] for o in refs]) for k in got}
    v = want['valid']
    require(np.array_equal(got['valid'], v),
            "valid masks differ between 'flat' and 'pyramid'")
    d_box = float(np.abs(got['boxes'][v] - want['boxes'][v]).max())
    d_lmk = float(np.abs(got['landmarks'][v] - want['landmarks'][v]).max())
    d_score = float(np.abs(got['scores'][v] - want['scores'][v]).max())
    print(f"  'flat' vs 'pyramid' cascade: {int(v.sum())} valid faces in 64 "
          f'scenes, boxes {d_box:.3e} px, landmarks {d_lmk:.3e} px, scores '
          f'{d_score:.3e}')
    require(v.sum() >= 64 and d_box < 1.5 and d_lmk < 1.5 and d_score < 0.02,
            "'flat' cascade != 'pyramid' cascade")

    print('[16c] the B6 tool: python -m facenet_tpu_torch.tools.'
          'try_pallas_pnet --iters 3')
    reset_launches()
    try_pallas_pnet.main(['--iters', '3'])
    counts_c = read_launches()
    print(f'  kernel launches {counts_c}')
    require(counts_c['pnet_level'] > 0
            and counts_c == only(pnet_level=counts_c['pnet_level']),
            f'expected pnet_level launches alone, got {counts_c}')
    print('[16d] the B7 tool: python -m facenet_tpu_torch.tools.try_pnet_v3')
    reset_launches()
    try_pnet_v3.main([])
    counts_d = read_launches()
    print(f'  kernel launches {counts_d}')
    require(counts_d['pnet_trunk_nhwc'] > 0
            and counts_d == only(pnet_trunk_nhwc=counts_d['pnet_trunk_nhwc']),
            f'expected pnet_trunk_nhwc launches alone, got {counts_d}')

    # 17. times
    print(f'[17] times on {smi} (median of 3 windows; kernels and their '
          'yardsticks in device time, host enqueue per call beside)')
    copies = [(x128.clone(),) for _ in range(3)]   # 59 MB in, past the L2
    with torch.inference_mode():
        b5_ms, b5_all, b5_host = device_ms(
            rotating(lambda x: stem.stem_forward(params, x), copies), 20)
        b5_plain, b5_plain_all, _ = device_ms(
            rotating(lambda x: stem.stem_forward_plain(params, x), copies), 5)
        b5_lib, b5_lib_all, b5_lib_host = device_ms(
            rotating(lambda x: irv1_fast.stem_prefix(params, x), copies), 20)
        lib_err = float((irv1_fast.stem_prefix(params, x128).float()
                         - stem.stem_forward(params, x128).float())
                        .abs().max())
    del copies
    flops, nbytes = stem_work(128)
    b5_ops, b5_bytes = (flops / H100_BF16_FLOPS * 1e3,
                        nbytes / H100_HBM_BYTES * 1e3)
    b5_bound = max(b5_ops, b5_bytes)
    print(f'  stem_fused, 128 images: kernel {b5_ms:.4f} ms '
          f'({_spread(b5_all)}; host {b5_host:.4f}) = '
          f'{flops / b5_ms / 1e9:.1f} TFLOP/s, plain {b5_plain:.4f} ms '
          f'({_spread(b5_plain_all)}), cuDNN prefix {b5_lib:.4f} ms '
          f'({_spread(b5_lib_all)}; host {b5_lib_host:.4f}; max |cuDNN - '
          f'kernel| {lib_err:.3e}), bound {b5_bound:.4f} ms ({flops:.4e} '
          f'flop at the bf16 tensor-core rate, {nbytes:.4e} bytes; '
          f'{flops / H100_FP32_FLOPS * 1e3:.4f} ms at the FP32 rate)')
    print(stem_schedule_line(
        torch.cuda.get_device_properties(0).multi_processor_count))

    serving = {'cudnn': [], 'fused': []}
    busy = {'cudnn': [], 'fused': []}
    for name in ('cudnn', 'fused', 'fused', 'cudnn'):
        embedder = fused if name == 'fused' else cudnn
        ms, _ = cuda_ms(lambda: embedder(batches[0]), reps=20, warmup=5)
        serving[name].append(ms)
        busy[name].append(device_busy(lambda: embedder(batches[0]), 5)[0])
    print('  serving per batch of 128 (uint8 on the card; in turns cudnn, '
          'fused, fused, cudnn), host included: ' + '; '.join(
              f"stem='{name}' {_spread(times)} ms = "
              f'{128e3 / np.mean(times):.1f} embeddings/s'
              for name, times in serving.items())
          + '; device busy time alone (torch.profiler, the sum of the '
          "kernels' durations over 5 batches): " + '; '.join(
              f"stem='{name}' {_spread(times)} ms = "
              f'{128e3 / np.mean(times):.1f} embeddings/s'
              for name, times in busy.items()))

    level0 = levels[0]
    b, _, sh, sw = level0.shape
    planes0 = level0.view(b, 3, sh * sw)
    nhwc0 = level0.permute(0, 2, 3, 1).contiguous()
    rounded = pnet.packed_weights(det.pnet, level0.device)
    unrounded = pnet.pack_level_weights(det.pnet).to(level0.device)
    with torch.inference_mode():
        b4_ms, b4_all, b4_host = device_ms(
            lambda: pnet.pnet_forward_flat(det.pnet, planes0, sh, sw, sw), 20)
        b6_ms, b6_all, b6_host = device_ms(
            lambda: pnet.pnet_forward_level(unrounded, level0), 20)
        b7_ms, b7_all, b7_host = device_ms(
            lambda: try_pnet_v3.pnet_trunk_nhwc(nhwc0, rounded), 20)
        lv_plain, lv_plain_all, _ = device_ms(
            lambda: pnet.level_plain(rounded, level0), 5)
        b6_plain, _, _ = device_ms(
            lambda: pnet.level_plain(unrounded, level0), 5)
        raw_plain, raw_plain_all, _ = device_ms(
            lambda: pnet.level_plain(rounded, level0, raw=True), 5)
        lv_lib, lv_lib_all, lv_lib_host = device_ms(
            lambda: det.pnet.forward_nchw(level0), 10)
        b7_lib, b7_lib_all, _ = device_ms(lambda: det.pnet(nhwc0), 10)
    flops0, bytes0 = pnet_work([level0])
    flops_all, _ = pnet_work(levels)
    lv_ops, lv_bytes = (flops0 / H100_BF16_FLOPS * 1e3,
                        bytes0 / H100_HBM_BYTES * 1e3)
    lv_bound = max(lv_ops, lv_bytes)
    # float32 weights as three bf16 parts: three mma a multiply-add, exact
    b6_ops = 3 * flops0 / H100_BF16_FLOPS * 1e3
    b6_bound = max(b6_ops, lv_bytes)
    b6_fp32 = max(flops0 / H100_FP32_FLOPS * 1e3, lv_bytes)
    share = context['pyramid_ms'] * flops0 / flops_all
    print(f'  level 0 ({sh}x{sw}), batch {b}: pnet_flat {b4_ms:.4f} ms '
          f'({_spread(b4_all)}; host {b4_host:.4f}), pnet_level '
          f'{b6_ms:.4f} ms ({_spread(b6_all)}; host {b6_host:.4f}), '
          f'pnet_trunk_nhwc {b7_ms:.4f} ms ({_spread(b7_all)}; host '
          f'{b7_host:.4f}); plain {lv_plain:.4f} ms '
          f'({_spread(lv_plain_all)}), with float32 weights '
          f'{b6_plain:.4f} ms, raw heads {raw_plain:.4f} ms '
          f'({_spread(raw_plain_all)}); cuDNN P-Net {lv_lib:.4f} ms '
          f'({_spread(lv_lib_all)}; host {lv_lib_host:.4f}), from NHWC '
          f'pixels {b7_lib:.4f} ms ({_spread(b7_lib_all)}); the '
          f"whole-pyramid kernel's share for this level's operations "
          f'{share:.4f} ms ({flops0 / flops_all:.3f} of {flops_all:.4e} '
          f'flop); bound {lv_bound:.4f} ms ({flops0:.4e} flop at the bf16 '
          f'tensor-core rate, {bytes0:.4e} bytes); pnet_level (float32 '
          f'weights as three bf16 parts) bound {b6_bound:.4f} ms (3 x '
          f'{flops0:.4e} flop at the bf16 tensor-core rate; {b6_fp32:.4f} '
          f'ms at the FP32 rate)')

    scenes16 = torch.from_numpy(images[16:32]).cuda()
    cascades = {'flax': FaceDetector(image_shape=SCENE, device='cuda',
                                     pnet_impl='flax').backend_for(SCENE),
                'flat': flat, 'pyramid': det}
    cascade_ms = {}
    for name in ('flax', 'flat', 'pyramid', 'pyramid', 'flat', 'flax'):
        ms, _ = cuda_ms(lambda: cascades[name]._detect(scenes16), 5, 2)
        cascade_ms.setdefault(name, []).append(ms)
    cascade_busy = {name: device_busy(
        lambda: cascades[name]._detect(scenes16), 3)[0] for name in cascades}
    print('  cascade alone per batch of 16 scenes, host included (in turns '
          'flax, flat, pyramid, pyramid, flat, flax): ' + '; '.join(
              f"'{name}' {_spread(times)} ms"
              for name, times in cascade_ms.items())
          + '; device busy time alone (torch.profiler, the sum of the '
          "kernels' durations over 3 batches): " + '; '.join(
              f"'{name}' {ms:.3f} ms" for name, ms in cascade_busy.items()))

    source = 'facenet_tpu_torch/csrc/pnet_level.cu'
    jax_pnet = 'facenet_tpu/detectors/mtcnn/pallas_pnet.py'
    return [{
        'name': 'stem_fused',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/stem_fused.cu',
        'replaces': 'facenet_tpu/ops/pallas_stem.py:115',
        'launches': counts_a['stem_fused'],
        'max_abs_err': max(stem_errs),
        'ms': b5_ms,
        'plain_ms': b5_plain,
        'bound_ms': b5_bound,
        'bound_by': 'operations' if b5_ops >= b5_bytes else 'bytes',
        'library_ms': b5_lib,
    }, {
        'name': 'pnet_flat',
        'route': 'cuda',
        'source': source,
        'replaces': f'{jax_pnet}:421',
        'launches': counts_b['pnet_flat'],
        'max_abs_err': level_errs['pnet_flat'],
        'ms': b4_ms,
        'plain_ms': lv_plain,
        'bound_ms': lv_bound,
        'bound_by': 'operations' if lv_ops >= lv_bytes else 'bytes',
        'library_ms': lv_lib,
    }, {
        'name': 'pnet_level',
        'route': 'cuda',
        'source': source,
        'replaces': f'{jax_pnet}:163',
        'launches': counts_c['pnet_level'],
        'max_abs_err': level_errs['pnet_level'],
        'ms': b6_ms,
        'plain_ms': b6_plain,
        'bound_ms': b6_bound,
        'bound_by': 'operations' if b6_ops >= lv_bytes else 'bytes',
        'library_ms': lv_lib,
    }, {
        'name': 'pnet_trunk_nhwc',
        'route': 'cuda',
        'source': source,
        'replaces': 'tools/try_pnet_v3.py:115',
        'launches': counts_d['pnet_trunk_nhwc'],
        'max_abs_err': level_errs['pnet_trunk_nhwc'],
        'ms': b7_ms,
        'plain_ms': raw_plain,
        'bound_ms': lv_bound,
        'bound_by': 'operations' if lv_ops >= lv_bytes else 'bytes',
        'library_ms': b7_lib,
    }]


def lfw_pixels(path):
    """The pixels of LFW-shaped placeholder `<name>/<name>_%04d.png`, made
    from the name: a seeded base image an identity (20 x 20 blocks of 8 px)
    plus seeded noise an image (40 x 40 blocks of 4 px); no file is read."""
    ident, index = (int(v) for v in
                    re.match(r'person_(\d+)_(\d+)$', Path(path).stem).groups())
    base = np.random.default_rng(ident).integers(
        0, 256, (20, 20, 3), dtype=np.uint8).repeat(8, 0).repeat(8, 1)
    noise = np.random.default_rng((ident, index)).integers(
        -24, 25, (40, 40, 3), dtype=np.int16).repeat(4, 0).repeat(4, 1)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def slice7_phases(rng, context):
    """Phases 18-21 (see the module docstring): extraction, the embeddings
    app's pipeline mode, validate-on-LFW at protocol scale and the port's
    bench, each with every launch count reset just before and read just
    after."""
    import contextlib
    import io
    import tempfile

    import torch

    from facenet_tpu_torch import bench, lfw
    from facenet_tpu_torch.apps.embeddings import (kept_rows, save_npz,
                                                   save_tfrecord)
    from facenet_tpu_torch.apps.validate_on_lfw import embed
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.dataset import BatchLoader
    from facenet_tpu_torch.facenet import evaluate_embeddings, renormalized
    from facenet_tpu_torch.models.inception_resnet_v1 import \
        InceptionResnetV1
    from facenet_tpu_torch.pipeline import FacePipeline
    from facenet_tpu_torch.utils.synthetic import lfw_shape_counts
    from facenet_tpu_torch.utils.tfrecord import TFRecord

    facenet, smi = context['facenet'], context['smi']

    # 18. extraction on the card
    print('[18] extraction: BatchLoader (array loader, shuffle=False) -> '
          'evaluate_embeddings, 64 classes x 16 images, batch 128 (cuda)')
    table = {}
    for images, labels in synthetic_batches(rng, 64, 16, 128):
        for image, label in zip(images, labels):
            table[f'id_{label:02d}/{len(table) % 16:04d}'] = image
    files = list(table)
    n = len(files)
    classes = np.repeat(np.arange(64), 16)

    def batches():
        return BatchLoader(files, np.arange(n), table.__getitem__, 128,
                           shuffle=False)

    evaluate_embeddings(facenet.dispatch, batches())        # warm
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb, order = evaluate_embeddings(facenet.dispatch, batches())
    wall = time.perf_counter() - t0
    counts = read_launches()
    t0 = time.perf_counter()
    for _ in batches():
        pass
    loader_s = time.perf_counter() - t0
    require(counts == only(), f'expected no kernel launches, got {counts}')
    require(np.array_equal(order, np.arange(n)), 'rows out of order')
    norms = np.linalg.norm(emb, axis=1)
    require(emb.shape == (n, 512) and np.isfinite(emb).all()
            and np.abs(norms - 1).max() < 1e-5,
            'extracted embeddings are not finite and unit-norm')
    ref = np.concatenate([facenet.evaluate(np.stack(
        [table[f] for f in files[s:s + 128]])) for s in range(0, n, 128)])
    cos = (emb * ref).sum(1) / np.linalg.norm(ref, axis=1)
    require(cos.min() >= 0.99999, f'extraction != FaceNet.evaluate: min '
            f'cosine {cos.min()}')
    with tempfile.TemporaryDirectory() as tmp:
        save_npz(Path(tmp) / 'e.npz', emb, classes, files)
        data = np.load(Path(tmp) / 'e.npz')
        save_tfrecord(Path(tmp) / 'e.tfrecord', emb, classes, files)
        record = TFRecord(Path(tmp) / 'e.tfrecord')
    require(np.array_equal(data['embeddings'], emb)
            and np.array_equal(data['labels'], classes)
            and list(data['files']) == files, 'npz round trip differs')
    require(np.array_equal(record.embeddings, emb)
            and np.array_equal(record.labels, classes)
            and record.files == files, 'TFRecord round trip differs')
    print(f'  {n} embeddings in order, unit norms, min cosine {cos.min():.7f} '
          f'against FaceNet.evaluate; npz and TFRecord round trips exact; '
          f'kernel launches {counts}')
    print(f'  {wall:.3f} s = {n / wall:.1f} embeddings/s as issued; the '
          f'loader alone {loader_s:.3f} s ({loader_s / wall:.3f} of it)')
    context.update(extract_rate=n / wall, extract_loader_rate=n / loader_s)

    # 19. pipeline mode on the card
    print('[19] the embeddings app\'s pipeline mode: FacePipeline '
          f'(align crop | landmarks, 1 face a scene, {SCENE}) -> kept_rows, '
          'phase 10\'s 64 scenes in batches of 16 (cuda)')
    images = context['images']
    labels = np.repeat(np.arange(16), 4)
    names = [f'scene_{i:02d}' for i in range(64)]
    kept = {}
    for align, warps in (('crop', 0), ('landmarks', 4)):
        pipe = FacePipeline(facenet, image_shape=SCENE, align=align)
        pipe.process_batch(images[:16])                     # warm
        reset_launches()
        t0 = time.perf_counter()
        outs = [pipe.process_batch(images[i:i + 16])
                for i in range(0, 64, 16)]
        wall = time.perf_counter() - t0
        counts = read_launches()
        require(counts == only(pnet_pyramid=4, dense_warp=warps,
                               crop_resize=12, nms_greedy=4),
                f'{align}: expected 4 pnet_pyramid, {warps} dense_warp, '
                f'12 crop_resize and 4 nms_greedy launches, got {counts}')
        rows, row_labels, row_files, dropped = kept_rows(
            np.concatenate([o['embeddings'] for o in outs]),
            np.concatenate([o['valid'] for o in outs]), labels, names)
        norms = np.linalg.norm(rows, axis=1)
        require(len(rows) > 0 and np.isfinite(rows).all()
                and np.abs(norms - 1).max() < 1e-5,
                f'{align}: kept embeddings are not finite and unit-norm')
        kept[align] = (row_files, list(row_labels), dropped)
        print(f'  {align}: {len(rows)} scenes kept, {dropped} dropped, '
              f'kernel launches {counts}; {wall:.3f} s = {64 / wall:.1f} '
              'scenes/s')
    require(kept['crop'] == kept['landmarks'],
            'the two align modes kept different scenes')

    # 20. validate-on-LFW at protocol scale
    print('[20] validate-on-LFW at protocol scale: LFW-shaped placeholder '
          'tree -> generate_pairs(10 x 300) -> get_paths -> embed(flip, '
          'batch 256) -> LfwValidation(metric 0, subtract_mean) (cuda)')
    counts_lfw = lfw_shape_counts()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / 'lfw'
        t0 = time.perf_counter()
        for label, count in enumerate(counts_lfw):
            name = f'person_{label:05d}'
            (root / name).mkdir(parents=True)
            for i in range(1, count + 1):
                (root / name / f'{name}_{i:04d}.png').touch()
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pairs = lfw.generate_pairs(root, nrof_folds=10, nrof_pairs=300, seed=0)
        paths, issame, skipped = lfw.get_paths(root, pairs)
        pairs_s = time.perf_counter() - t0
    require(len(pairs) == 6000 and len(paths) == 12000 and skipped == 0,
            f'{len(pairs)} pairs, {len(paths)} paths, {skipped} skipped')
    t0 = time.perf_counter()
    pixels = {p: lfw_pixels(p) for p in dict.fromkeys(paths)}
    make_s = time.perf_counter() - t0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = embed(paths, facenet, pixels.__getitem__, 256, flip=True)
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = lfw.LfwValidation(emb, issame, Config({
        'metric': 0, 'nrof_folds': 10, 'far_target': 1e-3,
        'subtract_mean': True}))
    report_s = time.perf_counter() - t0
    counts = read_launches()
    require(counts == only(), f'expected no kernel launches, got {counts}')
    require(emb.shape == (12000, 1024) and np.isfinite(emb).all(),
            f'bad LFW embeddings {emb.shape}')
    values = report.dict
    require(all(np.isfinite(float(v)) for v in values.values()),
            f'non-finite report values {values}')
    head = np.stack([pixels[p] for p in paths[:256]])
    flipped = renormalized(facenet.evaluate(
        np.ascontiguousarray(head[:, :, ::-1])))
    cos_flip = (emb[:256, 512:] * flipped).sum(1)
    require(cos_flip.min() >= 0.99999,
            f'flip half != FaceNet on flipped arrays: {cos_flip.min()}')
    t0 = time.perf_counter()
    unfused = InceptionResnetV1().from_flax_variables(context['variables'])
    with torch.inference_mode():
        ref = unfused.eval()(torch.from_numpy(head[:64])).numpy()
    cpu_s = time.perf_counter() - t0
    cos_ref = (emb[:64, :512] * ref).sum(1) / np.linalg.norm(ref, axis=1)
    require(cos_ref.min() >= 0.995,
            f'min cosine {cos_ref.min()} < 0.995 against float32 on the CPU')
    print(f'  {len(issame)} pairs ({int(issame.sum())} same) over '
          f'{counts_lfw.size} identities / {int(counts_lfw.sum())} images, '
          f'{len(pixels)} distinct images; embeddings {emb.shape}; kernel '
          f'launches {counts}')
    print('  report: ' + ', '.join(
        f'{k} {v:.5f}' if isinstance(v, float) else f'{k} {v}'
        for k, v in values.items()))
    print(f'  flip half vs FaceNet on the flipped arrays: min cosine '
          f'{cos_flip.min():.7f}; 64 rows vs the unfused float32 module on '
          f'the CPU: min cosine {cos_ref.min():.6f} ({cpu_s:.1f} s)')
    print(f'  wall: placeholder tree {tree_s:.3f} s, generate_pairs + '
          f'get_paths {pairs_s:.3f} s, image making '
          f'{make_s:.3f} s, forwards {forward_s:.3f} s (24,000 = '
          f'{24000 / forward_s:.1f} embeddings/s, loader and host '
          f'normalization included), report {report_s:.3f} s')

    # 21. the port's bench
    print(f'[21] the port\'s bench: python -m facenet_tpu_torch.bench '
          f'(32 chunks x 128 back to back, int8 then bf16) on {smi}')
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main([])
    counts = read_launches()
    lines = out.getvalue().strip().splitlines()
    busy = [json.loads(line) for line in lines if '"serving"' in line
            and '"chunk"' in line]
    last = json.loads(lines[-1])
    require(counts == only(), f'expected no kernel launches, got {counts}')
    require([b['serving'] for b in busy] == ['int8', 'bf16'],
            f'expected the int8 and bf16 busy lines, got {busy}')
    require(last.get('metric') == bench.METRIC and last['value'] > 0
            and last.get('serving') in ('int8', 'bf16')
            and last['value'] == max(last['int8_img_per_s'],
                                     last['bf16_img_per_s'])
            and 'error' not in last, f'bad bench line {last}')
    for b in busy:
        print(f'  {json.dumps(b)}')
    print(f'  {lines[-1]}')


def record_int8_convs(fn):
    """The int8 convs one call of fn() runs, in order: [(C, H, W, (oc, ic,
    kh, kw), stride, padding)], through a wrapper on
    `ops.int8_conv.int8_conv` that is removed again."""
    from facenet_tpu_torch.ops import int8_conv

    seen = []
    conv = int8_conv.int8_conv

    def recording(x, w, stride=1, padding='SAME'):
        seen.append((*x.shape[1:], w['shape'], stride, padding))
        return conv(x, w, stride, padding)

    int8_conv.int8_conv = recording
    try:
        fn()
    finally:
        int8_conv.int8_conv = conv
    return seen


def int8_conv_work(key):
    """(input elements, output elements, multiply-adds) of one image
    through the int8 conv `key`."""
    c, h, w, (oc, ic, kh, kw), stride, padding = key
    oh = h if padding == 'SAME' else (h - kh) // stride + 1
    ow = w if padding == 'SAME' else (w - kw) // stride + 1
    return c * h * w, oh * ow * oc, oh * ow * oc * ic * kh * kw


def int8_gemm_times(rng, key, batch, smi):
    """Device ms of one int8 conv's parts at `batch` (quantize, im2col,
    GEMM, rescale) beside cuDNN's bf16 conv of the same shape; returns the
    line to print."""
    import torch
    import torch.nn.functional as F

    from facenet_tpu_torch.ops import int8_conv
    from facenet_tpu_torch.utils.timing import device_ms

    c, h, w, (oc, ic, kh, kw), stride, padding = key
    k = rng.integers(-127, 128, (oc, ic, kh, kw)).astype(np.int8)
    entry = int8_conv.quantized_entry(k, np.full(oc, 1e-3), 0.05,
                                      np.zeros(oc), 'cuda')
    x = torch.randn(batch, c, h, w, device='cuda').to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    kb = torch.from_numpy(k).cuda().to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bias = torch.zeros(oc, device='cuda', dtype=torch.bfloat16)
    xq = int8_conv.quantize(x, entry['xs'])
    rows, _ = int8_conv.patch_rows(xq, entry['shape'], stride, padding)
    rows = F.pad(rows, (0, entry['kq'].shape[1] - rows.shape[1])).contiguous()
    sums = int8_conv.int8_sums(xq, entry, stride, padding)
    pad = 'same' if padding == 'SAME' else 0
    with torch.inference_mode():
        parts = {
            'quantize': lambda: int8_conv.quantize(x, entry['xs']),
            'im2col': lambda: int8_conv.patch_rows(
                xq, entry['shape'], stride, padding)[0].contiguous(),
            'GEMM': lambda: torch._int_mm(rows, entry['kq'].t()),
            'rescale': lambda: torch.mul(sums, entry['wxs']).add_(
                entry['b']).to(torch.bfloat16),
            'whole int8 conv': lambda: int8_conv.int8_conv(
                x, entry, stride, padding),
            'cuDNN bf16 conv': lambda: F.conv2d(x, kb, bias, stride, pad)}
        times = {name: device_ms(fn, 20)[0] for name, fn in parts.items()}
    m, kk = rows.shape
    ops = 2.0 * m * oc * ic * kh * kw
    return (f'  {kh}x{kw}/{stride} {padding} {ic}->{oc} on {c}x{h}x{w}, '
            f'batch {batch} (M={m}, K={kk}, N={entry["kq"].shape[0]}; '
            f'{ops:.4e} int8 operations, {ops / H100_INT8_OPS * 1e3:.4f} ms '
            f'at the int8 tensor-core rate): ' + ', '.join(
                f'{name} {ms:.4f} ms' for name, ms in times.items())
            + f' on {smi}')


def serving_times(nets, batch):
    """{name: (host-issued ms, device busy ms)} per call of each net on
    `batch`, measured in turns (the names, then reversed)."""
    from facenet_tpu_torch.utils.timing import cuda_ms, device_busy

    issued, busy = {}, {}
    for name in (*nets, *reversed(nets)):
        net = nets[name]
        issued.setdefault(name, []).append(
            cuda_ms(lambda: net.dispatch(batch), reps=20, warmup=5)[0])
        busy.setdefault(name, []).append(
            device_busy(lambda: net.dispatch(batch), 5)[0])
    return issued, busy


def slice8_phases(rng, context):
    """Phases 22-24 (see the module docstring): the int8 GEMM against its
    plain version, IRv1 int8 serving under both stems, IRv2 in bf16 and
    int8; launch counts reset just before each main path and read just
    after."""
    import torch

    from facenet_tpu_torch import FaceNet
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.export import ModelBundle
    from facenet_tpu_torch.models import inception_resnet_v2 as irv2
    from facenet_tpu_torch.ops import int8_conv
    from facenet_tpu_torch.utils.timing import spread as _spread

    smi, bundle1 = context['smi'], context['bundle']
    batches = [torch.from_numpy(rng.integers(
        0, 256, (128, 160, 160, 3), dtype=np.uint8)).cuda() for _ in range(4)]
    calib = batches[0][:32].cpu().numpy()
    variables2 = irv2.init_variables(seed=0)
    bundle2 = ModelBundle(variables2, {'model_class': 'InceptionResnetV2',
                                       'config': None, 'image_size': 160,
                                       'normalization': 0})

    def net(bundle, **options):
        return FaceNet(Config({'normalize': True, **options}), device='cuda',
                       bundle=bundle)

    int8 = {'quantize': 'int8', 'calib': calib}
    nets1 = {'bf16 cudnn': context['facenet'],
             'int8 cudnn': net(bundle1, **int8),
             'bf16 fused': net(bundle1, stem='fused'),
             'int8 fused': net(bundle1, stem='fused', **int8)}
    nets2 = {'bf16': net(bundle2), 'int8': net(bundle2, **int8)}

    # 22. the int8 GEMM against its plain version on every int8 conv shape
    print('[22] int8 GEMM (im2col + torch._int_mm) vs its plain version '
          '(F.conv2d in float64) on every int8 conv shape of full-width '
          'IRv1 (stem cudnn, every conv quantized) and IRv2, batch 8, '
          'random int8 inputs and weights (cuda)')
    keys = set()
    with torch.inference_mode():
        for family, n in (('IRv1', nets1['int8 cudnn']),
                          ('IRv2', nets2['int8'])):
            convs = record_int8_convs(lambda: n.dispatch(batches[0][:8]))
            keys.update(convs)
            work = np.array([int8_conv_work(k) for k in convs], np.float64)
            print(f'  {family}: {len(convs)} int8 convs a forward; an image '
                  f'{work[:, 0].sum():.4e} input and {work[:, 1].sum():.4e} '
                  f'output elements, {work[:, 2].sum():.4e} multiply-adds')
    worst = 0
    for key in sorted(keys, key=str):
        c, h, w, shape, stride, padding = key
        oc, ic, kh, kw = shape
        k = rng.integers(-127, 128, shape).astype(np.int8)
        entry = int8_conv.quantized_entry(k, np.ones(oc), 1.0, np.zeros(oc),
                                          'cuda')
        xq = torch.from_numpy(rng.integers(-127, 128, (8, h, w, c))
                              .astype(np.int8)).cuda()
        got = int8_conv.int8_sums(xq, entry, stride, padding)
        torch.cuda.synchronize()
        want = int8_conv.int8_sums_plain(xq, entry, stride, padding)
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        require(got.dtype == torch.int32 and got.shape == want.shape
                and err == 0, f'int8 GEMM != plain on {key}: max |d| {err}')
    print(f'  {len(keys)} distinct shapes, max |GEMM - plain| {worst} '
          '(int32 sums)')

    for key in sorted(keys, key=lambda k: int8_conv_work(k)[2],
                      reverse=True)[:3]:
        print(int8_gemm_times(rng, key, 128, smi))

    # 23. IRv1 int8 serving through FaceNet under both stems
    print("[23] full-width IRv1 int8 serving through FaceNet(quantize="
          "'int8', calibrated on 32 images) under stem='cudnn' and 'fused', "
          '4 batches of 128 (cuda)')
    with torch.inference_mode():
        for stem, launches in (('cudnn', 0), ('fused', 4)):
            q8, bf = nets1[f'int8 {stem}'], nets1[f'bf16 {stem}']
            reset_launches()
            emb = torch.cat([q8.dispatch(b) for b in batches])
            torch.cuda.synchronize()
            counts = read_launches()
            require(counts == only(stem_fused=launches),
                    f"int8 stem='{stem}': expected {launches} stem_fused "
                    f'launches alone, got {counts}')
            ref = torch.cat([bf.dispatch(b) for b in batches])
            norms = emb.norm(dim=1)
            require(tuple(emb.shape) == (512, 512)
                    and bool(emb.isfinite().all())
                    and float((norms - 1).abs().max()) < 1e-5,
                    f"int8 stem='{stem}': embeddings not finite and unit-norm")
            cos = float((emb * ref).sum(dim=1).min())
            print(f"  stem='{stem}': kernel launches {counts}; finite "
                  f'unit-norm rows; min cosine int8 vs bf16 {cos:.6f}')
    issued, busy = serving_times(nets1, batches[0])
    print(f'  per batch of 128 on {smi} (in turns), as the host issues it: '
          + '; '.join(f'{name} {_spread(t)} ms' for name, t in issued.items())
          + "; device busy (torch.profiler, the sum of the kernels' "
          'durations over 5 batches): '
          + '; '.join(f'{name} {_spread(t)} ms' for name, t in busy.items()))
    device_breakdown(lambda: nets1['int8 cudnn'].dispatch(batches[0]), 10)

    # 24. IRv2 through FaceNet in bf16 and int8
    print('[24] full-width IRv2 (default config, 512-d, init_variables('
          'seed=0)) through FaceNet in bf16 and int8, batch 128 (cuda)')
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        unfused = irv2.InceptionResnetV2().from_flax_variables(variables2)
        unfused = unfused.cuda().eval()
        with torch.inference_mode():
            ref = unfused(batches[1]).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul_precision)
    del unfused
    reset_launches()
    served = {name: n.evaluate(batches[1]) for name, n in nets2.items()}
    counts = read_launches()
    require(counts == only(), f'IRv2: expected no kernel launches, got '
            f'{counts}')
    for name, emb in served.items():
        norms = np.linalg.norm(emb, axis=1)
        require(emb.shape == (128, 512) and np.isfinite(emb).all()
                and np.abs(norms - 1).max() < 1e-5,
                f'IRv2 {name}: embeddings not finite and unit-norm')
    cos_ref = (served['bf16'] * ref).sum(1) / np.linalg.norm(ref, axis=1)
    cos8 = (served['int8'] * served['bf16']).sum(1)
    print(f'  bf16 fused vs float32 unfused: min cosine {cos_ref.min():.6f}; '
          f'int8 vs bf16: min cosine {cos8.min():.6f}; kernel launches '
          f'{counts}')
    require(cos_ref.min() >= 0.995,
            f'IRv2 min cosine {cos_ref.min()} < 0.995 against float32')
    issued, busy = serving_times(nets2, batches[0])
    print(f'  per batch of 128 on {smi} (in turns), as the host issues it: '
          + '; '.join(f'{name} {_spread(t)} ms' for name, t in issued.items())
          + '; device busy: '
          + '; '.join(f'{name} {_spread(t)} ms' for name, t in busy.items()))


VGGFACE2_CLASSES = 8631     # train identities of VGGFace2, train_softmax.yaml's data


def train_config(steps=20, **loss):
    """apps/configs/train_softmax.yaml's defaults (built here: the card
    machine may lack yaml), `steps` steps an epoch, `loss` over the
    defaults."""
    from facenet_tpu_torch.config import Config
    return Config({
        'image': {'size': 160, 'normalization': 0, 'random_crop': False,
                  'random_flip': False},
        'train': {'adam_epsilon': 0.1, 'remat': False, 'prefetch': 2,
                  'epoch': {'size': steps},
                  'learning_rate': {'schedule': [[100, 0.05], [200, 0.005],
                                                 [300, 0.0005]]}},
        'loss': {'softmax_factor': 1.0, 'center_alfa': 0.95,
                 'center_factor': 0.0, 'triplet_margin': 0.2,
                 'triplet_factor': 0.0, **loss},
    })


def slice9_phases(rng, context):
    """Phases 25-30 (see the module docstring): full-width IRv1 training
    with the 8,631-way head on the card; every launch count reset just
    before each path and read just after."""
    import tempfile
    import types

    import torch

    from facenet_tpu_torch import FaceNet, callbacks, export
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.dataset import BatchLoader, PKPipeline
    from facenet_tpu_torch.models.inception_resnet_v1 import (BatchNorm,
                                                              init_variables)
    from facenet_tpu_torch.train.checkpoint import CheckpointManager
    from facenet_tpu_torch.train.softmax import (SoftmaxTrainer, flat_leaves,
                                                 step_on_devices)
    from facenet_tpu_torch.utils.timing import cuda_ms, device_busy
    from facenet_tpu_torch.utils.timing import spread as _spread

    smi = context['smi']
    started = time.monotonic()
    # 400 images: 50 identities x 8 (a base image each plus noise), drawn
    # among the head's 8,631 classes, shuffled into 4 batches of 100
    pool = next(synthetic_batches(rng, 50, 8, 400))
    ids = rng.choice(VGGFACE2_CLASSES, 50, replace=False).astype(np.int32)
    order = rng.permutation(400)
    images_np, labels_np = pool[0][order], ids[pool[1][order]]
    held_out = list(synthetic_batches(rng, 40, 26, 100))

    # 25. softmax steps at batch 100
    print(f'[25] full-width IRv1 (default config, 512-d) + {VGGFACE2_CLASSES}'
          '-way head, train_softmax.yaml defaults (Adam eps 0.1, lr 0.05), '
          'bf16 compute / float32 weights, 20 softmax steps at batch 100 '
          'over 4 cycled uint8 batches (cuda)')
    t0 = time.monotonic()
    trainer = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES, device='cuda')
    state = trainer.init_state(seed=0)
    backbone0 = init_variables(seed=0)['params']['Conv2d_1a_3x3']['conv']
    require(np.array_equal(state.model.backbone.to_flax_variables()['params']
                           ['Conv2d_1a_3x3']['conv']['kernel'],
                           backbone0['kernel']),
            'the trainer does not start from init_variables(seed=0)')
    cards = [trainer.placed(images_np[i:i + 100], labels_np[i:i + 100])
             for i in range(0, 400, 100)]
    print(f'  state made in {time.monotonic() - t0:.1f} s on {smi}: '
          f'{sum(p.numel() for p in state.model.parameters()):,} parameters')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    losses, entropies = [], []
    for i in range(20):
        state, metrics = trainer.step_fn(state, *cards[i % 4])
        losses.append(metrics['loss'])
        entropies.append(metrics['cross_entropy'])
    losses = [float(v) for v in losses]
    entropies = [float(v) for v in entropies]
    run_s = time.monotonic() - t0
    counts = read_launches()
    require(counts == only(), f'training launched kernels: {counts}')
    first, last = np.mean(entropies[:5]), np.mean(entropies[-5:])
    print(f'  losses {" ".join(f"{v:.3f}" for v in losses)}')
    print(f'  cross-entropies {" ".join(f"{v:.3f}" for v in entropies)}')
    print(f'  cross-entropy: mean of the first 5 {first:.4f}, of the last 5 '
          f'{last:.4f}; 20 steps in {run_s:.2f} s wall on {smi} (first '
          f'steps included); kernel launches {counts}')
    require(np.isfinite(losses).all() and last < first,
            f'loss not finite or cross-entropy not falling: {first} -> '
            f'{last}')
    peak = torch.cuda.max_memory_allocated()

    def step():
        trainer.step_fn(state, *cards[0])

    ms, windows = cuda_ms(step, reps=5, warmup=1)
    busy, wall, _ = device_busy(step, 3)
    print(f'  on {smi}: {ms:.3f} ms per step as the host issues it '
          f'(windows {_spread(windows)}) = {100e3 / ms:.1f} img/s; device '
          f'busy {busy:.3f} ms per step (torch.profiler, 3 steps, '
          f'{busy / wall:.3f} of {wall:.3f} ms wall) = '
          f'{100e3 / busy:.1f} img/s at the device busy time; '
          f'max_memory_allocated {peak / 2 ** 30:.2f} GiB')
    device_breakdown(step, 10)

    # 26. center and triplet steps
    print('[26] one step with center_factor 0.01, one triplet-only step '
          '(softmax_factor 0, triplet_factor 1) on a PKPipeline 20 x 5 '
          'batch (cuda)')
    center = SoftmaxTrainer(train_config(center_factor=0.01),
                            VGGFACE2_CLASSES, device='cuda')
    c_state = center.init_state(seed=0)
    c_state, metrics = center.step_fn(c_state, *cards[0])
    moved_rows = int((c_state.centers.abs().sum(dim=1) > 0).sum())
    want_rows = len(np.unique(labels_np[:100]))
    print(f'  center step: loss {float(metrics["loss"]):.4f}, center_loss '
          f'{float(metrics["center_loss"]):.4f}, {moved_rows} center rows '
          f'moved ({want_rows} identities in the batch)')
    require(np.isfinite(float(metrics['loss'])) and moved_rows == want_rows,
            'center step: loss not finite or the table did not move')
    del center, c_state
    # noise images, 20 identities x 8: no identity is closer to itself
    # than to the others, so semi-hard triplets exist from the start
    noise = rng.integers(0, 256, (160, 160, 160, 3)).astype(np.uint8)
    classes = [types.SimpleNamespace(files=[str(i) for i in
                                            range(8 * c, 8 * c + 8)],
                                     nrof_images=8) for c in range(20)]
    pk = PKPipeline(lambda f: noise[int(f)], classes,
                    Config({'nrof_classes_per_batch': 20,
                            'nrof_examples_per_class': 5}), seed=0)
    pk_images, pk_labels = next(pk)
    triplet = SoftmaxTrainer(train_config(softmax_factor=0.0,
                                          triplet_factor=1.0),
                             VGGFACE2_CLASSES, device='cuda')
    t_state = triplet.init_state(seed=0)
    norms = [m for m in t_state.model.backbone.modules()
             if isinstance(m, BatchNorm)]
    biases = [m.bias.detach().clone() for m in norms]
    head_bias = t_state.model.logits.bias.detach().clone()
    t_state, metrics = triplet.step_fn(
        t_state, *triplet.placed(pk_images, ids[pk_labels]))
    moved = sum(not torch.equal(m.bias, b) for m, b in zip(norms, biases))
    head_kept = torch.equal(t_state.model.logits.bias, head_bias)
    print(f'  triplet step on {pk_images.shape[0]} noise images of '
          f'{len(np.unique(pk_labels))} identities: triplet_loss '
          f'{float(metrics["triplet_loss"]):.4f}, loss '
          f'{float(metrics["loss"]):.4f}; {moved} of {len(norms)} BatchNorm '
          f'biases moved (their gradient comes from the triplet term '
          f'alone), the head\'s bias {"kept" if head_kept else "moved"}')
    require(float(metrics['triplet_loss']) > 0 and moved == len(norms)
            and head_kept, 'triplet step: loss 0 or no gradient through it')
    del triplet, t_state

    # 27. the card against the CPU, float32 and float64
    print('[27] one step, full width, batch 8, from the same state on the '
          'card and on the CPU (TF32 off), in float32 and in float64')
    bounds = {torch.float32: (1e-4, 1e-6, 0.5),
              torch.float64: (1e-5, 1e-12, 1e-5)}
    for dtype, (rtol, atol, bound) in bounds.items():
        t0 = time.monotonic()
        (card, cpu), worst, moved = step_on_devices(
            train_config(1), VGGFACE2_CLASSES, images_np[:8], labels_np[:8],
            dtype=dtype, atol=atol)
        print(f'  {dtype}: losses card {card} cpu {cpu}')
        print(f'  {dtype}: worst leaf |card - cpu| - {atol:g} = {worst:.3e} '
              f'of that leaf\'s largest update (largest update '
              f'{moved:.3e}); {time.monotonic() - t0:.1f} s on {smi} and '
              f'the host')
        for key, value in cpu.items():
            require(abs(card[key] - value) <= rtol * abs(value) + atol,
                    f'{dtype}: card {key} != cpu')
        require(worst <= bound,
                f'{dtype}: card update != cpu update ({worst} > {bound})')

    # 28. checkpoint and resume
    print('[28] checkpoint after 2 steps (shuffled BatchLoader over the 400 '
          'images), restore into a fresh trainer, the next step on both '
          '(cudnn.deterministic)')
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    files = [str(i) for i in range(400)]

    def loader(**kw):
        return BatchLoader(files, labels_np, lambda f: images_np[int(f)],
                           100, shuffle=True, repeat=True,
                           drop_remainder=True, num_workers=4, seed=3, **kw)

    try:
        with tempfile.TemporaryDirectory() as tmp:
            first = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES,
                                   device='cuda')
            r_state = first.init_state(seed=0)
            pipeline = loader()
            stream = iter(pipeline)
            for _ in range(2):
                r_state, _ = first.step_fn(r_state,
                                           *first.placed(*next(stream)))
            mgr = CheckpointManager(Path(tmp) / 'checkpoints')
            t0 = time.monotonic()
            mgr.save(r_state.step, r_state, data_state=pipeline.state())
            save_s = time.monotonic() - t0
            nxt = next(stream)
            r_state, m_want = first.step_fn(r_state, *first.placed(*nxt))
            want = list(flat_leaves(r_state.model.to_flax_variables()))
            want_loss = float(m_want['loss'])
            del first, r_state

            second = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES,
                                    device='cuda')
            fresh = second.init_state(seed=1)
            t0 = time.monotonic()
            fresh, cursor = mgr.restore(fresh, with_data_state=True)
            load_s = time.monotonic() - t0
            resumed = next(iter(loader(start_state=cursor)))
            require(np.array_equal(resumed[0], nxt[0])
                    and np.array_equal(resumed[1], nxt[1]),
                    'the restored cursor yields another batch')
            fresh, m_got = second.step_fn(fresh, *second.placed(*resumed))
            got = list(flat_leaves(fresh.model.to_flax_variables()))
            diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
            got_loss = float(m_got['loss'])
            print(f'  cursor {cursor}; save {save_s:.2f} s, restore '
                  f'{load_s:.2f} s on {smi}; next step loss resumed '
                  f'{got_loss:.6f} uninterrupted {want_loss:.6f}; max '
                  f'|param diff| {diff:.3e} over {len(got)} leaves; step '
                  f'{fresh.step}')
            require(fresh.step == 3 and abs(got_loss - want_loss)
                    <= 1e-6 * abs(want_loss) and diff <= 1e-6,
                    f'resumed step != uninterrupted step ({diff})')
            del second, fresh
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = deterministic

    # 29. validation through B1
    print('[29] ValidateCallback at an epoch end: the trained state of phase '
          '25 on 1,040 held-out images (40 identities x 26), 10 folds, '
          'metric 0, FAR 1e-3 (cuda)')
    callback = callbacks.ValidateCallback(
        forward_factory=trainer.embedding_forward,
        batches_factory=lambda: iter(held_out), every_n_epochs=1,
        max_nrof_epochs=1,
        config=Config({'validate': {'metric': 0, 'nrof_folds': 10,
                                    'far_target': 1e-3}}), device='cuda')
    reset_launches()
    t0 = time.monotonic()
    validation = callback.on_epoch_end(0, state)
    valid_s = time.monotonic() - t0
    counts = read_launches()
    print(f'  {valid_s:.2f} s on {smi}; kernel launches {counts}')
    require(counts == only(pair_below_counts=30),
            f'expected 30 pair_below_counts launches alone, got {counts}')
    for crit, values in validation.dict.items():
        require(all(np.isfinite(v) for v in values.values()),
                f'non-finite report values in {crit}')
        print(f'  {crit}: accuracy {values["accuracy"]:.5f}')

    # 30. export and serve
    print('[30] save_model of the trained backbone -> load_model -> FaceNet '
          'on the card, 100 held-out images (cuda)')
    with tempfile.TemporaryDirectory() as tmp:
        export.save_model(tmp, state.model.backbone)
        bundle = export.load_model(tmp)
        require(bundle.model_class == 'InceptionResnetV1'
                and bundle.image_size == 160, f'bundle meta {bundle.meta}')
        reset_launches()
        served = FaceNet(Config({'path': tmp, 'normalize': True}),
                         device='cuda').evaluate(held_out[0][0])
        counts = read_launches()
    trained = trainer.embedding_forward(state)(held_out[0][0]).cpu().numpy()
    cos = (served * trained).sum(1) / (np.linalg.norm(served, axis=1)
                                       * np.linalg.norm(trained, axis=1))
    print(f'  served {served.shape}, min cosine against the trainer\'s '
          f'embedding_forward {cos.min():.6f}; kernel launches {counts}')
    require(served.shape == (100, 512) and np.isfinite(served).all()
            and cos.min() >= 0.995, f'exported model serves off: {cos.min()}')
    require(counts == only(), f'serving launched kernels: {counts}')
    print(f'  phases 25-30 in {time.monotonic() - started:.1f} s on {smi}')
    context.update(train_images=images_np, train_labels=labels_np,
                   held_out=held_out, train_ms=ms, train_busy=busy)


MS1MV2_CLASSES = 85742      # identities of InsightFace's MS1MV2 (emore)


COLLECTIVES = ('all_reduce', 'all_gather', 'all_gather_into_tensor',
               'reduce_scatter_tensor', 'broadcast', 'barrier')


def counting_collectives():
    """Count every torch.distributed collective this process makes from
    now on: {name: calls}, filled in as they are made."""
    import torch.distributed as dist

    counts = dict.fromkeys(COLLECTIVES, 0)

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, counted(name, getattr(dist, name)))
    return counts


def grid_path_rank(device, images, labels, held_out, steps):
    """Phase 31 in its rank (a world of one under NCCL): the trainer on a
    1 x 1 grid, `steps` bf16 steps under cudnn.deterministic, the leaves;
    the step's time; the collectives the steps and the validation made;
    the validation callback's B1 launches."""
    import torch

    from facenet_tpu_torch import callbacks
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.ops import pair_counts
    from facenet_tpu_torch.parallel.mesh import create_mesh
    from facenet_tpu_torch.train.softmax import SoftmaxTrainer, flat_leaves
    from facenet_tpu_torch.utils.timing import cuda_ms

    seconds = {}
    collectives = counting_collectives()
    t0 = time.monotonic()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = create_mesh(1, 1, device=device)
    trainer = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES, mesh=mesh)
    state = trainer.init_state(seed=0)
    cards = [trainer.placed_rows(*batch)
             for batch in hundreds(images, labels)]
    seconds['state'] = time.monotonic() - t0
    t0 = time.monotonic()
    for i in range(steps):
        state, metrics = trainer.step_fn(state, *cards[i % len(cards)])
    leaves = [a.astype(np.float32) for a in
              flat_leaves(state.model.to_flax_variables())]
    loss = float(metrics['loss'])
    seconds['steps'] = time.monotonic() - t0

    def step():
        trainer.step_fn(state, *cards[0])

    t0 = time.monotonic()
    ms, _ = cuda_ms(step, reps=5, warmup=1)
    seconds['times'] = time.monotonic() - t0
    t0 = time.monotonic()
    callback = callbacks.ValidateCallback(
        forward_factory=trainer.embedding_forward,
        batches_factory=lambda: iter(held_out), every_n_epochs=1,
        max_nrof_epochs=1,
        config=Config({'validate': {'metric': 0, 'nrof_folds': 10,
                                    'far_target': 1e-3}}),
        device=device, mesh=mesh)
    pair_counts.pair_histogram.launches = 0
    validation = callback.on_epoch_end(0, state)
    launches = pair_counts.pair_histogram.launches
    finite = all(np.isfinite(v) for values in validation.dict.values()
                 for v in values.values())
    seconds['validation'] = time.monotonic() - t0
    return {'leaves': leaves, 'loss': loss, 'ms': ms,
            'collectives': sum(collectives.values()), 'launches': launches,
            'finite': finite, 'world': mesh.world_size,
            'seconds': seconds}


def shared_card_rank(device, gate, grid_images, grid_labels, pk_images,
                     pk_labels, train_images, train_labels, pair_emb,
                     pair_labels):
    """Phases 32-34 in each of two ranks sharing the card under gloo, once
    `gate` opens (1; -1 returns at once)."""
    import torch
    import torch.distributed as dist

    from facenet_tpu_torch.facenet import evaluate_embeddings
    from facenet_tpu_torch.models.inception_resnet_v1 import (
        InceptionResnetV1, init_variables)
    from facenet_tpu_torch.ops import pair_counts
    from facenet_tpu_torch.parallel.mesh import create_mesh
    from facenet_tpu_torch.parallel.sharded_eval import \
        sharded_pair_histograms
    from facenet_tpu_torch.statistics import confusion_counts
    from facenet_tpu_torch.train.softmax import (SoftmaxTrainer,
                                                 grid_step_check)

    while gate.value == 0:
        time.sleep(0.05)
    if gate.value < 0:
        return None
    out = {}
    # 32. float64 steps on (2, 1) and (1, 2), then bf16 steps on (2, 1)
    checks = [((2, 1), VGGFACE2_CLASSES, 'softmax + center',
               train_config(1, center_factor=0.01), grid_images,
               grid_labels),
              ((2, 1), VGGFACE2_CLASSES, 'triplet',
               train_config(1, softmax_factor=0.0, triplet_factor=1.0),
               pk_images, pk_labels),
              ((1, 2), MS1MV2_CLASSES, 'softmax + center',
               train_config(1, center_factor=0.01), grid_images,
               grid_labels)]
    out['checks'] = []
    for grid, classes, loss, cfg, images, labels in checks:
        t0 = time.monotonic()
        result = grid_step_check(device, cfg, classes, images, labels, grid,
                                 dtype='float64', atol=1e-12)
        out['checks'].append((grid, classes, loss, result,
                              time.monotonic() - t0))
    t0 = time.monotonic()
    mesh = create_mesh(2, 1, device=device)
    trainer = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES, mesh=mesh)
    state = trainer.init_state(seed=0)
    batch = trainer.placed_rows(train_images[:100], train_labels[:100])
    state, _ = trainer.step_fn(state, *batch)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    for _ in range(3):
        state, metrics = trainer.step_fn(state, *batch)
    float(metrics['loss'])
    torch.cuda.synchronize()
    out['bf16_ms'] = (time.monotonic() - t1) / 3 * 1e3
    out['bf16_loss'] = float(metrics['loss'])
    out['bf16_s'] = time.monotonic() - t0
    del trainer, state, batch

    # 33. the pair statistics, each rank with its own half of the rows
    # (the sharded path), then each with the full set (the validate path)
    thresholds = np.linspace(0, 4.0, 100).astype(np.float32)
    dense = np.unique(pair_labels, return_inverse=True)[1]
    classes = int(dense.max()) + 1
    local = create_mesh(2, 1, device=device, local_rows=True)
    half = len(dense) // 2
    rows = slice(0, half) if local.rank == 0 else slice(half, None)
    stripe, stripe_labels = pair_emb[rows], dense[rows]
    sharded_pair_histograms(stripe[:256], stripe_labels[:256], thresholds,
                            classes, 0, local)         # warm-up
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    hist = sharded_pair_histograms(stripe, stripe_labels, thresholds,
                                   classes, 0, local)
    torch.cuda.synchronize()
    out['pairs_ms'] = (time.monotonic() - t0) * 1e3
    out['hist'] = np.stack(hist)
    confusion_counts(pair_emb[:256], pair_labels[:256], thresholds,
                     mesh=mesh)                        # warm-up
    dist.barrier()
    torch.cuda.synchronize()
    pair_counts.pair_histogram.launches = 0
    t0 = time.monotonic()
    out['full_counts'] = confusion_counts(pair_emb, pair_labels, thresholds,
                                          mesh=mesh)
    torch.cuda.synchronize()
    out['full_ms'] = (time.monotonic() - t0) * 1e3
    out['full_launches'] = pair_counts.pair_histogram.launches

    # 34. sharded extraction, float32 without TF32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = InceptionResnetV1().from_flax_variables(init_variables(seed=0))
        net = net.to(device).eval()

        def forward(images):
            with torch.inference_mode():
                return net(torch.as_tensor(images).to(device))

        rng = np.random.default_rng(34)
        images = rng.integers(0, 256, (1000, 160, 160, 3), dtype=np.uint8)
        batches = [(images[i:i + 111], np.arange(i, min(i + 111, 1000)))
                   for i in range(0, 1000, 111)]
        t0 = time.monotonic()
        rows, order = evaluate_embeddings(forward, batches,
                                          renormalize=False, mesh=mesh)
        out['extract_s'] = time.monotonic() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    out['rows'], out['order'] = rows, order
    return out if mesh.rank == 0 else None


def grid_path(context, pool):
    """Phase 31: the 1 x 1 grid in a world of one under NCCL, its rank
    started on `pool` while the trainer alone takes the same steps here."""
    import torch

    from facenet_tpu_torch.parallel import launch
    from facenet_tpu_torch.train.softmax import SoftmaxTrainer, flat_leaves

    smi = context['smi']
    images_np, labels_np = context['train_images'], context['train_labels']
    print('[31] SoftmaxTrainer(mesh=create_mesh(1, 1)) in a world of one '
          'under NCCL (parallel.launch.spawn), 5 bf16 steps at batch 100 '
          f'with the {VGGFACE2_CLASSES}-way head, cudnn.deterministic, '
          'against the trainer without a process group (cuda)')
    t0 = time.monotonic()
    rank = pool.submit(launch.spawn, grid_path_rank, 1, backend='nccl',
                       device='cuda', timeout=300,
                       args=(images_np, labels_np, context['held_out'], 5))
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        alone = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES,
                               device='cuda')
        state = alone.init_state(seed=0)
        batches = hundreds(images_np, labels_np)
        for i in range(5):
            state, _ = alone.step_fn(
                state, *alone.placed(*batches[i % len(batches)]))
        want = list(flat_leaves(state.model.to_flax_variables()))
        del alone, state
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = deterministic
    torch.cuda.empty_cache()
    got = rank.result()[0]
    spawn_s = time.monotonic() - t0
    diff = max(float(np.abs(a - b).max()) for a, b in zip(got['leaves'],
                                                          want))
    print(f'  world {got["world"]} (nccl): max |grid - alone| over '
          f'{len(want)} leaves after 5 steps {diff:.3e} (bound 1e-6); '
          f'loss {got["loss"]:.6f}; {spawn_s:.1f} s for the rank on {smi}, '
          'start-up included: ' + ', '.join(f'{k} {v:.1f} s'
                                   for k, v in got['seconds'].items()))
    print(f'  on {smi}: {got["ms"]:.3f} ms a step as the host issues it; '
          f'phase 25\'s trainer {context["train_ms"]:.3f} ms issued, '
          f'{context["train_busy"]:.3f} ms device busy; the grid\'s '
          f'5 steps, timing and validation made '
          f'{got["collectives"]} collectives, so NCCL holds no share of '
          'its busy time (the steps launch the kernels of phase 25\'s, '
          'whose busy time stands for theirs)')
    print(f'  ValidateCallback in the rank: {got["launches"]} '
          'pair_below_counts launches')
    require(diff <= 1e-6, f'1 x 1 grid != trainer alone ({diff})')
    require(got['launches'] == 30 and got['finite'],
            f'grid validation: {got["launches"]} B1 launches')
    require(got['collectives'] == 0,
            f'a 1 x 1 grid made {got["collectives"]} collectives')


def slice10_phases(context):
    """Phases 31-34 (see the module docstring): the process grid on the
    card; returns nothing, fails the run when a check fails."""
    import torch
    import torch.multiprocessing as mp

    from facenet_tpu_torch import statistics
    from facenet_tpu_torch.models.inception_resnet_v1 import (
        InceptionResnetV1, init_variables)
    from facenet_tpu_torch.ops import pair_counts
    from facenet_tpu_torch.parallel import launch

    smi = context['smi']
    started = time.monotonic()
    images_np, labels_np = context['train_images'], context['train_labels']

    pk_labels = np.repeat(ids_for_pk(labels_np), 2)
    pk_images = np.stack([images_np[np.flatnonzero(labels_np == c)[j]]
                          for c in ids_for_pk(labels_np) for j in (0, 1)])
    emb, pair_labels, inputs = context['pair_inputs']
    # The ranks start up (processes, imports, process groups) while the
    # trainer alone takes phase 31's steps here: the two-rank group of
    # phases 32-34 then waits at `gate` until phase 31 is done (1), or
    # returns at once if it failed (-1).
    gate = mp.get_context('spawn').Value('i', 0)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        group = pool.submit(
            launch.spawn, shared_card_rank, 2, backend='gloo',
            device='cuda', timeout=600,
            args=(gate, images_np[:8], labels_np[:8], pk_images, pk_labels,
                  images_np[:100], labels_np[:100], emb, pair_labels))
        try:
            grid_path(context, pool)
        except BaseException:
            gate.value = -1
            raise
        t0 = time.monotonic()
        gate.value = 1

        # 32-34. two ranks share the card under gloo
        print('[32] two ranks sharing the card under gloo (CUDA tensors): '
              'one float64 step (TF32 off) at global batch 8 on (data=2, '
              f'model=1) with the {VGGFACE2_CLASSES}-way head, softmax + '
              'center and triplet (a 4 x 2 P x K batch), and on (data=1, '
              f'model=2) with the {MS1MV2_CLASSES}-way head of MS1MV2 '
              '(8,631 does not split in two), each against the same step '
              'on one rank; then 3 bf16 steps at global batch 100 on '
              '(2, 1)')
        out = group.result()[0]
    group_s = time.monotonic() - t0
    for grid, classes, loss, result, seconds in out['checks']:
        (on_grid, one), worst, largest = result
        print(f'  {grid} {classes} classes {loss}: worst leaf |grid - one| '
              f'- 1e-12 = {worst:.3e} of its update (bound 1e-5; largest '
              f'update {largest:.3e}); loss grid {on_grid["loss"]:.8f} one '
              f'{one["loss"]:.8f}; {seconds:.1f} s on {smi}')
        for key, value in one.items():
            require(abs(on_grid[key] - value) <= 1e-5 * abs(value) + 1e-12,
                    f'{grid} {loss}: {key} {on_grid[key]} != {value}')
        require(worst <= 1e-5, f'{grid} {loss}: grid step != one rank '
                f'({worst})')
    print(f'  (2, 1) bf16 at global batch 100: {out["bf16_ms"]:.3f} ms a '
          f'step on {smi}, loss {out["bf16_loss"]:.4f} ({out["bf16_s"]:.1f}'
          ' s with the state and a first step); gloo stages every '
          'collective through the host and both ranks share one card: '
          'no multi-GPU rate')

    print(f'[33] pair statistics on two ranks: N={emb.shape[0]} '
          f'D={emb.shape[1]} T=100, each rank with its half of the rows '
          '(sharded, plain torch) and each with the full set (B1 on each '
          'rank, no collective), against B1 on one rank (phase 6\'s '
          'inputs)')
    b1 = pair_counts.pair_histogram(inputs).cumsum(1)
    sharded = torch.from_numpy(out['hist']).cuda().cumsum(1)
    diff = (sharded - b1).abs()
    limit = near_cutoff_weight(inputs) + 1e-6 * b1.abs() + 1e-12
    thresholds = np.linspace(0, 4.0, 100).astype(np.float32)
    alone = statistics.confusion_counts(emb, pair_labels, thresholds,
                                        device='cuda')
    full_diff = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                    for a, b in zip(out['full_counts'], alone))
    print(f'  sharded: max |sharded - B1| {float(diff.max()):.3e}, '
          f'{out["pairs_ms"]:.3f} ms wall (two ranks on one card, gloo); '
          f'full set: {out["full_launches"]} B1 launch on rank 0, counts '
          f'within {full_diff:.3e} of one rank\'s (relative), '
          f'{out["full_ms"]:.3f} ms wall for confusion_counts (both ranks\' '
          f'B1 at once on one card); B1 alone {context["pair_ms"]:.3f} ms '
          f'(phase 6) on {smi}')
    require(not bool((diff > limit).any()),
            f'sharded counts != B1: max excess '
            f'{float((diff - limit).max()):.3e}')
    require(out['full_launches'] == 1 and full_diff <= 1e-6,
            f'full-set counts: {out["full_launches"]} launches, '
            f'{full_diff:.3e} off')

    print('[34] evaluate_embeddings(mesh=) on two ranks: 1,000 images in '
          'batches of 111 (each split 56 + 55 with a padded row; the last '
          'batch one image), full-width IRv1 in float32 without TF32')
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = InceptionResnetV1().from_flax_variables(init_variables(seed=0))
        net = net.cuda().eval()
        images = np.random.default_rng(34).integers(
            0, 256, (1000, 160, 160, 3), dtype=np.uint8)
        with torch.inference_mode():
            one = torch.cat([net(torch.from_numpy(images[i:i + 111]).cuda())
                             for i in range(0, 1000, 111)]).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    rows = out['rows']
    cos = (rows * one).sum(1) / (np.linalg.norm(rows, axis=1)
                                 * np.linalg.norm(one, axis=1))
    print(f'  rows {rows.shape}, min cosine against one rank '
          f'{cos.min():.8f}, order {"kept" if np.array_equal(out["order"], np.arange(1000)) else "LOST"}; '
          f'{out["extract_s"]:.2f} s wall on two ranks of {smi}')
    require(rows.shape == (1000, 512) and cos.min() >= 0.99999
            and np.array_equal(out['order'], np.arange(1000)),
            f'sharded extraction off: {cos.min()}')
    print(f'  phases 32-34 {group_s:.1f} s for the two ranks (their '
          'start-up ran during phase 31); phases 31-34 in '
          f'{time.monotonic() - started:.1f} s '
          f'on {smi}')


def hundreds(images, labels):
    """Phase 25's batches of 100."""
    return [(images[i:i + 100], labels[i:i + 100])
            for i in range(0, len(images), 100)]


def ids_for_pk(labels):
    """4 identities with at least two images each, in label order."""
    values, counts = np.unique(labels, return_counts=True)
    return values[counts >= 2][:4]


def busy_line(fn, calls):
    """(device busy ms a call, wall ms a call, kernel launches a call) from
    torch.profiler over `calls` calls of fn()."""
    from facenet_tpu_torch.utils.timing import device_busy
    busy, wall, rows = device_busy(fn, calls)
    return busy, wall, sum(e.count for e in rows) / calls


def detection_scenes(seed, n, shape, min_face=40, max_face=200):
    """(uint8 [n, H, W, 3] scenes, their boxes, their landmarks), 1-3
    faces a scene."""
    from facenet_tpu_torch.utils.synthetic import render_scene
    scene_rng = np.random.RandomState(seed)
    scenes = [render_scene(scene_rng, shape=shape,
                           n_faces=scene_rng.randint(1, 4),
                           min_face=min_face, max_face=max_face)
              for _ in range(n)]
    return (np.stack([s[0] for s in scenes]), [s[1] for s in scenes],
            [s[2] for s in scenes])


def crop_batches(images, boxes, landmarks, net, batch, n, seed):
    """n batches of `batch` training crops for one MTCNN net, sampled from
    the scenes by `generate_training_crops`, every sample type present."""
    from facenet_tpu_torch.train import mtcnn
    rng = np.random.RandomState(seed)
    parts = []
    i = 0
    while sum(len(p[0]) for p in parts) < n * batch:
        j = i % len(images)
        parts.append(mtcnn.generate_training_crops(
            images[j], boxes[j], mtcnn.INPUT_SIZE[net], rng,
            gt_landmarks=landmarks[j]))
        i += 1
    pool = [np.concatenate([p[k] for p in parts]) for k in range(5)]
    order = rng.permutation(len(pool[0]))[:n * batch]
    pool = [a[order] for a in pool]
    return [tuple(a[j * batch:(j + 1) * batch] for a in pool)
            for j in range(n)]


def slice11_phases(rng, context):
    """Phases 35-40 (see the module docstring): Faster-RCNN serving, its
    quality gate and training, MTCNN training, the pair classifiers, and
    the trained trees served; the crop kernel is the only hand-written
    kernel on these paths."""
    import torch

    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.dataset import equal_batches_input_pipeline
    from facenet_tpu_torch.detectors import evaluation, pretrained
    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    from facenet_tpu_torch.detectors.frcnn import detector as frcnn
    from facenet_tpu_torch.ops.crop import crop_and_resize
    from facenet_tpu_torch.train import classifier, mtcnn
    from facenet_tpu_torch.utils.timing import cuda_ms, device_ms
    from facenet_tpu_torch.utils.timing import spread as _spread

    smi = context['smi']
    started = time.monotonic()
    bundled = pretrained.load_bundled('frcnnv3')

    # 35. FRCNN serving through FaceDetector, card and CPU
    print(f'[35] FaceDetector(detector="frcnnv3"), bundled weights, {SCENE}, '
          '64 synthetic scenes in batches of 16, proposals 256, outputs 32 '
          '(cuda)')
    images, truth, _ = detection_scenes(35, 64, SCENE)
    fd = FaceDetector(detector='frcnnv3', image_shape=SCENE, device='cuda')
    det = fd.backend_for(SCENE)
    fd.detect_images(list(images[:16]))                    # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    found = []
    for i in range(0, 64, 16):
        found += fd.detect_images(list(images[i:i + 16]))
    path_s = time.monotonic() - t0
    counts = read_launches()
    require(counts == only(crop_resize=4, nms_greedy=8),
            f'expected 4 crop_resize (RoIAlign) and 8 nms_greedy (2 a batch) '
            f'launches alone, got {counts}')
    n_found = sum(len(f) for f in found)
    matched = sum(evaluation.match_detections(
        gt, np.array([[b.left, b.top, b.left + b.width, b.top + b.height]
                      for b in f], np.float32).reshape(-1, 4))[0]
        for gt, f in zip(truth, found))
    print(f'  {n_found} detections, {matched} of '
          f'{sum(len(t) for t in truth)} ground-truth faces matched at IoU '
          f'0.5; {path_s:.2f} s wall for the 64 (letterbox included); kernel '
          f'launches {counts}')
    require(matched >= 0.75 * sum(len(t) for t in truth),
            'the FRCNN found too few faces')
    card_out = det.detect_batch(images[:4])
    cpu_det = frcnn.FasterRCNN(image_shape=SCENE, params=bundled,
                               device='cpu')
    cpu_out = cpu_det.detect_batch(images[:4])
    gap = evaluation.compare_outputs(card_out, cpu_out)
    print(f'  card vs CPU, 4 scenes: {gap}')
    require(gap['unmatched'] == 0 and gap['n_b'] > 0
            and gap['box_px'] <= 1.5 and gap['score'] <= 0.02,
            f'FRCNN card != CPU: {gap}')
    batch = det.to_device(images[:16])
    ms, windows = cuda_ms(lambda: det.detect_batch_async(batch), reps=5)
    busy, wall, launches = busy_line(lambda: det.detect_batch_async(batch), 3)
    with torch.inference_mode():
        fmap, boxes, _, _ = det._propose(batch)
    # the crop kernel, launched through ctypes, has no ATen op over it, so
    # the profiler's key averages (busy_line) leave it out: CUDA events
    crop_ms = device_ms(
        lambda: crop_and_resize(fmap, boxes / frcnn.STRIDE, det.roi_size),
        reps=20)[0]
    print(f'  on {smi}: {ms:.3f} ms a batch of 16 as issued (windows '
          f'{_spread(windows)}) = {16e3 / ms:.1f} scenes/s; device busy '
          f'{busy:.3f} ms a batch ({busy / wall:.3f} of {wall:.3f} ms wall, '
          f'{launches:.0f} launches) besides crop_and_resize, '
          f'{crop_ms:.3f} ms')
    device_breakdown(lambda: det.detect_batch_async(batch), 10)

    # 36. the bundled FRCNN's quality gate on the card
    print('[36] bundled FRCNN quality gate on the card: 32 held-out 256x256 '
          'scenes (seed 555)')
    gate_rng = np.random.RandomState(555)
    from facenet_tpu_torch.utils.synthetic import render_scene
    gate = [render_scene(gate_rng, shape=(256, 256),
                         n_faces=gate_rng.randint(1, 4), min_face=32,
                         max_face=160) for _ in range(32)]
    m = evaluation.evaluate_detector(
        FaceDetector(detector='frcnnv3', image_shape=(256, 256),
                     device='cuda'), [s[0] for s in gate],
        [s[1] for s in gate], iou_threshold=0.5, batch_size=16)
    print(f'  recall {m["recall"]:.4f} precision {m["precision"]:.4f} mean '
          f'IoU {m["mean_iou"]:.4f} ({m["n_matched"]}/{m["n_gt"]} matched, '
          f'{m["n_pred"]} predicted)')
    require(m['recall'] >= 0.97 and m['precision'] >= 0.86
            and m['mean_iou'] >= 0.5, f'FRCNN quality gate failed: {m}')

    # 37. FRCNN training
    print(f'[37] FasterRCNNTrainer: 20 bf16 steps at batch 8 of {SCENE} '
          'scenes (1-3 faces), Adam 1e-3 from init_params(seed=0) (cuda)')
    t_images, t_boxes, _ = detection_scenes(37, 32, SCENE)
    train_det = frcnn.FasterRCNN(image_shape=SCENE, device='cuda')
    trainer = frcnn.FasterRCNNTrainer(train_det, learning_rate=1e-3)
    state = trainer.init_state(seed=0)
    batches = [(t_images[i:i + 8], t_boxes[i:i + 8]) for i in range(0, 32, 8)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = []
    t0 = time.monotonic()
    for i in range(20):
        state, metrics = trainer.train_step(state, *batches[i % 4])
        history.append(metrics)
    history = [{k: float(v) for k, v in h.items()} for h in history]
    run_s = time.monotonic() - t0
    counts = read_launches()
    require(counts == only(crop_resize=20),
            f'expected 20 crop_resize launches (a step\'s RoIAlign) alone, '
            f'got {counts}')
    rpn = [h['rpn_cls'] for h in history]
    require(all(np.isfinite(list(h.values())).all() for h in history)
            and np.mean(rpn[-5:]) < np.mean(rpn[:5]),
            f'FRCNN losses not finite or rpn_cls not falling: {rpn}')
    print(f'  rpn_cls {" ".join(f"{v:.4f}" for v in rpn)}')
    print(f'  last step {history[-1]}; 20 steps in {run_s:.2f} s wall')
    peak = torch.cuda.max_memory_allocated()

    def frcnn_step():
        trainer.train_step(state, *batches[0])

    ms, windows = cuda_ms(frcnn_step, reps=5)
    busy, wall, launches = busy_line(frcnn_step, 3)
    print(f'  on {smi}: {ms:.3f} ms a step as issued (windows '
          f'{_spread(windows)}) = {8e3 / ms:.1f} img/s; device busy '
          f'{busy:.3f} ms a step ({busy / wall:.3f} of {wall:.3f} ms wall), '
          f'{launches:.0f} launches a step; max_memory_allocated '
          f'{peak / 2 ** 30:.2f} GiB')
    frcnn_params = trainer.params_of(state)
    t0 = time.monotonic()
    (card, cpu), worst = frcnn.step_on_devices(
        frcnn_params, t_images[:2], t_boxes[:2])
    rel = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu)
    print(f'  one float32 step (TF32 off) at batch 2, card vs CPU from the '
          f'trained state: losses rel {rel:.2e}, Adam first moment '
          f'{worst:.2e} of a leaf ({time.monotonic() - t0:.1f} s)')
    require(rel <= 1e-4 and worst <= 1e-3,
            f'FRCNN step card != CPU: {rel} {worst}')

    # 38. MTCNN training
    print('[38] MTCNNTrainer P-, R-, O-Net: 20 bf16 steps each at batch 256 '
          '(4 batches cycled) of generate_training_crops samples of 256x256 '
          'scenes with landmarks (cuda)')
    s_images, s_boxes, s_lmks = detection_scenes(38, 48, (256, 256),
                                                 min_face=40, max_face=160)
    mtcnn_params = {}
    for k, net in enumerate(('pnet', 'rnet', 'onet')):
        crops = crop_batches(s_images, s_boxes, s_lmks, net, 256, 4, k)
        trainer = mtcnn.MTCNNTrainer(net, device='cuda')
        state = trainer.init_state(seed=0)
        reset_launches()
        history = []
        for i in range(20):
            state, metrics = trainer.train_step(state, *crops[i % 4])
            history.append(metrics)
        history = [{k: float(v) for k, v in h.items()} for h in history]
        counts = read_launches()
        require(counts == only(), f'{net} training launched kernels: {counts}')
        cls = [h['cls_loss'] for h in history]
        require(all(np.isfinite(list(h.values())).all() for h in history)
                and np.mean(cls[-5:]) < np.mean(cls[:5]),
                f'{net} losses not finite or cls_loss not falling: {cls}')
        ms, windows = cuda_ms(lambda: trainer.train_step(state, *crops[0]),
                              reps=5)
        busy, wall, launches = busy_line(
            lambda: trainer.train_step(state, *crops[0]), 3)
        mtcnn_params[net] = trainer.params_of(state)
        (card, cpu), worst = mtcnn.step_on_devices(net, mtcnn_params[net],
                                                   crops[1])
        rel = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
                  for k in cpu)
        print(f'  {net}: cls_loss {cls[0]:.4f} -> {cls[-1]:.4f} (means of 5: '
              f'{np.mean(cls[:5]):.4f} -> {np.mean(cls[-5:]):.4f}); on {smi}: '
              f'{ms:.3f} ms a step as issued (windows {_spread(windows)}), '
              f'device busy {busy:.3f} ms ({launches:.0f} launches); float32 '
              f'step card vs CPU: losses rel {rel:.2e}, first moment '
              f'{worst:.2e} of a leaf')
        require(rel <= 1e-4 and worst <= 1e-3,
                f'{net} step card != CPU: {rel} {worst}')

    # 39. the pair classifiers
    print('[39] ClassifierTrainer: 500 identities x 50 embeddings x 512-d '
          '(synthetic, clustered), P = 500, K = 5, 2 epochs x 250 steps, '
          'both classifiers; ConfusionMatrix on the card and on the CPU')
    emb, labels = clustered(rng, 500, 50, 512, 1.2)
    scale = rng.uniform(0.6, 1.6, (emb.shape[0], 1)).astype(np.float32)
    for normalized in (False, True):
        data = emb if normalized else emb * scale
        per_class = [data[labels == c] for c in np.unique(labels)]
        cfg = Config({'nrof_classes_per_batch': None,
                      'nrof_examples_per_class': 5,
                      'train': {'epoch': {'max_nrof_epochs': 2, 'size': 250},
                                'learning_rate_schedule': {
                                    'initial_value': 0.01,
                                    'decay_rate': 0.1}}})
        batches = equal_batches_input_pipeline(per_class, cfg, seed=0)
        trainer = classifier.ClassifierTrainer(cfg, normalized=normalized,
                                               device='cuda')
        reset_launches()
        t0 = time.monotonic()
        model = trainer.train(batches, nrof_epochs=2, epoch_size=250,
                              p=int(cfg.nrof_classes_per_batch), k=5)
        losses = [float(v) for v in trainer.losses]
        train_s = time.monotonic() - t0
        counts = read_launches()
        require(counts == only(), f'classifier launched kernels: {counts}')
        require(np.isfinite(losses).all()
                and np.mean(losses[-25:]) < np.mean(losses[:25]),
                f'classifier loss not falling: {losses[:3]} {losses[-3:]}')
        torch.cuda.synchronize()
        t0 = time.monotonic()
        on_card = classifier.ConfusionMatrix(per_class, model)
        card_s = time.monotonic() - t0
        t0 = time.monotonic()
        on_cpu = classifier.ConfusionMatrix(
            per_class, type(model).from_variables(model.variables,
                                                  device='cpu'))
        cpu_s = time.monotonic() - t0
        worst = max(abs(getattr(on_card, a) - getattr(on_cpu, a))
                    for a in ('accuracy', 'precision', 'tp_rate', 'tn_rate'))
        print(f'  {type(model).__name__}: loss {np.mean(losses[:25]):.4f} -> '
              f'{np.mean(losses[-25:]):.4f} (means of 25); {train_s / 500 * 1e3:.3f} '
              f'ms a step wall over 500 steps on {smi} (batches drawn on the '
              f'host included); variables {model.variables_dict()}; '
              f'confusion: accuracy {on_card.accuracy:.6f}, card '
              f'{card_s:.3f} s wall, CPU {cpu_s:.3f} s, max |card - CPU| '
              f'{worst:.2e}')
        require(worst <= 1e-6, f'ConfusionMatrix card != CPU: {worst}')

    # 40. the trained trees served
    print('[40] the trained trees of phases 37 and 38 through '
          'FaceDetector(params=...) on the card (the MTCNN with its '
          '"flax" P-Net, so the crops are the only kernel), one batch of 16 '
          'each')
    reset_launches()
    for name, params, kwargs in (('frcnnv3', frcnn_params, {}),
                                 ('mtcnn', mtcnn_params,
                                  {'pnet_impl': 'flax'})):
        served = FaceDetector(detector=name, image_shape=SCENE, params=params,
                              device='cuda', **kwargs)
        out = served.backend_for(SCENE).detect_batch(images[:16])
        require(all(np.isfinite(out[k]).all() for k in ('boxes', 'scores')),
                f'{name}: non-finite outputs from the trained tree')
        print(f'  {name}: {int(out["valid"].sum())} valid boxes in 16 scenes, '
              'finite')
    counts = read_launches()
    require(counts == only(crop_resize=3, nms_greedy=3),
            f'phase 40: expected 3 crop_resize and 3 nms_greedy launches '
            f'alone, got {counts}')
    print(f'phases 35-40: {time.monotonic() - started:.1f} s')


def perturbed_variables(variables, seed):
    """`variables` with every BatchNorm statistic and every bias moved off
    its init (mean N(0, 0.1), var U(0.5, 1.5), biases N(0, 0.05)), so that
    the fold of an import does work."""
    rng = np.random.RandomState(seed)

    def walk(tree, fn, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, fn, k) for k, v in tree.items()}
        return fn(key, tree)

    def stats(key, leaf):
        if key == 'mean':
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    def params(key, leaf):
        if key == 'bias':
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        return leaf

    return {'params': walk(variables['params'], params),
            'batch_stats': walk(variables['batch_stats'], stats)}


def min_cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a * b).sum(axis=1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1),
        1e-30)).min())


def trace_busy(trace, span):
    """(device busy ms, span wall ms, kernel launches, [(kernel, ms, count)]
    by time) per span of a torch.profiler Chrome trace whose spans' names
    start with `span`: the kernels', copies' and sets' own durations,
    without annotations, as `device_busy` counts them."""
    events = trace['traceEvents']
    spans = [e['dur'] for e in events if e.get('cat') == 'user_annotation'
             and str(e.get('name', '')).startswith(span)]
    rows = {}
    for e in events:
        if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            ms, count = rows.get(e['name'], (0.0, 0))
            rows[e['name']] = (ms + e['dur'] / 1e3, count + 1)
    n = len(spans)
    top = sorted(((name, ms / n, count // n)
                  for name, (ms, count) in rows.items()),
                 key=lambda row: -row[1])
    launches = sum(count for _, count in rows.values()) / n
    return (sum(ms for _, ms, _ in top), sum(spans) / n / 1e3, launches,
            top)


def slice12_phases(rng, context):
    """Phases 41-44 (see the module docstring): the h5 import, the
    export_model app and the compiled artifact on the card, Inception-
    ResNet-v2 training from the zoo, IRv2's step card vs CPU, and a trace
    of IRv2 steps; no hand-written kernel runs on these paths, so every
    launch count stays 0. Their files go to a temporary directory that is
    removed at the end."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix='chip_smoke_12_'))
    try:
        _slice12(rng, context, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _slice12(rng, context, work):
    import importlib.util

    import torch

    from facenet_tpu_torch import FaceNet, export, models
    from facenet_tpu_torch.apps import export_model
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.models import import_weights
    from facenet_tpu_torch.models.inception_resnet_v1 import (
        InceptionResnetV1, init_variables)
    from facenet_tpu_torch.train.softmax import (SoftmaxTrainer,
                                                 step_on_devices)
    from facenet_tpu_torch.utils import profiling
    from facenet_tpu_torch.utils.timing import cuda_ms
    from facenet_tpu_torch.utils.timing import spread as _spread

    smi = context['smi']
    started = time.monotonic()
    images = rng.integers(0, 256, (128, 160, 160, 3)).astype(np.uint8)

    # 41. import -> export -> compiled serving
    print('[41] full-width IRv1 (default config, 512-d, init_variables(seed=0)'
          ' with BatchNorm statistics and biases moved): the reference\'s '
          'folded-BN units -> import -> export_model -> model.pt2 on the '
          'card (cuda)')
    t0 = time.monotonic()
    original = perturbed_variables(init_variables(seed=0), 41)
    has_h5 = importlib.util.find_spec('h5py') is not None
    if has_h5:
        h5 = import_weights.export_ref_h5(original, work / 'ref.h5')
        imported = import_weights.import_h5_weights(h5)
        app_args = ['--import-h5', str(h5), '--h5', str(work / 'dump.h5')]
        print('  export_ref_h5 -> import_h5_weights -> export_model '
              '--import-h5 --h5')
    else:
        units = import_weights.reference_units(original)
        imported = import_weights.import_units(units)
        source = export.save_model(
            work / 'imported',
            InceptionResnetV1().from_flax_variables(imported))
        app_args = ['--model-dir', str(source)]
        print(f'  h5py is not installed here: the {len(units)} folded units '
              'go through reference_units -> import_units in memory (the h5 '
              'file round trip runs in the CPU tests); export_model '
              '--model-dir of the imported bundle')

    def bundle_of(variables):
        return export.ModelBundle(variables, {
            'model_class': 'InceptionResnetV1', 'config': None,
            'image_size': 160, 'normalization': 0})

    served = FaceNet(Config({}), device='cuda', bundle=bundle_of(imported))
    want = FaceNet(Config({}), device='cuda', bundle=bundle_of(original))
    cos = min_cosine(served.evaluate(images), want.evaluate(images))
    print(f'  imported tree vs the original through FaceNet, 128 images: '
          f'min cosine {cos:.6f}')
    require(cos >= 0.999, f'imported tree serves other embeddings ({cos})')
    print(f'  tree, import and both FaceNets: {time.monotonic() - t0:.1f} s')

    reset_launches()
    t1 = time.monotonic()
    export_model.main(app_args + ['--output', str(work / 'bundle'),
                                  '--device', 'cuda'])
    compiled = export.load_compiled(work / 'bundle', device='cuda')
    print(f'  export_model wrote {work / "bundle" / "model.pt2"} '
          f'({(work / "bundle" / "model.pt2").stat().st_size / 2 ** 20:.1f} '
          f'MiB) and it loaded: {time.monotonic() - t1:.1f} s (the first '
          'torch.export of the run, its trace, the move of its weights to '
          'the CPU, the file, the load and the move back)')
    for batch in (1, 3, 128):
        got = compiled(images[:batch]).cpu().numpy()
        ref = served.evaluate(images[:batch])
        cos = min_cosine(got, ref)
        print(f'  model.pt2 at batch {batch}: {got.shape}, min cosine to '
              f'FaceNet {cos:.6f}')
        require(got.shape == (batch, 512) and np.isfinite(got).all()
                and cos >= 0.9999, f'compiled artifact at batch {batch}')
    calib = images[:32]
    t1 = time.monotonic()
    # the int8 program save_compiled writes, run without its file: the
    # file round trip is model.pt2's above (and the int8 one's in the
    # cuda tests)
    q_compiled = export.CompiledModel(
        export.export_program(bundle_of(imported), quantize='int8',
                              calib_images=calib, device='cuda'),
        compiled.device)
    q_s = time.monotonic() - t1
    q_facenet = FaceNet(Config({'quantize': 'int8', 'calib': calib}),
                        device='cuda', bundle=bundle_of(imported))
    got = q_compiled(images).cpu().numpy()
    norms = np.linalg.norm(got, axis=1)
    cos = min_cosine(got, q_facenet.evaluate(images))
    print(f'  int8 program (32 calibration images; calibrated and traced '
          f'in {q_s:.1f} s): norms {norms.min():.6f}-{norms.max():.6f}, min '
          f'cosine to FaceNet int8 {cos:.6f}')
    require(np.isfinite(got).all() and np.abs(norms - 1).max() < 1e-3
            and cos >= 0.999, 'int8 compiled program')
    counts = read_launches()
    require(counts == only(), f'the export path launched kernels: {counts}')
    cards = torch.from_numpy(images).cuda()
    for name, fn in (('model.pt2', lambda: compiled(cards)),
                     ('FaceNet', lambda: served.dispatch(cards))):
        ms, windows = cuda_ms(fn, reps=5, warmup=1)
        busy, wall, launches = busy_line(fn, 1)
        print(f'  {name}: {ms:.3f} ms per 128 as issued ({_spread(windows)}),'
              f' device busy {busy:.3f} ms, {launches:.0f} launches, on {smi}')
    for name, fn in (('int8 program', lambda: q_compiled(cards)),
                     ('FaceNet int8', lambda: q_facenet.dispatch(cards))):
        ms, windows = cuda_ms(fn, reps=2, warmup=1)
        print(f'  {name}: {ms:.3f} ms per 128 as issued ({_spread(windows)}),'
              f' on {smi}')
    top = list(compiled.op_histogram().items())[:5]
    print(f'  op histogram, top 5: {top}; kernel launches {counts}; '
          f'{time.monotonic() - t0:.1f} s')

    # 42. IRv2 training from the zoo
    print(f'[42] full-width Inception-ResNet-v2 from the zoo\'s '
          f'inception_resnet_v2.yaml + {VGGFACE2_CLASSES}-way head, bf16, 20 '
          'softmax steps at batch 100 on phase 25\'s images (cuda)')
    t0 = time.monotonic()
    zoo = models.load_model_config('inception_resnet_v2')
    print(f'  zoo config: module {zoo.module}, keep_probability '
          f'{zoo.config.keep_probability}, embedding_size '
          f'{zoo.config.embedding_size}, repeat {zoo.config.repeat}')
    train_np, labels_np = context['train_images'], context['train_labels']
    trainer = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES,
                             model_cfg=zoo, device='cuda')
    state = trainer.init_state(seed=0)
    print(f'  state made in {time.monotonic() - t0:.1f} s: '
          f'{sum(p.numel() for p in state.model.parameters()):,} parameters')
    require(type(state.model.backbone).__name__ == 'InceptionResnetV2'
            and state.model.backbone.keep == 0.5, 'the zoo built no IRv2')
    batches = [trainer.placed(train_np[i:i + 100], labels_np[i:i + 100])
               for i in range(0, 400, 100)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    entropies, losses = [], []
    t1 = time.monotonic()
    for i in range(20):
        state, metrics = trainer.step_fn(state, *batches[i % 4])
        entropies.append(metrics['cross_entropy'])
        losses.append(metrics['loss'])
    entropies = [float(v) for v in entropies]
    losses = [float(v) for v in losses]
    run_s = time.monotonic() - t1
    counts = read_launches()
    first, last = np.mean(entropies[:5]), np.mean(entropies[-5:])
    print(f'  cross-entropies {" ".join(f"{v:.3f}" for v in entropies)}')
    print(f'  cross-entropy: mean of the first 5 {first:.4f}, of the last 5 '
          f'{last:.4f}; 20 steps in {run_s:.2f} s wall (first steps '
          f'included); kernel launches {counts}')
    require(counts == only(), f'IRv2 training launched kernels: {counts}')
    require(np.isfinite(losses).all() and last < first,
            f'IRv2: loss not finite or cross-entropy not falling: {first} '
            f'-> {last}')
    peak = torch.cuda.max_memory_allocated()

    def step():
        trainer.step_fn(state, *batches[0])

    ms, windows = cuda_ms(step, reps=3, warmup=1)
    print(f'  on {smi}: {ms:.3f} ms per step as the host issues it (windows '
          f'{_spread(windows)}) = {100e3 / ms:.1f} img/s; '
          f'max_memory_allocated {peak / 2 ** 30:.2f} GiB (device busy, '
          'launches and the top kernels: phase 44\'s trace)')
    backbone = state.model.backbone
    trained = export.ModelBundle(backbone.to_flax_variables(), {
        'model_class': 'InceptionResnetV2', 'config': backbone.config,
        'image_size': 160, 'normalization': 0})
    bf16 = FaceNet(Config({}), device='cuda', bundle=trained)
    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = backbone(cards[:64], dtype=torch.float32).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    cos = min_cosine(bf16.evaluate(images[:64]), ref)
    print(f'  the trained backbone through FaceNet (IRv2, bf16) vs its '
          f'float32 eval forward, 64 images: min cosine {cos:.6f}; '
          f'{time.monotonic() - t0:.1f} s')
    require(cos >= 0.995, f'trained IRv2 served otherwise ({cos})')

    # 43. IRv2 step card vs CPU
    print('[43] TINY IRv2 (repeat [1, 1, 1], 512-d), one float64 softmax '
          'step at batch 8, card vs CPU (TF32 off), keep 1.0 then 0.5')
    t0 = time.monotonic()
    tiny = {'repeat': [1, 1, 1], 'embedding_size': 512}
    for keep in (1.0, 0.5):
        (card, cpu), worst, moved = step_on_devices(
            train_config(1), 16, train_np[:8], labels_np[:8] % 16,
            model_cfg={'module': 'inception_resnet_v2',
                       'config': dict(tiny, keep_probability=keep)},
            dtype=torch.float64, atol=1e-12)
        print(f'  keep {keep}: loss card {card["loss"]:.12f} cpu '
              f'{cpu["loss"]:.12f}; worst leaf |card - cpu| - 1e-12 = '
              f'{worst:.3e} of its largest update ({moved:.3e})')
        for key, value in cpu.items():
            require(abs(card[key] - value) <= 1e-5 * abs(value) + 1e-12,
                    f'IRv2 keep {keep}: card {key} != cpu')
        require(np.isfinite(card['loss']) and worst <= 1e-5,
                f'IRv2 keep {keep}: card update != cpu update ({worst})')
    net = models.create_model_from_config(
        {'module': 'inception_resnet_v2',
         'config': dict(tiny, keep_probability=0.5)})
    mask = net.dropout_mask(100, torch.Generator().manual_seed(0))
    share, sigma = mask.float().mean().item(), np.sqrt(0.25 / mask.numel())
    print(f'  kept share of a 100 x 1536 mask {share:.5f} (0.5 +- 5 x '
          f'{sigma:.5f}); {time.monotonic() - t0:.1f} s')
    require(abs(share - 0.5) <= 5 * sigma, 'dropout keeps another share')

    # 44. a trace of IRv2 steps
    print('[44] profiling.trace around 3 of phase 42\'s steps, each in an '
          'annotate span; StepTimer (cuda)')
    t0 = time.monotonic()
    timer = profiling.StepTimer(items_per_step=100, name='IRv2 step')
    with profiling.trace(work / 'trace'):
        for i in range(3):
            with timer, profiling.annotate(f'irv2-step-{i}'):
                state, metrics = trainer.step_fn(state, *batches[i])
                float(metrics['loss'])
    trace_file = work / 'trace' / 'trace.json'
    text = trace_file.read_text()
    named = [f'irv2-step-{i}' in text for i in range(3)]
    print(f'  {trace_file} ({len(text) / 2 ** 20:.1f} MiB) names the spans: '
          f'{named}; {timer!r} (host, synchronized each step, traced)')
    require(all(named) and timer.items_per_sec > 0, 'trace or timer')
    busy, wall, launches, top = trace_busy(json.loads(text), 'irv2-step-')
    print(f'  phase 42\'s step in the trace, on {smi}: device busy '
          f'{busy:.3f} ms a step ({busy / wall:.3f} of the span\'s '
          f'{wall:.3f} ms) = {100e3 / busy:.1f} img/s at the device busy '
          f'time; {launches:.0f} launches a step; top 10:')
    for name, ms, count in top[:10]:
        print(f'    {ms:8.3f} ms  x{count:<4d} {name[:90]}')
    print(f'  {time.monotonic() - t0:.1f} s')
    print(f'  phases 41-44: {time.monotonic() - started:.1f} s')


def write_png(path, image):
    """uint8 [H, W, 3] -> an 8-bit RGB PNG, with zlib and struct alone
    (the card's machine may have no PIL)."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))

    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * 3)],
                          axis=1)
    Path(path).write_bytes(
        b'\x89PNG\r\n\x1a\n'
        + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
        + chunk(b'IDAT', zlib.compress(rows.tobytes(), 1))
        + chunk(b'IEND', b''))


def write_image_file(stem, image, quality=90):
    """A JPEG where PIL can write one, else a PNG (`write_png`); returns
    the path."""
    try:
        from PIL import Image
    except ImportError:
        path = Path(f'{stem}.png')
        write_png(path, image)
        return path
    path = Path(f'{stem}.jpg')
    Image.fromarray(image).save(path, quality=quality)
    return path


def face_files(rng, root, n_classes, per_class, size=250):
    """`n_classes` identity folders of `per_class` face-sized files: a
    smooth base image an identity, a smooth field and noise an image."""
    def smooth(n, cells):
        low = rng.integers(0, 256, (n, cells, cells, 3)).astype(np.int16)
        up = np.repeat(np.repeat(low, size // cells + 1, 1),
                       size // cells + 1, 2)
        return up[:, :size, :size]

    base = smooth(n_classes, 10)
    noise = rng.integers(-6, 7, (16, size, size, 3)).astype(np.int16)
    files, labels = [], []
    for c in range(n_classes):
        folder = Path(root) / f'id_{c:04d}'
        folder.mkdir()
        shade = smooth(per_class, 5) // 8 - 16
        for i in range(per_class):
            img = np.clip(base[c] + shade[i] + noise[(c + i) % 16], 0, 255)
            files.append(write_image_file(folder / f'{i:04d}',
                                          img.astype(np.uint8)))
            labels.append(c)
    return files, np.asarray(labels)


def decoder_line(native):
    """The rows a file phase decoded through the native library, failing
    where it decoded none."""
    rows = native.rows_decoded()
    require(rows > 0, 'no row of this path decoded through the native '
            'library')
    return f'native library ({native.library_source()}), {rows} rows'


@contextlib.contextmanager
def native_off(native):
    """The port's file paths with the native library turned off, as
    tests/test_torch_letterbox.py turns it off: they decode with PIL."""
    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def max_diff(got, want):
    """max |got - want| over two uint8 images, failing on another shape."""
    require(got is not None and got.shape == want.shape,
            f'decoded {None if got is None else got.shape}, want '
            f'{want.shape}')
    return int(np.abs(got.astype(np.int32) - want).max())


def native_equals_pil(native, letterbox, files, big):
    """Phase 45, continued: the native decode against PIL's, which decodes
    with the same libjpeg-turbo where the library links Pillow's: 64 of
    phase 46's 250x250 JPEGs at full size and letterboxed into 96x96, and
    the 32 1080x1440 scene JPEGs letterboxed into 480x640 (both at the DCT
    scale 1/2; PIL's side is `letterbox_file` with the library off, which
    forces that scale), each at max |d| = 0."""
    try:
        import PIL
        from PIL import Image
    except ImportError:
        print('  PIL is not installed: no decode to hold the library to')
        return
    t0 = time.monotonic()
    sample = files[::len(files) // 64][:64]
    require(all(f.suffix == '.jpg' for f in sample + big),
            'PIL wrote no JPEGs')
    worst = {'full': 0, (96, 96): 0, (480, 640): 0}
    for path in sample:
        with Image.open(path) as img:
            want = np.asarray(img.convert('RGB'))
        worst['full'] = max(worst['full'], max_diff(
            native.decode_image_native_size(path), want))
    for path, target in ([(f, (96, 96)) for f in sample]
                         + [(f, (480, 640)) for f in big]):
        got = native.decode_image(path, target, native.MODE_LETTERBOX)
        with native_off(native):
            want, _, _ = letterbox.letterbox_file(
                path, lambda h, w, target=target: target)
        worst[target] = max(worst[target], max_diff(got, want))
    print(f'  the native decode against PIL {PIL.__version__}\'s: '
          f'{len(sample)} of phase 46\'s JPEGs at full size max |d| '
          f'{worst["full"]}, letterboxed into 96x96 (DCT 1/2) max |d| '
          f'{worst[96, 96]}; {len(big)} 1080x1440 scene JPEGs into 480x640 '
          f'(DCT 1/2) max |d| {worst[480, 640]} ({time.monotonic() - t0:.1f}'
          ' s)')
    require(max(worst.values()) == 0, 'the native decode differs from PIL\'s')


def slice13_phases(rng, context):
    """Phases 45-48 (see the module docstring): the native image library
    and the file-reading paths on the card; every launch count and the
    native row count reset just before each path and read just after."""
    import tempfile

    import torch

    from facenet_tpu_torch import native, statistics
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.dataset import Database, ImageLoader, PKPipeline
    from facenet_tpu_torch.detectors.evaluation import iou_matrix
    from facenet_tpu_torch.detectors.face_detector import FaceDetector
    from facenet_tpu_torch.detectors.mtcnn import letterbox
    from facenet_tpu_torch.facenet import evaluate_embeddings
    from facenet_tpu_torch.pipeline import FacePipeline
    from facenet_tpu_torch.train.softmax import SoftmaxTrainer
    from facenet_tpu_torch.utils.timing import spread

    smi, facenet = context['smi'], context['facenet']
    started = time.monotonic()

    # 45. the library
    print(f'[45] the native image library (facenet_tpu_torch/native): '
          f'{context["native_probe"]}')
    t0 = time.monotonic()
    require(native.available(), f'the native library did not build:\n'
            f'{native.build_error()}')
    source = native.library_source()
    variant = source.partition(':')[0]
    linked = ''
    if variant == 'pillow':
        linked = ' against ' + ', '.join(
            lib.name for lib in native.pillow_libs()[1:])
    print(f'  {native.library_path(variant).name} loaded (built at its first '
          f'use; {time.monotonic() - t0:.1f} s here); library_source() = '
          f'{source}{linked}')
    sizes = [tuple(int(v) for v in rng.integers(1, 700, 4))
             for _ in range(12)]
    sizes += [(1, 300, 480, 640), (300, 1, 480, 640), (200, 300, 1, 90),
              (200, 300, 90, 1), (1080, 1440, 540, 720)]
    worst = 0
    for h, w, th, tw in sizes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.zeros((th, tw, 3), np.uint8)
        letterbox._letterbox_into(want, img, h, w)
        worst = max(worst, max_diff(native.letterbox_array(img, (th, tw)),
                                    want))
    with tempfile.TemporaryDirectory() as tmp:
        img = rng.integers(0, 256, (97, 203, 3), dtype=np.uint8)
        write_png(Path(tmp) / 'a.png', img)
        png_equal = np.array_equal(
            native.decode_image_native_size(Path(tmp) / 'a.png'), img)
    print(f'  letterbox_array vs the numpy restatement on {len(sizes)} '
          f'sizes (1-pixel sides included): max |d| {worst}; PNG decode '
          f'{"equal" if png_equal else "NOT equal"} to the written array')
    require(worst == 0 and png_equal, 'the native library disagrees')

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / 'faces'
        root.mkdir()
        t0 = time.monotonic()
        files, _ = face_files(rng, root, 100, 20)
        made_s = time.monotonic() - t0
        nbytes = sum(f.stat().st_size for f in files)
        scenes = Path(tmp) / 'scenes'
        scenes.mkdir()
        big, _, _ = detection_scenes(48, 32, BIG_SCENE, 30, 150)
        big = np.repeat(np.repeat(big, 2, axis=1), 2, axis=2)
        paths = ([write_image_file(scenes / f's{i:02d}', img)
                  for i, img in enumerate(context['images'][:32])]
                 + [write_image_file(scenes / f'b{i:02d}', img)
                    for i, img in enumerate(big)])
        native_equals_pil(native, letterbox, files, paths[32:])

        # 46. validate from files
        print(f'[46] validate from files: {len(files)} 250x250 '
              f'{files[0].suffix} files in 100 identity folders '
              f'({nbytes / len(files) / 1e3:.1f} kB a file, made in '
              f'{made_s:.1f} s) -> Database -> BatchLoader(ImageLoader(160)) '
              '-> FaceNet bf16 -> evaluate_embeddings -> FaceToFaceValidation'
              ' (cuda)')
        db = Database(root)
        loader = ImageLoader(size=160)
        vcfg = Config({'metric': 0, 'nrof_folds': 10, 'far_target': 1e-3})
        for n in (128, len(files) % 128):       # the chain's batch shapes
            facenet.evaluate(np.zeros((n, 160, 160, 3), np.uint8))
        reset_launches()
        native.reset_rows_decoded()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs, labels = evaluate_embeddings(
            facenet.dispatch, db.batches(loader, 128))
        t1 = time.perf_counter()
        report = statistics.FaceToFaceValidation(embs, labels, vcfg,
                                                 device='cuda')
        chain_s = time.perf_counter() - t0
        report_s = time.perf_counter() - t1
        counts = read_launches()
        decoder = decoder_line(native)
        t0 = time.perf_counter()
        for _ in db.batches(loader, 128):
            pass
        loader_s = time.perf_counter() - t0
        with native_off(native):
            t0 = time.perf_counter()
            for _ in db.batches(loader, 128):
                pass
            pil_loader_s = time.perf_counter() - t0
        decoded = np.stack([loader(f) for f in db.files])
        ref = np.concatenate([facenet.evaluate(decoded[s:s + 128])
                              for s in range(0, len(decoded), 128)])
        cos = (embs * ref).sum(1) / np.linalg.norm(ref, axis=1)
        require(embs.shape == (2000, 512) and np.isfinite(embs).all()
                and np.array_equal(labels, db.labels),
                'validate from files: bad rows')
        require(cos.min() >= 0.99999, f'validate from files: min cosine '
                f'{cos.min()} to FaceNet on the decoded arrays')
        require(counts == only(pair_below_counts=30),
                f'expected 30 pair_below_counts launches alone, got {counts}')
        accuracy = report.dict['MaximumAccuracy']['accuracy']
        require(np.isfinite(accuracy), 'non-finite report')
        print(f'  decoder: {decoder}; rows in order, min cosine '
              f'{cos.min():.7f} to FaceNet on the decoded arrays; kernel '
              f'launches {counts}; accuracy {accuracy:.4f}')
        print(f'  on {smi}: the loader alone {len(files) / loader_s:.1f} '
              f'img/s (the library off, PIL: {len(files) / pil_loader_s:.1f} '
              f'img/s); the chain {chain_s:.3f} s = {len(files) / chain_s:.1f}'
              f' img/s as issued, {report_s:.3f} s of it the 10-fold '
              f'validation; phase 18 (arrays in memory, no decode) '
              f'{context["extract_rate"]:.1f} img/s, its loader '
              f'{context["extract_loader_rate"]:.1f} img/s')

        # 47. train from files
        print('[47] train from files: PKPipeline(ImageLoader(160)) 20 x 5 '
              'over the same tree -> SoftmaxTrainer, full-width IRv1 + '
              f'{VGGFACE2_CLASSES}-way head, bf16, 20 steps at batch 100 '
              '(cuda)')
        pk_config = {'nrof_classes_per_batch': 20,
                     'nrof_examples_per_class': 5}
        pk_rate = {}
        for off in (False, True):
            with native_off(native) if off else contextlib.nullcontext():
                t0 = time.perf_counter()
                probe_pk = PKPipeline(loader, db.classes,
                                      Config(dict(pk_config)), seed=1)
                for _ in range(10):
                    next(probe_pk)
                pk_rate[off] = 1000 / (time.perf_counter() - t0)
        trainer = SoftmaxTrainer(train_config(), VGGFACE2_CLASSES,
                                 device='cuda')
        state = trainer.init_state(seed=0)
        state, _ = trainer.step_fn(state, *trainer.placed(*next(PKPipeline(
            loader, db.classes, Config(dict(pk_config)), seed=2))))
        pk = PKPipeline(loader, db.classes, Config(dict(pk_config)), seed=0)
        reset_launches()
        native.reset_rows_decoded()
        torch.cuda.synchronize()
        entropies, waits = [], []
        t0 = time.perf_counter()
        for _ in range(20):
            t1 = time.perf_counter()
            images, labels = next(pk)
            waits.append(time.perf_counter() - t1)
            state, metrics = trainer.step_fn(state,
                                             *trainer.placed(images, labels))
            entropies.append(metrics['cross_entropy'])
        entropies = [float(v) for v in entropies]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_launches()
        decoder = decoder_line(native)
        first, last = np.mean(entropies[:5]), np.mean(entropies[-5:])
        print(f'  decoder: {decoder}; cross-entropies '
              f'{" ".join(f"{v:.3f}" for v in entropies)}; kernel launches '
              f'{counts}')
        require(np.isfinite(entropies).all() and last < first,
                f'cross-entropy not falling from files: {first} -> {last}')
        require(counts == only(), f'training launched kernels: {counts}')
        print(f'  on {smi}: the loader alone {pk_rate[False]:.1f} img/s '
              f'(the library off, PIL: {pk_rate[True]:.1f} img/s = '
              f'{1e5 / pk_rate[True]:.1f} ms a batch, all of which a step '
              f'waits there: that path decodes in next(), nothing ahead); '
              f'20 steps from files {run_s:.3f} s = {2000 / run_s:.1f} img/s '
              f'(phase 25 in memory: {100e3 / context["train_ms"]:.1f} img/s '
              f'as issued); the loader\'s wait a step '
              f'{1e3 * np.mean(waits):.1f} ms (max {1e3 * max(waits):.1f})')
        del trainer, state

        # 48. detect from files
        print('[48] detect from files: 64 scene files (32 480x640, 32 '
              '1080x1440) -> FaceDetector(image_shapes=[(480, 640), (540, '
              '720)]).detect_files, batches of 16; then FacePipeline'
              '.process_files on the 480x640 half, batches of 8 (cuda)')
        det = FaceDetector(image_shapes=[SCENE, BIG_SCENE], device='cuda')
        det.detect_files(paths[:1] + paths[-1:], batch_size=16)  # build
        reset_launches()
        native.reset_rows_decoded()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        found = det.detect_files(paths, batch_size=16)
        files_s = time.perf_counter() - t0
        counts = read_launches()
        decoder = decoder_line(native)
        require(counts == only(pnet_pyramid=4, crop_resize=8, nms_greedy=4),
                f'expected 4 pnet_pyramid (2 batches a bucket), 8 '
                f'crop_resize and 4 nms_greedy launches, got {counts}')
        # the cascade one batch at a time on the same decoded canvases
        worst_box = worst_score = 0.0
        decode_ms, pil_ms, cascade_ms, n_found = [], [], [], 0
        worst_pil = 0
        for start in range(0, 64, 16):
            t1 = time.perf_counter()
            decoded = [letterbox.letterbox_file(p, det.route_shape)
                       for p in paths[start:start + 16]]
            decode_ms.append(1e3 * (time.perf_counter() - t1))
            with native_off(native):
                t1 = time.perf_counter()
                by_pil = [letterbox.letterbox_file(p, det.route_shape)
                          for p in paths[start:start + 16]]
                pil_ms.append(1e3 * (time.perf_counter() - t1))
            for (canvas, *place), (want, *want_place) in zip(decoded, by_pil):
                require(place == want_place, 'another placement through PIL')
                worst_pil = max(worst_pil, max_diff(canvas, want))
            backend = det.backend_for(decoded[0][0].shape[:2])
            batch = np.stack([canvas for canvas, _, _ in decoded])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = backend.detect_batch(batch)
            cascade_ms.append(1e3 * (time.perf_counter() - t1))
            for i, (_, scale, (left, top)) in enumerate(decoded):
                want = det._boxes_from_output(out, i, scale, left, top)
                got = found[start + i]
                require(len(got) == len(want), f'file {start + i}: '
                        f'{len(got)} faces, {len(want)} on its canvas')
                if not want:
                    continue
                a = np.array([[b.left, b.top, b.right, b.bottom]
                              for b in want], np.float64)
                b = np.array([[g.left, g.top, g.right, g.bottom]
                              for g in got], np.float64)
                match = iou_matrix(a, b).argmax(axis=1)
                require(sorted(match) == list(range(len(b))),
                        f'file {start + i}: faces do not match by IoU')
                worst_box = max(worst_box, float(np.abs(a - b[match]).max()))
                worst_score = max(worst_score, max(
                    abs(want[k].confidence - got[j].confidence)
                    for k, j in enumerate(match)))
                n_found += len(want)
        print(f'  decoder: {decoder}; {n_found} faces in 64 files, the '
              f'same as the cascade one batch at a time on the decoded '
              f'canvases: boxes within {worst_box:.1f} px (pixel-rounded), '
              f'scores within {worst_score:.4f}; kernel launches {counts}; '
              f'the canvases through PIL max |d| {worst_pil}')
        require(n_found >= 64 and worst_box <= 2 and worst_score <= 0.02,
                f'detect_files off the canvases: {n_found} faces, boxes '
                f'{worst_box} px, scores {worst_score}')
        require(worst_pil == 0, 'the canvases differ through PIL')
        print(f'  on {smi}: detect_files {files_s:.3f} s = '
              f'{64 / files_s:.1f} scenes/s; a batch of 16 decoded '
              f'(letterbox_file, serial) in {spread(decode_ms)} ms '
              f'(480x640 | 1080x1440; the library off, PIL: '
              f'{spread(pil_ms)} ms), the cascade on it in '
              f'{spread(cascade_ms)} ms')

        pipe = FacePipeline(facenet, image_shape=SCENE, align='landmarks')
        pipe.process_files(paths[:8], batch_size=8)               # warm
        reset_launches()
        native.reset_rows_decoded()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, _, valid = pipe.process_files(paths[:32], batch_size=8)
        pipe_s = time.perf_counter() - t0
        counts = read_launches()
        decoder = decoder_line(native)
        want = pipe.process_batch(np.stack(
            [letterbox.letterbox_file(p, lambda h, w: SCENE)[0]
             for p in paths[:8]]))
        norms = np.linalg.norm(emb[valid], axis=-1)
        agree = (emb[:8] * want['embeddings']).sum(-1)[valid[:8]]
        print(f'  process_files: decoder: {decoder}; {int(valid.sum())} '
              f'faces, min cosine {agree.min():.6f} to process_batch on the '
              f'first 8 scenes; kernel launches {counts}; {pipe_s:.3f} s = '
              f'{32 / pipe_s:.1f} scenes/s on {smi}')
        require(counts == only(pnet_pyramid=4, dense_warp=4,
                               crop_resize=12, nms_greedy=4),
                f'expected 4 pnet_pyramid, 4 dense_warp, 12 crop_resize and '
                f'4 nms_greedy launches, got {counts}')
        require(np.array_equal(valid[:8], want['valid'])
                and np.abs(norms - 1).max() < 1e-3 and agree.min() >= 0.999,
                'process_files differs from process_batch on the arrays')
    print(f'  phases 45-48 in {time.monotonic() - started:.1f} s on {smi}')


# a batch's crops in the benchmark's pipeline cells: (part, scenes, boxes a
# scene, side, box px)
CROP_CELLS = (
    ('crowd-b8', (('R-Net', 8, 64, 24, (12, 300)),
                  ('O-Net', 8, 32, 48, (12, 300)),
                  ('alignment', 8, 32, 240, (40, 180)))),
    ('single-b64', (('R-Net', 64, 64, 24, (12, 300)),
                    ('O-Net', 64, 32, 48, (12, 300)),
                    ('box crop', 64, 1, 160, (56, 200)))))


def crop_boxes(rng, b, k, px, shape):
    """[b, k, 4] float32 (x1, y1, x2, y2) boxes of px[0]-px[1] pixels on
    the card, centred anywhere in the scene (so some cross its edge)."""
    import torch
    side = rng.uniform(*px, (b, k, 1)) * rng.uniform(0.8, 1.25, (b, k, 2))
    centre = rng.uniform(0, 1, (b, k, 2)) * np.array(shape[::-1])
    boxes = np.concatenate([centre - side / 2, centre + side / 2], -1)
    return torch.from_numpy(boxes.astype(np.float32)).cuda()


def crop_positions(boxes, size, shape):
    """The crops' sample positions (ys, xs), each [B, K, size], in source
    pixels (centres at whole numbers), as the crop computes them."""
    import torch
    grid = (torch.arange(size, dtype=torch.float32, device=boxes.device)
            + 0.5) / size

    def along(lo, hi):
        return lo[..., None] + grid * (hi - lo)[..., None] - 0.5

    return (along(boxes[..., 1], boxes[..., 3]),
            along(boxes[..., 0], boxes[..., 2]))


def crop_touched(boxes, size, shape):
    """Distinct source pixels the crops' taps read: for each scene, the
    union over its boxes of tap rows x tap columns."""
    import torch
    ys, xs = crop_positions(boxes, size, shape)

    def taps(pos, n):
        f = torch.floor(pos)
        return torch.cat([f.clamp(0, n - 1), (f + 1).clamp(0, n - 1)],
                         -1).long()

    touched = 0
    for y, x in zip(taps(ys, shape[0]), taps(xs, shape[1])):
        mask = torch.zeros(shape, dtype=torch.bool, device=boxes.device)
        mask[y[:, :, None], x[:, None, :]] = True
        touched += int(mask.sum())
    return touched


def crop_phase(rng, context):
    """Phase 49 (see the module docstring); returns the kernels-line entry
    of the crop kernel, its times those of a crowd-b8 batch."""
    import torch
    import torch.nn.functional as F

    from facenet_tpu_torch.ops import crop
    from facenet_tpu_torch.pipeline import FacePipeline
    from facenet_tpu_torch.utils.timing import cuda_ms, device_ms

    smi = context['smi']
    print('[49] the crop kernel vs plain at the pipeline cells\' crop shapes '
          f'(480x640 scenes of noise), then times on {smi}: the kernel and '
          'F.grid_sample in device time, the plain version by CUDA events')
    torch.cuda.empty_cache()        # the plain version's broadcasts
    errs, batch_ms = [], {}
    for cell, parts in CROP_CELLS:
        total = dict.fromkeys(('kernel', 'plain', 'library', 'bound'), 0.0)
        scenes = torch.from_numpy(rng.integers(
            0, 256, (parts[0][1], *SCENE, 3), dtype=np.uint8)).cuda().float()
        nchw = scenes.permute(0, 3, 1, 2).contiguous()
        for part, b, k, size, px in parts:
            boxes = crop_boxes(rng, b, k, px, SCENE)
            got = crop.crop_and_resize(scenes, boxes, size)
            torch.cuda.synchronize()
            want = crop.crop_and_resize_plain(scenes, boxes, size)
            err = float((got - want).abs().max())
            del got, want
            errs.append(err)
            require(err <= 1e-3,
                    f'crop kernel != plain ({cell}, {part}): {err}')
            kern_ms = device_ms(
                lambda: crop.crop_and_resize(scenes, boxes, size), reps=20)[0]
            plain_ms = cuda_ms(
                lambda: crop.crop_and_resize_plain(scenes, boxes, size),
                reps=2)[0]
            # the library's bilinear sampler at the same positions,
            # channels first, clamped to the border
            ys, xs = crop_positions(boxes, size, SCENE)
            xn = ((2 * xs + 1) / SCENE[1] - 1)[:, :, None, :]
            yn = ((2 * ys + 1) / SCENE[0] - 1)[:, :, :, None]
            grid = torch.stack(torch.broadcast_tensors(xn, yn), -1).reshape(
                b, k * size, size, 2)
            lib_ms = device_ms(lambda: F.grid_sample(
                nchw, grid, mode='bilinear', padding_mode='border',
                align_corners=False), reps=20)[0]
            nbytes = 4 * (b * k * size * size * 3 + boxes.numel()
                          + 3 * crop_touched(boxes, size, SCENE))
            bound_ms = nbytes / H100_HBM_BYTES * 1e3
            print(f'  {cell} {part}: {b} x {k} crops of {size} px, max '
                  f'|kernel - plain| {err:.3e}; kernel {kern_ms:.4f} ms, '
                  f'bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB: crops '
                  f'written, '
                  f'taps\' pixels read), plain {plain_ms:.3f} ms, '
                  f'F.grid_sample {lib_ms:.4f} ms')
            for key, ms in (('kernel', kern_ms), ('plain', plain_ms),
                            ('library', lib_ms), ('bound', bound_ms)):
                total[key] += ms
        print(f'  {cell}, a batch\'s three crops: kernel {total["kernel"]:.4f}'
              f' ms = {total["kernel"] / total["bound"]:.2f} x its bound '
              f'{total["bound"]:.4f}; plain {total["plain"]:.3f} ms; '
              f'F.grid_sample {total["library"]:.4f} ms')
        batch_ms[cell] = total
        del scenes, nchw
        torch.cuda.empty_cache()

    counts = {}
    for align, warps in (('crop', 0), ('landmarks', 1)):
        pipe = FacePipeline(context['facenet'], image_shape=SCENE,
                            align=align)
        pipe.process_batch(context['images'][:16])           # warm
        reset_launches()
        pipe.process_batch(context['images'][16:32])
        counts[align] = read_launches()
        require(counts[align] == only(pnet_pyramid=1, dense_warp=warps,
                                      crop_resize=3, nms_greedy=1),
                f'{align}: expected 1 pnet_pyramid, {warps} dense_warp, 3 '
                f'crop_resize and 1 nms_greedy launches a batch, got '
                f'{counts[align]}')
    print(f'  one FacePipeline batch of 16: launches {counts}')
    crowd = batch_ms['crowd-b8']
    return {
        'name': 'crop_resize',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/crop_resize.cu',
        'replaces': None,
        'launches': counts['landmarks']['crop_resize'],
        'max_abs_err': max(errs),
        'ms': crowd['kernel'],
        'plain_ms': crowd['plain'],
        'bound_ms': crowd['bound'],
        'bound_by': 'bytes',
        'library_ms': crowd['library'],
    }



# float32 operations of one pair test and one area of the greedy NMS
# (benchmark/core/retina_work.py counts them the same way)
NMS_PAIR_OPS, NMS_AREA_OPS = 16, 7
# (label, frames, candidates, IoU threshold, mode, offset, keep capacity)
NMS_CELLS = (('RetinaFace', 8, 5000, 0.4, 'union', 1.0, 750),
             ("MTCNN's O-Net", 16, 32, 0.7, 'min', 0.0, None))


def nms_candidates(rng, b, k, shape=(1080, 1920)):
    """Sorted candidates on the card: boxes [b, k, 4] of 16-300 px over
    the frame, 90% valid, in descending order of uniform scores."""
    import torch
    centre = rng.uniform(0, 1, (b, k, 2)) * np.array(shape[::-1])
    side = rng.uniform(16, 300, (b, k, 1)) * rng.uniform(0.7, 1.4, (b, k, 2))
    boxes = np.concatenate([centre - side / 2, centre + side / 2], -1)
    valid = rng.uniform(0, 1, (b, k)) < 0.9
    scores = np.where(valid, rng.uniform(0, 1, (b, k)), -np.inf)
    order = np.argsort(-scores, axis=1, kind='stable')
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    valid = np.take_along_axis(valid, order, 1)
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


def nms_pair_tests(boxes, valid, iou_threshold, mode, offset):
    """[B] pair tests that exact greedy NMS makes on sorted candidates:
    each kept candidate against every later valid one that no kept
    candidate before it suppressed (py_cpu_nms's count). A later j is
    tested by the kept i < j up to and including its first kept
    suppressor."""
    import torch

    from facenet_tpu_torch.ops import nms
    b, k = valid.shape
    keep, _ = nms.greedy_keep_plain(boxes, valid, iou_threshold, mode,
                                    offset)
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    by_kept = ((nms.iou_matrix(boxes, mode, offset) > iou_threshold)
               & later & keep[..., :, None])              # [B, i, j]
    index = torch.arange(k, device=boxes.device).expand(b, k)
    first = torch.where(by_kept.any(1), by_kept.to(torch.uint8).argmax(1),
                        k)
    limit = torch.minimum(first + 1, index)
    before = torch.nn.functional.pad(torch.cumsum(keep, -1), (1, 0))
    return (torch.gather(before, 1, limit) * valid).sum(-1)


def nms_phase(rng, context):
    """Phase 50 (see the module docstring); returns the kernels-line entry
    of the NMS kernel, its times those of a RetinaFace batch."""
    import torch

    from facenet_tpu_torch.ops import nms
    from facenet_tpu_torch.pipeline import FacePipeline
    from facenet_tpu_torch.utils.timing import cuda_ms, device_ms

    smi = context['smi']
    print('[50] the NMS kernel vs the loop at RetinaFace\'s and O-Net\'s '
          f'shapes, then times on {smi}: the kernel in device time, the '
          'loop by CUDA events')
    entry = None
    for label, b, k, thr, mode, offset, cap in NMS_CELLS:
        boxes, valid = nms_candidates(rng, b, k)
        keep, kept = nms.greedy_keep(boxes, valid, thr, mode, offset, cap)
        torch.cuda.synchronize()
        want, count = nms.greedy_keep_plain(boxes, valid, thr, mode, offset,
                                            cap)
        require(torch.equal(keep, want) and torch.equal(kept, count),
                f'NMS kernel != loop ({label})')
        kern_ms = device_ms(lambda: nms.greedy_keep(
            boxes, valid, thr, mode, offset, cap), reps=20)[0]
        loop_ms = cuda_ms(lambda: nms.greedy_keep_plain(
            boxes, valid, thr, mode, offset, cap), reps=1, windows=1)[0]
        n = valid.sum(1).double()
        tested = nms_pair_tests(boxes, valid, thr, mode, offset).double()
        ops = float((NMS_PAIR_OPS * tested + NMS_AREA_OPS * n).sum())
        nbytes = float(17 * n.sum() + b * (k + 4))
        bound_ms = max(ops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES) * 1e3
        print(f'  {label}: {b} x {k} candidates, kept {int(kept.min())}-'
              f'{int(kept.max())} a frame, equal to the loop; kernel '
              f'{kern_ms:.4f} ms, bound {bound_ms:.4f} ms ({ops:.3e} '
              f'operations at the FP32 rate) = {bound_ms / kern_ms:.1%}, '
              f'loop {loop_ms:.2f} ms')
        if entry is None:
            entry = {'name': 'nms_greedy', 'route': 'cuda',
                     'source': 'facenet_tpu_torch/csrc/nms_greedy.cu',
                     'replaces': None, 'max_abs_err': 0.0, 'ms': kern_ms,
                     'plain_ms': loop_ms, 'bound_ms': bound_ms,
                     'bound_by': 'operations', 'library_ms': None}
        del boxes, valid, keep, want

    frames = rng.integers(0, 256, (8, 1080, 1920, 3), dtype=np.uint8)
    pipe = FacePipeline(context['facenet'], image_shape=(1080, 1920),
                        align='landmarks', num_faces=16,
                        detector='retinaface')
    pipe.process_batch(frames)                                  # warm
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.process_batch(frames)
    wall = time.perf_counter() - t0
    counts = read_launches()
    print(f'  RetinaFace-R50 FacePipeline batch of 8 1080x1920 frames: '
          f'{int(out["valid"].sum())} valid slots of 128, '
          f'{int(out["candidates"].min())}-{int(out["candidates"].max())} '
          f'candidates a frame, {wall * 1e3:.1f} ms, launches {counts}')
    require(counts == only(nms_greedy=1, crop_resize=1, dense_warp=1),
            f'expected 1 nms_greedy, 1 crop_resize and 1 dense_warp launch '
            f'a RetinaFace batch, got {counts}')
    entry['launches'] = counts['nms_greedy']
    del pipe
    torch.cuda.empty_cache()
    return entry


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false', file=sys.stderr)
        return 1

    from facenet_tpu_torch import FaceNet, statistics
    from facenet_tpu_torch.config import Config
    from facenet_tpu_torch.export import ModelBundle
    from facenet_tpu_torch.facenet import evaluate_embeddings
    from facenet_tpu_torch.models.inception_resnet_v1 import (
        InceptionResnetV1, init_variables)
    from facenet_tpu_torch.detectors.mtcnn import pnet
    from facenet_tpu_torch.ops import (crop, cuda_build, nms, pair_counts,
                                       stem, warp)
    from facenet_tpu_torch.tools import probe_native
    from facenet_tpu_torch.utils.timing import card_line, cuda_ms
    from facenet_tpu_torch.utils.timing import spread as _spread

    started = time.monotonic()
    rng = np.random.default_rng(0)

    # 1. the card
    smi = card_line()
    print(smi)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    probe = probe_native.summary()
    print(f'native image library: {probe}')

    # 2. build every kernel, one nvcc each, all started together
    t0 = time.monotonic()
    kernels = (pair_counts.KERNEL, warp.KERNEL, pnet.KERNEL,
               pnet.LEVEL_KERNEL, stem.KERNEL, crop.KERNEL, nms.KERNEL,
               copy_roof_kernel())
    libs = dict(zip((k.name for k in kernels), cuda_build.build_all(kernels)))
    print(f'[2] built {", ".join(k.library_path().name for k in kernels)} '
          f'in {time.monotonic() - t0:.1f} s')
    print_ptxas(libs['pair_below_counts'])

    # 3. kernel vs plain
    print('[3] kernel vs plain')
    errs = []
    emb, labels = clustered(rng, 128, 32, 512, 1.0)
    for metric in (0, 1):
        errs.append(compare_kernel_plain(
            pair_counts, prepared(pair_counts, emb, labels, metric),
            f'metric={metric}'))
    for n in (936, 104):        # the main path's train and test folds
        emb, labels = clustered(rng, 40, 26, 512, 1.0)
        pick = np.sort(rng.choice(emb.shape[0], n, replace=False))
        errs.append(compare_kernel_plain(
            pair_counts, prepared(pair_counts, emb[pick], labels[pick], 0),
            'metric=0'))
    emb, labels = clustered(rng, 40, 25, 17, 0.5)
    errs.append(compare_kernel_plain(
        pair_counts, prepared(pair_counts, emb, labels, 0),
        'metric=0'))

    for d in (512, 17):
        emb, _ = clustered(rng, 32, 32, d, 1.0)           # pairs at s ~ 0.5
        emb[1::7] = emb[0::7][:emb[1::7].shape[0]]        # and at s = 1
        x = torch.from_numpy(emb).cuda()
        got = pair_counts.pair_similarities(x)
        torch.cuda.synchronize()
        s64 = torch.clamp(x.double() @ x.double().T, -1.0, 1.0)
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            f32 = torch.clamp(x @ x.T, -1.0, 1.0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        err = float((got.double() - s64).abs().max())
        print(f'  N={emb.shape[0]} D={d} product: max |s - s64| kernel '
              f'(3xTF32) {err:.3e}, float32 torch.matmul '
              f'{float((f32.double() - s64).abs().max()):.3e}; max s '
              f'{float(got.max()):.7f}')
        require(err <= 5e-7 and float(got.max()) <= 1.0,
                f'3xTF32 product off float64 by {err} at D={d}')

    # 4. full-width serving
    print('[4] full-width IRv1 serving')
    variables = init_variables(seed=0)
    bundle = ModelBundle(variables, {'model_class': 'InceptionResnetV1',
                                     'config': None, 'image_size': 160,
                                     'normalization': 0})
    facenet = FaceNet(device='cuda', bundle=bundle)
    require(facenet.embedding_size == 512, 'embedding size is not 512')
    images = rng.integers(0, 256, (128, 160, 160, 3), dtype=np.uint8)
    served = facenet.evaluate(images)
    norms = np.linalg.norm(served, axis=1)
    require(served.shape == (128, 512) and np.isfinite(served).all(),
            f'bad served embeddings {served.shape}')
    require(np.abs(norms - 1).max() < 1e-5, f'norms off: {norms.min()} '
            f'{norms.max()}')
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        unfused = InceptionResnetV1().from_flax_variables(variables)
        unfused = unfused.cuda().eval()
        with torch.inference_mode():
            ref = unfused(torch.from_numpy(images).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul_precision)
    cos = (served * ref).sum(1) / np.linalg.norm(ref, axis=1)
    print(f'  bf16 fused vs f32 unfused: min cosine {cos.min():.6f}')
    require(cos.min() >= 0.995, f'min cosine {cos.min()} < 0.995')
    batch = torch.from_numpy(images).cuda()
    ms, times = cuda_ms(lambda: facenet.dispatch(batch), reps=20, warmup=10)
    print(f'  serving: {ms:.3f} ms per batch of 128 (uint8 on the card; '
          f'windows {_spread(times)}) = {128e3 / ms:.1f} embeddings/s')

    # 5. main path: serve -> 10-fold validation on the card
    print('[5] main path: FaceNet -> evaluate_embeddings -> '
          'FaceToFaceValidation (cuda)')
    vcfg = Config({'metric': 0, 'nrof_folds': 10, 'far_target': 1e-3})
    reset_launches()
    t0 = time.monotonic()
    embs, labs = evaluate_embeddings(
        facenet.dispatch, synthetic_batches(rng, 40, 26, 128))
    report = statistics.FaceToFaceValidation(embs, labs, vcfg, device='cuda')
    path_s = time.monotonic() - t0
    counts = read_launches()
    launches = counts['pair_below_counts']
    print(f'  {embs.shape[0]} embeddings, {path_s:.2f} s, kernel launches '
          f'{counts}')
    require(embs.shape == (1040, 512) and np.isfinite(embs).all(),
            'bad main-path embeddings')
    require(counts == only(pair_below_counts=30),
            f'expected 30 pair_below_counts launches alone, got {counts}')
    for crit, values in report.dict.items():
        require(all(np.isfinite(v) for v in values.values()),
                f'non-finite report values in {crit}')
        print(f'  {crit}: accuracy {values["accuracy"]:.5f} '
              f'threshold {values["threshold"]:.5f}')

    sep_rng = np.random.RandomState(1)
    centres = sep_rng.randn(6, 32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    sep = np.repeat(centres, 16, axis=0) + 0.1 * sep_rng.randn(96, 32)
    sep = (sep / np.linalg.norm(sep, axis=1, keepdims=True)).astype(np.float32)
    sep_labels = np.repeat(np.arange(6), 16)
    for metric in (0, 1):
        cfg = Config({'metric': metric, 'nrof_folds': 5, 'far_target': 0.01})
        on_card = statistics.FaceToFaceValidation(sep, sep_labels, cfg,
                                                  device='cuda').dict
        on_cpu = statistics.FaceToFaceValidation(sep, sep_labels, cfg,
                                                 device='cpu').dict
        worst = max(abs(on_card[c][k] - on_cpu[c][k])
                    for c in on_cpu for k in on_cpu[c])
        print(f'  separated set, metric {metric}: max |cuda - cpu| '
              f'{worst:.3e}')
        require(worst <= 1e-6, f'cuda report != cpu report ({worst})')

    # 6. timing at the main path's validation shape
    n, d, t = 23840, 512, 100
    print(f'[6] timing N={n} D={d} T={t}')
    emb, labels = clustered(rng, 917, 26, d, 1.0)
    emb, labels = emb[:n], labels[:n]
    inputs = prepared(pair_counts, emb, labels, 0, t)
    errs.append(compare_kernel_plain(pair_counts, inputs, 'metric=0'))
    kern_ms, kern_all = cuda_ms(lambda: pair_counts.pair_histogram(inputs),
                                reps=5)
    plain_ms, plain_all = cuda_ms(
        lambda: pair_counts.pair_histogram_plain(inputs), reps=3)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms, library_all = cuda_ms(
            lambda: torch.matmul(inputs.embeddings, inputs.embeddings.T),
            reps=5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    flops = n * (n - 1) / 2 * 2 * d
    nbytes = n * d * 4 + n * (4 + 8 + 8) + t * 4 + 2 * (t + 1) * 8
    fp32_ms = flops / H100_FP32_FLOPS * 1e3
    ops_ms = 3 * flops / H100_TF32_FLOPS * 1e3     # what the kernel runs
    bytes_ms = nbytes / H100_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f'  kernel {kern_ms:.3f} ms ({_spread(kern_all)}), plain '
          f'{plain_ms:.3f} ms ({_spread(plain_all)}), f32 matmul of the '
          f'full N x N product {library_ms:.3f} ms ({_spread(library_all)}), '
          f'bound {bound_ms:.3f} ms (3 x {flops:.3e} flop at the TF32 '
          f'tensor-core rate; {fp32_ms:.3f} ms at the FP32 rate)')
    pair_inputs = (emb, labels, inputs)
    for label, (ms, windows) in pair_split_times(pair_counts, emb, labels,
                                                 t).items():
        print(f'  kernel at {label}: {ms:.3f} ms ({_spread(windows)})')

    # a whole 10-fold validation at the reference eval size, host included
    n = 26489
    emb, labels = clustered(rng, 1019, 26, d, 1.0)
    vcfg = Config({'metric': 0, 'nrof_folds': 10, 'far_target': 1e-3})
    torch.cuda.synchronize()
    t0 = time.monotonic()
    full = statistics.FaceToFaceValidation(emb[:n], labels[:n], vcfg,
                                           device='cuda')
    validation_s = time.monotonic() - t0
    accuracy = full.dict['MaximumAccuracy']['accuracy']
    require(np.isfinite(accuracy), 'non-finite accuracy at full size')
    print(f'  10-fold validation of {n} x {d} on the card: '
          f'{validation_s:.3f} s wall (accuracy {accuracy:.5f})')

    pair_entry = {
        'name': 'pair_below_counts',
        'route': 'cuda',
        'source': 'facenet_tpu_torch/csrc/pair_below_counts.cu',
        'replaces': 'facenet_tpu/ops/pallas_stats.py:73',
        'launches': launches,
        'max_abs_err': max(errs),
        'ms': kern_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': library_ms,
    }
    context, detection = detection_phases(rng, libs, bundle)
    context.update(smi=smi, variables=variables, facenet=facenet,
                   bundle=bundle, pair_inputs=pair_inputs, pair_ms=kern_ms,
                   native_probe=probe)
    slice3 = slice3_phases(rng, libs, context)
    slice7_phases(rng, context)
    slice8_phases(rng, context)
    slice9_phases(rng, context)
    slice10_phases(context)
    slice11_phases(rng, context)
    slice12_phases(rng, context)
    slice13_phases(rng, context)
    crop_entry = crop_phase(rng, context)
    nms_entry = nms_phase(rng, context)

    print(f'total {time.monotonic() - started:.1f} s')
    print(json.dumps({'kernels': [pair_entry] + detection + slice3
                      + [crop_entry, nms_entry]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
