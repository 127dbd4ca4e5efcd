#!/usr/bin/env python3
"""Drive the PyTorch port (``event_representation_study_tpu_torch``) on one
CUDA card and check it.

Phases, one printed line each:
0. env: which of cv2, matplotlib, tensorboard and wandb import on this
   machine, with their versions (a report: no phase depends on it).
1. device: CUDA must be present; the card's name and power limit.
2. build: the port's CUDA kernels from ``csrc/``.
3. ergo12: ERGO-12 for 8 Gen1 windows of 50,000 events (240x304) on the
   card (kernel K1) against the plain PyTorch version on the CPU.
4. kernel_K1 / kernel_K2: each kernel against its plain version on the card
   at the serving path's shapes (sums to a stated tolerance, max and count
   columns exactly, bit-identical across two launches), and its time beside
   its bound, the plain version's and ``index_add_`` + ``scatter_reduce_``'s.
   kernel_hard_shapes: K1/K2 on shapes the serve path does not give them (a
   hot pixel, a tile spanning many chunks, an empty row, N % 4 != 0, an odd
   S, the widest column counts of one launch (Ks=32, Km=16), a table wider
   than that (Ks=36, Km=3: two column groups, two launches) and the
   narrowest, the event stack's Km=12, the time surface's 2*H*W segments,
   B=1, the event mosaic's 200,000-event rows), exactly equal to the plain
   version, with their times beside the plain version's and the library
   call's.
4b. kernel_K4_window_attn: K4, the Swin-V2 window attention core
   (``ops/window_attention.py``), forward and backward against the model's
   plain code at the Swin-V2-L detector's stage-0 (2304 windows, 6 heads,
   shifted) and stage-2 (144 windows, 24 heads) shapes at 576², batch 16:
   output, qkv, scale and bias gradients within 1e-4 of the largest,
   bit-identical across two runs; forward and backward ms beside the plain
   code's and the least time of the shape (its products' FLOPs at the
   float32 peak, or its bytes at the HBM rate).
5. serve: the full-width ``configs/gen1_optimized.py`` detector serves
   requests of 8 windows through ``make_server``; the kernel launch counters
   are zeroed before and read after, and K1 must run once per request.
   mdes_sum_only drives ``mdes_fused_batched`` on a sum-only table, the path
   of K2, the same way.
6. reference: a shrunk detector serves the same windows on the card and on
   the CPU; representation and predictions must agree, and NMS must match box
   for box on tie-free predictions at the serve shape.
7. train: the full-width detector takes train steps (``make_train_step``,
   separable image-space warp) on batches of 8 windows with the paper's
   strong augmentation planned per step; the warm-up step records the
   arguments of both per-row rolls (kernel K3). After it, 3 steps at epoch 0
   (ATSS) and 3 at epoch 5 (TAL) run with the launch counters zeroed before
   and read after: K1 must run once a step and K3 twice. Then the stages of
   a step are timed one by one (``train_stages_ms``).
8. kernel_K3: K3 against its plain version on the card at the two captured
   shapes (exactly equal, also with out-of-range starts, an odd W, bf16 and
   every vector width; bit-identical across two launches), its time beside
   its bound, the plain version's and one ``torch.gather``'s.
9. warp: the separable warp on the card (K3) against the same function on
   the CPU (plain roll) at 640 px with the paper recipe's plan.
10. train_reference: one step of a shrunk detector at 128 px on the card
   and on the CPU from the same weights: loss, gradients, updated parameters
   and BatchNorm statistics must agree.
10a. multi_step: K steps a call (``make_multi_train_step``, K = 4) of the
   full-width detector on the train phase's batch shape: from one saved
   state, 4 per-batch steps, one K = 4 call with the EMA blended every step
   and one with it blended once (``ema_cadence="dispatch"``), each timed
   after its own warm-up (ms a step, peak memory, K1 4 and K3 8 launches a
   run); the K-step call held against the per-batch steps (loss parts 1e-4
   relative, parameter updates 2e-2 of leaf scale) and the dispatch cadence
   against the step cadence (parameters as above, the EMA 2e-3, 4 EMA
   updates).
10b. bf16_train: the same detector built with ``dtype=torch.bfloat16`` from
   the saved state on the same batches: a warm-up and 6 timed steps (K1 once
   and K3 twice a step, every K3 source bf16), the first step's loss within
   1e-2 relative of the f32 step's; kernel_K3_bf16: K3 at the bf16 step's
   captured shapes against its plain version, timed beside its bound and
   ``torch.gather``; bf16_reference: the shrunk bf16 step at 128 px card vs
   CPU, within twice the CPU's own bf16-vs-f32 distances.
11. event_mosaic: the event-space strong augmentation
   (``reps/event_mosaic.py``) of 8 windows plus a partner pool of 2 at 640²
   with the paper's recipe, one K1 launch, against the same call on the CPU
   (event destinations equal, images within 0.05 on 0..255), timed; the
   train phase's ``train_stages_ms`` times it on the train batches too.
12. trainer: ``cli/train.py`` trains the full-width detector on synthetic
   Gen1 splits (written by the port's ``write_gen1_fixture``) for 2 epochs
   with ``--augment`` (epoch 0 event mosaic, epoch 1 event-space affine
   after the stop-aug boundary), evaluating each epoch (COCO on the EMA,
   ``last_ckpt``/``best_ckpt``); a fresh run resumes from ``last_ckpt`` for
   a third epoch; ``cli/eval.py`` evaluates its last checkpoint to the
   Trainer's AP. K1 runs exactly once a step and once an eval batch, K3
   never. Prints the loader's host ms per batch, step ms, the eval speed
   slots, checkpoint seconds and bytes (``trainer_host_ms``).
12a. multi_step_trainer: ``cli/train.py --steps-per-dispatch 4
   --ema-cadence dispatch`` with ``use_tensorboard`` on synthetic splits of
   5 batches an epoch (one K-step call, one remainder step) for 1 epoch and
   an eval: the calls and their launches, the step median, the "Model
   Summary" line (140.3M parameters, GFLOPs), and the TensorBoard event
   file's records (CRCs verified, a scalar event at every logged step).
13. representations: every name of ``batched_representation`` (voxel grid,
   MDES, ERGO-12, event stack, histogram, TORE, time surface) on 8 windows
   of 50,000 events at 240x304 on the card, against the same call on the
   CPU (the plain K1/K2 version), timed; the launch counters are zeroed
   before each call and read after (K2 once for histogram and voxel grid,
   K1 once for ERGO-12, event stack and time surface, none for TORE). K1
   at the event-stack and time-surface shapes and K2 at the histogram and
   voxel-grid shapes are held against their plain versions and timed
   (``kernel_K1_event_stack`` ... ``kernel_K2_voxel_grid``).
14. gwd: ``cli/gwd.py`` ranks ERGO-12 and the voxel grid on a synthetic
   Gen1 validation split (8 windows of up to 50,000 events), by the host
   loop and by ``--batched``, which must agree; the time of a sample is
   split into representation, quadrant compaction and kernel sums
   (``gwd_stages_s``). ``otmi_batched`` on the card against the CPU, and a
   matching voxel grid against a scrambled one (``gwd_checks``).
15. search: the ERGO-12 channel search (``search/optimize.py``, Gryffin) on
   the card at the study's surrogate settings (2000 BNN steps, 1000 draws,
   the 7 x 7 x 4 space with its constraint table), its objective the mean
   OTMI C_p of each candidate MDES table (K1/K2) on the gwd phase's 8
   windows; 2 channels x 6 measures instead of 12 x 100. Recommends timed
   as fit + acquisition, measures as representation + OTMI with their
   K1/K2 launches (ERGO-12 and the 36-column table measured last, two
   launches for the latter); one fit's draws card vs CPU and vs the float64
   C evaluator, that fit re-run on the CPU, its idle share from a profile,
   ``cli/bo.py`` on the card (``search_checks``).
16. gen1_published_format: the committed Gen1 fixture in the published
   format (``tests/data/gen1_blosc_seed7.h5``: superblock v0, Blosc-ZSTD
   chunks, written by h5py) read where h5py is absent, through
   ``events/h5lite.py``; the same fixture written here unfiltered by the
   port's writer; ``Gen1H5`` count and time windows and every window query
   of ``H5EventHandle`` read both bit-equal; ERGO-12 of the Blosc windows on
   the card (K1) against the CPU; the read time per window.
17. classify: ``cli/classify.py`` at full width (ResNet34, stem kernel 14,
   12 channels, 100 classes, ERGO-12 on K1 at 224², slices of 30,000 events,
   batch 64, float32) for 2 epochs on a synthetic npz tree of 192 + 64
   samples; K1 exactly once a train step and once an eval batch; the train
   step ms, eval ms per image, ``load_s``/``infer_s`` per epoch, peak memory;
   the step's stages timed one by one (``classify_stages_ms``).
18. classify_reference: one classifier step (ResNet18, 64²) card vs CPU from
   the same weights, with Adam and with SGD: loss, logits and BN statistics
   in float32, and the parameter updates in float64.
19. kernel_K1_nimagenet: K1 at the classification shape (B 64, N 30,000,
   S 50,176, Ks 18, Km 3) against its plain version, timed beside its
   bound and the library call.
20. zoo: each other detector family of ``configs/`` at full width and depth
   (``gen1_efficientrep``: RepVGG EfficientRep + CSPRepBiFPANNeck, 151.0M;
   ``gen1_lite``: 1.3M; ``gen1_resnet50``: 44.6M; ``gen1_swinvit``: the
   Swin-V2-L, 216.4M; the last two at 576²) serves 3 requests of 8 windows
   through ``make_server`` (K1 once each) and takes a warm-up and 3 timed
   train steps through ``make_train_step`` with the separable warp (K1
   once, K3 twice a step); parameters, request and step medians, peak
   memory and launches per config. K3 at each step shape that the paper
   step (phase 7) does not give (576²) is held against its plain version
   and timed on the arguments of that config's warm-up step
   (``kernel_K3_<config>``).
21. zoo_half: ``cli/eval.py --task speed`` of the paper detector on a
   synthetic validation split of 64 windows, float32 and ``--half`` (bf16
   compute), twice each: ms per image, and every convolution's output
   dtype (bf16 under ``--half``); the loader's batch assembly and the eval
   step with NMS apart; the detector's forward alone both ways, in NCHW and
   in the eval step's layout, with profiler traces (``zoo_half_profile``);
   one batch through both models from the same weights: the largest score
   difference (above 0) and the mean IoU of the float32 top-100 boxes
   against the bf16 boxes.
22. zoo_reference: a shrunk copy of each family of phase 20 serves the
   reference phase's windows on the card and on the CPU from the same
   weights.
23. variants: the training variants and deploy tools at the full width of
   the paper detector (batch 8 of 50,000-event windows at 640², float32):
   a fuse-ab run and a distillation run (``distill_feat``; the teacher
   written as a train checkpoint and read back by
   ``load_teacher_variables``), each a warm-up plus 3 ATSS and 3 TAL steps
   through ``make_train_step`` with the separable warp (K1 once and K3 twice
   a step; the teacher's BatchNorm statistics bit-unchanged); the learned
   representation (raw events into the quantization layer; the config's
   flips on the host, no strong aug) a warm-up plus 6 steps and an eval
   batch (K1 and K3 never);
   ``DetectBackend.detect`` on a deploy checkpoint against the eval step
   and NMS; ``cli/train.py --fuse-ab --quant --calib`` on the trainer
   phase's synthetic splits (no training, ``ptq_ckpt`` with int8 weights
   and scales equal to the same quantization on the CPU); the serving
   graph exported with ``torch.export``, saved, loaded and served 3
   requests (K1 once each; detections equal to the eager server's), with
   the export and load seconds. Step medians, peak memory and launches a
   mode.
24. variants_reference: one fuse-ab, one distill_ns (a YOLOv6s student) and
   one learned step of a shrunk detector at 128 px on the card and on the
   CPU from the same weights, held as ``train_reference`` is; the learned
   step's value layer (``quantization.*``) in a float64 step, since its
   float32 bias gradients are chaotic, every other leaf in the float32 one.
25. gen4: the 1 Mpx (Gen4) path on the 1280x720 sensor. Release-format
   files (2 recordings a split of 1,500,000 events, ``*_td.dat`` written by
   ``write_dat`` and ``*_bbox.npy`` GT with boxes of all 3 classes, one of
   class 3, one across the frame edge and one under the 60 px diagonal)
   consolidated by ``cli/consolidate.py`` (through h5lite where h5py is
   absent; Blosc whenever a codec is present), every array read back and
   checked; ``cli/convert.py --filter hot_pixel`` read back through
   ``H5EventHandle``; the loader's host time a batch of 8 Blosc windows of
   70,000 events; the full-width paper detector with 3 classes takes a
   warm-up and 3 ATSS + 3 TAL steps on 8 windows of the split at 640²
   (ERGO-12 on K1 at 1280x720, image-mode strong augmentation with K3;
   K1 once and K3 twice a step), its stages timed; 3 requests through
   ``make_server`` and ``cli/infer.py`` on a ``.dat`` file (K1 once each);
   ``cli/train.py`` for an epoch then ``cli/eval.py`` (K1 once a step and
   an eval batch, AP finite); ``cli/precompute_reps.py --limit 8`` (K1
   once), two samples against the CPU; ``kernel_K1_gen4``: K1 at B 8, N
   70,000, S 921,600 against its plain version, timed beside its bound.
26. images: original-image data. A synthetic image folder written with cv2
   (images/{train,val}, labels/{train,val}: 56 + 8 RGB frames of sizes
   drawn around 240x304, one box each, one background-only frame a
   split); the full-width paper detector at 3 channels
   (``data.type=images``) takes a warm-up and 3 ATSS + 3 TAL steps on
   batches of 8 from ``ImageBatchLoader`` with the config's recipe, the
   separable warp of the 0..255 RGB tiles on K3 (twice a step, K1 never),
   its stages timed (``images_stages_ms``) and the loader's host ms a
   batch; ``cli/train.py --override data.type=images --augment`` for an
   epoch and its COCO evaluation (AP finite, ``last_ckpt``;
   ``images_trainer``); ``cli/infer.py --source`` on a PNG and on an MJPG
   ``.avi`` with that checkpoint, ``--save-dir`` and ``--max-frames 2``
   (frames counted, files read back; ``images_demo``); ``--save-img`` on a
   Gen1 event file (K1 once; ``images_save_img``); a reference-style state
   dict of ``configs/swinv2_yolov6l6_finetune.py`` in half precision
   imported by ``utils/torch_convert.py`` and served on the card against
   the CPU (boxes 1e-2 px; ``images_torch_convert``); ``cli/train.py
   --plot-images`` on small Gen1 splits (both mosaics written, or an
   ImportError naming matplotlib where it is absent; ``images_plots``);
   kernel_K3_images: K3 at the RGB step's captured shapes (the 4-byte
   vector branch) against its plain version, timed beside its bound and
   ``torch.gather``.
27. trainer_ddp: ``cli/train.py`` at full width on the trainer phase's
   splits for an epoch with the image-space strong augmentation (K1 once
   and K3 twice a step, K1 once an eval batch), run as a world of one
   through NCCL (``RANK=0 WORLD_SIZE=1`` and an address: the gradients
   all-reduced each step, the group left at the end) beside the same run
   without a process group: step medians side by side, the first losses
   within 1e-3.
28-30. Two gloo processes sharing the card (spawned once):
   parallel_event_shard: every sharded representation
   (``parallel/event_shard.py``: ERGO-12 and the time surface on K1 once a
   rank, a sum-only MDES table, the histogram and the voxel grid on K2,
   TORE) of the serve batch split over an "event" axis of 2, against the
   unsharded call on the card; parallel_ddp: one data-parallel step of the
   shrunk detector at 320² (4 windows a rank, rank 1 without a box; global
   BatchNorm, summed gradients; K1 once and K3 twice a rank) against the
   one-process step on the 8 windows from the same weights, the ranks'
   states bit-equal; parallel_tp: the same detector sharded by output
   channel over a "model" axis of 2 against the replicated step.
Then the ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: exit code non-zero
and no result line.

    python3 chip_smoke.py
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W, N, B = 240, 304, 50_000, 8
S = H * W
IMG = 640
REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
REPLACES = "event_representation_study_tpu/ops/pallas_scatter.py"
SOURCE = "event_representation_study_tpu_torch/csrc/fused_segment_reduce.cu"
K3_SOURCE = "event_representation_study_tpu_torch/csrc/roll_rows.cu"
K3_REPLACES = "event_representation_study_tpu/ops/pallas_roll.py:25"
K4_SOURCE = "event_representation_study_tpu_torch/csrc/window_attention.cu"
# windows, tokens, heads, windows of the shift mask (0: unmasked)
K4_SHAPES = {"stage0_shifted": (2304, 144, 6, 144), "stage2": (144, 144, 24, 0)}
TRAIN_STEPS = {0: 3, 5: 3}  # epoch -> timed steps: ATSS below epoch 4, TAL from it
LABELS_PER_WINDOW = 8


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def tf32_state() -> dict:
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def cuda_ms(fn, iters: int = 20, flush: torch.Tensor | None = None) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events. With ``flush``,
    a buffer larger than L2 is rewritten before every launch and only the
    launch is timed, so the inputs come from device memory."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush.add_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def fake_batch(seed0: int, n_windows: int = B, n_events: int = N,
               height: int = H, width: int = W):
    from event_representation_study_tpu_torch.events import (
        from_structured, generate_fake_events, stack_blocks)

    return stack_blocks([
        from_structured(generate_fake_events(n_events, height, width, 50_000, seed=seed0 + i),
                        n_events)
        for i in range(n_windows)
    ])


def capture_kernel_inputs(fn):
    """Run ``fn`` and return its result with the arguments it passed to the
    sort glue and to the kernel wrapper (the main path's own shapes)."""
    from event_representation_study_tpu_torch.ops import fused_scatter

    seen = {}
    real_sort, real_reduce = fused_scatter.sort_columns, fused_scatter.segment_reduce_sorted

    def sort_columns(*args):
        seen["glue"] = args
        return real_sort(*args)

    def segment_reduce_sorted(*args):
        seen["kernel"] = args
        return real_reduce(*args)

    fused_scatter.sort_columns = sort_columns
    fused_scatter.segment_reduce_sorted = segment_reduce_sorted
    try:
        out = fn()
    finally:
        fused_scatter.sort_columns = real_sort
        fused_scatter.segment_reduce_sorted = real_reduce
    return out, seen["glue"], seen["kernel"]


def check_kernel(label, kernel_args, count_cols, flush):
    """Kernel vs plain on the card; times; bound. Returns the kernels-line
    entry without ``launches``."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs

    seg_s, vs, vm, num_segments = kernel_args
    bsz, ks, n = vs.shape
    km = 0 if vm is None else vm.shape[1]
    k_sum, k_max = fs.segment_reduce_sorted(*kernel_args)
    k_sum2, k_max2 = fs.segment_reduce_sorted(*kernel_args)
    p_sum, p_max = fs.segment_reduce_sorted_plain(*kernel_args)
    c_sum, c_max = fs.segment_reduce_sorted_plain(*(
        a.cpu() if torch.is_tensor(a) else a for a in kernel_args))
    torch.cuda.synchronize()
    err = (k_sum - p_sum).abs().max().item()
    checks = {
        "bit_identical_rerun": torch.equal(k_sum, k_sum2) and (km == 0 or torch.equal(k_max, k_max2)),
        "sums_close": torch.allclose(k_sum, p_sum, rtol=1e-5, atol=1e-4),
        "count_cols_exact": torch.equal(k_sum[..., count_cols], p_sum[..., count_cols]),
        "max_exact": km == 0 or torch.equal(k_max, p_max),
    }
    err_cpu = max((k.cpu() - c).abs().max().item()
                  for k, c in ((k_sum, c_sum), (k_max, c_max)) if k is not None)
    require(all(checks.values()), f"{label}: kernel disagrees with its plain version: {checks}")
    # both sum in event order: the card equals the CPU bit for bit
    require(err_cpu == 0.0, f"{label}: kernel vs the plain version on the CPU: {err_cpu}")

    ms = cuda_ms(lambda: fs.segment_reduce_sorted(*kernel_args), flush=flush)
    ms_warm = cuda_ms(lambda: fs.segment_reduce_sorted(*kernel_args))
    plain_ms = cuda_ms(lambda: fs.segment_reduce_sorted_plain(*kernel_args), flush=flush)
    library_ms = cuda_ms(library_call(*kernel_args), flush=flush)
    # yardstick: writing the kernel's outputs alone
    fill_ms = cuda_ms(lambda: [o.fill_(0.0) for o in (k_sum, k_max) if o is not None], flush=flush)

    t_bytes, t_ops, nbytes, flops = segment_reduce_bound(seg_s, ks, km, num_segments)
    say(label, shape={"B": bsz, "N": n, "S": num_segments, "Ks": ks, "Km": km},
        max_abs_err_vs_plain_card=err, max_abs_err_vs_plain_cpu=err_cpu,
        tolerance="sums rtol 1e-5 atol 1e-4 (plain uses float atomics); max and count columns exact",
        **checks, ms_l2_flushed=ms, ms_warm_l2=ms_warm, plain_ms=plain_ms,
        library_ms=library_ms, fill_outputs_ms=fill_ms, bound_ms=max(t_bytes, t_ops), bytes=nbytes, flops=flops,
        tf32=tf32_state())
    return {
        "name": fs.K1 if km else fs.K2, "route": "cuda", "source": SOURCE,
        "replaces": f"{REPLACES}:{99 if km else 63}",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def library_call(seg_s, vs, vm, num_segments):
    """The library yardstick of K1/K2: ``index_add_`` + ``scatter_reduce_``
    ("amax") into preallocated outputs, as a function to time."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs

    bsz, ks, n = vs.shape
    km = 0 if vm is None else vm.shape[1]
    rows = torch.arange(bsz, device=vs.device)[:, None] * (num_segments + 1)
    idx = (seg_s.to(torch.int64).clamp_max(num_segments) + rows).reshape(-1)
    vs_t = vs.transpose(1, 2).reshape(bsz * n, ks).contiguous()
    out_s = torch.empty((bsz * (num_segments + 1), ks), device=vs.device)
    if km:
        vm_t = vm.transpose(1, 2).reshape(bsz * n, km).contiguous()
        idx_m = idx[:, None].expand(-1, km).contiguous()
        out_m = torch.empty((bsz * (num_segments + 1), km), device=vs.device)

    def library():
        out_s.zero_().index_add_(0, idx, vs_t)
        if km:
            out_m.fill_(fs.NEG_INF).scatter_reduce_(0, idx_m, vm_t, "amax", include_self=True)

    return library


def segment_reduce_bound(seg_s, ks: int, km: int, num_segments: int):
    """The least time any implementation needs: each valid event's id and
    Ks+Km values read once, the (B, S, Ks+Km) outputs written once, one add
    or max per value. Returns (bytes ms, operations ms, bytes, operations)."""
    n_valid = int((seg_s < num_segments).sum().item())
    nbytes = 4 * (n_valid * (1 + ks + km) + seg_s.shape[0] * num_segments * (ks + km))
    flops = n_valid * (ks + km)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3, nbytes, flops


# name -> (B, N, S, Ks, Km, layout of the ids): shapes the serve path does not give K1/K2
HARD_SHAPES = {
    "hot_pixel": (B, N, S, 18, 3, "hot"),  # one pixel holds 25% of a row's events
    "multi_chunk_tile": (B, N, S, 18, 3, "dense_tile"),  # 20% of a row in 128 pixels of one tile
    "empty_row": (3, N, S, 18, 3, "empty_row"),  # row 1 has num = 0
    "n_unaligned": (B, N + 1, S, 18, 3, "uniform"),  # the 4-byte copy path
    # odd S: rows after the first start their output tiles off a 16-byte boundary
    "s_unaligned": (B, N, S - 1, 18, 3, "uniform"),
    "ks32_km16": (2, N, S, 32, 16, "uniform"),  # the compiled maximum of one launch
    "ks36_km3": (2, N, S, 36, 3, "uniform"),  # two column groups: 18 + 18 sums, 2 + 1 maxes
    "ks1_km12": (B, N, S, 1, 12, "uniform"),  # the event stack
    "time_surface_2hw": (B, N, 2 * S, 1, 6, "uniform"),  # polarity x pixels
    "ks1_km0": (2, N, S, 1, 0, "uniform"),
    "b1": (1, N, S, 18, 3, "uniform"),
    "event_mosaic": (B, 4 * N, S, 18, 3, "uniform"),  # 4 windows' events per row
}


def hard_shape_args(dev, gen, bsz: int, n: int, s: int, ks: int, km: int, layout: str):
    """Sorted ids over ``s`` pixels with 5% padding ids (``s`` and above),
    and values that are multiples of 1/64 in [-8, 8], so that every sum here
    is exact in any order; sum column 0 counts events."""
    seg = torch.randint(0, s, (bsz, n), generator=gen, device=dev, dtype=torch.int32)
    seg[:, n - n // 20:] = s + torch.randint(0, 3 * s, (bsz, n // 20), generator=gen, device=dev,
                                             dtype=torch.int32)
    if layout == "hot":
        seg[:, : n // 4] = 517
    elif layout == "dense_tile":
        seg[:, : n // 5] = 1024 + torch.randint(0, 128, (bsz, n // 5), generator=gen, device=dev,
                                                dtype=torch.int32)
    elif layout == "empty_row":
        seg[1] = s
    seg = torch.sort(seg, dim=1).values

    def dyadic(k):
        v = torch.randint(-512, 513, (bsz, k, n), generator=gen, device=dev)
        return (v.to(torch.float32) / 64).contiguous()

    vs = dyadic(ks)
    vs[:, 0] = 1.0
    return seg, vs, dyadic(km) if km else None, s


def check_hard_shapes(dev, flush):
    """K1/K2 on HARD_SHAPES against the plain version on the card (exactly
    equal: the values make every sum exact) and on the CPU; their times
    beside the plain version's and the library call's."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs

    gen = torch.Generator(device=dev).manual_seed(11)
    cases = {}
    for name, (bsz, n, s, ks, km, layout) in HARD_SHAPES.items():
        args = hard_shape_args(dev, gen, bsz, n, s, ks, km, layout)
        k_sum, k_max = fs.segment_reduce_sorted(*args)
        k_sum2, k_max2 = fs.segment_reduce_sorted(*args)
        p_sum, p_max = fs.segment_reduce_sorted_plain(*args)
        c_sum, c_max = fs.segment_reduce_sorted_plain(*(
            a.cpu() if torch.is_tensor(a) else a for a in args))
        torch.cuda.synchronize()
        checks = {
            "bit_identical_rerun": torch.equal(k_sum, k_sum2) and (km == 0 or torch.equal(k_max, k_max2)),
            "sums_equal": torch.equal(k_sum, p_sum),
            "max_equal": km == 0 or torch.equal(k_max, p_max),
            "equal_cpu_plain": torch.equal(k_sum.cpu(), c_sum) and (km == 0 or torch.equal(k_max.cpu(), c_max)),
        }
        ms = cuda_ms(lambda: fs.segment_reduce_sorted(*args), flush=flush)
        plain_ms = cuda_ms(lambda: fs.segment_reduce_sorted_plain(*args), flush=flush)
        library_ms = cuda_ms(library_call(*args), flush=flush)
        row0 = args[0][-1]
        cases[name] = {"shape": {"B": bsz, "N": n, "S": s, "Ks": ks, "Km": km}, "layout": layout,
                       "events_in_densest_pixel": int(torch.unique_consecutive(
                           row0[row0 < s], return_counts=True)[1].max()),
                       **checks, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": segment_reduce_bound(args[0], ks, km, s)[0]}
        require(all(checks.values()), f"hard shape {name}: {checks}")
        del args, k_sum, k_sum2, k_max, k_max2, p_sum, p_max
    say("kernel_hard_shapes", cases=cases,
        tolerance="exact: values are multiples of 1/64, so every sum is exact in any order")


def tie_free_predictions(bsz: int, anchors: int, nc: int, seed: int) -> torch.Tensor:
    """(bsz, anchors, 5 + nc) predictions: boxes clustered around a few
    centres (so NMS suppresses), objectness 1, distinct class scores."""
    g = torch.Generator().manual_seed(seed)
    centres = torch.rand((bsz, 16, 2), generator=g) * 560 + 40
    pick = torch.randint(0, 16, (bsz, anchors), generator=g)
    cxy = centres.gather(1, pick[..., None].expand(-1, -1, 2))
    cxy = cxy + torch.randn((bsz, anchors, 2), generator=g) * 8
    wh = torch.rand((bsz, anchors, 2), generator=g) * 60 + 20
    scores = torch.randperm(bsz * anchors * nc, generator=g).reshape(bsz, anchors, nc)
    scores = scores.to(torch.float32) / (bsz * anchors * nc)
    return torch.cat([cxy, wh, torch.ones((bsz, anchors, 1)), scores], dim=-1)


def randomize_preds_(model, generator, which: str = "_pred_"):
    """Random pred-conv weights (those whose name holds ``which``), so that
    scores vary and NMS has work (the seeded init leaves them at zero, as
    the reference does)."""
    with torch.no_grad():
        for name, mod in model.head.named_children():
            if which in name:
                std = (1.0 / mod.weight[0].numel()) ** 0.5
                mod.weight.normal_(0.0, std, generator=generator)
                mod.bias.normal_(0.0, 0.5, generator=generator)


def fake_labels(rng, n_windows: int = B, img: int = IMG):
    """Per window, 1..LABELS_PER_WINDOW Gen1-like boxes (class, normalised
    cx, cy, w, h) put into the letterboxed frame: (n, 5) [cls, x1, y1, x2, y2]."""
    from event_representation_study_tpu_torch.ops.image import letterbox_labels

    out = []
    for _ in range(n_windows):
        n = int(rng.integers(1, LABELS_PER_WINDOW + 1))
        cxcy = rng.uniform(0.15, 0.85, (n, 2))
        wh = rng.uniform(0.04, 0.3, (n, 2))
        cls = rng.integers(0, 2, (n, 1))
        out.append(letterbox_labels(
            np.concatenate([cls, cxcy, wh], 1).astype(np.float32), H, W, img))
    return out


def make_batch(blocks, labels, hyp, rng, img: int = IMG):
    """A train Batch: the plan and labels from the host planner."""
    from event_representation_study_tpu_torch.data.augment import plan_augment_batch
    from event_representation_study_tpu_torch.ops.warp import AugPlan
    from event_representation_study_tpu_torch.parallel.train_step import Batch

    cap = LABELS_PER_WINDOW * 4 * 2  # x4 mosaic tiles, x2 mixup partner
    plan, lab, nl = plan_augment_batch(labels, img, hyp, rng, cap)
    mask = (np.arange(cap)[None] < nl[:, None]).astype(np.float32)
    return Batch(None, blocks, lab[..., 0], lab[..., 1:5], mask, AugPlan(**plan))


def capture_roll_inputs(fn, keep=lambda args: args):
    """Run ``fn`` and return its result with ``keep`` of the arguments it
    passed to the per-row roll (K3's wrapper; by default the arguments
    themselves), one entry per call."""
    from event_representation_study_tpu_torch.ops import warp

    seen = []
    real = warp.roll_rows

    def roll_rows(*args):
        seen.append(keep(args))
        return real(*args)

    warp.roll_rows = roll_rows
    try:
        out = fn()
    finally:
        warp.roll_rows = real
    return out, seen


def solver_config(cfg):
    from event_representation_study_tpu_torch.train.optim import SolverConfig

    return SolverConfig(**{k: cfg["solver"][k] for k in (
        "lr0", "lrf", "momentum", "weight_decay", "warmup_epochs", "warmup_momentum",
        "warmup_bias_lr")})


def loss_config(cfg):
    from event_representation_study_tpu_torch.train.losses import LossConfig

    hd = cfg["model"]["head"]
    return LossConfig(num_classes=cfg["data"]["num_classes"], strides=tuple(hd["strides"]),
                      reg_max=hd["reg_max"], iou_type=hd["iou_type"],
                      warmup_epoch=hd["atss_warmup_epoch"])


def train_setup(dev, n_batches: int, config: str = "gen1_optimized", img: int = IMG,
                model_kw=None, step_kw=None, plan: bool = True, overrides=(),
                rep_hw=(H, W), batches=None):
    """The full-width detector of ``configs/<config>.py`` (with
    ``overrides``; ``build_model`` also given ``model_kw``), its train state
    and step (separable warp over a ``rep_hw`` sensor; ``make_train_step``
    also given ``step_kw``) at ``img``, and ``n_batches`` batches of B
    Gen1 windows with the config's strong augmentation planned for each
    (with ``plan`` false: the config's flips only, as the learned
    representation trains), unless ``batches`` are given. Returns (state,
    step, batches, info)."""
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops.warp import separable_hyp_eligible
    from event_representation_study_tpu_torch.parallel.train_step import (
        init_train_state, make_train_step)
    from event_representation_study_tpu_torch.train.optim import (
        accumulation_steps, build_optimizer, with_accumulation)
    from event_representation_study_tpu_torch.utils.config import load_config

    cfg = load_config(f"configs/{config}.py", overrides=list(overrides))
    hyp = dict(cfg["data_aug"])
    require(separable_hyp_eligible(hyp, img), f"{config}: the recipe must fit the separable warp")
    model_kw = model_kw or {}
    t0 = time.perf_counter()
    model = build_model(cfg, cfg["data"]["num_classes"], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5), **model_kw)
    # random box-pred convs: with Flax's zero init nothing upstream of them
    # gets a gradient at first. The class preds keep their init (logits
    # -4.6): random ones saturate sigmoid scores to 1.0 in float32, where the
    # loss's clip at 1 - 1e-9 (== 1.0) leaves log(0), in the JAX package as here
    randomize_preds_(model, torch.Generator(device=dev).manual_seed(6), which="reg_pred")
    k_acc = accumulation_steps(B, nominal=B)  # nominal batch = batch: every step updates
    sgd = build_optimizer(model, solver_config(cfg))
    # start at the end of the warmup, as a run resumed there: every group has
    # its learning rate (at update 0 the weight and BN groups have none)
    sgd.count = max(round(sgd.cfg.warmup_epochs * sgd.cfg.steps_per_epoch), 1000)
    state = init_train_state(model, with_accumulation(sgd, k_acc))
    step = make_train_step(loss_config(cfg), model_kw.get("representation",
                                                          "OptimizedRepresentation"),
                           rep_hw, img, warp_impl="separable", device=dev, **(step_kw or {}))
    info = {"build_s": time.perf_counter() - t0, "accumulate": k_acc,
            "params": sum(p.numel() for p in model.parameters())}
    if batches is None:
        rng = np.random.default_rng(0)
        batches = [(make_batch if plan else flip_batch)(
            fake_batch(1000 + 10 * i), fake_labels(rng, img=img), hyp, rng, img)
            for i in range(n_batches)]
    return state, step, batches, info


def flip_batch(blocks, labels, hyp, rng, img: int = IMG):
    """A train Batch without a strong-augmentation plan: each window's
    events and letterboxed boxes flipped left-right and up-down with the
    probabilities of ``hyp`` on the host, as the loader flips them, and the
    boxes padded to LABELS_PER_WINDOW."""
    from event_representation_study_tpu_torch.ops.image import letterbox_geometry
    from event_representation_study_tpu_torch.parallel.train_step import Batch

    r, _, (dw, dh) = letterbox_geometry(H, W, img)
    x, y = blocks.x.clone(), blocks.y.clone()
    lab = np.zeros((len(labels), LABELS_PER_WINDOW, 5), np.float32)
    mask = np.zeros((len(labels), LABELS_PER_WINDOW), np.float32)
    for i, a in enumerate(labels):
        a, n = a.copy(), int(blocks.num[i])
        if rng.random() < hyp["fliplr"]:  # sensor x -> W - 1 - x, box cx -> 1 - cx
            x[i, :n] = W - 1 - x[i, :n]
            a[:, [1, 3]] = 2 * dw + r * W - a[:, [3, 1]]
        if rng.random() < hyp["flipud"]:
            y[i, :n] = H - 1 - y[i, :n]
            a[:, [2, 4]] = 2 * dh + r * H - a[:, [4, 2]]
        lab[i, :len(a)], mask[i, :len(a)] = a, 1.0
    return Batch(None, dataclasses.replace(blocks, x=x, y=y), lab[..., 0], lab[..., 1:5], mask)


def timed_steps(state, step, batches):
    """The steps of TRAIN_STEPS (epoch -> count) on ``batches`` in order,
    each timed to its end on the host clock, with the launch counters and
    the peak memory zeroed before. Returns (state, ms a step, the parts of
    each step, launches, peak bytes)."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.reset_launches()
    roll.reset_launches()
    times, per_step, i = [], [], 0
    for epoch, count in TRAIN_STEPS.items():
        for _ in range(count):
            t = time.perf_counter()
            state, parts = step(state, batches[i], epoch)
            vals = {k: v.item() for k, v in parts.items()}  # host copy: waits
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            per_step.append(dict(epoch=epoch, **vals))
            i += 1
    return (state, times, per_step, {**fs.LAUNCHES, **roll.LAUNCHES},
            torch.cuda.max_memory_allocated())


def train_phase(dev):
    """The full-width train step; returns (launches of the timed steps,
    the K3 arguments captured in the warm-up step)."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll

    n_steps = sum(TRAIN_STEPS.values())
    state, step, batches, info = train_setup(dev, n_steps + 1)
    model = state.model

    t0 = time.perf_counter()
    (state, parts), k3_args = capture_roll_inputs(lambda: step(state, batches[0], 0))
    warm = {k: v.item() for k, v in parts.items()}
    warm_ms = (time.perf_counter() - t0) * 1e3
    require(len(k3_args) == 2, f"the separable warp rolled {len(k3_args)} times, not 2")
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    e0 = {k: v.clone() for k, v in state.ema.variables.items()}

    state, times, per_step, launches, peak = timed_steps(state, step, batches[1:])
    changed = sum(not torch.equal(p0[n], p) for n, p in model.named_parameters())
    ema_changed = sum(not torch.equal(e0[k], v) for k, v in state.ema.variables.items())
    say("train", batch=B, events_per_window=N, img=IMG, **info, warmup_step_ms=warm_ms,
        warmup_step=warm, ms_per_step=times, median_ms=statistics.median(times),
        peak_mem_bytes=peak, steps=per_step,
        launches=launches, params_changed=changed, params_total=len(p0),
        ema_tensors_changed=ema_changed, optimizer_updates=state.opt_state.count,
        roll_shapes=[list(a[0].shape) for a in k3_args], tf32=tf32_state())
    require(launches[fs.K1] == n_steps, f"K1 launches {launches} for {n_steps} steps")
    require(launches[roll.K3] == 2 * n_steps, f"K3 launches {launches} for {n_steps} steps")
    require(all(math.isfinite(v) for st in per_step for v in st.values()), "finite losses")
    require(all(st["num_pos"] > 0 for st in per_step), "every step has positive anchors")
    # the reg branch of a level that held no positive anchor gets no gradient
    require(changed >= 0.95 * len(p0), f"{len(p0) - changed} parameters did not change: " + str(
        [n for n, p in model.named_parameters() if torch.equal(p0[n], p)]))
    require(ema_changed >= 0.95 * len(e0), f"{len(e0) - ema_changed} EMA tensors did not change")

    stages = step_stages(state, step, batches, dev)
    say("train_stages_ms", epoch=5, tf32=tf32_state(),
        **{k: statistics.median(v) for k, v in stages.items()},
        all_runs=stages)
    del state, model, step, batches
    torch.cuda.empty_cache()
    return launches, k3_args


def step_stages(state, step, batches, dev, mosaic: bool = True, gather_dtype=None):
    """Where a step's device time goes: its stages replayed one by one on
    the first 3 batches, each stage's ms from CUDA events; the warp gathers
    its source in ``gather_dtype`` (bf16 for a bf16 model, as the step
    does). With ``mosaic``, also event_mosaic (Gen1 windows): the other
    executor of the same plan (aug_mode="event"), which replaces ergo12 +
    letterbox + warp."""
    from event_representation_study_tpu_torch.ops.image import letterbox_image
    from event_representation_study_tpu_torch.parallel.train_step import batch_on_device
    from event_representation_study_tpu_torch.reps.event_mosaic import mosaic_event_rep

    names = ("ergo12", "letterbox", "warp", "forward_loss", "backward", "optimizer_ema")
    stages = {k: [] for k in names + (("event_mosaic",) if mosaic else ())}
    for j in range(3):
        batch = batch_on_device(batches[j], dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        rep = step.rep_fn(batch.events)
        ev[1].record()
        img = letterbox_image(rep, IMG)
        ev[2].record()
        imgs = (step.warp(img, batch.aug, IMG, gather_dtype=gather_dtype) / 255.0
                ).permute(0, 3, 1, 2)
        ev[3].record()
        state.model.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(state.model, imgs, batch, 5)
        ev[4].record()
        loss.backward()
        ev[5].record()
        step.apply_update(state)
        ev[6].record()
        if mosaic:
            mosaic_event_rep(batch.events, batch.aug, "OptimizedRepresentation", (H, W), IMG)
            ev[7].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stages, zip(ev, ev[1:])):
            stages[k].append(a.elapsed_time(b))
    return stages


def serve_stages(serve, blocks, dev, img: int = IMG):
    """Where a request's device time goes, stage by stage (ms from CUDA
    events), and the detector's predictions."""
    from event_representation_study_tpu_torch.ops.image import letterbox_image
    from event_representation_study_tpu_torch.ops.nms import non_max_suppression

    with torch.inference_mode():
        blk = blocks.to(dev)
        rep = serve.rep_fn(blk)
        x = (letterbox_image(rep, img) / 255.0).permute(0, 3, 1, 2)
        preds = serve.model(x)
        return {
            "h2d": cuda_ms(lambda: blocks.to(dev), 5),
            "ergo12": cuda_ms(lambda: serve.rep_fn(blk), 5),
            "letterbox": cuda_ms(lambda: letterbox_image(rep, img) / 255.0, 5),
            "detector": cuda_ms(lambda: serve.model(x), 5),
            "nms": cuda_ms(lambda: non_max_suppression(preds, conf_thres=serve.conf_thres), 5),
        }, preds


def roll_key(k3_args):
    """The shapes of one step's two K3 calls: (x's shape, w_out) each."""
    return tuple((tuple(x.shape), w_out) for x, _, w_out in k3_args)


def check_k3(k3_args, label: str = "kernel_K3"):
    """K3 against its plain version at one train step's pass V and pass H
    shapes and at edge cases; times. Returns the kernels-line entry without
    ``launches`` (ms, bound and yardsticks summed over the two passes of one
    step)."""
    from event_representation_study_tpu_torch.ops import roll

    dev = k3_args[0][0].device
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    passes, checks, errs = {}, {}, []
    for name, (x, starts, w_out) in zip(("pass_v", "pass_h"), k3_args):
        w_in = x.shape[2]
        wild = torch.randint(-60, w_in + 60, starts.shape, generator=gen, device=dev,
                             dtype=torch.int32)
        odd = x[:, :, : w_in - 3].contiguous()  # W_in % 8 != 0 and != the captured one
        for case, (xa, sa) in {"captured": (x, starts), "out_of_range": (x, wild),
                               "odd_w": (odd, wild), "bf16": (x.to(torch.bfloat16), wild)
                               }.items():
            k = roll.roll_rows(xa, sa, w_out)
            k2 = roll.roll_rows(xa, sa, w_out)
            p = roll.roll_rows_plain(xa, sa, w_out)
            checks[f"{name}.{case}"] = torch.equal(k, p) and torch.equal(k, k2)
            errs.append((k.float() - p.float()).abs().max().item())
            del k, k2, p
        starts_c, x_c = starts.cpu(), x[:2].cpu()
        checks[f"{name}.vs_cpu_plain"] = torch.equal(
            roll.roll_rows(x[:2].contiguous(), starts[:2].contiguous(), w_out).cpu(),
            roll.roll_rows_plain(x_c, starts_c[:2], w_out))
        out = torch.empty((*x.shape[:2], w_out, x.shape[3]), dtype=x.dtype, device=dev)
        s = starts.to(torch.int64).clamp(0, w_in - w_out)
        idx = (s[..., None] + torch.arange(w_out, device=dev))[..., None].expand(out.shape)
        idx = idx.contiguous()
        nbytes = 2 * out.numel() * out.element_size()  # window read + output written
        passes[name] = {
            "shape": list(x.shape), "w_out": w_out,
            "ms": cuda_ms(lambda: roll.roll_rows(x, starts, w_out), flush=flush),
            "ms_warm_l2": cuda_ms(lambda: roll.roll_rows(x, starts, w_out)),
            "plain_ms": cuda_ms(lambda: roll.roll_rows_plain(x, starts, w_out), flush=flush),
            "library_ms": cuda_ms(lambda: torch.gather(x, 2, idx, out=out), flush=flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
        }
        del out, idx, s
    # every vector width of the kernel: 16 B (f32 C=12), 8 B (bf16 C=12),
    # 4 B (f32 C=5, and the RGB images' f32 C=3), 2 B (bf16 C=5, bf16 C=3)
    for dtype in (torch.float32, torch.bfloat16):
        for c in (12, 5, 3):
            xs = torch.randn((2, 37, 101, c), generator=gen, device=dev).to(dtype)
            ss = torch.randint(-9, 80, (2, 37), generator=gen, device=dev, dtype=torch.int32)
            checks[f"width.{dtype}.C{c}"] = torch.equal(roll.roll_rows(xs, ss, 40),
                                                        roll.roll_rows_plain(xs, ss, 40))
    del flush
    say(label, passes=passes, **checks, max_abs_err=max(errs),
        tolerance="exact (data movement)",
        library="torch.gather along W into a preallocated output, index precomputed")
    require(all(checks.values()), f"K3 disagrees with its plain version: {checks}")
    total = {k: sum(p[k] for p in passes.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": roll.K3, "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
            "max_abs_err": max(errs), "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": "bytes",
            "library_ms": total["library_ms"], "per_launch": passes}


def window_attention_bound_ms(windows, n, heads, mask_windows, backward: bool) -> float:
    """Least time of K4's work at one shape: the float32 FLOPs of its
    products (q̂ k̂ᵀ and P v forward; P, dP, dv, dq̂ and dk̂ backward) at the
    float32 peak, or its bytes read and written once at the HBM rate
    (forward: qkv in, the output out; backward: qkv, the output, its
    gradient and the log-sum-exp in, qkv's gradient out), whichever is
    longer, with the bias and mask tables read once."""
    c = heads * 32
    flops = (5 if backward else 2) * 2 * windows * heads * n * n * 32
    rows = windows * n
    tables = (heads + mask_windows) * n * n
    words = rows * (3 * c + c + c + heads + 3 * c) + tables + heads * n * n if backward \
        else rows * (3 * c + c) + tables
    return 1e3 * max(flops / FP32_FLOPS, 4 * words / HBM_BYTES_PER_S)


def check_k4(dev):
    """K4 against the model's plain code (``window_attention_plain``,
    through autograd) at the Swin-V2-L detector's stage-0 and stage-2 shapes:
    errors, two runs bit-equal, and forward and backward ms of each beside
    the bound. Returns the kernels-line entry without ``launches``."""
    from event_representation_study_tpu_torch.models import swin_vit
    from event_representation_study_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device=dev).manual_seed(11)
    shapes, errs = {}, []
    for label, (windows, n, heads, mask_windows) in K4_SHAPES.items():
        c = heads * 32
        qkv = torch.randn(windows, n, 3 * c, generator=gen, device=dev)
        scale = torch.exp(math.log(10.0) + 0.3 * torch.randn(heads, generator=gen, device=dev))
        bias = 16 * torch.sigmoid(torch.randn(heads, n, n, generator=gen, device=dev))
        dout = torch.randn(windows, n, c, generator=gen, device=dev)
        mask = None
        if mask_windows:
            side = math.isqrt(mask_windows) * math.isqrt(n)
            mask = torch.from_numpy(swin_vit._shift_mask(side, side, math.isqrt(n),
                                                         math.isqrt(n) // 2)).to(dev)
        leaves = [t.clone().requires_grad_(True) for t in (qkv, scale, bias)]
        plain_out = swin_vit.window_attention_plain(leaves[0], leaves[1][:, None, None],
                                                    leaves[2], mask, heads)
        want = [plain_out.detach(), *torch.autograd.grad(plain_out, leaves, dout,
                                                         retain_graph=True)]
        runs = []
        for _ in range(2):
            got = wa.window_attention(*leaves, mask, heads)
            runs.append([got.detach(), *torch.autograd.grad(got, leaves, dout)])
        err = {name: ((a - b).abs().max() / b.abs().max()).item()
               for name, a, b in zip(("out", "dqkv", "dscale", "dbias"), runs[0], want)}
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        errs.append(max(err.values()))
        out, lse = wa._forward_cuda(qkv, scale, bias, mask, heads, True)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: wa.window_attention(qkv, scale, bias, mask, heads))
            plain_fwd_ms = cuda_ms(lambda: swin_vit.window_attention_plain(
                qkv, scale[:, None, None], bias, mask, heads), iters=5)
        bwd_ms = cuda_ms(lambda: wa._backward_cuda(qkv, out, dout, lse, scale, bias, mask, heads))
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, leaves, dout,
                                                           retain_graph=True), iters=5)
        shapes[label] = {
            "windows": windows, "tokens": n, "heads": heads, "mask_windows": mask_windows,
            "rel_err": err, "bit_equal_runs": same,
            "ms": fwd_ms, "plain_ms": plain_fwd_ms,
            "bound_ms": window_attention_bound_ms(windows, n, heads, mask_windows, False),
            "backward_ms": bwd_ms, "plain_backward_ms": plain_bwd_ms,
            "backward_bound_ms": window_attention_bound_ms(windows, n, heads, mask_windows,
                                                           True),
            "backward_group": wa.backward_group(
                windows, heads, torch.cuda.get_device_properties(dev).multi_processor_count)}
        del qkv, bias, dout, leaves, plain_out, want, runs, out, lse
        torch.cuda.empty_cache()
    say("kernel_K4_window_attn", shapes=shapes, tolerance="1e-4 of the largest; runs bit-equal",
        tf32=tf32_state())
    require(all(e <= 1e-4 for e in errs) and all(v["bit_equal_runs"] for v in shapes.values()),
            f"K4 disagrees with the plain code: {shapes}")
    stage0 = shapes["stage0_shifted"]
    return {"name": "window_attention", "route": "cuda", "source": K4_SOURCE,
            "replaces": "none (the JAX package's attention is plain jnp)",
            "max_abs_err": max(errs), "ms": stage0["ms"], "plain_ms": stage0["plain_ms"],
            "bound_ms": stage0["bound_ms"], "bound_by": "flops", "library_ms": None,
            "backward_ms": stage0["backward_ms"],
            "plain_backward_ms": stage0["plain_backward_ms"],
            "backward_bound_ms": stage0["backward_bound_ms"], "by_shape": shapes}


def warp_phase(dev):
    """The separable warp on the card (K3) vs the CPU (plain roll) on
    letterboxed ERGO-12 images of 4 windows (the planner mosaics only
    batches of 4 or more) at 640 px, with the paper recipe's plan."""
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.ops.image import letterbox_image
    from event_representation_study_tpu_torch.ops.warp import compose_warp_separable
    from event_representation_study_tpu_torch.reps.dispatch import batched_representation
    from event_representation_study_tpu_torch.utils.config import load_config

    hyp = dict(load_config("configs/gen1_optimized.py")["data_aug"])
    rng = np.random.default_rng(25)  # a draw with mosaic on every row, mixup on 2, flips on 3
    batch = make_batch(fake_batch(77, n_windows=4), fake_labels(rng, 4), hyp, rng)
    imgs = letterbox_image(batched_representation("ERGO12", H, W)(batch.events.to(dev)), IMG)
    plan = batch.aug.to(dev)
    roll.reset_launches()
    got = compose_warp_separable(imgs, plan, IMG)
    torch.cuda.synchronize()
    launches = roll.LAUNCHES[roll.K3]
    want = compose_warp_separable(imgs.cpu(), batch.aug.to("cpu"), IMG)
    err = (got.cpu() - want).abs().max().item()
    rows = {"mosaic": int((plan.src_idx != plan.src_idx[:, :1]).any(1).sum()),
            "mixup": int((plan.mix_r < 1).sum()), "flip_lr": int((plan.inv_affine[:, 0, 0] < 0).sum())}
    say("warp", shape=list(got.shape), rows=rows, max_abs_err_vs_cpu=err, k3_launches=launches,
        tolerance="1e-3 on the 0..255 scale (float32 elementwise arithmetic; the card may "
                  "contract a multiply-add)", tf32=tf32_state())
    require(launches == 2 and bool(torch.isfinite(got).all()), f"warp on the card: {launches}")
    require(min(rows.values()) > 0, f"the plan exercises mosaic, mixup and flips: {rows}")
    require(err <= 1e-3, f"warp card vs CPU: {err}")


SMALL = ["model.depth_multiple=0.2", "model.width_multiple=0.125"]
REF_IMG = 128  # the image size of the card-vs-CPU train steps


def card_vs_cpu_step(dev, cfg, batch, model_kw=None, step_kw=None, teacher=None,
                     dtype=torch.float32, held=lambda leaf: True, raw: bool = False,
                     preds: str = "_pred_"):
    """One train step (epoch 0, REF_IMG px) of the detector of ``cfg``
    (``build_model`` given ``model_kw``, random pred convs, parameters in
    ``dtype``) on the card and on the CPU from the same weights; a
    ``teacher`` (a CPU model) is copied to each device. Returns (parts on
    the CPU, parts on the card, errors): the loss's relative error, and for
    gradients, parameter updates and BatchNorm statistics the largest
    card-CPU difference of a leaf that ``held`` names over its largest CPU
    entry plus 1e-3 of the largest over all leaves, with the leaf. With
    ``raw``, also each device's parts, gradients, updates and statistics.
    ``preds`` names the pred convs drawn at random (the rest keep their
    init)."""
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.parallel.train_step import (
        TrainState, make_train_step)
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.optim import build_optimizer

    model_kw = model_kw or {}
    base = build_model(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(4),
                       **model_kw)
    randomize_preds_(base, torch.Generator().manual_seed(6), which=preds)
    out = {}
    for d in ("cpu", dev):
        model = copy.deepcopy(base).to(d, dtype)
        opt = build_optimizer(model, solver_config(cfg))
        opt.count = 1500  # past the warmup: every group has a learning rate
        state = TrainState(model, opt, ema_init(model), 0)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        kw = dict(step_kw or {})
        if teacher is not None:
            kw["teacher"] = copy.deepcopy(teacher).to(d, dtype)
        step = make_train_step(loss_config(cfg), model_kw.get("representation",
                                                              "OptimizedRepresentation"),
                               (H, W), REF_IMG, warp_impl="separable", device=d, **kw)
        state, parts = step(state, batch, 0)
        out[d] = {
            "parts": {k: v.item() for k, v in parts.items()},
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "delta": {n: (p.detach() - p0[n]).cpu() for n, p in model.named_parameters()},
            "bn": {k: v.cpu() for k, v in model.state_dict().items() if "running" in k},
        }

    c, g = out["cpu"]["parts"], out[dev]["parts"]
    errs = step_errors(out[dev], out["cpu"], held)
    return (c, g, errs, out) if raw else (c, g, errs)


def step_errors(got, want, held=lambda leaf: True):
    """The loss's relative error, and for gradients, parameter updates and
    BatchNorm statistics the largest difference of a leaf over its largest
    entry in ``want`` plus 1e-3 of the largest over all leaves, with the
    leaf (``got`` and ``want`` as :func:`card_vs_cpu_step` collects them)."""
    return {"loss_rel": abs(got["parts"]["loss"] - want["parts"]["loss"])
            / abs(want["parts"]["loss"]),
            **{name: leaf_error(got[key], want[key], held)
               for name, key in (("grads", "grads"), ("updates", "delta"), ("bn_stats", "bn"))}}


def leaf_error(got, want, held=lambda leaf: True):
    """The largest difference of a leaf that ``held`` names over its
    largest entry in ``want`` plus 1e-3 of the largest over all leaves,
    with the leaf."""
    top = max(v.abs().max().item() for v in want.values())
    return max(((((got[k] - want[k]).abs().max() / (want[k].abs().max() + 1e-3 * top)).item(), k)
                for k in want if held(k)), default=(0.0, None))


STEP_TOLERANCE = ("loss 1e-4 relative; gradients and parameter updates 2e-2, BN statistics "
                  "2e-3, of each leaf's largest CPU entry plus 1e-3 of the largest over all "
                  "leaves; positive anchors equal")


def step_within(errs) -> bool:
    return (errs["loss_rel"] <= 1e-4 and errs["grads"][0] <= 2e-2
            and errs["updates"][0] <= 2e-2 and errs["bn_stats"][0] <= 2e-3)


def train_reference(dev):
    """One train step of a shrunk detector at 128 px, batch 4, mosaic and
    mixup at 1.0, on the card and on the CPU from the same weights."""
    from event_representation_study_tpu_torch.utils.config import load_config

    small = load_config("configs/gen1_optimized.py", overrides=SMALL)
    hyp = dict(small["data_aug"], mosaic=1.0, mixup=1.0)
    rng = np.random.default_rng(8)
    batch = make_batch(fake_batch(9, n_windows=4, n_events=5000), fake_labels(rng, 4, REF_IMG),
                       hyp, rng, REF_IMG)
    c, g, errs = card_vs_cpu_step(dev, small, batch)
    say("train_reference", parts_card=g, parts_cpu=c, errors=errs, tolerance=STEP_TOLERANCE,
        tf32=tf32_state())
    require(g["num_pos"] == c["num_pos"] > 0, f"positive anchors {g['num_pos']} vs {c['num_pos']}")
    require(step_within(errs), f"train step card vs CPU: {errs}")


# -- K steps a call, the bf16 step --------------------------------------------

MULTI_K = 4  # steps a K-step call
MULTI_TOLERANCE = ("loss parts 1e-4 relative; parameter updates 2e-2 and the EMA 2e-3 (the "
                   "JAX package's bound for the once-a-call blend, tests/test_train.py, on "
                   "leaves of order 1), each of a leaf's largest entry plus 1e-3 of the "
                   "largest over all leaves: the blends part by the last decay times a step's "
                   "drift, and the BN running variances here are far from order 1; "
                   "4 EMA updates")
BF16_LOSS_RTOL = 1e-2  # first bf16 step vs the f32 step; the CPU test at 128 px: 1.8e-3
BF16_STEPS = 6


def state_snapshot(state):
    """Copies of everything a step changes: parameters and BN statistics,
    the optimizer's state, the EMA and the counters."""
    opt = state.opt_state.state_dict()
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {**opt, "momentum": {k: v.clone() for k, v in opt["momentum"].items()}},
            {k: v.clone() for k, v in state.ema.variables.items()}, state.ema.updates,
            state.step)


def state_restore(state, snap):
    from event_representation_study_tpu_torch.train.ema import EMAState

    model, opt, ema, updates, step = snap
    state.model.load_state_dict(model)
    state.opt_state.load_state_dict(opt)
    for k, v in state.ema.variables.items():
        v.copy_(ema[k])
    state.ema = EMAState(state.ema.variables, updates)
    state.step = step
    return state


def multi_step_phase(dev):
    """The paper detector at full width on the train cell's batches (8 x
    50,000-event windows at 640², image-mode strong augmentation: K1 once,
    K3 twice a step): from one saved state, 4 per-batch steps, one K = 4
    call with the EMA blended every step and one with it blended once
    (``ema_cadence="dispatch"``), each timed after a warm-up of its own.

    The runs are then repeated from the saved state with deterministic
    algorithms (cuDNN's and torch's) for the comparison, the per-batch run
    twice: random weights at a full learning rate make a few steps chaotic,
    and cuDNN's default backward is not bit-reproducible, so two ordinary
    per-batch runs already part by ~0.5% in the third step's loss. Each
    comparison holds the MULTI_TOLERANCE figures, or, where the two
    identical per-batch runs part by more, twice their distance. Returns
    (the saved model state, the batches, the first per-batch step's loss,
    launches {run: {kernel: n}})."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.parallel.train_step import (
        make_multi_train_step, stack_batches)
    from event_representation_study_tpu_torch.utils.config import load_config

    state, step, batches, info = train_setup(dev, BF16_STEPS + 1)
    cfg = load_config("configs/gen1_optimized.py")
    group = batches[:MULTI_K]
    stacked = stack_batches(group)
    multi = {c: make_multi_train_step(loss_config(cfg), MULTI_K, ema_cadence=c,
                                      representation="OptimizedRepresentation", rep_hw=(H, W),
                                      img_size=IMG, warp_impl="separable", device=dev)
             for c in ("step", "dispatch")}

    def per_batch(st):
        parts = []
        for b in group:
            st, p = step(st, b, 5)
            parts.append(p)
        return st, {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    runs = {"per_batch": per_batch,
            "k_step": lambda st: multi["step"](st, stacked, 5),
            "k_dispatch": lambda st: multi["dispatch"](st, stacked, 5)}
    snap = state_snapshot(state)
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}

    def result(run):
        state_restore(state, snap)
        _, parts = run(state)
        return {"parts": {k: v.tolist() for k, v in parts.items()},
                "delta": {n: p.detach() - p0[n] for n, p in state.model.named_parameters()},
                "ema": {k: v.clone() for k, v in state.ema.variables.items()},
                "ema_updates": state.ema.updates, "step": state.step}

    timed, launches = {}, {}
    for name, run in runs.items():
        state_restore(state, snap)
        run(state)  # warm-up
        state_restore(state, snap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        roll.reset_launches()
        t = time.perf_counter()
        _, parts = run(state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches[name] = {k: v for k, v in {**fs.LAUNCHES, **roll.LAUNCHES}.items() if v}
        timed[name] = {"ms_per_step": ms / MULTI_K, "call_ms": ms,
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "loss": parts["loss"].tolist()}
    first_loss = timed["per_batch"]["loss"][0]

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {"per_batch_a": result(per_batch), "per_batch_b": result(per_batch),
               "k_step": result(runs["k_step"]), "k_dispatch": result(runs["k_dispatch"])}
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False

    def dist(a, b):
        return {"parts_rel": max(abs(x - y) / abs(y) for k in ("loss", "iou", "dfl", "cls")
                                 for x, y in zip(a["parts"][k], b["parts"][k])),
                "updates": leaf_error(a["delta"], b["delta"])[0],
                "ema": leaf_error(a["ema"], b["ema"]),
                "ema_abs": max((a["ema"][k] - b["ema"][k]).abs().max().item() for k in b["ema"])}

    noise = dist(out["per_batch_b"], out["per_batch_a"])
    errs = {"k_step_vs_per_batch": dist(out["k_step"], out["per_batch_a"]),
            "dispatch_vs_step": dist(out["k_dispatch"], out["k_step"]),
            "per_batch_repeat": noise}
    fixed = {"parts_rel": 1e-4, "updates": 2e-2, "ema": 2e-3}
    allowed = {k: max(v, 2 * (noise[k][0] if k == "ema" else noise[k])) for k, v in fixed.items()}
    say("multi_step", k=MULTI_K, batch=B, events_per_window=N, img=IMG,
        params=info["params"], tf32=tf32_state(), launches=launches, **timed,
        errors=errs, allowed=allowed, tolerance=MULTI_TOLERANCE + "; or twice the distance of "
        "two identical per-batch runs where that is larger (compared with deterministic "
        "algorithms)", compared={k: {f: r[f] for f in ("parts", "ema_updates", "step")}
                                 for k, r in out.items()})
    for name, n in launches.items():
        require(n.get(fs.K1) == MULTI_K and n.get(roll.K3) == 2 * MULTI_K,
                f"{name}: launches {n} for {MULTI_K} steps")
    require(all(math.isfinite(v) for r in out.values() for vs in r["parts"].values() for v in vs),
            "finite loss parts")
    require(all(r["step"] == r["ema_updates"] == MULTI_K for r in out.values()),
            "4 steps and 4 EMA updates a run")
    ks, kd = errs["k_step_vs_per_batch"], errs["dispatch_vs_step"]
    require(ks["parts_rel"] <= allowed["parts_rel"] and ks["updates"] <= allowed["updates"]
            and ks["ema"][0] <= allowed["ema"], f"K-step call: {errs} > {allowed}")
    require(kd["updates"] <= allowed["updates"] and kd["ema"][0] <= allowed["ema"],
            f"dispatch cadence: {errs} > {allowed}")
    model_state = snap[0]
    del state, step, multi, out, snap, p0
    torch.cuda.empty_cache()
    return model_state, batches, first_loss, launches


def bf16_train_phase(dev, model_state, batches, f32_loss):
    """The paper detector built with ``dtype=torch.bfloat16`` (autocast over
    float32 weights) from the multi_step phase's saved state, on its
    batches: a warm-up step (its loss against the f32 step's from the same
    weights and batch) and 6 timed steps (3 ATSS + 3 TAL); every K3 launch
    must take a bf16 source. Returns (launches, the warm-up's K3
    arguments)."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll

    state, step, _, info = train_setup(dev, 0, model_kw={"dtype": torch.bfloat16},
                                       batches=batches)
    state.model.load_state_dict(model_state)
    t0 = time.perf_counter()
    (state, parts), k3_args = capture_roll_inputs(lambda: step(state, batches[0], 5))
    warm = {k: v.item() for k, v in parts.items()}
    warm_ms = (time.perf_counter() - t0) * 1e3
    (state, times, per_step, launches, peak), dtypes = capture_roll_inputs(
        lambda: timed_steps(state, step, batches[1:]), keep=lambda args: str(args[0].dtype))
    loss_rel = abs(warm["loss"] - f32_loss) / abs(f32_loss)
    say("bf16_train", batch=B, events_per_window=N, img=IMG, params=info["params"],
        warmup_step=warm, warmup_step_ms=warm_ms, f32_first_loss=f32_loss,
        first_loss_rel_vs_f32=loss_rel,
        tolerance=f"first loss within {BF16_LOSS_RTOL} relative of the f32 step's (the CPU "
                  "test at 128 px: 1.8e-3 port, 1.6e-3 JAX)",
        ms_per_step=times, median_ms=statistics.median(times), peak_mem_bytes=peak,
        steps=per_step, launches=launches, roll_source_dtypes=sorted(set(dtypes)),
        roll_calls=len(dtypes), warmup_roll_dtypes=[str(a[0].dtype) for a in k3_args],
        param_dtypes=sorted({str(p.dtype) for p in state.model.parameters()}),
        tf32=tf32_state())
    require(launches[fs.K1] == BF16_STEPS and launches[roll.K3] == 2 * BF16_STEPS,
            f"bf16 steps: launches {launches}")
    require(dtypes == ["torch.bfloat16"] * 2 * BF16_STEPS and len(k3_args) == 2
            and all(a[0].dtype == torch.bfloat16 for a in k3_args),
            f"bf16 roll sources: {dtypes}, warm-up {[a[0].dtype for a in k3_args]}")
    require(all(math.isfinite(v) for st in per_step for v in st.values()), "finite bf16 losses")
    require(all(p.dtype == torch.float32 for p in state.model.parameters()), "f32 weights")
    require(loss_rel <= BF16_LOSS_RTOL, f"bf16 first loss vs f32: {loss_rel}")
    stages = step_stages(state, step, batches, dev, mosaic=False, gather_dtype=torch.bfloat16)
    say("bf16_train_stages_ms", epoch=5, tf32=tf32_state(),
        **{k: statistics.median(v) for k, v in stages.items()}, all_runs=stages)
    del state, step
    torch.cuda.empty_cache()
    return launches, k3_args


def rel_l2(got, want, key) -> float:
    """||got - want|| / ||want|| over every leaf of ``key`` at once."""
    num = sum(float(((got[key][k] - w).double() ** 2).sum()) for k, w in want[key].items())
    return math.sqrt(num / sum(float((w.double() ** 2).sum()) for w in want[key].values()))


def bf16_reference(dev):
    """The shrunk bf16 step at 128 px on the card and on the CPU from the
    same weights. bf16 rounding of the activations, which the two devices'
    autocast round apart, moves single leaves far (a residual scale's
    gradient sums a whole tensor: 5.8x its scale between bf16 and f32 on
    the CPU), so the step is held as a whole: the loss, and the relative L2
    distance over all gradients, all updates and all BN statistics, each
    within twice the CPU's own bf16-vs-f32 distance plus 1e-3."""
    from event_representation_study_tpu_torch.utils.config import load_config

    small = load_config("configs/gen1_optimized.py", overrides=SMALL)
    hyp = dict(small["data_aug"], mosaic=1.0, mixup=1.0)
    rng = np.random.default_rng(8)
    batch = make_batch(fake_batch(9, n_windows=4, n_events=5000), fake_labels(rng, 4, REF_IMG),
                       hyp, rng, REF_IMG)
    # the class preds at their init, as the full-width steps keep them:
    # random ones saturate the scores, and the varifocal loss's gradient
    # then swamps the step in rounding
    c, g, errs, out16 = card_vs_cpu_step(dev, small, batch, model_kw={"dtype": torch.bfloat16},
                                         raw=True, preds="reg_pred")
    _, _, _, out32 = card_vs_cpu_step(dev, small, batch, raw=True, preds="reg_pred")

    def distances(got, want):
        return {"loss_rel": abs(got["parts"]["loss"] - want["parts"]["loss"])
                / abs(want["parts"]["loss"]),
                **{f"{key}_l2": rel_l2(got, want, key) for key in ("grads", "delta", "bn")}}

    held = distances(out16[dev], out16["cpu"])
    cpu_dev = distances(out16["cpu"], out32["cpu"])
    allowed = {k: 2 * v + 1e-3 for k, v in cpu_dev.items()}
    say("bf16_reference", parts_card=g, parts_cpu=c, distances=held,
        cpu_bf16_vs_f32=cpu_dev, allowed=allowed, leafwise_errors=errs,
        tolerance="each distance (the loss relative; gradients, updates, BN statistics as "
                  "relative L2 over all leaves) within 2x the CPU's bf16-vs-f32 one plus 1e-3",
        tf32=tf32_state())
    require(g["num_pos"] == c["num_pos"] > 0, f"positive anchors {g['num_pos']} vs {c['num_pos']}")
    require(all(held[k] <= allowed[k] for k in held), f"bf16 step card vs CPU: {held} > {allowed}")


def tb_records(path):
    """(step, {tag: value}) of each scalar event of a TensorBoard event
    file, its framing CRCs verified (length and data, TFRecord's masked
    CRC32-C) and the Event protos decoded by hand: this machine need not
    have the ``tensorboard`` package."""
    import struct

    from event_representation_study_tpu_torch.utils.tb_native import masked_crc

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            num, wire = key >> 3, key & 7
            if wire == 0:
                val, i = varint(buf, i)
            elif wire == 1:
                val, i = buf[i:i + 8], i + 8
            elif wire == 5:
                val, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                val, i = buf[i:i + n], i + n
            yield num, val

    def varint(buf, i):
        out = shift = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return out, i

    data, off, records = path.read_bytes(), 0, []
    while off < len(data):
        header = data[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        payload = data[off + 12:off + 12 + length]
        require(struct.unpack("<I", data[off + 8:off + 12])[0] == masked_crc(header)
                and struct.unpack("<I", data[off + 12 + length:off + 16 + length])[0]
                == masked_crc(payload), f"event record CRC at byte {off}")
        off += 16 + length
        ev = dict(fields(payload))
        if 5 in ev:  # summary: values of (tag, simple_value)
            values = {}
            for num, v in fields(ev[5]):
                f = dict(fields(v))
                if 2 in f:
                    values[f[1].decode()] = struct.unpack("<f", f[2])[0]
            records.append((ev.get(2, 0), values))
    return records


def multi_step_trainer_phase(dev):
    """``cli/train.py --steps-per-dispatch 4 --ema-cadence dispatch`` on the
    trainer phase's synthetic splits with 5 batches an epoch (one K-step
    call and one remainder step), 1 epoch with the event-space strong
    augmentation (K1 once a step, K3 never) and an eval, the TensorBoard
    writer on (``use_tensorboard``) and the loss logged every 4 steps.
    Returns the K1 launches."""
    import logging
    import pathlib
    import tempfile

    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.train import engine, evaler

    calls, evals, summary = [], [], []
    real = {"multi": engine.make_multi_train_step, "step": engine.make_train_step,
            "eval": evaler.make_eval_step, "init": engine.Trainer.__init__}

    def timed(kind, fn):
        def call(*a):
            before, t = (fs.LAUNCHES[fs.K1], roll.LAUNCHES[roll.K3]), time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            calls.append({"kind": kind, "ms": (time.perf_counter() - t) * 1e3,
                          "k1": fs.LAUNCHES[fs.K1] - before[0],
                          "k3": roll.LAUNCHES[roll.K3] - before[1]})
            return out

        return call

    def counted(*a, **k):
        step = real["eval"](*a, **k)

        def run(*b):
            before = fs.LAUNCHES[fs.K1]
            out = step(*b)
            evals.append(fs.LAUNCHES[fs.K1] - before)
            return out

        return run

    def init(self, *a, **k):
        real["init"](self, *a, **k)
        self.log_interval = MULTI_K  # every call crosses a log step

    class Catch(logging.Handler):
        def emit(self, record):
            if "Model Summary" in record.getMessage():
                summary.append(record.getMessage())

    handler = Catch()
    logging.getLogger("engine").addHandler(handler)
    engine.make_multi_train_step = lambda *a, **k: timed("k_call", real["multi"](*a, **k))
    engine.make_train_step = lambda *a, **k: timed("step", real["step"](*a, **k))
    evaler.make_eval_step, engine.Trainer.__init__ = counted, init
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = pathlib.Path(tmp)
            _trainer_fixture(root, train_boxes=20)  # 40 windows: 5 batches of 8
            fs.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr = train_cli.main([
                "--conf", "configs/gen1_optimized.py", "--data-path", tmp,
                "--batch-size", str(B), "--img-size", str(IMG), "--num-events", str(N),
                "--augment", "--aug-mode", "auto", "--stop-aug-last-n-epoch", "0",
                "--epochs", "1", "--steps-per-dispatch", str(MULTI_K), "--ema-cadence",
                "dispatch", "--output-dir", f"{tmp}/run", "--override", "use_tensorboard=True"])
            run_s = time.perf_counter() - t0
            k1 = fs.LAUNCHES[fs.K1]
            peak = torch.cuda.max_memory_allocated()
            tb = sorted((root / "run" / "tb").glob("events.out.tfevents.*"))
            records = tb_records(tb[0]) if len(tb) == 1 else []
            logged = [json.loads(ln)["step"]
                      for ln in (root / "run" / "metrics.jsonl").read_text().splitlines()]
            info = {"loader_batches": len(tr.train_loader), "steps": tr.state.step,
                    "ema_updates": tr.state.ema.updates, "aug_mode": tr.aug_mode,
                    "steps_per_dispatch": tr.steps_per_dispatch, "best_ap": tr.best_ap}
            del tr
    finally:
        engine.make_multi_train_step, engine.make_train_step = real["multi"], real["step"]
        evaler.make_eval_step, engine.Trainer.__init__ = real["eval"], real["init"]
        logging.getLogger("engine").removeHandler(handler)
    torch.cuda.empty_cache()
    k_calls = [c for c in calls if c["kind"] == "k_call"]
    steps = [c for c in calls if c["kind"] == "step"]
    step_ms = [c["ms"] / MULTI_K for c in k_calls] + [c["ms"] for c in steps]
    tb_steps = sorted({st for st, vals in records if vals})
    say("multi_step_trainer", **info, run_s=run_s, calls=calls,
        step_ms_median=statistics.median(step_ms), k_call_ms_per_step=[c["ms"] / MULTI_K
                                                                        for c in k_calls],
        remainder_step_ms=[c["ms"] for c in steps], eval_k1_per_batch=evals, k1_launches=k1,
        model_summary=summary, tb_files=len(tb), tb_records=len(records),
        tb_scalar_steps=tb_steps, logged_steps=logged, peak_mem_bytes=peak, tf32=tf32_state())
    require(info["loader_batches"] == MULTI_K + 1, f"{info['loader_batches']} batches an epoch")
    require([c["kind"] for c in calls] == ["k_call", "step"], f"calls {calls}")
    require(k_calls[0]["k1"] == MULTI_K and steps[0]["k1"] == 1
            and all(c["k3"] == 0 for c in calls), f"launches {calls}")
    require(info["steps"] == info["ema_updates"] == MULTI_K + 1, f"counters {info}")
    require(k1 == MULTI_K + 1 + len(evals) and all(e == 1 for e in evals) and evals,
            f"K1 {k1}, eval batches {evals}")
    params_m = [float(m) for m in
                re.findall(r"Params: ([\d.]+)M, Gflops: [\d.]+", "".join(summary))]
    require(len(summary) == 1 and len(params_m) == 1 and round(params_m[0], 1) == 140.3,
            f"model summary {summary}")
    require(len(tb) == 1 and tb_steps and set(logged) <= set(tb_steps),
            f"TensorBoard: {len(tb)} files, scalar steps {tb_steps}, logged {logged}")
    require(math.isfinite(info["best_ap"]), "AP finite")
    return k1


MOSAIC_POOL = 2  # partner-pool rows of the event_mosaic phase


def mosaic_plan(n_rows: int, seed0: int):
    """Fake windows and a strong-aug plan with the paper's ``data_aug`` for
    ``B`` emitted rows and ``n_rows - B`` partner-pool rows: the first draw
    from ``seed0`` on whose emitted rows mosaic, mixup (one partner from the
    pool) and a flip all occur."""
    from event_representation_study_tpu_torch.data.augment import plan_augment_batch
    from event_representation_study_tpu_torch.ops.warp import AugPlan
    from event_representation_study_tpu_torch.utils.config import load_config

    hyp = dict(load_config("configs/gen1_optimized.py")["data_aug"])
    for seed in range(seed0, seed0 + 200):
        rng = np.random.default_rng(seed)
        plan, _, _ = plan_augment_batch(fake_labels(rng, n_rows), IMG, hyp, rng, 64, n_out=B)
        p = {k: v[:B] for k, v in plan.items()}
        rows = {"mosaic": int((p["src_idx"] != p["src_idx"][:, :1]).any(1).sum()),
                "mixup": int((p["mix_r"] < 1).sum()),
                "mixup_from_pool": int(((p["mix_r"] < 1) & (p["mix_idx"] >= B)).sum()),
                "flip_lr": int((p["fwd_affine"][:, 0, 0] < 0).sum())}
        if min(rows.values()) > 0:
            return AugPlan(**plan), rows, seed
    raise AssertionError("no plan draw exercises mosaic, pool mixup and flips")


def event_mosaic_phase(dev):
    """One full-width ``mosaic_event_rep`` (ERGO-12, 640², 8 emitted rows
    plus a partner pool of 2 from which mixup draws) on the card (one K1
    launch) against the same call on the CPU (the plain version). Returns
    the K1 launches of the call."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.reps.event_mosaic import mosaic_event_rep

    n_rows = B + MOSAIC_POOL
    blocks = fake_batch(300, n_windows=n_rows)
    plan, rows, seed = mosaic_plan(n_rows, 40)
    blocks_d, plan_d = blocks.to(dev), plan.to(dev)
    mosaic_event_rep(blocks_d, plan_d, "ERGO12", (H, W), IMG)  # warm-up
    torch.cuda.synchronize()
    fs.reset_launches()
    got, glue, k1_args = capture_kernel_inputs(
        lambda: mosaic_event_rep(blocks_d, plan_d, "ERGO12", (H, W), IMG))
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    want, glue_cpu, _ = capture_kernel_inputs(
        lambda: mosaic_event_rep(blocks, plan.to("cpu"), "ERGO12", (H, W), IMG))
    err = (got.cpu() - want).abs().max().item()
    seg_equal = torch.equal(glue[0].cpu(), glue_cpu[0])
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        mosaic_event_rep(blocks_d, plan_d, "ERGO12", (H, W), IMG)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    seg = glue[0]
    say("event_mosaic", shape=list(got.shape), emitted_rows=B, pool_rows=MOSAIC_POOL,
        plan_seed=seed, plan_rows=rows, k1_shape=list(k1_args[1].shape),
        events_kept=int((seg < IMG * IMG).sum()),
        events_of_the_tiles=int(blocks.num[torch.as_tensor(plan.src_idx).long()].sum()),
        max_abs_err_vs_cpu=err, seg_equal_cpu=seg_equal, launches=launches,
        ms_runs=times, median_ms=statistics.median(times),
        tolerance="0.05 on the 0..255 scale; event destinations (seg) equal", tf32=tf32_state())
    require(launches[fs.K1] == 1 and launches[fs.K2] == 0, f"event mosaic launches {launches}")
    require(got.shape == (n_rows, IMG, IMG, 12) and bool(torch.isfinite(got).all()),
            "event mosaic: shape or finiteness")
    require(seg_equal and err <= 0.05, f"event mosaic card vs CPU: seg {seg_equal}, err {err}")
    return launches[fs.K1]


TRAINER_EPOCHS, TRAINER_BOXES = 2, 16


def _trainer_fixture(root, val_boxes: int = TRAINER_BOXES, train: bool = True,
                     train_boxes: int = TRAINER_BOXES):
    """Synthetic Gen1 splits from the port's writer: training 2 recordings x
    ``train_boxes`` boxes (unless ``train`` is false), validation 1 x ``val_boxes``,
    200,000 events a recording for each 16 boxes; Blosc-ZSTD chunks when
    this process can encode them and has h5py. Without h5py the splits stay
    unfiltered, as in the runs before ``events/h5lite.py`` wrote chunks, so
    that this phase's loader times compare across runs (the gen4 phase
    writes Blosc through h5lite). Returns (what wrote it, seconds)."""
    from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
    from event_representation_study_tpu_torch.events import blosc_codec, h5lite

    hdf5 = "h5lite" if blosc_codec.h5py is h5lite else "h5py"
    blosc = blosc_codec.available() and hdf5 == "h5py"
    t0 = time.perf_counter()
    splits = [("training.h5", 2, 1, train_boxes)] if train else []
    for split, files, seed, boxes in splits + [("validation.h5", 1, 2, val_boxes)]:
        write_gen1_fixture(root / split, num_files=files, boxes_per_file=boxes,
                           events_per_file=200_000 * boxes // TRAINER_BOXES, seed=seed,
                           blosc=blosc)
    return {"hdf5": hdf5, "blosc": blosc}, time.perf_counter() - t0


class TrainerProbe:
    """Wraps the Trainer's train step, the Evaler's eval step, the loader's
    batch assembly and the checkpoint functions, recording per call what
    the checks and the printed numbers need. The train step is followed by
    a synchronise, so that its host time is the step's."""

    def __init__(self):
        self.steps, self.evals, self.batches, self.saves, self.restores = [], [], [], [], []
        self.snapshot = None

    def install(self):
        from event_representation_study_tpu_torch.data.loader import EventBatchLoader
        from event_representation_study_tpu_torch.ops import fused_scatter as fs
        from event_representation_study_tpu_torch.ops import roll
        from event_representation_study_tpu_torch.train import checkpoint, engine, evaler

        probe = self
        real = {"step": engine.make_train_step, "eval": evaler.make_eval_step,
                "batch": EventBatchLoader._make_batch, "save": engine.save_checkpoint,
                "restore": checkpoint.restore_train_state}

        def launches():
            return fs.LAUNCHES[fs.K1], roll.LAUNCHES[roll.K3]

        def make_train_step(*a, **k):
            step = real["step"](*a, **k)

            def timed(state, batch, epoch):
                if probe.snapshot is None:
                    probe.snapshot = (
                        {n: p.detach().clone() for n, p in state.model.named_parameters()},
                        {n: v.clone() for n, v in state.ema.variables.items()})
                before, step0, t = launches(), state.step, time.perf_counter()
                state, parts = step(state, batch, epoch)
                vals = {n: v.item() for n, v in parts.items()}  # waits for the step
                ms = (time.perf_counter() - t) * 1e3
                k1, k3 = (x - y for x, y in zip(launches(), before))
                probe.steps.append(dict(epoch=epoch, step_before=step0, mosaic=batch.aug is not None,
                                        k1=k1, k3=k3, ms=ms, **vals))
                return state, parts

            return timed

        def make_eval_step(*a, **k):
            step = real["eval"](*a, **k)

            def counted(variables, batch):
                before = launches()[0]
                out = step(variables, batch)
                probe.evals.append(launches()[0] - before)
                return out

            return counted

        def make_batch(loader, indices):
            t = time.perf_counter()
            out = real["batch"](loader, indices)
            hyp = loader.hyp
            kind = ("eval" if hyp is None else "strong" if hyp["mosaic"] > 0 or hyp["mixup"] > 0
                    else "affine")
            probe.batches.append((kind, (time.perf_counter() - t) * 1e3))
            return out

        def save(path, *a, **k):
            t = time.perf_counter()
            real["save"](path, *a, **k)
            probe.saves.append((time.perf_counter() - t, path.stat().st_size))

        def restore(*a, **k):
            t = time.perf_counter()
            out = real["restore"](*a, **k)
            probe.restores.append(time.perf_counter() - t)
            return out

        engine.make_train_step, evaler.make_eval_step = make_train_step, make_eval_step
        EventBatchLoader._make_batch = make_batch
        engine.save_checkpoint, checkpoint.restore_train_state = save, restore
        self.real = real

    def uninstall(self):
        from event_representation_study_tpu_torch.data.loader import EventBatchLoader
        from event_representation_study_tpu_torch.train import checkpoint, engine, evaler

        engine.make_train_step, evaler.make_eval_step = self.real["step"], self.real["eval"]
        EventBatchLoader._make_batch = self.real["batch"]
        engine.save_checkpoint = self.real["save"]
        checkpoint.restore_train_state = self.real["restore"]


def trainer_phase(dev):
    """``cli/train.py`` at the full width of ``configs/gen1_optimized.py`` on
    synthetic Gen1 splits: 2 epochs with ``--augment`` (epoch 0 event
    mosaic, epoch 1 after the stop-aug boundary the event-space affine),
    eval each epoch, then a resume for a third epoch, then ``cli/eval.py``
    on the last checkpoint. Returns the K1 launches of the two train runs
    and the eval."""
    import tempfile

    from event_representation_study_tpu_torch.cli import eval as eval_cli
    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.data.gen1 import Gen1H5
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.train import engine

    stats = []
    real_eval_and_save = engine.Trainer.eval_and_save

    def eval_and_save(self, epoch):
        stats.append(real_eval_and_save(self, epoch))
        return stats[-1]

    probe = TrainerProbe()
    with tempfile.TemporaryDirectory() as tmp:
        import pathlib

        root = pathlib.Path(tmp)
        written, fixture_s = _trainer_fixture(root)
        ds = Gen1H5(root, "train", num_events=N)
        n_windows, full = len(ds), sum(ds[i].num_events == N for i in range(len(ds)))
        ds.h5.close()
        args = ["--conf", "configs/gen1_optimized.py", "--data-path", tmp,
                "--batch-size", str(B), "--img-size", str(IMG), "--num-events", str(N),
                "--augment", "--aug-mode", "auto", "--stop-aug-last-n-epoch", "1",
                "--eval-interval", "1"]
        probe.install()
        engine.Trainer.eval_and_save = eval_and_save
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fs.reset_launches()
            t0 = time.perf_counter()
            tr = train_cli.main(args + ["--epochs", str(TRAINER_EPOCHS),
                                        "--output-dir", f"{tmp}/run1"])
            run1_s = time.perf_counter() - t0
            k1_run1 = fs.LAUNCHES[fs.K1]
            steps1, evals1 = list(probe.steps), list(probe.evals)
            changed = sum(not torch.equal(probe.snapshot[0][n], p)
                          for n, p in tr.state.model.named_parameters())
            ema_changed = sum(not torch.equal(probe.snapshot[1][n], v)
                              for n, v in tr.state.ema.variables.items())
            n_params, n_ema = len(probe.snapshot[0]), len(probe.snapshot[1])
            ckpts = {c: (root / "run1" / c).exists() for c in ("last_ckpt", "best_ckpt")}
            info = {"aug_mode": tr.aug_mode, "accumulate": tr.accumulate,
                    "loader_batches": len(tr.train_loader), "val_batches": len(tr.val_loader),
                    "optimizer_updates": tr.state.opt_state.count}
            del tr
            torch.cuda.empty_cache()

            fs.reset_launches()
            t0 = time.perf_counter()
            tr2 = train_cli.main(args + ["--epochs", str(TRAINER_EPOCHS + 1),
                                         "--checkpoint", f"{tmp}/run1/last_ckpt",
                                         "--output-dir", f"{tmp}/run2"])
            run2_s = time.perf_counter() - t0
            k1_run2 = fs.LAUNCHES[fs.K1]
            steps2, evals2 = probe.steps[len(steps1):], probe.evals[len(evals1):]
            start_epoch, resumed_step = tr2.start_epoch, tr2.state.step
            del tr2
            torch.cuda.empty_cache()

            fs.reset_launches()
            cli_stats = eval_cli.main(["--conf", "configs/gen1_optimized.py", "--data-path", tmp,
                                       "--checkpoint", f"{tmp}/run2/last_ckpt", "--task", "val",
                                       "--batch-size", str(B), "--img-size", str(IMG),
                                       "--num-events", str(N)])
            k1_eval = fs.LAUNCHES[fs.K1]
            evals3 = probe.evals[len(evals1) + len(evals2):]
        finally:
            probe.uninstall()
            engine.Trainer.eval_and_save = real_eval_and_save
        peak = torch.cuda.max_memory_allocated()

    def median_by(rows, key, field):
        vals = [r[field] for r in rows if key(r)]
        return statistics.median(vals) if vals else None

    loader_ms = {k: statistics.median([ms for kind, ms in probe.batches if kind == k])
                 for k in ("strong", "affine", "eval")}
    step_ms = {f"epoch_{e}": median_by(steps1 + steps2, lambda r: r["epoch"] == e, "ms")
               for e in range(TRAINER_EPOCHS + 1)}
    say("trainer", fixture={**written, "seconds": fixture_s, "train_windows": n_windows,
                            "windows_full_at_50k": int(full)},
        **info, run1_s=run1_s, run2_s=run2_s,
        steps=[{k: r[k] for k in ("epoch", "mosaic", "k1", "k3", "loss", "num_pos")}
               for r in steps1 + steps2],
        k1_launches={"run1": k1_run1, "run2": k1_run2, "eval_cli": k1_eval},
        eval_k1_per_batch=evals1 + evals2 + evals3,
        params_changed=changed, params_total=n_params, ema_changed=ema_changed, ema_total=n_ema,
        checkpoints=ckpts, start_epoch=start_epoch,
        first_resumed_step=steps2[0]["step_before"] if steps2 else None,
        steps_run1=len(steps1), resumed_step=resumed_step,
        ap_trainer_last=stats[-1]["AP"], ap_eval_cli=cli_stats["AP"],
        peak_mem_bytes=peak, tf32=tf32_state())
    say("trainer_host_ms", loader_make_batch_median_ms=loader_ms,
        loader_batches={k: sum(kind == k for kind, _ in probe.batches)
                        for k in ("strong", "affine", "eval")},
        step_ms_median=step_ms, step_ms=[r["ms"] for r in steps1 + steps2],
        eval_speed_ms_per_image=[{k: s[k] for k in ("speed_pre_ms", "speed_infer_nms_ms",
                                                     "speed_post_ms")} for s in stats],
        eval_cli_speed_ms_per_image={k: cli_stats[k] for k in (
            "speed_pre_ms", "speed_infer_nms_ms", "speed_post_ms")},
        checkpoint_save=[{"s": s, "bytes": b} for s, b in probe.saves],
        checkpoint_restore_s=probe.restores)

    require(info["aug_mode"] == "event", f"aug_mode auto resolved to {info['aug_mode']}")
    per_epoch = info["loader_batches"]
    require(len(steps1) == TRAINER_EPOCHS * per_epoch and len(steps2) == per_epoch,
            f"steps {len(steps1)} + {len(steps2)} for {per_epoch} batches an epoch")
    for r in steps1 + steps2:
        strong = r["epoch"] < TRAINER_EPOCHS - 1
        require(r["mosaic"] == strong and r["k1"] == 1 and r["k3"] == 0,
                f"epoch {r['epoch']} step: mosaic {r['mosaic']}, K1 {r['k1']}, K3 {r['k3']}")
        require(all(math.isfinite(r[k]) for k in ("loss", "iou", "dfl", "cls")), f"losses {r}")
    require(all(e == 1 for e in evals1 + evals2 + evals3) and
            len(evals1) == TRAINER_EPOCHS * info["val_batches"] and
            len(evals2) == len(evals3) == info["val_batches"],
            f"eval batches {evals1} / {evals2} / {evals3}")
    require(k1_run1 == len(steps1) + len(evals1) and k1_run2 == len(steps2) + len(evals2)
            and k1_eval == len(evals3),
            f"K1 launches {k1_run1}, {k1_run2}, {k1_eval} vs steps + eval batches")
    # the learning rates are still in their warmup (at most a few thousandths
    # of lr0 for weights): a change, not its size
    require(changed > 0 and ema_changed > 0,
            f"parameters changed {changed}/{n_params}, EMA {ema_changed}/{n_ema}")
    require(all(ckpts.values()), f"checkpoints {ckpts}")
    require(start_epoch == TRAINER_EPOCHS and steps2[0]["step_before"] == len(steps1)
            and resumed_step == len(steps1) + len(steps2),
            f"resume: start epoch {start_epoch}, first step {steps2[0]['step_before']}")
    require(all(math.isfinite(v) for s in stats + [cli_stats] for k, v in s.items()
                if isinstance(v, float)), "COCO stats finite")
    require(all(k in s for s in stats for k in ("speed_pre_ms", "speed_infer_nms_ms",
                                                 "speed_post_ms")), "speed slots")
    require(abs(stats[-1]["AP"] - cli_stats["AP"]) <= 1e-6,
            f"AP of the last eval {stats[-1]['AP']} vs cli/eval.py {cli_stats['AP']}")
    return k1_run1 + k1_run2 + k1_eval


REP_NAMES = ("VoxelGrid", "MixedDensityEventStack", "OptimizedRepresentation", "EventStack",
             "EventHistogram", "TORE", "TimeSurface")
# card vs CPU (x255 scale), (rtol, atol): exact where the work is counts and
# maxes; the float32 exp, log and divisions after the kernel may round one ulp
# apart on the two devices, and near 0 an ulp of log(151) is 1.2e-4 here
REP_TOLERANCE = {"VoxelGrid": (1e-5, 1e-4), "MixedDensityEventStack": (0.0, 2e-4 * 255),
                 "OptimizedRepresentation": (0.0, 2e-4 * 255), "EventStack": (0.0, 0.0),
                 "EventHistogram": (0.0, 0.0), "TORE": (1e-6, 1e-3), "TimeSurface": (1e-5, 1e-4)}
# the kernel shapes of the representation library held by check_kernel
REP_KERNEL_SHAPES = {"EventStack": "kernel_K1_event_stack", "TimeSurface": "kernel_K1_time_surface",
                     "EventHistogram": "kernel_K2_histogram", "VoxelGrid": "kernel_K2_voxel_grid"}


def capture_topk_slots(fn):
    """Run ``fn`` and return its result with the (segments, k) slots that
    TORE's segmented top-k produced."""
    from event_representation_study_tpu_torch.ops import scatter

    seen = []
    real = scatter.segment_topk_recent_values

    def topk(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    scatter.segment_topk_recent_values = topk
    try:
        out = fn()
    finally:
        scatter.segment_topk_recent_values = real
    return out, seen[0]


def representations_phase(dev, flush):
    """Every representation through ``batched_representation`` on 8 Gen1
    windows of 50,000 events, card vs CPU, timed, with the launches of each
    call; K1/K2 at the new shapes against their plain versions. Returns
    (K1/K2 launches by name, the check_kernel entries by shape)."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.reps.dispatch import batched_representation

    blocks = fake_batch(500)
    blocks_d = blocks.to(dev)
    rows, launches, kernel_args = {}, {}, {}
    for name in REP_NAMES:
        fn = batched_representation(name, H, W)
        fn(blocks_d)  # warm-up
        torch.cuda.synchronize()
        fs.reset_launches()
        if name == "TORE":
            got, slots = capture_topk_slots(lambda: fn(blocks_d))
        elif name in REP_KERNEL_SHAPES:
            got, _, kernel_args[name] = capture_kernel_inputs(lambda: fn(blocks_d))
        else:
            got = fn(blocks_d)
        torch.cuda.synchronize()
        launches[name] = dict(fs.LAUNCHES)
        if name == "TORE":
            want, want_slots = capture_topk_slots(lambda: fn(blocks))
        else:
            want = fn(blocks)
        got = got.cpu()
        err = (got - want).abs().max().item()
        rtol, atol = REP_TOLERANCE[name]
        ok = torch.allclose(got, want, rtol=rtol, atol=atol) if rtol or atol else torch.equal(got, want)
        if name == "TORE":
            ok = ok and torch.equal(slots.cpu(), want_slots)
        times = []
        for _ in range(10):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(blocks_d)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        rows[name] = {"shape": list(got.shape), "launches": launches[name],
                      "max_abs_err_vs_cpu": err, "rtol_atol": [rtol, atol], "agrees": ok,
                      "median_ms": statistics.median(times), "ms_runs": times,
                      "finite": bool(torch.isfinite(got).all())}
        require(ok and rows[name]["finite"], f"{name} card vs CPU: {rows[name]}")
        expect = {"EventHistogram": (0, 1), "VoxelGrid": (0, 1), "TORE": (0, 0)}.get(name, (1, 0))
        require((launches[name][fs.K1], launches[name][fs.K2]) == expect,
                f"{name}: launches {launches[name]}, expected K1/K2 {expect}")
        del got, want
    say("representations", windows=B, events_per_window=N, sensor=[H, W], reps=rows,
        note="x255 scale; rtol_atol [0, 0] is exact; TORE's top-k slots (its sample "
             "times) are compared exactly too", tf32=tf32_state())
    entries = {}
    for name, label in REP_KERNEL_SHAPES.items():
        args = kernel_args[name]
        entries[name] = check_kernel(label, args, [0, 1] if name == "EventHistogram" else [], flush)
        entries[name]["share_of_representation"] = entries[name]["ms"] / rows[name]["median_ms"]
    del blocks_d, kernel_args
    torch.cuda.empty_cache()
    return launches, entries


GWD_WINDOWS = 8


class StageTimer:
    """Wraps module functions so that each call's host time, synchronised
    with the card before and after, adds to a named bucket."""

    def __init__(self):
        self.seconds, self.calls, self._restore = {}, {}, []

    def timed(self, bucket: str, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds[bucket] = self.seconds.get(bucket, 0.0) + time.perf_counter() - t
            self.calls[bucket] = self.calls.get(bucket, 0) + 1
            return out

        return run

    def wrap(self, module, attr: str, bucket: str, factory: bool = False):
        """Time ``module.attr``, or with ``factory`` the functions it returns."""
        real = getattr(module, attr)
        setattr(module, attr, (lambda *a, **k: self.timed(bucket, real(*a, **k))) if factory
                else self.timed(bucket, real))
        self._restore.append((module, attr, real))

    def restore(self):
        for module, attr, real in reversed(self._restore):
            setattr(module, attr, real)
        self._restore = []


def gwd_phase(dev):
    """``cli/gwd.py`` for ERGO-12 and the voxel grid on a synthetic Gen1
    validation split, host loop and --batched, with the stages of each
    timed; ``otmi_batched`` card vs CPU; the protocol's sense on the card.
    Returns the K1/K2 launches of the --batched runs."""
    import pathlib
    import tempfile

    from event_representation_study_tpu_torch.cli import gwd
    from event_representation_study_tpu_torch.data.gen1 import Gen1H5, write_gen1_fixture
    from event_representation_study_tpu_torch.events import (
        from_structured, generate_fake_events, stack_blocks)
    from event_representation_study_tpu_torch.metrics import chosen_indexes
    from event_representation_study_tpu_torch.metrics import otmi as otmi_mod
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.reps import dispatch
    from event_representation_study_tpu_torch.reps.dispatch import batched_representation

    runs, launches = {}, {fs.K1: 0, fs.K2: 0}
    real_extract = chosen_indexes.extract_indexes
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        write_gen1_fixture(root / "validation.h5", num_files=1, boxes_per_file=GWD_WINDOWS,
                           events_per_file=400_000, seed=9)
        fixture_s = time.perf_counter() - t0
        ds = Gen1H5(root, "val", num_events=N)
        sizes = [ds[i].num_events for i in range(GWD_WINDOWS)]
        ds.h5.close()
        chosen_indexes.extract_indexes = lambda name: list(range(GWD_WINDOWS))
        try:
            for name in ("OptimizedRepresentation", "VoxelGrid"):
                for mode in ("host", "batched"):
                    timer = StageTimer()
                    if mode == "host":
                        timer.wrap(dispatch, "get_item_transform", "representation")
                        timer.wrap(otmi_mod, "otmi", "otmi")
                    else:
                        timer.wrap(dispatch, "batched_representation", "representation",
                                   factory=True)
                        timer.wrap(otmi_mod, "otmi_batched", "otmi")
                    timer.wrap(otmi_mod, "sampled_kernel_cost", "kernel_sums")
                    args = ["--data-path", tmp, "--representation", name, "--num-events", str(N),
                            "--img-size", str(H), "--device", "cuda"]
                    fs.reset_launches()
                    t0 = time.perf_counter()
                    try:
                        mean = gwd.main(args + (["--batched"] if mode == "batched" else []))
                    finally:
                        timer.restore()
                    wall = time.perf_counter() - t0
                    if mode == "batched":
                        for k in launches:
                            launches[k] += fs.LAUNCHES[k]
                    stages = dict(timer.seconds)
                    stages["quadrant_compaction"] = stages["otmi"] - stages["kernel_sums"]
                    stages["data_and_host"] = wall - stages["otmi"] - stages["representation"]
                    runs[f"{name}.{mode}"] = {"mean_cp": mean, "wall_s": wall,
                                              "s_per_sample": wall / GWD_WINDOWS,
                                              "stages_s": stages, "calls": dict(timer.calls),
                                              "launches": dict(fs.LAUNCHES)}
        finally:
            chosen_indexes.extract_indexes = real_extract
    agree = {name: abs(runs[f"{name}.batched"]["mean_cp"] / runs[f"{name}.host"]["mean_cp"] - 1)
             for name in ("OptimizedRepresentation", "VoxelGrid")}
    say("gwd", windows=GWD_WINDOWS, events_per_window=sizes, img_size=H, fixture_s=fixture_s,
        runs=runs, rel_diff_batched_vs_host=agree, tolerance="rtol 3e-4", tf32=tf32_state())
    require(all(math.isfinite(r["mean_cp"]) for r in runs.values()), f"C_p finite: {runs}")
    require(all(v <= 3e-4 for v in agree.values()), f"--batched vs host loop: {agree}")
    require(runs["OptimizedRepresentation.batched"]["launches"][fs.K1] == 1
            and runs["VoxelGrid.batched"]["launches"][fs.K2] == 1, f"gwd launches {runs}")

    # otmi_batched on the card against the CPU: 2 windows of 8,192 events
    small = fake_batch(900, n_windows=2, n_events=8192)
    reps = batched_representation("VoxelGrid", H, W)(small)
    ev = torch.stack([small.x, small.y, small.t, small.p], -1).to(torch.float32)
    mask = small.mask.to(torch.float32)
    want = otmi_mod.otmi_batched(ev, mask, reps, H, W, rep_size=H)
    got = otmi_mod.otmi_batched(ev.to(dev), mask.to(dev), reps.to(dev), H, W, rep_size=H).cpu()
    otmi_err = ((got - want).abs() / want.abs()).max().item()

    # the protocol's sense (tests/test_gw.py:86-104): a matching voxel grid
    # scores below a scrambled one
    h, w = 120, 152
    e = generate_fake_events(6000, height=h, width=w, seed=11)
    block = stack_blocks([from_structured(e, 8192)]).to(dev)
    rep = batched_representation("VoxelGrid", h, w)(block)[0].cpu().numpy()
    scrambled = np.random.default_rng(0).permutation(rep.reshape(-1, 12)).reshape(rep.shape)
    events = np.stack([e["x"], e["y"], e["t"], e["p"]], -1).astype(np.float64)
    c_match = otmi_mod.otmi(events, rep, h, w, rep_size=h, capacity=4096, device=dev)
    c_scram = otmi_mod.otmi(events, scrambled, h, w, rep_size=h, capacity=4096, device=dev)
    say("gwd_checks", otmi_batched_card=got.tolist(), otmi_batched_cpu=want.tolist(),
        max_rel_err=otmi_err, tolerance="rtol 2e-4", c_match=c_match, c_scrambled=c_scram)
    require(otmi_err <= 2e-4, f"otmi_batched card vs CPU: {otmi_err}")
    require(math.isfinite(c_match) and c_match < c_scram,
            f"matching voxel grid {c_match} vs scrambled {c_scram}")
    return launches


SEARCH_CHANNELS, SEARCH_BUDGET = 2, 6  # the study searches 12 channels x 100 measures
# 12 variances of distinct (function, window): 36 sum columns, two K1/K2 column groups
VARIANCE_36 = ([(w, "timestamp", "variance") for w in range(7)]
               + [(w, "timestamp_pos", "variance") for w in range(5)])
# One seed's fit, card vs CPU. The 2000-step fit is chaotic: on the CPU,
# -1e-6 on one initial weight moves a draw's cat_probs by 0.87 and their mean
# over the draws by 0.020, after 200 steps by 1.1e-6 (tests/
# test_torch_port_search_bnn.py, the CHAOS lines). So the draws are compared
# after FIT_CHECK_STEPS steps, before rounding has grown, and the full fit by
# its mean over the draws, the kernel density's input.
FIT_CHECK_STEPS, FIT_TOLERANCE, FIT_MEAN_TOLERANCE = 200, 1e-3, 0.05
PROFILED_FIT_STEPS = 200
MEASURE_TOLERANCE = 2e-4  # each measured MDES table, card vs the plain version on the CPU


def union_us(intervals, lo, hi) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi):
    a profiler window's device busy time."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def fit_profile(fit, args, kwargs):
    """Device busy time and idle share of one surrogate fit of
    PROFILED_FIT_STEPS steps (and the study's draws), from a torch.profiler
    trace: busy is the union of the CUDA kernel intervals in the fit's
    window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("fit"):
            fit(*args, **{**kwargs, "train_steps": PROFILED_FIT_STEPS})
            torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == cuda and e.name != "fit"]
    lo, hi = next((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type != cuda and e.name == "fit")
    busy = union_us(spans, lo, hi)
    return {"train_steps": PROFILED_FIT_STEPS, "wall_ms": (hi - lo) / 1e3,
            "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / (hi - lo),
            "kernels": len(spans), "kernels_per_step": len(spans) / PROFILED_FIT_STEPS}


def search_phase(dev):
    """The ERGO-12 channel search (``search/optimize.py``) on the card at the
    study's surrogate settings: 2000 BNN train steps, 1000 posterior draws,
    the 7 x 7 x 4 space with its constraint table, alternating +-1
    strategies. The objective is the mean ``otmi_batched`` C_p of
    ``mdes_fused_batched(fixed + [triple])`` (K1/K2) on the 8 synthetic Gen1
    windows of 50,000 events that the gwd phase writes, at rep size 240. Cut:
    SEARCH_CHANNELS channels x SEARCH_BUDGET measures instead of 12 x 100.
    Each recommend is timed as fit + acquisition, each measure as
    representation + OTMI with its K1/K2 launches; then ERGO-12 (K1 once)
    and the 36-column table VARIANCE_36 (two launches) are measured. Checks:
    every scored triple is allowed, the history file holds every measure;
    every measured table agrees with the plain version on the CPU
    (MEASURE_TOLERANCE);
    on one fit's draws the kernel density card vs CPU (rtol 1e-5) and vs the
    float64 C evaluator (rtol 1e-4); that fit re-run on the CPU from its
    seed (FIT_CHECK_STEPS, FIT_TOLERANCE, FIT_MEAN_TOLERANCE); ``cli/bo.py``
    recommends on the card from an observations file. Returns the K1/K2
    launches of the search."""
    import pathlib
    import tempfile

    from event_representation_study_tpu_torch.cli import bo
    from event_representation_study_tpu_torch.data.gen1 import Gen1H5, write_gen1_fixture
    from event_representation_study_tpu_torch.events import from_structured, stack_blocks
    from event_representation_study_tpu_torch.metrics.otmi import otmi_batched
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.reps import fused_mdes
    from event_representation_study_tpu_torch.reps.ergo12 import (
        AGGREGATIONS, FUNCTIONS, WINDOW_INDEXES)
    from event_representation_study_tpu_torch.search import (
        bnn, db, gryffin, kernels, native, optimize)
    from event_representation_study_tpu_torch.search.acquisition import enumerate_feasible

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        write_gen1_fixture(root / "validation.h5", num_files=1, boxes_per_file=GWD_WINDOWS,
                           events_per_file=400_000, seed=9)
        ds = Gen1H5(root, "val", num_events=N)
        blocks = stack_blocks([from_structured(ds.structured_events(i), N)
                               for i in range(GWD_WINDOWS)])
        ds.h5.close()
        events = torch.stack([blocks.x, blocks.y, blocks.t, blocks.p], -1).to(torch.float32)
        blocks_d, events_d = blocks.to(dev), events.to(dev)
        mask_d = blocks.mask.to(torch.float32).to(dev)
        measures, calls, fits = [], [], []

        def measure(triples):
            windows, funcs, aggs = (tuple(c) for c in zip(*triples))
            before = dict(fs.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = fused_mdes.mdes_fused_batched(blocks_d, H, W, windows, funcs, aggs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            c_p = float(np.nanmean(otmi_batched(events_d, mask_d, rep, H, W, rep_size=H)
                                   .cpu().numpy()))
            otmi_s = time.perf_counter() - t1
            # the same table by the plain version on the CPU (untimed, uncounted)
            rep_cpu = fused_mdes.mdes_fused_batched(blocks, H, W, windows, funcs, aggs)
            sums, maxes, _ = fused_mdes._plan(windows, funcs, aggs)
            groups = fs.column_groups(len(sums), len(maxes))
            measures.append({
                "channels": len(triples), "triple": list(triples[-1]), "c_p": c_p,
                "representation_s": t1 - t0, "otmi_s": otmi_s,
                "shape_ok": tuple(rep.shape) == (GWD_WINDOWS, H, W, len(triples)),
                "max_abs_err_card_vs_cpu": (rep.cpu() - rep_cpu).abs().max().item(),
                "Ks": len(sums), "Km": len(maxes),
                "launches": {k: fs.LAUNCHES[k] - before[k] for k in fs.LAUNCHES},
                "expected": {fs.K1: sum(len(m) > 0 for _, m in groups),
                             fs.K2: sum(len(m) == 0 for _, m in groups)}})
            return c_p

        def timed(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                calls.append((name, time.perf_counter() - t))
                if name == "fit":
                    fits.append((a, k, out))
                return out
            return run

        real_recommend, real_fit = gryffin.Gryffin.recommend, bnn.fit_categorical_kernels
        gryffin.Gryffin.recommend = timed("recommend", real_recommend)
        bnn.fit_categorical_kernels = timed("fit", real_fit)
        fs.reset_launches()
        t0 = time.perf_counter()
        try:
            fixed = optimize.sequential_optimization(
                measure, channels=SEARCH_CHANNELS, budget=SEARCH_BUDGET, seed=42,
                verbose=False, db_path=root / "history.json", device="cuda")
            search_s = time.perf_counter() - t0
            measure(list(zip(WINDOW_INDEXES, FUNCTIONS, AGGREGATIONS)))  # ERGO-12 (K1 once)
            measure(VARIANCE_36)  # two launches
        finally:
            gryffin.Gryffin.recommend, bnn.fit_categorical_kernels = real_recommend, real_fit
        launches = dict(fs.LAUNCHES)
        history = db.DatabaseHandler(root / "history.json").load()

        recommends, fit_s = [], None
        for name, s in calls:
            if name == "fit":
                fit_s = s
            else:
                recommends.append({"fit_s": fit_s, "acquisition_s": s - fit_s}
                                  if fit_s is not None else {"random_s": s})
                fit_s = None
        scored = [m["triple"] for m in measures[:-2]]
        ergo12, wide = measures[-2:]
        say("search", channels=SEARCH_CHANNELS, budget=SEARCH_BUDGET, windows=GWD_WINDOWS,
            events_per_window=N, rep_size=H, bnn_train_steps=bnn.TRAIN_STEPS,
            bnn_draws=bnn.N_DRAWS, cut=f"{SEARCH_CHANNELS} channels x {SEARCH_BUDGET} "
            "measures instead of the study's 12 x 100; synthetic Gen1 windows",
            fixed=fixed, search_s=search_s, recommends=recommends, measures=measures[:-2],
            ergo12=ergo12, variance_36=wide, launches=launches, tf32=tf32_state())
        require(len(scored) == len(history) == SEARCH_CHANNELS * SEARCH_BUDGET,
                f"{len(scored)} measures, {len(history)} in the history")
        require(all(a in optimize.POSSIBLE_SCENARIOS[f] for _, f, a in scored),
                f"a scored triple outside the constraint table: {scored}")
        require(all(math.isfinite(m["c_p"]) for m in measures), "C_p finite")
        require(all(m["shape_ok"] and m["max_abs_err_card_vs_cpu"] <= MEASURE_TOLERANCE
                    for m in measures),
                f"MDES tables card vs CPU: {[m['max_abs_err_card_vs_cpu'] for m in measures]}")
        require(all(m["launches"] == m["expected"] for m in measures),
                f"K1/K2 launches per measure: {[m['launches'] for m in measures]}")
        require(ergo12["launches"] == {fs.K1: 1, fs.K2: 0} and wide["Ks"] == 36
                and wide["launches"] == {fs.K1: 0, fs.K2: 2},
                f"ERGO-12 and 36-column launches: {ergo12}, {wide}")
        require(sum(1 for r in recommends if "fit_s" in r) >= SEARCH_CHANNELS,
                f"recommends with a fit: {recommends}")

        # one fit's draws: the kernel density card vs CPU and vs the C evaluator
        (seed, observations, counts), fit_kw, cat_probs = fits[-1][0][:3], fits[-1][1], fits[-1][2]
        samples = enumerate_feasible(counts)
        objs = np.random.default_rng(0).random(cat_probs.shape[1])
        inv_vol = 1.0 / np.prod(counts)
        offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)])[:-1])
        model = {d: kernels.KernelModel(cat_probs.to(d), offsets.to(d),
                                        torch.as_tensor(objs, dtype=torch.float32).to(d), inv_vol)
                 for d in (dev, torch.device("cpu"))}
        card = {d: {"num_inv_den": torch.stack(kernels.kernel_contribution(model[d], samples)),
                    "acq_explore": kernels.acquisition_values(model[d], samples, -1.0),
                    "acq_exploit": kernels.acquisition_values(model[d], samples, 1.0)}
                for d in model}

        def rel(a, b):
            a, b = a.cpu().double(), b.cpu().double()
            return ((a - b).abs() / b.abs().clamp_min(1e-6 * b.abs().max())).max().item()

        vs_cpu = {k: rel(card[dev][k], card[torch.device("cpu")][k]) for k in card[dev]}
        n_num, n_inv, _ = native.kernel_contrib_categorical(
            cat_probs.cpu().double().numpy(), offsets.numpy(), samples, objs, inv_vol)
        vs_c = rel(card[dev]["num_inv_den"], torch.from_numpy(np.stack([n_num, n_inv])))
        samples_d = torch.as_tensor(samples, device=dev)
        acq_ms = cuda_ms(lambda: kernels.acquisition_values(model[dev], samples_d, -1.0))
        short = [real_fit(seed, observations, counts, **{
            **fit_kw, "train_steps": FIT_CHECK_STEPS, "device": d}).cpu() for d in (dev, "cpu")]
        fit_err = (short[0] - short[1]).abs().max().item()
        t0 = time.perf_counter()
        cpu_probs = real_fit(seed, observations, counts, **{**fit_kw, "device": "cpu"})
        cpu_fit_s = time.perf_counter() - t0
        fit_mean_err = (cat_probs.cpu().mean(0) - cpu_probs.mean(0)).abs().max().item()
        profile = fit_profile(real_fit, (seed, observations, counts), fit_kw)

        # cli/bo.py: one recommendation on the card from an observations file
        space = {"parameters": [{"name": p.name, "type": "categorical", "options": p.options}
                                for p in optimize.search_space()], "batch": 2}
        (root / "space.json").write_text(json.dumps(space))
        (root / "obs.json").write_text(json.dumps(
            [{k: h[k] for k in ("window", "function", "aggregation", "obj")}
             for h in history[:SEARCH_BUDGET]]))
        t0 = time.perf_counter()
        cli_recs = bo.main(["--config", str(root / "space.json"), "--observations",
                            str(root / "obs.json"), "--out", str(root / "recs.json")])
        cli_s = time.perf_counter() - t0
    say("search_checks", draws=list(cat_probs.shape), samples=len(samples),
        max_rel_err_card_vs_cpu=vs_cpu, max_rel_err_card_vs_c_float64=vs_c,
        acquisition_ms=acq_ms, fit_seed=seed, fit_card_s=[r["fit_s"] for r in recommends
                                                          if "fit_s" in r],
        fit_cpu_s=cpu_fit_s, fit_check_steps=FIT_CHECK_STEPS,
        fit_max_abs_err_card_vs_cpu=fit_err, fit_mean_over_draws_max_abs_err_card_vs_cpu=(
            fit_mean_err), fit_profile=profile,
        cli_bo_recs=cli_recs, cli_bo_s=cli_s,
        tolerance=f"card vs CPU rtol 1e-5, vs C rtol 1e-4 (floor 1e-6 of the largest value); "
                  f"fit cat_probs after {FIT_CHECK_STEPS} steps {FIT_TOLERANCE} abs, their "
                  f"mean over draws after the full fit {FIT_MEAN_TOLERANCE} abs; each "
                  f"measured MDES table {MEASURE_TOLERANCE} abs")
    require(all(v <= 1e-5 for v in vs_cpu.values()), f"kernel density card vs CPU: {vs_cpu}")
    require(vs_c <= 1e-4, f"kernel density card vs the C evaluator: {vs_c}")
    require(fit_err <= FIT_TOLERANCE and fit_mean_err <= FIT_MEAN_TOLERANCE,
            f"fit card vs CPU: draws {fit_err}, mean over draws {fit_mean_err}")
    require(len(cli_recs) == 2 and all(
        r[p.name] in p.options for r in cli_recs for p in optimize.search_space()),
        f"cli/bo.py recommendations {cli_recs}")
    return launches


PUBLISHED_FIXTURE = "tests/data/gen1_blosc_seed7.h5"  # scripts/make_gen1_blosc_fixture.py
PUBLISHED_SEED = 7
PUBLISHED_TIME_WINDOW = 150_000  # us
# (step, window, step unit, window unit) of compute_time_and_index_windows
PUBLISHED_QUERIES = ((5000, 8000, "nr", "nr"), (50_000, 120_000, "us", "us"),
                     (40_000, 7000, "nr", "us"), (3000, 90_000, "us", "nr"))


def _handle_queries(path, group: str) -> dict:
    """Every window query of ``H5EventHandle`` over one recording."""
    from event_representation_study_tpu_torch.events.h5_io import H5EventHandle

    h = H5EventHandle(path, group=group)
    out = {"len": np.array(len(h)), "index_from_time": np.array(
        [h.index_from_time(t) for t in (0, 250_000, 500_000, 10**9)]),
        "between": h.get_between_time(200_000, 260_000),
        "index_windows": h.compute_index_windows(5000, 3000),
        "time_windows": h.compute_time_windows(50_000, 20_000)}
    for j, q in enumerate(PUBLISHED_QUERIES):
        (t0, t1), (i0, i1) = h.compute_time_and_index_windows(*q)
        out.update({f"tai{j}_t0": t0, f"tai{j}_t1": t1, f"tai{j}_i0": i0, f"tai{j}_i1": i1})
    h.close()
    return out


def gen1_published_format_phase(dev):
    """The committed Gen1 fixture in the published format (superblock v0,
    Blosc-ZSTD chunks, written by h5py) read on this machine: through
    ``events/h5lite.py`` where h5py is absent. The same fixture is written
    here unfiltered by the port's writer; ``Gen1H5`` (count and time
    windows) and ``H5EventHandle``'s window queries must read both files
    bit-equal. ERGO-12 of the Blosc file's count windows on the card (K1)
    against the same call on the CPU. Returns the K1 launches."""
    import pathlib
    import tempfile

    from event_representation_study_tpu_torch.data.gen1 import Gen1H5, write_gen1_fixture
    from event_representation_study_tpu_torch.events import blosc_codec, h5lite
    from event_representation_study_tpu_torch.events.core import EventBlock
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.reps.dispatch import batched_representation

    blosc_path = pathlib.Path(__file__).resolve().parent / PUBLISHED_FIXTURE
    hdf5 = "h5lite" if blosc_codec.h5py is h5lite else "h5py"
    out, read_ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        plain_path = pathlib.Path(tmp) / "plain.h5"
        write_gen1_fixture(plain_path, seed=PUBLISHED_SEED)  # no Blosc: h5lite writes it
        for mode in ("count", "time"):
            for fmt, path in (("blosc", blosc_path), ("plain", plain_path)):
                ds = Gen1H5(path, window_mode=mode, num_events=N,
                            time_window=PUBLISHED_TIME_WINDOW)
                require(hdf5 == "h5py" or isinstance(ds.h5, h5lite.File),
                        f"{fmt} {mode}: read by {type(ds.h5)}, not h5lite")
                times, samples = [], []
                for i in range(len(ds)):
                    t = time.perf_counter()
                    samples.append(ds[i])
                    times.append((time.perf_counter() - t) * 1e3)
                ds.h5.close()
                out[(mode, fmt)] = samples
                read_ms[f"{mode}_{fmt}"] = {"median_ms_per_window": statistics.median(times),
                                            "ms_per_window": times}
        queries = {fmt: {g: _handle_queries(path, f"{g}/events") for g in ("rec000", "rec001")}
                   for fmt, path in (("blosc", blosc_path), ("plain", plain_path))}
    equal = {}
    for mode in ("count", "time"):
        a, b = out[(mode, "blosc")], out[(mode, "plain")]
        equal[f"gen1h5_{mode}"] = len(a) == len(b) > 0 and all(
            np.array_equal(x.events, y.events) and np.array_equal(x.labels, y.labels)
            and x.num_events == y.num_events for x, y in zip(a, b))
    equal["handle_queries"] = all(
        np.array_equal(queries["blosc"][g][k], queries["plain"][g][k])
        for g in queries["plain"] for k in queries["plain"][g])

    samples = out[("count", "blosc")]
    ev = np.stack([s.events for s in samples])
    blocks = EventBlock(x=ev[:, 0], y=ev[:, 1], t=ev[:, 2], p=ev[:, 3],
                        num=np.array([s.num_events for s in samples], np.int32))
    rep_fn = batched_representation("OptimizedRepresentation", samples[0].height, samples[0].width)
    fs.reset_launches()
    rep = rep_fn(blocks.to(dev))
    torch.cuda.synchronize()
    launches = fs.LAUNCHES[fs.K1]
    rep_err = (rep.cpu() - rep_fn(blocks.to("cpu"))).abs().max().item()
    say("gen1_published_format", fixture=PUBLISHED_FIXTURE, bytes=blosc_path.stat().st_size,
        hdf5=hdf5, windows=len(samples), events_per_window=[s.num_events for s in samples],
        bit_equal_to_unfiltered=equal, read=read_ms,
        ergo12={"shape": list(rep.shape), "k1_launches": launches,
                "max_abs_err_vs_cpu_plain": rep_err, "tolerance": 2e-4 * 255})
    require(all(equal.values()), f"Blosc vs unfiltered reads: {equal}")
    require(launches == 1 and bool(torch.isfinite(rep).all()) and rep_err <= 2e-4 * 255,
            f"ERGO-12 of the published-format windows: K1 {launches}, err {rep_err}")
    return launches


CLASSIFY_TRAIN, CLASSIFY_VAL = (96, 2), (64, 1)  # (classes, samples a class) of the fixture
CLASSIFY_EVENTS, CLASSIFY_SLICE, CLASSIFY_BATCH = 32_000, 30_000, 64  # a sample, its slice
CLASSIFY_ARGS = ["model=ResNet34", "kernel_size=14", "channel_size=12", "num_classes=100",
                 "loader_type=reshape_then_optimized", "optimizer=Adam", "learning_rate=3e-4",
                 "epochs=2"]


def classify_phase(dev):
    """``cli/classify.py`` at full width: ResNet34, stem kernel 14, 12
    channels, 100 classes, ERGO-12 on K1 at 224², slices of 30,000 events,
    batch 64, float32, for 2 epochs on a synthetic npz tree (192 training
    and 64 validation samples of 32,000 events at the 480x640 sensor). The
    train and eval steps are wrapped to time them (synchronised) and to
    count K1's launches in each. Returns (K1 launches, a collated
    validation batch on the card)."""
    import pathlib
    import tempfile

    from event_representation_study_tpu_torch.cli import classify
    from event_representation_study_tpu_torch.data.nimagenet import (
        NImageNetDataset, write_nimagenet_fixture)
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.train.classifier import ClassifierTrainer

    calls = []
    real = {"train": ClassifierTrainer.train_step, "eval": ClassifierTrainer.eval_step}

    def probe(kind):
        def wrapped(self, *a):
            k1, t = fs.LAUNCHES[fs.K1], time.perf_counter()
            out = real[kind](self, *a)
            torch.cuda.synchronize()
            calls.append({"kind": kind, "ms": (time.perf_counter() - t) * 1e3,
                          "k1": fs.LAUNCHES[fs.K1] - k1,
                          "finite": bool(torch.isfinite(out[1] if kind == "train" else out).all())})
            return out
        return wrapped

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        lists = {}
        for split, (classes, per), seed in (("train", CLASSIFY_TRAIN, 0),
                                            ("val", CLASSIFY_VAL, 10_000)):
            files, _ = write_nimagenet_fixture(root / split, num_classes=classes, per_class=per,
                                               n_events=CLASSIFY_EVENTS, seed=seed)
            lists[split] = root / f"{split}.txt"
            lists[split].write_text("\n".join(files))
        fixture_s = time.perf_counter() - t0
        ClassifierTrainer.train_step, ClassifierTrainer.eval_step = probe("train"), probe("eval")
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fs.reset_launches()
            t0 = time.perf_counter()
            history = classify.main(["--train-list", str(lists["train"]), "--val-list",
                                     str(lists["val"]), "--override", "seed=1",
                                     *CLASSIFY_ARGS, f"slice_length={CLASSIFY_SLICE}",
                                     f"batch_size={CLASSIFY_BATCH}"])
            run_s = time.perf_counter() - t0
            launches = fs.LAUNCHES[fs.K1]
        finally:
            ClassifierTrainer.train_step, ClassifierTrainer.eval_step = real["train"], real["eval"]
        peak = torch.cuda.max_memory_allocated()
        val = NImageNetDataset(*classify.read_list(lists["val"]), slice_length=CLASSIFY_SLICE)
        blocks, _ = ClassifierTrainer._collate([val[i] for i in range(CLASSIFY_BATCH)])
    train = [c for c in calls if c["kind"] == "train"]
    evals = [c for c in calls if c["kind"] == "eval"]
    n_train, n_val = (c * p for c, p in (CLASSIFY_TRAIN, CLASSIFY_VAL))
    say("classify", args=CLASSIFY_ARGS, batch=CLASSIFY_BATCH, slice_length=CLASSIFY_SLICE,
        train_samples=n_train, val_samples=n_val,
        events_per_sample=CLASSIFY_EVENTS, fixture_s=fixture_s, run_s=run_s,
        train_step_ms=[c["ms"] for c in train],
        train_step_ms_median=statistics.median(c["ms"] for c in train),
        eval_ms_per_image=[c["ms"] / CLASSIFY_BATCH for c in evals],
        epochs=[{"epoch": h["epoch"], "train": h["train"], "val": h["val"]} for h in history],
        k1_launches=launches, k1_per_call=[c["k1"] for c in calls],
        peak_mem_bytes=peak, tf32=tf32_state())
    require(len(history) == 2 and len(train) == 2 * (n_train // CLASSIFY_BATCH)
            and len(evals) == 2 * -(-n_val // CLASSIFY_BATCH),
            f"steps {len(train)}, eval batches {len(evals)}")
    require(all(c["k1"] == 1 and c["finite"] for c in calls) and launches == len(calls),
            f"K1 launches per train step / eval batch: {[c['k1'] for c in calls]}, "
            f"total {launches}")
    require(all(math.isfinite(h["train"]["loss"]) and 0 <= h["val"]["top1"] <= 1
                for h in history), f"epochs {history}")
    classify_stages(dev, blocks)
    return launches, blocks.to(dev)


def classify_stages(dev, blocks):
    """Where a classification train step's device time goes, stage by
    stage on one batch of 64 (CUDA events, mean of 5): the copy to the
    card, ERGO-12 (sort glue + K1), the ResNet34 forward + cross-entropy +
    backward, Adam's update; and the eval forward."""
    import torch.nn.functional as F

    from event_representation_study_tpu_torch.models.resnet import EventResNet
    from event_representation_study_tpu_torch.reps.dispatch import batched_representation

    model = EventResNet(100, "ResNet34").to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    rep_fn = batched_representation("OptimizedRepresentation", 224, 224)
    on_card = blocks.to(dev)
    x = (rep_fn(on_card) / 255.0).permute(0, 3, 1, 2)  # as ClassifierTrainer.images_of
    labels = torch.zeros(x.shape[0], dtype=torch.long, device=dev)

    def forward_backward():
        model.zero_grad(set_to_none=False)
        F.cross_entropy(model(x), labels).backward()

    model.train()
    stages = {"h2d": cuda_ms(lambda: blocks.to(dev), 5), "ergo12": cuda_ms(lambda: rep_fn(on_card), 5),
              "forward_loss_backward": cuda_ms(forward_backward, 5), "adam": cuda_ms(opt.step, 5)}
    model.eval()
    with torch.no_grad():
        stages["eval_forward"] = cuda_ms(lambda: model(x), 5)
    say("classify_stages_ms", batch=x.shape[0], **stages, tf32=tf32_state())


def classify_reference(dev):
    """One ``ClassifierTrainer`` step of a shrunk classifier (ResNet18, 64²,
    12 channels) on the card and on the CPU from the same weights and the
    same input, with Adam and with SGD, in float32 and in float64. The input
    is ERGO-12 of 4 fake windows of 4,000 events built once on the CPU and
    given to both through the trainer's prebuilt-image path
    (``representation=None``); ERGO-12 of the same windows on the card (K1)
    is held against it beside. Loss, logits and BatchNorm statistics are
    held in float32 and float64, the updates in float64 elementwise and the
    float32 SGD update by its worst leaf's relative L2 error. In float32 an
    update is not a continuous function of rounding: one flipped ReLU or
    max-pool choice moves a weight-gradient row by percents when a deep
    stage has few positions a channel, so the SGD bound, 5e-2, sits above
    what the CPU alone shows between float32 and float64 (printed beside as
    ``sgd_f32_vs_f64_on_cpu_leaf_l2``). Adam's first update, lr * g /
    (|g| + eps), flips sign where |g| is at float32's noise, so its float32
    update errors are only printed."""
    from event_representation_study_tpu_torch.models.resnet import EventResNet
    from event_representation_study_tpu_torch.train import classifier

    from event_representation_study_tpu_torch.reps.dispatch import batched_representation

    img, nc = 64, 10
    blocks = fake_batch(70, n_windows=4, n_events=4000, height=img, width=img)
    labels = torch.tensor([1, 3, 5, 7])
    rep_fn = batched_representation("OptimizedRepresentation", img, img)
    images = rep_fn(blocks) / 255.0
    rep_err = (rep_fn(blocks.to(dev)).cpu() / 255.0 - images).abs().max().item()
    opts = {"adam": dict(optimizer="Adam"),
            "sgd": dict(optimizer="SGD", lr=0.05, weight_decay=1e-4)}
    runs, weights = {}, None
    for opt, kw in opts.items():
        for dtype in (torch.float32, torch.float64):
            for d in ("cpu", "cuda"):
                tr = classifier.ClassifierTrainer(EventResNet(nc, "ResNet18"), None, nc,
                                                  device=d, **kw)
                tr.init()  # seeded; the first CPU draw is loaded everywhere
                weights = weights or copy.deepcopy(tr.model.state_dict())
                tr.model.load_state_dict(weights)
                tr.model.to(dtype)
                loss, logits = tr.train_step(images.to(d, dtype), labels.to(d))
                runs[(opt, dtype, d)] = {
                    "loss": loss.item(), "logits": logits.double().cpu().numpy(),
                    "state": {k: v.double().cpu().numpy()
                              for k, v in tr.model.state_dict().items()
                              if not k.endswith("num_batches_tracked")}}
    before = {k: v.double().numpy() for k, v in weights.items()
              if not k.endswith("num_batches_tracked")}
    params = [k for k in before if "running_" not in k]
    stats = [k for k in before if "running_" in k]

    def update_errs(card, cpu):
        """Largest card-CPU difference of a leaf's update over the CPU's
        largest, and the largest relative L2 error of a leaf's update."""
        over_max, l2 = 0.0, 0.0
        for k in params:
            dc, dg = cpu[k] - before[k], card[k] - before[k]
            over_max = max(over_max, float(np.abs(dg - dc).max() / (np.abs(dc).max() + 1e-30)))
            l2 = max(l2, float(np.linalg.norm(dg - dc) / (np.linalg.norm(dc) + 1e-30)))
        return over_max, l2

    errs = {}
    for opt in opts:
        e = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            card, cpu = runs[(opt, dtype, "cuda")], runs[(opt, dtype, "cpu")]
            e[f"{tag}_loss_rel"] = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
            e[f"{tag}_logits_over_max"] = float(np.abs(card["logits"] - cpu["logits"]).max()
                                                / np.abs(cpu["logits"]).max())
            e[f"{tag}_update_over_leaf_max"], e[f"{tag}_update_leaf_l2"] = update_errs(
                card["state"], cpu["state"])
            bn = {k: np.abs(card["state"][k] - cpu["state"][k]) for k in stats}
            e[f"{tag}_bn_stats_max_abs"] = max(float(v.max()) for v in bn.values())
            e[f"{tag}_bn_stats_within"] = all(
                bool((v <= 1e-4 + 2e-3 * np.abs(cpu["state"][k])).all()) for k, v in bn.items())
        errs[opt] = e
    f32_vs_f64 = update_errs(runs[("sgd", torch.float32, "cpu")]["state"],
                             runs[("sgd", torch.float64, "cpu")]["state"])[1]
    say("classify_reference", max_err=errs, ergo12_max_abs_err_vs_cpu=rep_err,
        sgd_f32_vs_f64_on_cpu_leaf_l2=f32_vs_f64,
        tolerance="ERGO-12 2e-4 (of 0..1); float32: loss 1e-4 relative, logits 1e-4 of the "
                  "largest, BN statistics atol 1e-4 + rtol 2e-3, SGD update 5e-2 of each "
                  "leaf's L2 norm; float64: loss, logits and each leaf's update 1e-8 of the "
                  "CPU's largest, BN statistics as float32", tf32=tf32_state())
    require(rep_err <= 2e-4, f"ERGO-12 at 64² card vs CPU: {rep_err}")
    for opt, e in errs.items():
        require(e["f32_loss_rel"] <= 1e-4 and e["f32_logits_over_max"] <= 1e-4
                and e["f32_bn_stats_within"] and e["f64_loss_rel"] <= 1e-8
                and e["f64_logits_over_max"] <= 1e-8 and e["f64_update_over_leaf_max"] <= 1e-8
                and e["f64_bn_stats_within"]
                and (opt != "sgd" or e["f32_update_leaf_l2"] <= 5e-2),
                f"classifier step card vs CPU ({opt}): {e}")


ZOO_CONFIGS = ("gen1_efficientrep", "gen1_lite", "gen1_resnet50", "gen1_swinvit")
ZOO_TRAIN_STEPS = 3


def zoo_phase(dev, checked):
    """Each detector family of ``configs/`` beside the paper's at full width
    and depth, seeded random weights, float32: 3 requests of B windows
    through ``make_server`` at the config's ``img_size`` (K1 once each),
    then a warm-up and 3 timed train steps through ``make_train_step``
    with the separable warp (K1 once, K3 twice a step). ``checked`` holds
    the shapes of K3's two calls (:func:`roll_key`) already held against
    the plain version; at every other shape, K3 is held and timed on the
    arguments that the warm-up step gave it (:func:`check_k3`). Returns the
    K1 launches of the timed requests and steps, and for each K3 shape its
    timed launches, the first config and image size that gave it and
    ``check_k3``'s entry (None for a shape in ``checked``), and K4's forward
    and backward launches of the timed requests and steps (the Swin-V2-L
    detector's 24 window attentions a forward; no other family has one)."""
    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.ops import window_attention as wa
    from event_representation_study_tpu_torch.utils.config import load_config

    k1, rolls, k4 = 0, {}, {wa.K4: 0, wa.K4_BACKWARD: 0}
    requests = [fake_batch(300 + 10 * r) for r in range(REQUESTS + 1)]
    for name in ZOO_CONFIGS:
        cfg = load_config(f"configs/{name}.py")
        img = cfg["data"]["img_size"]
        t0 = time.perf_counter()
        serve = make_server(cfg, "OptimizedRepresentation", H, W, img, 0.03, device="cuda")
        randomize_preds_(serve.model, torch.Generator(device=dev).manual_seed(1))
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in serve.model.parameters())
        serve(requests[-1])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        wa.reset_launches()
        serve_ms, counts = [], []
        for blk in requests[:REQUESTS]:
            t = time.perf_counter()
            dets, n = serve(blk)
            counts.append(n.tolist())
            serve_ms.append((time.perf_counter() - t) * 1e3)
        serve_k1, serve_k4 = fs.LAUNCHES[fs.K1], dict(wa.LAUNCHES)
        serve_peak = torch.cuda.max_memory_allocated()
        require(serve_k1 == REQUESTS, f"{name}: K1 launches {serve_k1} for {REQUESTS} requests")
        require(dets.shape == (B, 300, 6) and dets.dtype == torch.float32
                and bool(torch.isfinite(dets).all()), f"{name}: detections")
        require(all(0 < c <= 300 for cs in counts for c in cs), f"{name}: counts {counts}")
        del serve, dets
        torch.cuda.empty_cache()

        state, step, batches, _ = train_setup(dev, ZOO_TRAIN_STEPS + 1, name, img)
        model = state.model
        t = time.perf_counter()
        (state, parts), k3_args = capture_roll_inputs(lambda: step(state, batches[0], 5))
        warm = {k: v.item() for k, v in parts.items()}
        warm_ms = (time.perf_counter() - t) * 1e3
        require(len(k3_args) == 2, f"{name}: the separable warp rolled {len(k3_args)} times")
        key = roll_key(k3_args)
        if key not in rolls:
            rolls[key] = {"config": name, "img": img, "launches": 0,
                          "check": None if key in checked
                          else check_k3(k3_args, f"kernel_K3_{name}")}
        del k3_args
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launches()
        roll.reset_launches()
        wa.reset_launches()
        step_ms, per_step = [], []
        for batch in batches[1:]:
            t = time.perf_counter()
            state, parts = step(state, batch, 5)
            per_step.append({k: v.item() for k, v in parts.items()})  # waits
            step_ms.append((time.perf_counter() - t) * 1e3)
        train_k1, train_k3 = fs.LAUNCHES[fs.K1], roll.LAUNCHES[roll.K3]
        train_k4 = dict(wa.LAUNCHES)
        train_peak = torch.cuda.max_memory_allocated()
        changed = sum(not torch.equal(p0[n], p) for n, p in model.named_parameters())
        say("zoo", config=name, params=n_params, img=img, batch=B, events_per_window=N,
            build_s=build_s, serve_ms=serve_ms, serve_median_ms=statistics.median(serve_ms),
            detections_per_image=counts, serve_peak_mem_bytes=serve_peak,
            warmup_step_ms=warm_ms, warmup_step=warm, step_ms=step_ms,
            step_median_ms=statistics.median(step_ms), steps=per_step,
            train_peak_mem_bytes=train_peak,
            launches={"serve_K1": serve_k1, "train_K1": train_k1, "train_K3": train_k3,
                      "serve_K4": serve_k4, "train_K4": train_k4},
            roll_shapes=[list(x) for x, _ in key],
            params_changed=changed, params_total=len(p0), tf32=tf32_state())
        require(train_k1 == ZOO_TRAIN_STEPS and train_k3 == 2 * ZOO_TRAIN_STEPS,
                f"{name}: K1 {train_k1}, K3 {train_k3} for {ZOO_TRAIN_STEPS} steps")
        attentions = 24 if name == "gen1_swinvit" else 0
        require(serve_k4 == {wa.K4: attentions * REQUESTS, wa.K4_BACKWARD: 0}
                and train_k4 == {wa.K4: attentions * ZOO_TRAIN_STEPS,
                                 wa.K4_BACKWARD: attentions * ZOO_TRAIN_STEPS},
                f"{name}: K4 {serve_k4} serving, {train_k4} training")
        require(all(math.isfinite(v) for st in per_step for v in st.values()), f"{name}: losses")
        require(all(st["num_pos"] > 0 for st in per_step), f"{name}: positive anchors")
        require(changed >= 0.9 * len(p0), f"{name}: {len(p0) - changed} parameters did not change")
        k1 += serve_k1 + train_k1
        for k in k4:
            k4[k] += serve_k4[k] + train_k4[k]
        rolls[key]["launches"] += train_k3
        del state, model, step, batches, p0
        torch.cuda.empty_cache()
    return k1, rolls, k4


def _matched_iou(a, b):
    """IoU of aligned (..., 4) xywh boxes."""
    from event_representation_study_tpu_torch.ops.boxes import iou_loss, xywh2xyxy

    return iou_loss(xywh2xyxy(a), xywh2xyxy(b), "iou")


ZOO_HALF_WINDOWS = 64  # the speed runs' validation split: 8 batches of B
KERNEL_CLASSES = (("layout", ("nchwtonhwc", "nhwctonchw", "transpose")),
                  ("conv_gemm", ("conv", "gemm", "xmma", "cutlass", "implicit")),
                  ("norm", ("bn_", "batch_norm", "norm")),
                  ("elementwise", ("elementwise",)))


def conv_output_dtypes(fn):
    """Run ``fn``; return its result and the dtypes of the outputs of every
    ``nn.Conv2d`` that ran in it, with their counts."""
    seen = {}

    def hook(module, args, out):
        if isinstance(module, torch.nn.Conv2d):
            seen[str(out.dtype)] = seen.get(str(out.dtype), 0) + 1

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        out = fn()
    finally:
        handle.remove()
    return out, seen


def kernel_profile(fn):
    """One call of ``fn`` (after one unprofiled) under torch.profiler: the
    device time of its kernels by class (KERNEL_CLASSES, the first whose
    key is in the lower-cased name; the rest "other") and the 12 kernels
    that took the most, with their counts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    classes = dict.fromkeys([c for c, _ in KERNEL_CLASSES] + ["other"], 0.0)
    for name, (us, _) in by_name.items():
        low = name.lower()
        classes[next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)),
                     "other")] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"device_ms": sum(classes.values()), "by_class_ms": classes,
            "top": [{"name": name[:160], "ms": us / 1e3, "count": n}
                    for name, (us, n) in top]}


def zoo_half_phase(dev):
    """``cli/eval.py --task speed`` of the full-width paper detector on a
    synthetic validation split of ZOO_HALF_WINDOWS windows, float32 and
    ``--half`` (bf16 compute over float32 weights), twice each: ms per image
    and the dtypes its convolutions gave. Where an Evaler batch's time
    goes, on the same split: the loader's host batch assembly alone, and
    the eval step with NMS alone on the loaded batches, both ways. The
    detector's forward alone on B random 640² inputs in NCHW and in the
    layout the eval step feeds it (a permuted NHWC image), both ways, with
    a profiler trace of the bf16 forward in each layout and of the float32
    one. Then one batch through both models from the same weights: the
    largest score difference (above 0: the bf16 model did round) and the
    mean IoU of the float32 top-100 boxes against the bf16 boxes at the
    same anchors. Returns the K1 launches."""
    import pathlib
    import tempfile

    from event_representation_study_tpu_torch.cli import eval as eval_cli
    from event_representation_study_tpu_torch.data.gen1 import Gen1H5
    from event_representation_study_tpu_torch.data.loader import EventBatchLoader
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops.nms import non_max_suppression
    from event_representation_study_tpu_torch.parallel.train_step import make_eval_step
    from event_representation_study_tpu_torch.utils.config import load_config

    speed, conv_dtypes, k1 = {}, {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        _trainer_fixture(pathlib.Path(tmp), val_boxes=ZOO_HALF_WINDOWS, train=False)
        args = ["--conf", "configs/gen1_optimized.py", "--data-path", tmp, "--task", "speed",
                "--batch-size", str(B), "--img-size", str(IMG), "--num-events", str(N)]
        for label, extra in (("float32", []), ("bfloat16", ["--half"]), ("float32_again", []),
                             ("bfloat16_again", ["--half"])):
            fs.reset_launches()
            stats, conv_dtypes[label] = conv_output_dtypes(lambda: eval_cli.main(args + extra))
            k1 += fs.LAUNCHES[fs.K1]
            speed[label] = {k: stats[k] for k in ("speed_pre_ms", "speed_infer_nms_ms",
                                                  "speed_post_ms")}
            speed[label]["ms_per_image"] = sum(speed[label].values())
        cfg = load_config("configs/gen1_optimized.py")
        ds = Gen1H5(tmp, task="val", num_events=N)
        loader_ms, batches = [], []
        it = iter(EventBatchLoader(ds, B, img_size=IMG, shuffle=False))
        while True:
            t = time.perf_counter()
            item = next(it, None)
            if item is None:
                break
            loader_ms.append((time.perf_counter() - t) * 1e3)
            batches.append(item[0])
        ds.h5.close()
    f32 = build_model(cfg, 2, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    randomize_preds_(f32, torch.Generator(device=dev).manual_seed(1))
    bf16 = build_model(cfg, 2, device=dev, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    preds, step_ms = {}, {}
    for label, model in (("float32", f32), ("bfloat16", bf16)):
        fs.reset_launches()
        step = make_eval_step(model, "OptimizedRepresentation", (H, W), IMG, device=dev)
        preds[label] = step(None, batches[0])
        step_ms[label] = []
        for batch in batches:
            t = time.perf_counter()
            with torch.inference_mode():
                _, n = non_max_suppression(step(None, batch), conf_thres=0.03, iou_thres=0.65)
            n.cpu()  # waits
            step_ms[label].append((time.perf_counter() - t) * 1e3)
        k1 += fs.LAUNCHES[fs.K1]
    x = torch.rand((B, 12, IMG, IMG), generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)  # as the eval step feeds
    with torch.inference_mode():  # the detector alone, the layer bf16 changes
        detector_ms = {f"{label}_{layout}": cuda_ms(lambda: model.eval()(xa), iters=10)
                       for label, model in (("float32", f32), ("bfloat16", bf16))
                       for layout, xa in (("nchw", x), ("nhwc", x_nhwc))}
        profiles = {f"{label}_{layout}": kernel_profile(lambda: model(xa))
                    for label, model, layout, xa in (("bfloat16", bf16, "nchw", x),
                                                     ("bfloat16", bf16, "nhwc", x_nhwc),
                                                     ("float32", f32, "nchw", x))}
    p32, p16 = preds["float32"], preds["bfloat16"]
    score_diff = (p16[..., 5:] - p32[..., 5:]).abs().max().item()
    top = p32[..., 5:].amax(-1).topk(100, dim=1).indices  # (B, 100)
    pick = top[..., None].expand(-1, -1, 4)
    iou = _matched_iou(p32[..., :4].gather(1, pick), p16[..., :4].gather(1, pick))
    box_err = (p16[..., :4] - p32[..., :4]).abs()
    say("zoo_half", windows=ZOO_HALF_WINDOWS, batches=len(batches),
        speed_ms_per_image=speed, conv_output_dtypes=conv_dtypes,
        loader_ms_per_batch=loader_ms, loader_median_ms=statistics.median(loader_ms),
        eval_step_nms_ms_per_batch=step_ms,
        eval_step_nms_median_ms={k: statistics.median(v) for k, v in step_ms.items()},
        detector_ms=detector_ms, dtype_of_preds=str(p16.dtype),
        max_score_diff=score_diff, mean_iou_top100=iou.mean().item(),
        min_iou_top100=iou.min().item(), box_abs_err_px={"mean": box_err.mean().item(),
                                                         "max": box_err.max().item()},
        tolerance="bf16 vs f32 on one batch: 0 < scores <= 0.05, mean IoU of the top-100 "
                  ">= 0.9; every convolution of --half gives bf16, of float32 float32",
        tf32=tf32_state())
    say("zoo_half_profile", **profiles)
    require(all(set(d) == {"torch.bfloat16" if label.startswith("bfloat16") else "torch.float32"}
                for label, d in conv_dtypes.items()), f"conv output dtypes {conv_dtypes}")
    require(p16.dtype == torch.float32 and bool(torch.isfinite(p16).all()), "bf16 preds")
    require(0 < score_diff <= 0.05 and iou.mean().item() >= 0.9,
            f"bf16 vs f32: scores {score_diff}, IoU {iou.mean().item()}")
    return k1


def zoo_reference(dev):
    """A shrunk copy of each new family (depth 0.2, width 0.125; the Lite
    family at full width, whose squeeze-excite needs >= 4 channels; the
    Swin backbone at its fixed preset) serves the same windows on the card
    and on the CPU from the same weights, at 320²."""
    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.utils.config import load_config

    ref_blocks = fake_batch(7, n_windows=2, n_events=5000)
    errs = {}
    for name in ZOO_CONFIGS:
        small = load_config(f"configs/{name}.py", overrides=[
            "model.depth_multiple=0.2",
            f"model.width_multiple={1.0 if name == 'gen1_lite' else 0.125}"])
        servers = {d: make_server(small, "OptimizedRepresentation", H, W, 320, 0.03, device=d)
                   for d in ("cpu", "cuda")}
        randomize_preds_(servers["cpu"].model, torch.Generator().manual_seed(2))
        servers["cuda"].model.load_state_dict(servers["cpu"].model.state_dict())
        (r_g, p_g), (r_c, p_c) = ([a.cpu() for a in servers[d].run(ref_blocks)[:2]]
                                  for d in ("cuda", "cpu"))
        errs[name] = {"rep": (r_g - r_c).abs().max().item(),
                      "boxes": (p_g[..., :4] - p_c[..., :4]).abs().max().item(),
                      "scores": (p_g[..., 4:] - p_c[..., 4:]).abs().max().item()}
        del servers
    say("zoo_reference", max_abs_err=errs,
        tolerance="rep 0.06 (x255), boxes 1e-2 px, scores 1e-4", tf32=tf32_state())
    require(all(e["rep"] <= 0.06 and e["boxes"] <= 1e-2 and e["scores"] <= 1e-4
                for e in errs.values()), f"zoo card vs CPU: {errs}")


def timed_variant_steps(label, state, step, batches):
    """A warm-up step, then :func:`timed_steps` on the other batches.
    Returns (state, what the ``variants`` line prints for this mode)."""
    t = time.perf_counter()
    state, parts = step(state, batches[0], 0)
    warm = {k: v.item() for k, v in parts.items()}
    warm_ms = (time.perf_counter() - t) * 1e3
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, times, per_step, launches, peak = timed_steps(state, step, batches[1:])
    changed = sum(not torch.equal(p0[n], p) for n, p in state.model.named_parameters())
    out = {"mode": label, "warmup_step_ms": warm_ms, "warmup_step": warm, "ms_per_step": times,
           "median_ms": statistics.median(times), "peak_mem_bytes": peak, "steps": per_step,
           "launches": launches, "params_changed": changed, "params_total": len(p0)}
    require(all(math.isfinite(v) for st in per_step for v in st.values()),
            f"{label}: losses {warm} {per_step}")
    require(all(st["num_pos"] > 0 for st in per_step), f"{label}: positive anchors {per_step}")
    require(changed >= 0.9 * len(p0), f"{label}: {len(p0) - changed} parameters did not change")
    return state, out


def detect_backend_check(dev, tmp):
    """``DetectBackend.detect`` on a deploy checkpoint (a train checkpoint
    of the full-width detector with random pred convs, stripped) against
    the Evaler's eval step and NMS on that detector itself, on one batch of
    random 640² images (an NHWC view of a contiguous NCHW tensor, so both
    feed the detector the same memory)."""
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.models.backend import DetectBackend
    from event_representation_study_tpu_torch.ops.nms import non_max_suppression
    from event_representation_study_tpu_torch.parallel.train_step import (
        Batch, TrainState, make_eval_step)
    from event_representation_study_tpu_torch.train.checkpoint import (
        save_checkpoint, strip_optimizer)
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.optim import build_optimizer
    from event_representation_study_tpu_torch.utils.config import load_config

    cfg = load_config("configs/gen1_optimized.py")
    model = build_model(cfg, 2, device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    randomize_preds_(model, torch.Generator(device=dev).manual_seed(10))
    save_checkpoint(tmp / "train", TrainState(
        model, build_optimizer(model, solver_config(cfg)), ema_init(model), 0), 0)
    strip_optimizer(tmp / "train", tmp / "deploy")
    t0 = time.perf_counter()
    backend = DetectBackend(tmp / "deploy", "configs/gen1_optimized.py", device=dev)
    load_s = time.perf_counter() - t0
    x = torch.rand((B, 12, IMG, IMG), generator=torch.Generator(device=dev).manual_seed(9),
                   device=dev)
    images = x.permute(0, 2, 3, 1)
    t0 = time.perf_counter()
    dets, counts = backend.detect(images)
    detect_ms = (time.perf_counter() - t0) * 1e3
    no_labels = Batch(images, None, np.zeros((B, 1)), np.zeros((B, 1, 4)), np.zeros((B, 1)))
    step = make_eval_step(model, "OptimizedRepresentation", (H, W), IMG, device=dev)
    want, want_n = non_max_suppression(step(None, no_labels), conf_thres=0.03, iou_thres=0.65)
    err = float(np.abs(dets - want.cpu().numpy()).max())
    out = {"load_s": load_s, "detect_ms": detect_ms, "detections_per_image": counts.tolist(),
           "max_abs_err_vs_eval_step": err}
    require(np.array_equal(counts, want_n.cpu().numpy()) and counts.min() > 0 and err <= 1e-5,
            f"DetectBackend vs the eval step: {out}, eval step counts {want_n.tolist()}")
    return out


def export_check(dev, tmp):
    """The full-width serving graph exported (``torch.export``), saved,
    loaded and served 3 requests; K1 once a request; detections equal to
    the eager ``make_server``'s on the same weights. Returns (the line's
    fields, K1 launches)."""
    import pathlib

    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.utils.config import load_config
    from event_representation_study_tpu_torch.utils.export import (
        build_serving_fn, export_serving_graph, load_serving_graph)

    cfg = load_config("configs/gen1_optimized.py")
    serve = make_server(cfg, "OptimizedRepresentation", H, W, IMG, 0.03, device=dev)
    randomize_preds_(serve.model, torch.Generator(device=dev).manual_seed(1))
    requests = [fake_batch(500 + 10 * r).to(dev).as_int32() for r in range(REQUESTS)]
    path = pathlib.Path(tmp) / "serve.pt2"
    t0 = time.perf_counter()
    export_serving_graph(build_serving_fn(serve), requests[0], path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = load_serving_graph(path)
    load_s = time.perf_counter() - t0

    def call(b):
        with torch.inference_mode():
            return graph(b.x, b.y, b.t, b.p, b.num)

    call(requests[-1])  # warm-up
    torch.cuda.synchronize()
    fs.reset_launches()
    times, outs = [], []
    for b in requests:
        t = time.perf_counter()
        dets, n = call(b)
        n.tolist()  # waits
        times.append((time.perf_counter() - t) * 1e3)
        outs.append((dets, n))
    k1 = fs.LAUNCHES[fs.K1]
    eager = [serve(b) for b in requests]
    err = max((d - e).abs().max().item() for (d, _), (e, _) in zip(outs, eager))
    counts = [n.tolist() for _, n in outs]
    fields = {"export_s": export_s, "load_s": load_s, "file_bytes": path.stat().st_size,
              "ms_per_request": times, "median_ms": statistics.median(times),
              "detections_per_image": counts, "max_abs_err_vs_eager": err, "k1_launches": k1}
    require(k1 == REQUESTS, f"exported graph: K1 launches {k1} for {REQUESTS} requests")
    require(all(torch.equal(n, e) for (_, n), (_, e) in zip(outs, eager)) and err <= 1e-5,
            f"exported graph vs eager serve: {fields}")
    require(all(0 < c <= 300 for cs in counts for c in cs), f"exported graph counts {counts}")
    return fields, k1


def ptq_check(dev, tmp):
    """``cli/train.py --fuse-ab --quant --calib`` at full width on the
    trainer phase's synthetic splits: no training, ``ptq_ckpt`` written;
    its int8 weights and scales equal to ``quantize_params`` of the same
    weights on the CPU. Returns (the line's fields, K1 launches)."""
    import pathlib

    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.train.checkpoint import load_checkpoint
    from event_representation_study_tpu_torch.utils.quantize import quantize_params

    root = pathlib.Path(tmp) / "gen1"
    root.mkdir()
    _trainer_fixture(root)
    fs.reset_launches()
    roll.reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main([
        "--conf", "configs/gen1_optimized.py", "--data-path", str(root), "--batch-size", str(B),
        "--img-size", str(IMG), "--num-events", str(N), "--output-dir", str(root / "out"),
        "--fuse-ab", "--quant", "--calib", "--device", torch.device(dev).type])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    k1, k3 = fs.LAUNCHES[fs.K1], roll.LAUNCHES[roll.K3]
    ptq = load_checkpoint(root / "out" / "ptq_ckpt")
    t0 = time.perf_counter()
    cpu_q, meta = quantize_params(copy.deepcopy(trainer.model).cpu())
    cpu_s = time.perf_counter() - t0
    card_q = {k: v for k, v in ptq["quantized"].items() if isinstance(v, dict)}
    equal = all(torch.equal(card_q[k]["q"], v["q"]) and torch.equal(card_q[k]["scale"], v["scale"])
                for k, v in cpu_q.items() if isinstance(v, dict))
    expected_k1 = min(4, len(trainer.train_loader)) + len(trainer.val_loader)
    fields = {"calib_s": calib_s, "quantized_weights": len(card_q), "cpu_quantize_s": cpu_s,
              "int8_and_scales_equal_cpu": equal, "steps": trainer.state.step,
              "activation_ranges": ptq["extra"]["activation_ranges"],
              "metrics": ptq["extra"]["metrics"], "k1_launches": k1, "k3_launches": k3,
              "k1_expected": expected_k1}
    require(equal and len(card_q) == len(meta) > 100, f"PTQ card vs CPU: {fields}")
    require(trainer.state.step == 0 and ptq["extra"]["activation_ranges"]["head_out"] > 0
            and "AP" in ptq["extra"]["metrics"], f"PTQ calibration: {fields}")
    require(k1 == expected_k1 and k3 == 0, f"PTQ launches: {fields}")
    del trainer
    return fields, k1


def variants_phase(dev):
    """The detector's training variants and deploy tools at the full width
    of ``configs/gen1_optimized.py`` (batch 8 of 50,000-event windows at
    640², float32): fuse-ab and distillation (``distill_feat``; the teacher
    written as a train checkpoint and read back by
    ``load_teacher_variables``) each a warm-up plus 3 ATSS and 3 TAL steps
    with the separable warp (K1 once, K3 twice a step; the teacher's
    BatchNorm statistics bit-unchanged); the learned representation (raw
    events, flips only) a warm-up plus 6 steps and an eval batch (K1 and
    K3 never); ``DetectBackend`` on a deploy checkpoint; PTQ through
    ``cli/train.py``; the exported serving graph. Returns the K1 and K3
    launches by path."""
    import tempfile

    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.ops.nms import non_max_suppression
    from event_representation_study_tpu_torch.parallel.train_step import (
        TrainState, make_eval_step)
    from event_representation_study_tpu_torch.train.checkpoint import (
        load_model_variables, load_teacher_variables, save_checkpoint)
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.optim import build_optimizer
    from event_representation_study_tpu_torch.utils.config import load_config

    n_steps = sum(TRAIN_STEPS.values())
    k1, k3, lines = {}, {}, []

    state, step, batches, info = train_setup(dev, n_steps + 1, model_kw={"fuse_ab": True},
                                             step_kw={"mode": "fuseab"})
    state, out = timed_variant_steps("fuseab", state, step, batches)
    lines.append(dict(out, **info))
    require(all(st["ab_num_pos"] > 0 for st in out["steps"]), "fuseab: ab positive anchors")
    k1["variants_fuseab"], k3["variants_fuseab"] = out["launches"][fs.K1], out["launches"][roll.K3]
    del state, step, batches
    torch.cuda.empty_cache()

    cfg = load_config("configs/gen1_optimized.py")
    with tempfile.TemporaryDirectory() as tmp:
        import pathlib

        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        # the teacher: the student's init (train_setup's seeds) plus noise of
        # 5% of each leaf's spread. Distillation starts from a trained
        # teacher; two unrelated random networks put the feature KD in a
        # cliff regime, and random class preds make the class KD (summed
        # over 8 x 8,400 anchors, times T^2) push the student's scores to
        # 1.0 in one step, where the varifocal loss is log(0). The class
        # preds start at zero weights and one bias value, so they get 5% of
        # randomize_preds_'s weight scale and a class prior instead (biases
        # -4.6 +- 0.75, as a detector trained on Gen1's cars and
        # pedestrians has one): the class KD of two uniform score maps is
        # float32 rounding about 0 (+-0.2 at this size); with this prior, ~2
        teacher = build_model(cfg, 2, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        randomize_preds_(teacher, torch.Generator(device=dev).manual_seed(6), which="reg_pred")
        g = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for name, p in teacher.named_parameters():
                if ".cls_pred_" in name and name.endswith("weight"):
                    p.normal_(0.0, 0.05 * p[0].numel() ** -0.5, generator=g)
                elif ".cls_pred_" in name:
                    p.add_(torch.tensor([0.75, -0.75], device=dev))
                elif p.numel() > 1:
                    p.add_(torch.randn(p.shape, generator=g, device=dev) * (0.05 * p.std()))
        save_checkpoint(tmp / "teacher", TrainState(
            teacher, build_optimizer(teacher, solver_config(cfg)), ema_init(teacher), 0), 0)
        want = {k: v.clone() for k, v in teacher.state_dict().items()}
        del teacher
        teacher = build_model(cfg, 2, device=dev)
        load_model_variables(teacher, load_teacher_variables(tmp / "teacher", dev))
        teacher.requires_grad_(False)
        teacher_s = time.perf_counter() - t0
        require(all(torch.equal(want[k], v) for k, v in teacher.state_dict().items()
                    if not k.endswith("num_batches_tracked")),
                "the teacher read back is not the one written")
        state, step, batches, info = train_setup(
            dev, n_steps + 1, step_kw={"mode": "distill", "teacher": teacher,
                                       "distill_feat": True, "max_epoch": 300})
        bn0 = {k: v.clone() for k, v in teacher.state_dict().items()}
        state, out = timed_variant_steps("distill", state, step, batches)
        unchanged = all(torch.equal(bn0[k], v) for k, v in teacher.state_dict().items())
        lines.append(dict(out, **info, teacher_checkpoint_s=teacher_s,
                          teacher_state_bit_unchanged=unchanged))
        require(unchanged, "the teacher's BatchNorm statistics changed")
        require(all(st["kd_cls"] > 0 and st["kd_dfl"] > 0 and st["kd_cw"] > 0
                    for st in out["steps"]),
                f"distill: KD terms {out['steps']}")
        k1["variants_distill"], k3["variants_distill"] = (out["launches"][fs.K1],
                                                          out["launches"][roll.K3])
        del state, step, batches, teacher
        torch.cuda.empty_cache()
        backend = detect_backend_check(dev, tmp)
        torch.cuda.empty_cache()

    learned = {"representation": "LearnedRepresentation", "img_size": IMG}
    state, step, batches, info = train_setup(dev, n_steps + 1, model_kw=learned, plan=False)
    state, out = timed_variant_steps("learned", state, step, batches)
    vl = [n for n, _ in state.model.named_parameters() if n.startswith("quantization.")]
    eval_step = make_eval_step(state.model, "LearnedRepresentation", (H, W), IMG, device=dev)
    fs.reset_launches()
    with torch.inference_mode():
        preds = eval_step(None, batches[-1])
        dets, counts = non_max_suppression(preds, conf_thres=0.03)
    eval_k1 = fs.LAUNCHES[fs.K1]
    lines.append(dict(out, **info, value_layer_params=len(vl), eval_preds_shape=list(preds.shape),
                      eval_detections_per_image=counts.tolist(), eval_k1=eval_k1))
    require(out["launches"][fs.K1] == 0 and out["launches"][roll.K3] == 0 and eval_k1 == 0,
            f"learned: launches {out['launches']}, eval K1 {eval_k1}")
    require(len(vl) == 6 and bool(torch.isfinite(preds).all()), "learned: value layer, eval preds")
    k1["variants_learned"] = 0
    del state, step, batches, preds
    torch.cuda.empty_cache()

    for n in lines:
        per_step = 0 if n["mode"] == "learned" else 1
        require(n["launches"][fs.K1] == per_step * n_steps
                and n["launches"][roll.K3] == 2 * per_step * n_steps,
                f"{n['mode']}: launches {n['launches']} for {n_steps} steps")
    with tempfile.TemporaryDirectory() as tmp:
        ptq, k1["variants_ptq"] = ptq_check(dev, tmp)
        torch.cuda.empty_cache()
        export, k1["variants_export"] = export_check(dev, tmp)
    torch.cuda.empty_cache()
    say("variants", batch=B, events_per_window=N, img=IMG, modes=lines, detect_backend=backend,
        ptq=ptq, export=export, tf32=tf32_state(),
        step_median_ms={n["mode"]: n["median_ms"] for n in lines},
        peak_mem_bytes={n["mode"]: n["peak_mem_bytes"] for n in lines})
    return k1, k3


def variants_reference(dev):
    """One step of a shrunk detector at REF_IMG px (batch 4) on the card and
    on the CPU from the same weights, for each training variant: fuse-ab
    (mosaic and mixup at 1.0, the separable warp), distill_ns (a YOLOv6s
    student, a plain shrunk teacher; the same plan) and the learned
    representation (raw events, flips only); the tolerances of
    ``train_reference``. The learned step runs twice: in float32, held on
    every leaf but the value layer's, and in float64, held on the value
    layer's. Its input differs card vs CPU by rounding (the value layer's
    products, index_add_'s atomics), where K1 makes ERGO-12 bit-equal, and
    float32 rounding moves the value layer's bias gradients (sums of ~10^5
    near-cancelling terms) by percents: one ulp on those weights does so
    on the CPU alone."""
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.utils.config import load_config

    small = load_config("configs/gen1_optimized.py", overrides=SMALL)
    hyp = dict(small["data_aug"], mosaic=1.0, mixup=1.0)
    rng = np.random.default_rng(8)
    blocks = fake_batch(9, n_windows=4, n_events=5000)
    labels = fake_labels(rng, 4, REF_IMG)
    planned = make_batch(blocks, labels, hyp, rng, REF_IMG)
    flipped = flip_batch(blocks, labels, hyp, rng, REF_IMG)
    teacher = build_model(small, 2, device="cpu", generator=torch.Generator().manual_seed(5))
    randomize_preds_(teacher, torch.Generator().manual_seed(7))
    ns = load_config("configs/gen1_optimized.py", overrides=SMALL + ["model.type=YOLOv6s"])
    learned = {"representation": "LearnedRepresentation", "img_size": REF_IMG}

    def value_layer(leaf):
        return leaf.startswith("quantization.")

    cases = {
        "fuseab": (small, planned, {"fuse_ab": True}, {"mode": "fuseab"}, None,
                   torch.float32, lambda leaf: True),
        "distill_ns": (ns, planned, {"distill_ns": True},
                       {"mode": "distill", "distill_feat": True}, teacher, torch.float32,
                       lambda leaf: True),
        "learned": (small, flipped, learned, {}, None, torch.float32,
                    lambda leaf: not value_layer(leaf)),
        "learned_value_layer": (small, flipped, learned, {}, None, torch.float64, value_layer),
    }
    results = {}
    for name, (cfg, batch, model_kw, step_kw, t, dtype, held) in cases.items():
        c, g, errs = card_vs_cpu_step(dev, cfg, batch, model_kw, step_kw, t, dtype, held)
        results[name] = {"dtype": str(dtype), "parts_card": g, "parts_cpu": c, "errors": errs}
    say("variants_reference", **results, tolerance=STEP_TOLERANCE, tf32=tf32_state())
    for name, r in results.items():
        g, c = r["parts_card"], r["parts_cpu"]
        pos = [k for k in c if k.endswith("num_pos")]
        require(all(g[k] == c[k] > 0 for k in pos), f"{name}: positive anchors {g} vs {c}")
        require(step_within(r["errors"]), f"{name} step card vs CPU: {r['errors']}")

GEN4_H, GEN4_W, GEN4_N = 720, 1280, 70_000  # the 1 Mpx sensor, its windows' events
GEN4_EVENTS = 1_500_000  # a recording
GEN4_STAMPS = 12  # label timestamps a recording: 24 windows a split, 3 batches of B
GEN4_OVERRIDES = ["data.num_classes=3"]
GT_DTYPE = [("t", "<u8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"), ("h", "<f4"),
            ("class_id", "<u4")]  # the release's *_bbox.npy, the fields consolidation reads


def gen4_release(root, seed: int):
    """A 1 Mpx split in the release format: 2 recordings of GEN4_EVENTS
    events over 2.4 s (``*_td.dat``, EVT2.0) and their ``*_bbox.npy`` GT.
    Each of GEN4_STAMPS label timestamps has boxes of classes 0, 1 and 2
    inside the frame, one of class 3 (dropped: class_id <= 2), one crossing
    the left edge (cropped) and one of 30 x 30 px (under the 60 px
    diagonal: dropped). Half of the events fall in the 60 ms before a
    timestamp inside its kept boxes, the rest anywhere on the sensor.
    Returns [(events, GT rows)] per recording."""
    from event_representation_study_tpu_torch.events.prophesee import EVENT_DTYPE, write_dat

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    out = []
    for r in range(2):
        stamps = np.sort(rng.choice(np.arange(100, 2400) * 1000, GEN4_STAMPS, replace=False))
        gt = np.zeros(GEN4_STAMPS * 6, GT_DTYPE)
        gt["t"] = np.repeat(stamps, 6)
        gt["class_id"] = np.tile([0, 1, 2, 3, 1, 2], GEN4_STAMPS)
        w, h = rng.uniform(80, 400, len(gt)), rng.uniform(60, 300, len(gt))
        w[4::6], h[4::6], w[5::6], h[5::6] = 200.0, 120.0, 30.0, 30.0
        gt["w"], gt["h"] = w, h
        gt["x"], gt["y"] = rng.uniform(0, GEN4_W - w), rng.uniform(0, GEN4_H - h)
        gt["x"][4::6] = -60.0
        t = np.sort(rng.integers(0, 2_400_000, GEN4_EVENTS))
        x, y = rng.integers(0, GEN4_W, GEN4_EVENTS), rng.integers(0, GEN4_H, GEN4_EVENTS)
        nxt = np.minimum(np.searchsorted(stamps, t), GEN4_STAMPS - 1)
        inside = (rng.random(GEN4_EVENTS) < 0.5) & (t > stamps[nxt] - 60_000) & (t <= stamps[nxt])
        box = 6 * nxt + rng.integers(0, 3, GEN4_EVENTS)  # one of the three kept in-frame boxes
        x = np.where(inside, gt["x"][box] + rng.random(GEN4_EVENTS) * gt["w"][box], x)
        y = np.where(inside, gt["y"][box] + rng.random(GEN4_EVENTS) * gt["h"][box], y)
        x, y = np.minimum(x, GEN4_W - 1), np.minimum(y, GEN4_H - 1)  # float32 box edges
        ev = np.zeros(GEN4_EVENTS, EVENT_DTYPE)
        ev["x"], ev["y"], ev["t"] = x.astype(np.int64), y.astype(np.int64), t
        ev["p"] = rng.choice([-1, 1], GEN4_EVENTS)
        write_dat(root / f"rec{r}_td.dat", ev, GEN4_H, GEN4_W)
        np.save(root / f"rec{r}_bbox.npy", gt)
        out.append((ev, gt))
    return out


def gen4_expected(ev, gt) -> dict:
    """The arrays a consolidated recording must hold: the events in the
    layout's dtypes, and the GT through the frame crop, the paper's box
    filter and class_id <= 2, grouped by timestamp."""
    from event_representation_study_tpu_torch.data import gen4

    b = gen4.filter_boxes(gen4.crop_to_frame(np.stack(
        [gt[k].astype(np.float64) for k, _ in GT_DTYPE], 1), GEN4_H, GEN4_W))
    b = b[b[:, 5] <= 2]
    t_unique, inv = np.unique(b[:, 0], return_inverse=True)
    b = b[np.argsort(inv, kind="stable")]
    return {"events/x": ev["x"].astype(np.uint16), "events/y": ev["y"].astype(np.uint16),
            "events/t": ev["t"], "events/p": ev["p"].astype(np.int8),
            "events/height": np.int64(GEN4_H), "events/width": np.int64(GEN4_W),
            "bbox/t_unique": t_unique.astype(np.int64),
            "bbox/offsets": np.cumsum(np.bincount(inv)).astype(np.int64),
            "bbox/class_id": b[:, 5].astype(np.int64),
            **{f"bbox/{k}": b[:, i].astype(np.float32) for i, k in enumerate("xywh", 1)},
            "bbox/event_idx": np.searchsorted(ev["t"], t_unique, side="right").astype(np.int64)}


def gen4_phase(dev, cnt_cols):
    """The 1 Mpx (Gen4) path at the sensor's full size: release-format
    files consolidated (``cli/consolidate.py``) through h5lite and checked
    array by array; ``cli/convert.py`` with the hot-pixel filter; the
    full-width paper detector with 3 classes trained (warm-up, 3 ATSS, 3
    TAL steps on batches of 8 x 70,000-event windows from the split,
    ERGO-12 on K1 at 1280x720, the image-mode strong augmentation on K3)
    and served (3 requests, and ``cli/infer.py`` on a ``.dat`` file), the
    loader's host time a batch, ``cli/train.py`` for an epoch then
    ``cli/eval.py``, ``cli/precompute_reps.py`` on 8 windows against the
    CPU, and K1 at the 1 Mpx shape against its plain version
    (``kernel_K1_gen4``). Returns (K1 launches of the path, K3 launches,
    the K1 entry)."""
    import contextlib
    import io
    import pathlib
    import tempfile

    from event_representation_study_tpu_torch.cli import consolidate as consolidate_cli
    from event_representation_study_tpu_torch.cli import convert as convert_cli
    from event_representation_study_tpu_torch.cli import eval as eval_cli
    from event_representation_study_tpu_torch.cli import infer as infer_cli
    from event_representation_study_tpu_torch.cli import precompute_reps as bake_cli
    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.data.gen4 import Gen4Dataset
    from event_representation_study_tpu_torch.data.loader import EventBatchLoader
    from event_representation_study_tpu_torch.events import blosc_codec, filters, h5lite
    from event_representation_study_tpu_torch.events.h5_io import H5EventHandle
    from event_representation_study_tpu_torch.events.prophesee import read_dat
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.reps.dispatch import batched_representation
    from event_representation_study_tpu_torch.utils.config import load_config

    codec = blosc_codec.available()
    k1_path = k3_path = 0
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        data = root / "data"
        data.mkdir()
        t0 = time.perf_counter()
        release = {split: gen4_release(root / split, seed) for split, seed in
                   (("training", 1), ("validation", 2))}
        release_s = time.perf_counter() - t0

        # consolidation through h5lite where h5py is absent, checked array by array
        consolidation, equal = {}, {}
        for split, recs in release.items():
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                consolidate_cli.main([str(root / split), "--output", str(data / f"{split}.h5")])
            seconds = time.perf_counter() - t0
            f = h5lite.File(data / f"{split}.h5")
            blosc = all(f[f"{rec}/{g}/{k}"].filter_ids == (h5lite.BLOSC_FILTER_ID,)
                        for rec in f.keys() for g in ("events", "bbox")
                        for k in f[f"{rec}/{g}"].keys()
                        if f[f"{rec}/{g}/{k}"].shape not in ((), (0,)))
            for r, (ev, gt) in enumerate(recs):
                for name, want in gen4_expected(ev, gt).items():
                    got = f[f"rec{r:05d}/{name}"]
                    equal[f"{split}/rec{r}/{name}"] = (got.dtype == want.dtype
                                                       and np.array_equal(got[()], want))
            f.close()
            consolidation[split] = {"seconds": seconds, "events": 2 * GEN4_EVENTS,
                                    "events_per_s": 2 * GEN4_EVENTS / seconds,
                                    "bytes": (data / f"{split}.h5").stat().st_size,
                                    "dat_bytes": sum((root / split / f"rec{r}_td.dat").stat().st_size
                                                     for r in range(2)), "blosc": blosc}
        written_by = "h5lite" if blosc_codec.h5py is h5lite else "h5py"
        say("gen4_consolidation", blosc_codec_available=codec, written_by=written_by,
            release_files_s=release_s, **consolidation, arrays_checked=len(equal),
            arrays_equal=sum(equal.values()))
        require(all(equal.values()), "consolidated arrays differ: "
                + str([k for k, v in equal.items() if not v]))
        require(all(c["blosc"] == codec for c in consolidation.values()),
                f"Blosc datasets {consolidation} with a codec present: {codec}")

        # conversion: .dat -> .h5 through H5Writer, the hot-pixel filter on the way
        dat = root / "training" / "rec0_td.dat"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            convert_cli.main([str(dat), "--filter", "hot_pixel", "--output",
                              str(root / "converted.h5")])
        convert_s = time.perf_counter() - t0
        h = H5EventHandle(root / "converted.h5")
        got = h.get_between_idx(0, len(h))
        sensor = (h.height, h.width)
        h.close()
        want = filters.hot_pixel_filter(read_dat(dat), GEN4_H, GEN4_W)
        converted_equal = len(got) == len(want) and all(np.array_equal(got[k], want[k])
                                                        for k in "xytp")
        say("gen4_convert", seconds=convert_s, events=len(got), sensor=sensor,
            equal_to_filtered_read=converted_equal)
        require(converted_equal and sensor == (GEN4_H, GEN4_W), "converted .dat read back")

        # the loader's host time a batch: 8 Blosc windows of 70,000 events
        cfg = load_config("configs/gen1_optimized.py", overrides=GEN4_OVERRIDES)
        train_ds = Gen4Dataset(data / "training.h5", num_events=GEN4_N)
        val_ds = Gen4Dataset(data / "validation.h5", task="val", num_events=GEN4_N)
        strong = EventBatchLoader(train_ds, B, img_size=IMG, hyp=dict(cfg["data_aug"]), seed=0)
        plain = EventBatchLoader(val_ds, B, img_size=IMG, shuffle=False)
        loader_ms = {"strong_aug": [], "eval": []}
        batches, val_batches = [], []
        for k in range(1 + sum(TRAIN_STEPS.values())):
            order = strong._indices()
            idx = order[(k % 3) * B:(k % 3 + 1) * B]
            t0 = time.perf_counter()
            batches.append(strong._make_batch(idx)[0])
            loader_ms["strong_aug"].append((time.perf_counter() - t0) * 1e3)
            strong.epoch += k % 3 == 2
        for k in range(3):
            t0 = time.perf_counter()
            val_batches.append(plain._make_batch(np.arange(k * B, (k + 1) * B))[0])
            loader_ms["eval"].append((time.perf_counter() - t0) * 1e3)
        windows_full = sum(train_ds[i].num_events == GEN4_N for i in range(len(train_ds)))
        say("gen4_loader_host_ms", batch=B, events_per_window=GEN4_N,
            train_windows=len(train_ds), windows_full=int(windows_full),
            median_ms={k: statistics.median(v) for k, v in loader_ms.items()}, ms=loader_ms)

        # the full-width train step at 1280x720, image-mode strong augmentation
        state, step, batches, info = train_setup(dev, 0, overrides=GEN4_OVERRIDES,
                                                 rep_hw=(GEN4_H, GEN4_W), batches=batches)
        t0 = time.perf_counter()
        (state, parts), k3_args = capture_roll_inputs(lambda: step(state, batches[0], 0))
        warm = {k: v.item() for k, v in parts.items()}
        warm_ms = (time.perf_counter() - t0) * 1e3
        state, times, per_step, launches, peak = timed_steps(state, step, batches[1:])
        n_steps = sum(TRAIN_STEPS.values())
        k1_path += launches[fs.K1]
        k3_path += launches[roll.K3]
        stages = step_stages(state, step, batches[1:], dev, mosaic=False)
        say("gen4_train", batch=B, events_per_window=GEN4_N, sensor=[GEN4_H, GEN4_W], img=IMG,
            num_classes=3, **info, warmup_step_ms=warm_ms, warmup_step=warm,
            ms_per_step=times, median_ms=statistics.median(times), peak_mem_bytes=peak,
            steps=per_step, launches=launches,
            roll_shapes=[list(a[0].shape) for a in k3_args],
            stages_median_ms={k: statistics.median(v) for k, v in stages.items()},
            stages_ms=stages, tf32=tf32_state())
        require(launches[fs.K1] == n_steps and launches[roll.K3] == 2 * n_steps,
                f"1 Mpx steps: launches {launches} for {n_steps} steps")
        require(all(math.isfinite(v) for st in per_step for v in st.values()), "finite losses")
        require(all(st["num_pos"] > 0 for st in per_step), "every step has positive anchors")
        del state, step, batches, k3_args
        torch.cuda.empty_cache()

        # serving: 3 requests of 8 validation windows, and cli/infer.py on a .dat file
        serve = make_server(cfg, "OptimizedRepresentation", GEN4_H, GEN4_W, IMG, 0.03,
                            device="cuda")
        randomize_preds_(serve.model, torch.Generator(device=dev).manual_seed(1))
        requests = [b.events for b in val_batches]
        serve(requests[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, counts = [], []
        fs.reset_launches()
        for blk in requests:
            t = time.perf_counter()
            dets, n = serve(blk)
            counts.append(n.tolist())  # host copy: waits for the device
            times.append((time.perf_counter() - t) * 1e3)
        serve_k1 = fs.LAUNCHES[fs.K1]
        peak = torch.cuda.max_memory_allocated()
        stages, _ = serve_stages(serve, requests[0], dev)
        del serve
        torch.cuda.empty_cache()
        fs.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            infer_dets = infer_cli.main(["--events", str(root / "validation" / "rec1_td.dat"),
                                         "--num-events", str(GEN4_N), "--conf-thres", "0.001",
                                         "--override", *GEN4_OVERRIDES])
        infer_s, infer_k1 = time.perf_counter() - t0, fs.LAUNCHES[fs.K1]
        k1_path += serve_k1 + infer_k1
        say("gen4_serve", requests=len(requests), batch=B, events_per_window=GEN4_N,
            sensor=[GEN4_H, GEN4_W], img=IMG, ms_per_request=times,
            median_ms=statistics.median(times), peak_mem_bytes=peak,
            detections_per_image=counts, k1_launches=serve_k1, stages_ms=stages,
            infer_dat={"seconds": infer_s, "detections": len(infer_dets), "k1_launches": infer_k1},
            tf32=tf32_state())
        require(serve_k1 == len(requests) and bool(torch.isfinite(dets).all()),
                f"1 Mpx requests: K1 {serve_k1}")
        require(infer_k1 == 1 and np.isfinite(infer_dets).all(), f"cli/infer.py .dat: K1 {infer_k1}")

        # the Trainer for an epoch on the two splits, then cli/eval.py
        args = ["--conf", "configs/gen1_optimized.py", "--data-path", str(data),
                "--batch-size", str(B), "--img-size", str(IMG), "--num-events", str(GEN4_N),
                "--override", *GEN4_OVERRIDES]
        fs.reset_launches()
        t0 = time.perf_counter()
        tr = train_cli.main(args + ["--epochs", "1", "--eval-interval", "1",
                                    "--output-dir", str(root / "run")])
        trainer_s, trainer_k1 = time.perf_counter() - t0, fs.LAUNCHES[fs.K1]
        train_steps, val_steps = len(tr.train_loader), len(tr.val_loader)
        del tr
        torch.cuda.empty_cache()
        fs.reset_launches()
        t0 = time.perf_counter()
        stats = eval_cli.main(args + ["--checkpoint", str(root / "run" / "last_ckpt"),
                                      "--task", "val"])
        eval_s, eval_k1 = time.perf_counter() - t0, fs.LAUNCHES[fs.K1]
        k1_path += trainer_k1 + eval_k1
        say("gen4_trainer", seconds=trainer_s, train_steps=train_steps, val_batches=val_steps,
            k1_launches=trainer_k1, eval_cli={"seconds": eval_s, "k1_launches": eval_k1,
                                               "AP": stats["AP"], "AP50": stats["AP50"]})
        require(trainer_k1 == train_steps + val_steps and eval_k1 == val_steps,
                f"Trainer K1 {trainer_k1} for {train_steps} + {val_steps}, eval {eval_k1}")
        require(math.isfinite(stats["AP"]), f"cli/eval.py AP {stats['AP']}")

        # baking 8 validation windows; two of them against the CPU
        fs.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            baked = bake_cli.main(["--data-path", str(data), "--output-dir", str(root / "baked"),
                                   "--limit", str(B), "--batch-size", str(B),
                                   "--num-events", str(GEN4_N)])
        bake_s, bake_k1 = time.perf_counter() - t0, fs.LAUNCHES[fs.K1]
        k1_path += bake_k1
        cpu_rep = batched_representation("OptimizedRepresentation", GEN4_H, GEN4_W)(
            val_batches[0].events.to("cpu"))
        bake_err = 0.0
        for i in range(2):
            f = h5lite.File(root / "baked" / "reps" / f"{i}.h5")
            bake_err = max(bake_err, float(np.abs(f["rep"][()] - cpu_rep[i].numpy()).max()))
            f.close()
        say("gen4_bake", samples=baked, seconds=bake_s, k1_launches=bake_k1,
            bytes=sum(q.stat().st_size for q in (root / "baked" / "reps").iterdir()),
            max_abs_err_vs_cpu=bake_err, tolerance=2e-4 * 255)
        require(baked == B and bake_k1 == 1 and bake_err <= 2e-4 * 255,
                f"baking: {baked} samples, K1 {bake_k1}, err {bake_err}")

    # K1 at the 1 Mpx shape: B 8, N 70,000, S 921,600, Ks 18, Km 3
    blocks = val_batches[0].events.to(dev)
    _, _, k1_args = capture_kernel_inputs(
        lambda: batched_representation("OptimizedRepresentation", GEN4_H, GEN4_W)(blocks))
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    entry = check_kernel("kernel_K1_gen4", k1_args, cnt_cols, flush)
    del flush, k1_args, blocks
    torch.cuda.empty_cache()
    return k1_path, k3_path, entry


IMAGES_TRAIN, IMAGES_VAL = 7 * B, B  # the folder: 7 train batches of B, one val batch
IMAGES_HW = ((220, 261), (280, 331))  # frame heights and widths drawn around 240x304
DEMO_FRAMES = 3  # frames of the written video; --max-frames 2 serves 2


def image_batches(root, n_batches: int, hyp, img: int = IMG):
    """The first ``n_batches`` train batches of the port's ImageBatchLoader
    over ``root`` (the config's recipe with ``hyp``), each with its host
    assembly ms."""
    from event_representation_study_tpu_torch.data.image_dataset import (
        ImageBatchLoader, ImageFolderDataset)

    loader = ImageBatchLoader(ImageFolderDataset(root, task="train", img_size=img), B,
                              img_size=img, shuffle=True, seed=0, hyp=hyp)
    out, ms = [], []
    indices = loader._indices()
    for b in range(n_batches):
        t = time.perf_counter()
        out.append(loader._make_batch(indices[b * B:(b + 1) * B])[0])
        ms.append((time.perf_counter() - t) * 1e3)
    return out, ms


def image_step_stages(state, step, batches, dev):
    """Where an image step's device time goes, stage by stage (ms from CUDA
    events) on the first 3 batches: the host-to-device copy of the tiles,
    the separable warp (K3), forward + loss, backward, optimizer + EMA."""
    from event_representation_study_tpu_torch.parallel.train_step import batch_on_device

    stages = {k: [] for k in ("h2d", "warp", "forward_loss", "backward", "optimizer_ema")}
    for j in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        batch = batch_on_device(batches[j], dev)
        ev[1].record()
        imgs = step.images_of(batch)
        ev[2].record()
        state.model.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(state.model, imgs, batch, 5)
        ev[3].record()
        loss.backward()
        ev[4].record()
        step.apply_update(state)
        ev[5].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stages, zip(ev, ev[1:])):
            stages[k].append(a.elapsed_time(b))
    return stages


def images_phase(dev):
    """Original-image data on the card: a synthetic image folder written
    with cv2; the full-width paper detector at 3 channels trained on it
    (warm-up + 3 ATSS + 3 TAL steps, the separable warp of the RGB tiles on
    K3); ``cli/train.py --override data.type=images`` for an epoch and its
    COCO evaluation; ``cli/infer.py --source`` on a PNG and an MJPG video
    with the trained checkpoint; ``--save-img`` on a Gen1 event file (K1);
    a reference-style state dict of ``configs/swinv2_yolov6l6_finetune.py``
    imported by ``utils/torch_convert.py`` and served on the card against
    the CPU; ``--plot-images``. Returns (the K3 arguments of the warm-up
    step, launches by path)."""
    import pathlib
    import tempfile

    import cv2

    from event_representation_study_tpu_torch.cli import infer as infer_cli
    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.data.image_dataset import write_image_folder
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.parallel.train_step import (
        init_train_state, make_train_step)
    from event_representation_study_tpu_torch.train.optim import (
        accumulation_steps, build_optimizer, with_accumulation)
    from event_representation_study_tpu_torch.utils.config import load_config

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        boxes = write_image_folder(tmp / "folder", n=IMAGES_TRAIN, seed=0, h_range=IMAGES_HW[0],
                                   w_range=IMAGES_HW[1], tasks=("train",))
        boxes.update(write_image_folder(tmp / "folder", n=IMAGES_VAL, seed=1,
                                        h_range=IMAGES_HW[0], w_range=IMAGES_HW[1],
                                        tasks=("val",)))
        folder_s = time.perf_counter() - t0
        sizes = sorted({(h, w) for h, w, *_ in boxes.values()})

        # the full-width step on the folder's batches
        cfg = load_config("configs/gen1_optimized.py", overrides=["data.type=images"])
        hyp = dict(cfg["data_aug"])
        n_steps = sum(TRAIN_STEPS.values())
        batches, loader_ms = image_batches(tmp / "folder", n_steps + 1, hyp)
        t0 = time.perf_counter()
        model = build_model(cfg, cfg["data"]["num_classes"], num_channels=3, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(5))
        randomize_preds_(model, torch.Generator(device=dev).manual_seed(6), which="reg_pred")
        sgd = build_optimizer(model, solver_config(cfg))
        sgd.count = max(round(sgd.cfg.warmup_epochs * sgd.cfg.steps_per_epoch), 1000)
        state = init_train_state(model, with_accumulation(sgd, accumulation_steps(B, nominal=B)))
        step = make_train_step(loss_config(cfg), None, (IMG, IMG), IMG, warp_impl="separable",
                               device=dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (state, parts), k3_args = capture_roll_inputs(lambda: step(state, batches[0], 0))
        warm = {k: v.item() for k, v in parts.items()}
        warm_ms = (time.perf_counter() - t0) * 1e3
        require(len(k3_args) == 2 and all(a[0].shape[-1] == 3 for a in k3_args),
                f"the warp rolled {[list(a[0].shape) for a in k3_args]}, not twice at C = 3")
        state, times, per_step, step_launches, peak = timed_steps(state, step, batches[1:])
        stages = image_step_stages(state, step, batches, dev)
        n_params = sum(p.numel() for p in model.parameters())
        del state, model, step
        torch.cuda.empty_cache()
        say("images", folder={"frames": IMAGES_TRAIN + IMAGES_VAL, "sizes": len(sizes),
                              "smallest": sizes[0], "largest": sizes[-1], "write_s": folder_s},
            batch=B, img=IMG, channels=3, params=n_params, build_s=build_s,
            loader_make_batch_ms=loader_ms, loader_median_ms=statistics.median(loader_ms),
            warmup_step_ms=warm_ms, warmup_step=warm, ms_per_step=times,
            median_ms=statistics.median(times), peak_mem_bytes=peak, steps=per_step,
            launches=step_launches, roll_shapes=[list(a[0].shape) for a in k3_args],
            tf32=tf32_state())
        say("images_stages_ms", epoch=5, tf32=tf32_state(),
            **{k: statistics.median(v) for k, v in stages.items()}, all_runs=stages)
        require(step_launches[roll.K3] == 2 * n_steps and step_launches[fs.K1] == 0,
                f"image steps: launches {step_launches} for {n_steps} steps")
        require(all(math.isfinite(v) for st in per_step for v in st.values()), "finite losses")
        require(all(st["num_pos"] > 0 for st in per_step), "every step has positive anchors")
        launches["step"] = step_launches[roll.K3]

        # the Trainer through cli/train.py, and its evaluation
        stats = []
        from event_representation_study_tpu_torch.train import engine

        real_eval = engine.Trainer.eval_and_save

        def eval_and_save(self, epoch):
            stats.append(real_eval(self, epoch))
            return stats[-1]

        engine.Trainer.eval_and_save = eval_and_save
        fs.reset_launches()
        roll.reset_launches()
        t0 = time.perf_counter()
        try:
            tr = train_cli.main(["--conf", "configs/gen1_optimized.py", "--data-path",
                                 str(tmp / "folder"), "--override", "data.type=images",
                                 "--batch-size", str(B), "--img-size", str(IMG), "--epochs", "1",
                                 "--augment", "--eval-interval", "1",
                                 "--output-dir", str(tmp / "run")])
        finally:
            engine.Trainer.eval_and_save = real_eval
        trainer_s = time.perf_counter() - t0
        trainer_launches = {fs.K1: fs.LAUNCHES[fs.K1], roll.K3: roll.LAUNCHES[roll.K3]}
        info = {"aug_mode": tr.aug_mode, "warp_impl": tr.warp_impl, "steps": tr.state.step,
                "loader_batches": len(tr.train_loader), "val_batches": len(tr.val_loader),
                "stem_channels": tr.model.backbone.stem.conv.weight.shape[1]}
        del tr
        torch.cuda.empty_cache()
        ckpt = tmp / "run" / "last_ckpt"
        say("images_trainer", **info, seconds=trainer_s, launches=trainer_launches,
            ap=stats[-1]["AP"], ap50=stats[-1]["AP50"],
            eval_speed_ms_per_image={k: stats[-1][k] for k in (
                "speed_pre_ms", "speed_infer_nms_ms", "speed_post_ms")},
            last_ckpt=ckpt.exists())
        require(info["aug_mode"] == "image" and info["warp_impl"] == "separable"
                and info["stem_channels"] == 3, f"image Trainer: {info}")
        require(info["steps"] == info["loader_batches"] == IMAGES_TRAIN // B,
                f"image Trainer steps {info}")
        require(trainer_launches[roll.K3] == 2 * info["steps"] and trainer_launches[fs.K1] == 0,
                f"image Trainer launches {trainer_launches}")
        require(len(stats) == 1 and math.isfinite(stats[-1]["AP"]) and ckpt.exists(),
                f"image Trainer eval {stats}, checkpoint {ckpt.exists()}")
        launches["trainer"] = trainer_launches[roll.K3]

        # the pixel demo with the trained checkpoint: a PNG and an MJPG video
        frame = np.random.default_rng(3).integers(0, 255, (H, W, 3), np.uint8)
        require(cv2.imwrite(str(tmp / "demo.png"), frame), "cv2 writes the demo PNG")
        vw = cv2.VideoWriter(str(tmp / "demo.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 5.0, (W, H))
        require(vw.isOpened(), "cv2 opens an MJPG video writer")
        for i in range(DEMO_FRAMES):
            vw.write(np.ascontiguousarray(np.roll(frame, 17 * i, axis=1)))
        vw.release()
        real_run, frame_ms = infer_cli.Server.run, []

        def timed_run(self, x):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_run(self, x)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            return out

        infer_cli.Server.run = timed_run
        demo = {}
        fs.reset_launches()
        try:
            for kind in ("png", "avi"):
                t0 = time.perf_counter()
                res = infer_cli.main(["--source", str(tmp / f"demo.{kind}"), "--checkpoint",
                                      str(ckpt), "--img-size", str(IMG), "--max-frames", "2",
                                      "--save-dir", str(tmp / f"annotated_{kind}")])
                written = sorted(p.name for p in (tmp / f"annotated_{kind}").iterdir())
                demo[kind] = {"frames": len(res), "written": written,
                              "detections": [len(d) for _, _, d in res],
                              "shapes": [list(cv2.imread(str(tmp / f"annotated_{kind}" / n)).shape)
                                         for n in written],
                              "cli_s": time.perf_counter() - t0}
        finally:
            infer_cli.Server.run = real_run
        say("images_demo", **demo, frame_ms=frame_ms, launches=dict(fs.LAUNCHES),
            tf32=tf32_state())
        require(demo["png"]["frames"] == 1 and demo["avi"]["frames"] == 2,
                f"demo frames {demo}")
        require(demo["png"]["written"] == ["demo_00000.png"]
                and demo["avi"]["written"] == ["demo_00000.png", "demo_00001.png"],
                f"demo files {demo}")
        require(all(s == [H, W, 3] for k in demo for s in demo[k]["shapes"]),
                f"annotated shapes {demo}")
        require(fs.LAUNCHES[fs.K1] == 0, "the pixel path builds no representation")

        # --save-img on a Gen1 event file (ERGO-12 on K1)
        ev = fake_batch(500, n_windows=1)
        np.savez(tmp / "ev.npz", event_data=np.stack(
            [ev.x[0].numpy(), ev.y[0].numpy(), ev.t[0].numpy(), ev.p[0].numpy()], 1))
        fs.reset_launches()
        dets = infer_cli.main(["--source", str(tmp / "ev.npz"), "--img-size", str(IMG),
                               "--save-img", str(tmp / "ev.png")])
        save_img_k1 = fs.LAUNCHES[fs.K1]
        from PIL import Image

        saved = np.asarray(Image.open(tmp / "ev.png"))
        say("images_save_img", detections=len(dets), shape=list(saved.shape),
            k1_launches=save_img_k1)
        require(save_img_k1 == 1 and saved.shape == (H, W, 3), f"--save-img: {save_img_k1} "
                f"K1 launches, image {saved.shape}")
        launches["save_img_k1"] = save_img_k1

        # a reference-style state dict of the full-width paper config,
        # imported, served on the card and on the CPU
        launches["convert_k1"] = torch_convert_check(dev)

        # --plot-images: the mosaics, or an ImportError naming matplotlib
        launches["plots_k1"] = plot_images_check(tmp)
    return k3_args, launches


def torch_convert_check(dev):
    """``utils/torch_convert.py`` at full width: the seeded
    ``configs/swinv2_yolov6l6_finetune.py`` detector (random pred convs) on
    the CPU, its state dict under the reference's names in half precision
    (the published EMA's), converted and loaded into a card server and a CPU
    server; one request of 2 windows each. Returns the card's K1 launches."""
    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.utils import torch_convert
    from event_representation_study_tpu_torch.utils.config import load_config

    cfg = load_config("configs/swinv2_yolov6l6_finetune.py")
    servers = {"cpu": make_server(cfg, "OptimizedRepresentation", H, W, IMG, 0.03, device="cpu")}
    randomize_preds_(servers["cpu"].model, torch.Generator().manual_seed(4))
    ref = {k: v.half() if v.is_floating_point() else v for k, v in
           torch_convert.reference_state_dict(servers["cpu"].model.state_dict()).items()}
    t0 = time.perf_counter()
    sd, unmatched = torch_convert.convert_state_dict(ref)
    convert_s = time.perf_counter() - t0
    servers["cuda"] = make_server(cfg, "OptimizedRepresentation", H, W, IMG, 0.03, device=dev)
    load_s = {}
    for d in ("cpu", "cuda"):
        problems = torch_convert.verify_against_tree(sd, servers[d].model.state_dict())
        require(not problems and not unmatched, f"torch_convert: {problems[:5]} {unmatched[:5]}")
        t0 = time.perf_counter()
        servers[d].model.load_state_dict(sd, strict=True)
        if d == "cuda":
            torch.cuda.synchronize()
        load_s[d] = time.perf_counter() - t0
    blocks = fake_batch(600, n_windows=2)
    fs.reset_launches()
    t0 = time.perf_counter()
    _, p_g, _, n_g = servers["cuda"].run(blocks)
    n_g = n_g.tolist()  # waits for the card
    card_ms = (time.perf_counter() - t0) * 1e3
    k1 = fs.LAUNCHES[fs.K1]
    p_g = p_g.cpu()
    _, p_c, _, n_c = servers["cpu"].run(blocks)
    errs = {"boxes": (p_g[..., :4] - p_c[..., :4]).abs().max().item(),
            "scores": (p_g[..., 4:] - p_c[..., 4:]).abs().max().item()}
    say("images_torch_convert", keys=len(ref), converted=len(sd), skipped=len(ref) - len(sd) - len(
        unmatched), params=sum(p.numel() for p in servers["cuda"].model.parameters()),
        convert_s=convert_s, load_s=load_s, request_ms_card=card_ms, k1_launches=k1,
        detections_card=n_g, detections_cpu=n_c.tolist(), max_abs_err=errs,
        tolerance="boxes 1e-2 px, scores 1e-4", tf32=tf32_state())
    require(errs["boxes"] <= 1e-2 and errs["scores"] <= 1e-4 and k1 == 1,
            f"torch_convert card vs CPU: {errs}, K1 {k1}")
    del servers
    torch.cuda.empty_cache()
    return k1


def plot_images_check(tmp):
    """``cli/train.py --plot-images`` on small Gen1 splits (a shrunk detector
    at 640², 1 epoch): where matplotlib imports, ``train_batch.png`` and
    ``val_pred.png`` are written; where it does not, the first plot raises
    ``ImportError`` naming it. Returns the K1 launches of the run."""
    import importlib.util

    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
    from event_representation_study_tpu_torch.ops import fused_scatter as fs

    (tmp / "gen1").mkdir()
    for split, seed in (("training.h5", 3), ("validation.h5", 4)):
        write_gen1_fixture(tmp / "gen1" / split, num_files=1, boxes_per_file=4,
                           events_per_file=100_000, seed=seed)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    fs.reset_launches()
    error = None
    try:
        train_cli.main(["--conf", "configs/gen1_optimized.py", "--data-path", str(tmp / "gen1"),
                        "--override", *SMALL, "--batch-size", "2", "--img-size", str(IMG),
                        "--epochs", "1", "--eval-interval", "1", "--plot-images",
                        "--output-dir", str(tmp / "plots")])
    except ImportError as e:
        error = str(e)
    written = {n: (tmp / "plots" / n).exists() for n in ("train_batch.png", "val_pred.png")}
    say("images_plots", matplotlib=has_mpl, error=error, written=written,
        k1_launches=fs.LAUNCHES[fs.K1])
    if has_mpl:
        require(error is None and all(written.values()), f"--plot-images: {error}, {written}")
    else:
        require(error is not None and "matplotlib" in error,
                f"--plot-images without matplotlib must name it: {error}")
    return fs.LAUNCHES[fs.K1]


# -- the parallel layer: data parallel through the Trainer, event sharding,
# -- the data-parallel step and tensor parallelism ----------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def trainer_ddp_phase(dev):
    """``cli/train.py`` at the full width of ``configs/gen1_optimized.py``,
    as a world of one through NCCL (``RANK=0 WORLD_SIZE=1`` and an
    address), beside the same run without a process group: 1 epoch of the
    trainer phase's synthetic splits with the image-space strong
    augmentation (separable warp: K3 twice a step, K1 once a step and an
    eval batch) and an eval. The step all-reduces its gradients through
    NCCL; every step's loss and the epoch's parameter update match the run
    without a group. Returns
    the NCCL run's (K1, K3) launches."""
    import os
    import pathlib
    import tempfile

    import torch.distributed as dist

    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.parallel import train_step as train_step_mod

    reduced = []
    real_summed = train_step_mod._summed

    def summed(grads, group):
        reduced.append((dist.get_backend(group), dist.get_world_size(group)))
        return real_summed(grads, group)

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1"}
    runs, updates = {}, {}
    probe = TrainerProbe()
    with tempfile.TemporaryDirectory() as tmp:
        _trainer_fixture(pathlib.Path(tmp))
        args = ["--conf", "configs/gen1_optimized.py", "--data-path", tmp,
                "--batch-size", str(B), "--img-size", str(IMG), "--num-events", str(N),
                "--augment", "--aug-mode", "image", "--stop-aug-last-n-epoch", "0",
                "--eval-interval", "1", "--epochs", "1", "--device", dev.type]
        probe.install()
        train_step_mod._summed = summed
        try:
            for name in ("single", "nccl"):
                if name == "nccl":
                    os.environ.update(env, MASTER_PORT=str(_free_port()))
                n_steps, n_evals, n_reduced = len(probe.steps), len(probe.evals), len(reduced)
                probe.snapshot = None
                fs.reset_launches()
                roll.reset_launches()
                t0 = time.perf_counter()
                tr = train_cli.main(args + ["--output-dir", f"{tmp}/{name}"])
                runs[name] = {"s": time.perf_counter() - t0, "steps": probe.steps[n_steps:],
                              "evals": probe.evals[n_evals:], "reduced": reduced[n_reduced:],
                              "k1": fs.LAUNCHES[fs.K1], "k3": roll.LAUNCHES[roll.K3],
                              "group_left": not dist.is_initialized(),
                              "warp": tr.warp_impl, "aug_mode": tr.aug_mode}
                # the epoch's whole update, on the card: each run against the other below
                updates[name] = {n: p.detach() - probe.snapshot[0][n]
                                 for n, p in tr.state.model.named_parameters()}
                del tr
                torch.cuda.empty_cache()
                for k in (*env, "MASTER_PORT"):
                    os.environ.pop(k, None)
        finally:
            probe.uninstall()
            train_step_mod._summed = real_summed
    view = {name: {"run_s": r["s"], "step_ms_median": statistics.median(s["ms"] for s in r["steps"]),
                   "step_ms": [s["ms"] for s in r["steps"]],
                   "losses": [s["loss"] for s in r["steps"]],
                   "k1_per_step": [s["k1"] for s in r["steps"]],
                   "k3_per_step": [s["k3"] for s in r["steps"]],
                   "eval_k1_per_batch": r["evals"], "k1_launches": r["k1"], "k3_launches": r["k3"],
                   "gradient_all_reduces": r["reduced"][:1] + [len(r["reduced"])],
                   "group_left": r["group_left"], "aug_mode": r["aug_mode"], "warp": r["warp"]}
            for name, r in runs.items()}
    losses = [[s["loss"] for s in runs[n]["steps"]] for n in ("single", "nccl")]
    loss_rel = max((abs(b - a) / abs(a) for a, b in zip(*losses)), default=math.inf)
    update_err = leaf_error(updates["nccl"], updates["single"])
    update_max = max(d.abs().max().item() for d in updates["single"].values())
    del updates
    torch.cuda.empty_cache()
    say("trainer_ddp", **view, loss_rel_diff=loss_rel, update_leaf_scale=update_err,
        update_max=update_max,
        tolerance="every step's loss 1e-3 relative; the epoch's update 2e-2 of leaf scale",
        tf32=tf32_state())
    for name, r in runs.items():
        require(r["aug_mode"] == "image" and r["warp"] == "separable",
                f"{name}: aug_mode {r['aug_mode']}, warp {r['warp']}")
        require(all(s["k1"] == 1 and s["k3"] == 2 for s in r["steps"]) and r["steps"],
                f"{name}: K1/K3 a step {[(s['k1'], s['k3']) for s in r['steps']]}")
        require(all(e == 1 for e in r["evals"]) and r["evals"], f"{name}: eval K1 {r['evals']}")
        require(all(math.isfinite(s["loss"]) for s in r["steps"]), f"{name}: losses")
    require(runs["single"]["reduced"] == [] and runs["nccl"]["group_left"],
            "the run without a group reduced gradients, or the NCCL run kept its group")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    require(runs["nccl"]["reduced"] == [(backend, 1)] * len(runs["nccl"]["steps"]),
            f"NCCL gradient all-reduces {runs['nccl']['reduced']}")
    require(len(losses[0]) == len(losses[1]) and loss_rel <= 1e-3,
            f"losses with and without the group: {losses}")
    require(update_max > 0 and update_err[0] <= 2e-2,
            f"the epoch's update with and without the group: {update_err}, largest {update_max}")
    return runs["nccl"]["k1"], runs["nccl"]["k3"]


PARALLEL_WORLD = 2  # gloo ranks sharing the one card
DDP_IMG, DDP_B = 320, 8  # the shrunk detector's data-parallel batch: 4 a rank
EVENT_SHARD_TOLERANCE = ("histogram, TORE, the time surface, max channels and channels of "
                         "count / polarity columns exact; timestamp sums 2e-4 (ERGO-12, MDES), "
                         "voxel grid 1e-5 relative + 1e-4")


def _launch_counts():
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll

    return {"K1": fs.LAUNCHES[fs.K1], "K2": fs.LAUNCHES[fs.K2], "K3": roll.LAUNCHES[roll.K3]}


def _counted(fn):
    """(fn's result, the K1/K2/K3 launches it made), synchronised."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll

    fs.reset_launches()
    roll.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _launch_counts()


def _event_shard_part(rank: int, world: int, dev) -> dict:
    """Every sharded representation on this rank's half of the serve batch
    (8 x 50,000 events, 240x304) against the unsharded one on the card."""
    from event_representation_study_tpu_torch.parallel import event_shard as es
    from event_representation_study_tpu_torch.parallel.mesh import make_mesh
    from event_representation_study_tpu_torch.reps import fused_mdes, fused_reps
    from event_representation_study_tpu_torch.reps.ergo12 import (
        AGGREGATIONS, FUNCTIONS, WINDOW_INDEXES)
    from event_representation_study_tpu_torch.reps.tore import tore

    mesh = make_mesh(axis_names=("data", "event"), shape=(1, world), device=dev)
    blocks = fake_batch(0)
    loc = es.place_event_sharded(blocks, mesh)
    whole = blocks.to(dev)
    table = list(zip(WINDOW_INDEXES, FUNCTIONS, AGGREGATIONS))
    sum_only = [row for row in table if row[2] != "max"]
    tables = {"ergo12": table, "mdes_sum_only": sum_only}
    cases = {
        "ergo12": (lambda: es.sharded_ergo12(loc, H, W, mesh),
                   lambda: fused_mdes.ergo12_fused_batched(whole, H, W)),
        "mdes_sum_only": (lambda: es.sharded_mdes(loc, H, W, mesh, *zip(*sum_only)),
                          lambda: fused_mdes.mdes_fused_batched(whole, H, W, *zip(*sum_only))),
        "time_surface": (lambda: es.sharded_time_surface(loc, H, W, mesh),
                         lambda: fused_reps.time_surface_fused_batched(whole, H, W)),
        "histogram": (lambda: es.sharded_histogram(loc, H, W, mesh),
                      lambda: fused_reps.histogram_fused_batched(whole, H, W)),
        "voxel_grid": (lambda: es.sharded_voxel_grid(loc, H, W, mesh),
                       lambda: fused_reps.voxel_grid_fused_batched(whole, H, W)),
        "tore": (lambda: es.sharded_tore(loc, H, W, mesh), lambda: tore(whole, H, W)),
    }
    out = {"local_events": list(loc.x.shape)}
    for name, (sharded, unsharded) in cases.items():
        sharded()  # warm-up
        got, launches = _counted(sharded)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            sharded()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        want = unsharded()
        diff = (got - want).abs()
        if name in tables:
            exact = [c for c, (_, f, a) in enumerate(tables[name])
                     if a == "max" or not f.startswith("timestamp")]
            inexact = [c for c in range(got.shape[-1]) if c not in exact]
            errs = {"exact_channels": diff[..., exact].max().item(),
                    "timestamp_channels": diff[..., inexact].max().item()}
            ok = errs["exact_channels"] == 0 and errs["timestamp_channels"] <= 2e-4
        elif name == "voxel_grid":
            errs = {"max_abs": diff.max().item()}
            ok = bool((diff <= 1e-4 + 1e-5 * want.abs()).all())
        else:
            errs = {"max_abs": diff.max().item()}
            ok = torch.equal(got, want)
        out[name] = {"shape": list(got.shape), "launches": launches, "errors": errs, "ok": ok,
                     "finite": bool(torch.isfinite(got).all()), "ms": statistics.median(times)}
    return out


def _ddp_batches():
    """The whole batch (DDP_B windows of 50,000 events at DDP_IMG, the
    paper recipe with mosaic and mixup at 1.0) and each rank's half, each
    half planned alone (partners within it) and the whole batch's plan the
    halves' with the second's partner rows shifted; rank 1's windows carry
    no box."""
    from event_representation_study_tpu_torch.data.augment import plan_augment_batch
    from event_representation_study_tpu_torch.ops.warp import AugPlan
    from event_representation_study_tpu_torch.parallel.train_step import Batch
    from event_representation_study_tpu_torch.utils.config import load_config

    half = DDP_B // PARALLEL_WORLD
    hyp = dict(load_config("configs/gen1_optimized.py", overrides=SMALL)["data_aug"],
               mosaic=1.0, mixup=1.0)
    rng = np.random.default_rng(41)
    blocks = fake_batch(40, n_windows=DDP_B)
    labels = fake_labels(rng, half, DDP_IMG) + [np.zeros((0, 5), np.float32)] * half
    cap = LABELS_PER_WINDOW * 4 * 2
    halves, plans = [], []
    for r in range(PARALLEL_WORLD):
        rows = slice(r * half, (r + 1) * half)
        plan, lab, nl = plan_augment_batch(labels[rows], DDP_IMG, hyp, rng, cap)
        plan = dict(plan, src_idx=plan["src_idx"] + r * half, mix_idx=plan["mix_idx"] + r * half)
        plans.append(plan)
        mask = (np.arange(cap)[None] < nl[:, None]).astype(np.float32)
        halves.append((lab, mask))
    whole_plan = {k: np.concatenate([p[k] for p in plans]) for k in plans[0]}
    lab = np.concatenate([h[0] for h in halves])
    mask = np.concatenate([h[1] for h in halves])
    whole = Batch(None, blocks, lab[..., 0], lab[..., 1:5], mask, AugPlan(**whole_plan))

    def rank_rows(r):
        rows = slice(r * half, (r + 1) * half)
        plan = dict(plans[r], src_idx=plans[r]["src_idx"] - r * half,
                    mix_idx=plans[r]["mix_idx"] - r * half)
        ev = blocks
        part = type(ev)(*(getattr(ev, f.name)[rows] for f in dataclasses.fields(ev)))
        return Batch(None, part, lab[rows, :, 0], lab[rows, :, 1:5], mask[rows], AugPlan(**plan))

    return whole, [rank_rows(r) for r in range(PARALLEL_WORLD)]


def _small_state(dev, seed: int = 4):
    """The shrunk detector with random pred convs (so that gradients reach
    every layer) and its optimizer past the warmup and its EMA; the
    optimizer's gradients recorded as it sees them."""
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.parallel.train_step import TrainState
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.optim import build_optimizer
    from event_representation_study_tpu_torch.utils.config import load_config

    small = load_config("configs/gen1_optimized.py", overrides=SMALL)
    model = build_model(small, 2, device="cpu", generator=torch.Generator().manual_seed(seed))
    randomize_preds_(model, torch.Generator().manual_seed(seed + 2))
    model = model.to(dev)
    opt = build_optimizer(model, solver_config(small))
    opt.count = 1500  # past the warmup: every group has a learning rate
    seen = {}
    real = opt.update

    def spy(grads):
        seen.clear()
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        real(grads)

    opt.update = spy
    return TrainState(model, opt, ema_init(model), 0), seen, small


def _step_record(state, seen, parts, p0):
    return {"parts": {k: v.item() for k, v in parts.items()},
            "grads": {n: g.cpu() for n, g in seen.items()},
            "delta": {n: (p.detach() - p0[n]).cpu() for n, p in state.model.named_parameters()},
            "bn": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()
                   if "running" in k}}


def _state_digest(state) -> str:
    import hashlib

    flat = torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in state.model.state_dict().values() if t.is_floating_point()])
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


def _timed_steps(step, state, batch, epoch: int, n: int = 3) -> list:
    """Host ms of ``n`` more steps on ``batch``, each synchronised (the
    checked step before them was the process's first)."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        state, parts = step(state, batch, epoch)
        parts["loss"].item()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def _ddp_part(rank: int, world: int, dev) -> dict:
    """One data-parallel step of the shrunk detector at DDP_IMG on this
    rank's half of the batch (global BatchNorm, summed gradients) and, on
    rank 0, the one-process step on the whole batch from the same weights."""
    import torch.distributed as dist

    from event_representation_study_tpu_torch.parallel.train_step import make_train_step

    whole, halves = _ddp_batches()
    kw = dict(representation="OptimizedRepresentation", rep_hw=(H, W), img_size=DDP_IMG,
              warp_impl="separable", device=dev)
    out = {}
    if rank == 0:
        ref, seen, small = _small_state(dev)
        p0 = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
        ref, parts = make_train_step(loss_config(small), **kw)(ref, whole, 0)
        out["reference"] = _step_record(ref, seen, parts, p0)
        del ref
    state, seen, small = _small_state(dev)
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step = make_train_step(loss_config(small), group=dist.group.WORLD, **kw)
    (state, parts), launches = _counted(lambda: step(state, halves[rank], 0))
    out["launches"] = launches
    out["group"] = _step_record(state, seen, parts, p0)
    out["digest"] = _state_digest(state)
    out["ms"] = _timed_steps(step, state, halves[rank], 0)
    out["rank_positives"] = float(np.asarray(halves[rank].gt_mask).sum())
    return out


def _tp_part(rank: int, world: int, dev) -> dict:
    """One step of the shrunk detector at DDP_IMG with its convolutions
    sharded by output channel over a "model" axis of 2 (the whole batch
    on both ranks), against the same step replicated."""
    from event_representation_study_tpu_torch.parallel.mesh import make_mesh
    from event_representation_study_tpu_torch.parallel.tensor_parallel import (
        count_tp_sharded, shard_state_tp)
    from event_representation_study_tpu_torch.parallel.train_step import make_train_step

    mesh = make_mesh(axis_names=("data", "model"), shape=(1, world), device=dev)
    whole, _ = _ddp_batches()
    kw = dict(representation="OptimizedRepresentation", rep_hw=(H, W), img_size=DDP_IMG,
              warp_impl="separable", device=dev)
    epoch = 5  # TAL
    ref, _, small = _small_state(dev)
    p0 = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    first = next(iter(p0))
    ref, ref_parts = make_train_step(loss_config(small), **kw)(ref, whole, epoch)
    state, _, _ = _small_state(dev)
    state = shard_state_tp(state, mesh)
    counts = {"params": count_tp_sharded(state.model), "momentum": count_tp_sharded(state.opt_state),
              "ema": count_tp_sharded(state.ema.variables)}
    step = make_train_step(loss_config(small), group=mesh.group("data"), **kw)
    (state, parts), launches = _counted(lambda: step(state, whole, epoch))
    # each leaf's update: this rank's rows of a sharded one, all of another
    deltas, ref_deltas = {}, {}
    for n, p in state.model.named_parameters():
        k = p.shape[0]
        rows = slice(rank * k, (rank + 1) * k) if getattr(p, "tp_axis", None) else slice(None)
        deltas[n] = (p.detach() - p0[n][rows]).cpu()
        ref_deltas[n] = (ref.model.get_parameter(n).detach()[rows] - p0[n][rows]).cpu()
    w0 = p0[first]
    ms = _timed_steps(step, state, whole, epoch)
    return {"counts": counts, "counts_after": {"params": count_tp_sharded(state.model),
                                               "momentum": count_tp_sharded(state.opt_state)},
            "loss": parts["loss"].item(), "ref_loss": ref_parts["loss"].item(),
            "first_leaf": first, "first_leaf_sharded": deltas[first].shape[0] < w0.shape[0],
            "first_leaf_abs_err": (deltas[first] - ref_deltas[first]).abs().max().item(),
            # the stem's update over its weights' scale: weight decay alone gives ~1e-6
            "first_leaf_update_rel": (ref_deltas[first].abs().max() / w0.abs().max()).item(),
            "updates_leaf_scale": leaf_error(deltas, ref_deltas),
            "ms": ms, "launches": launches}


def _tree(fn, x):
    """``fn`` over every tensor or array leaf of nested dicts, lists and
    tuples."""
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x) if isinstance(x, (torch.Tensor, np.ndarray)) else x


def parallel_worker(rank: int, world: int, port: int, queue, device: str = "cuda") -> None:
    """One gloo rank on the card (``cuda:0``, shared): the event-shard, the
    data-parallel and the tensor-parallel parts; puts (rank, results) or
    (rank, the traceback)."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from event_representation_study_tpu_torch.parallel.dist import init_distributed

        init_distributed(f"127.0.0.1:{port}", world, rank, device=device, backend="gloo",
                         timeout=datetime.timedelta(seconds=300))
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device(device))
        out = {}
        for name, part in (("event_shard", _event_shard_part), ("ddp", _ddp_part),
                           ("tp", _tp_part)):
            t = time.perf_counter()
            out[name] = part(rank, world, dev)
            out[name]["part_s"] = time.perf_counter() - t
        # host arrays: a tensor would travel as a handle to this process's memory
        queue.put((rank, _tree(lambda a: a.detach().cpu().numpy(), out)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def parallel_phases(dev):
    """``parallel_event_shard``, ``parallel_ddp`` and ``parallel_tp``: 2
    gloo processes sharing the card, spawned once, each part checked here.
    Returns {phase: {kernel: launches summed over the ranks}} of the
    sharded calls and of the group steps (not of their references)."""
    import multiprocessing
    import queue as queue_mod

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=parallel_worker, args=(r, PARALLEL_WORLD, port, q, dev.type))
             for r in range(PARALLEL_WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:  # drain before joining
            rank, res = q.get(timeout=600)
            results[rank] = res
    except queue_mod.Empty:
        raise AssertionError(f"the parallel ranks gave {len(results)} results in 600 s") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall_s = time.perf_counter() - t0
    for rank, res in results.items():
        require(isinstance(res, dict), f"parallel rank {rank} failed:\n{res}")
    ranks = [results[r] for r in range(PARALLEL_WORLD)]

    def total(part):
        return {k: sum(r[part]["launches"][k] for r in ranks) for k in ("K1", "K2", "K3")}

    # event-axis sharding: every representation against the unsharded card result
    shard = {name: [r["event_shard"][name] for r in ranks] for name in ranks[0]["event_shard"]
             if isinstance(ranks[0]["event_shard"][name], dict)}
    want_launches = {"ergo12": ("K1", 1), "time_surface": ("K1", 1), "mdes_sum_only": ("K2", 1),
                     "histogram": ("K2", 1), "voxel_grid": ("K2", 1), "tore": (None, 0)}
    say("parallel_event_shard", ranks=PARALLEL_WORLD, backend="gloo", device="cuda:0 shared",
        local_block=ranks[0]["event_shard"]["local_events"], batch=B, events_per_window=N,
        reps={name: {"shape": v[0]["shape"], "errors": [x["errors"] for x in v],
                     "launches": [x["launches"] for x in v], "ms": [x["ms"] for x in v]}
              for name, v in shard.items()},
        part_s=[r["event_shard"]["part_s"] for r in ranks], tolerance=EVENT_SHARD_TOLERANCE)
    for name, v in shard.items():
        kernel, n = want_launches[name]
        for rank, x in enumerate(v):
            require(x["ok"] and x["finite"], f"{name} rank {rank}: {x['errors']}")
            want = {k: (n if k == kernel else 0) for k in ("K1", "K2", "K3")}
            require(x["launches"] == want, f"{name} rank {rank}: launches {x['launches']}")

    # the data-parallel step against the one-process step on the whole batch
    ref, got = (_tree(torch.from_numpy, ranks[0]["ddp"][k]) for k in ("reference", "group"))
    errs = step_errors(got, ref)
    bn_err = max((got["bn"][k] - ref["bn"][k]).abs().max().item()
                 / max(1.0, ref["bn"][k].abs().max().item()) for k in ref["bn"])
    say("parallel_ddp", ranks=PARALLEL_WORLD, img=DDP_IMG, batch=DDP_B,
        positives_per_rank=[r["ddp"]["rank_positives"] for r in ranks],
        parts_group=got["parts"], parts_reference=ref["parts"],
        errors={"loss_rel": errs["loss_rel"], "grads": errs["grads"], "updates": errs["updates"],
                "bn_stats_rel": bn_err},
        ranks_bit_equal=len({r["ddp"]["digest"] for r in ranks}) == 1,
        step_ms=[r["ddp"]["ms"] for r in ranks],
        step_ms_median=statistics.median(ms for r in ranks for ms in r["ddp"]["ms"]),
        launches=[r["ddp"]["launches"] for r in ranks],
        part_s=[r["ddp"]["part_s"] for r in ranks],
        tolerance="loss 1e-4 relative; gradients and updates 2e-2 of leaf scale; BN running "
                  "statistics 1e-5 of max(1, the leaf's largest); positive anchors equal; "
                  "ranks bit-equal")
    require(ranks[1]["ddp"]["rank_positives"] == 0 < ranks[0]["ddp"]["rank_positives"],
            "rank 1 must hold no box")
    require(got["parts"]["num_pos"] == ref["parts"]["num_pos"] > 0,
            f"positive anchors {got['parts']['num_pos']} vs {ref['parts']['num_pos']}")
    require(errs["loss_rel"] <= 1e-4 and errs["grads"][0] <= 2e-2 and errs["updates"][0] <= 2e-2
            and bn_err <= 1e-5, f"data-parallel step vs the whole batch's: {errs}, BN {bn_err}")
    require(len({r["ddp"]["digest"] for r in ranks}) == 1, "the ranks' states differ")
    require(all(r["ddp"]["launches"] == {"K1": 1, "K2": 0, "K3": 2} for r in ranks),
            f"data-parallel step launches {[r['ddp']['launches'] for r in ranks]}")

    # tensor parallelism against the replicated step
    tp = [r["tp"] for r in ranks]
    say("parallel_tp", ranks=PARALLEL_WORLD, img=DDP_IMG, batch=DDP_B,
        **{k: [x[k] for x in tp] for k in ("counts", "counts_after", "loss", "ref_loss",
                                            "first_leaf_abs_err", "first_leaf_update_rel",
                                            "updates_leaf_scale", "ms", "launches", "part_s")},
        first_leaf=tp[0]["first_leaf"], parallel_wall_s=wall_s,
        step_ms_median=statistics.median(ms for x in tp for ms in x["ms"]),
        regime="random pred convs (gradients reach every layer), the optimizer past its "
               "warmup, epoch 5 (TAL)",
        tolerance="loss 2e-4 relative; every leaf's update 2e-2 of leaf scale; the first "
                  "leaf (the stem) sharded and its update over 1e-3 of its weights' scale")
    for rank, x in enumerate(tp):
        require(min(x["counts"].values()) > 10 and x["counts_after"]["params"] > 10
                and x["counts_after"]["momentum"] > 10, f"tp rank {rank}: counts {x['counts']}")
        require(abs(x["loss"] - x["ref_loss"]) <= 2e-4 * abs(x["ref_loss"]),
                f"tp rank {rank}: loss {x['loss']} vs {x['ref_loss']}")
        require(x["first_leaf_sharded"] and x["first_leaf_update_rel"] > 1e-3
                and x["updates_leaf_scale"][0] <= 2e-2,
                f"tp rank {rank}: first leaf update {x['first_leaf_update_rel']} of its scale, "
                f"updates {x['updates_leaf_scale']}")
        require(x["launches"] == {"K1": 1, "K2": 0, "K3": 2}, f"tp rank {rank}: {x['launches']}")
    return {"parallel_event_shard": {k: sum(x["launches"][k] for v in shard.values() for x in v)
                                     for k in ("K1", "K2", "K3")},
            "parallel_ddp": total("ddp"), "parallel_tp": total("tp")}


def env_phase():
    """Which optional packages import on this machine (a report only: no
    phase depends on it)."""
    import importlib

    found = {}
    for name in ("cv2", "matplotlib", "tensorboard", "wandb"):
        try:
            found[name] = str(getattr(importlib.import_module(name), "__version__", "unknown"))
        except Exception:  # absent, or present and broken: not importable either way
            found[name] = None
    say("env", **found, python=sys.version.split()[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.ops import cuda_build
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops.nms import non_max_suppression
    from event_representation_study_tpu_torch.reps import fused_mdes
    from event_representation_study_tpu_torch.reps.ergo12 import (
        AGGREGATIONS, FUNCTIONS, WINDOW_INDEXES)
    from event_representation_study_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    env_phase()
    say("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    report = cuda_build.build_all()
    say("build", seconds=time.perf_counter() - t0, sources=list(cuda_build.SOURCES),
        compile_s={name: r[0] for name, r in report.items()},
        ptxas={name: [ln for ln in r[1].splitlines() if "ptxas info" in ln]
               for name, r in report.items()})

    # 3. ERGO-12 on the card (K1) vs the plain version on the CPU
    blocks = fake_batch(0)
    plan = fused_mdes._plan(WINDOW_INDEXES, FUNCTIONS, AGGREGATIONS)
    rep_gpu, glue_args, k1_args = capture_kernel_inputs(
        lambda: fused_mdes.ergo12_fused_batched(blocks.to(dev), H, W))
    rep_cpu = fused_mdes.ergo12_fused_batched(blocks, H, W)
    rep_err = (rep_gpu.cpu() - rep_cpu).abs().max().item()
    require(rep_gpu.shape == (B, H, W, 12) and bool(torch.isfinite(rep_gpu).all()),
            "ERGO-12 on the card: shape or finiteness")
    require(rep_err <= 2e-4, f"ERGO-12 card vs CPU plain: {rep_err}")
    glue_ms = cuda_ms(lambda: fs.sort_columns(*glue_args))
    say("ergo12", shape=list(rep_gpu.shape), max_abs_err_vs_cpu_plain=rep_err,
        tolerance=2e-4, glue_sort_gather_columns_ms=glue_ms,
        e2e_ms=cuda_ms(lambda: fused_mdes.ergo12_fused_batched(blocks.to(dev), H, W), iters=10),
        tf32=tf32_state())

    # 4. the kernels at the serving path's shapes
    flush = torch.empty(256 * 2**20 // 4, device=dev)  # 256 MB > 50 MB L2
    cnt_cols = [i for i, c in enumerate(plan[0]) if c[0] == "cnt"]
    k1 = check_kernel("kernel_K1", k1_args, cnt_cols, flush)
    sum_only = [(w, f, a) for w, f, a in zip(WINDOW_INDEXES, FUNCTIONS, AGGREGATIONS)
                if a != "max"]
    sum_table = tuple(tuple(c) for c in zip(*sum_only))
    _, _, k2_args = capture_kernel_inputs(
        lambda: fused_mdes.mdes_fused_batched(blocks.to(dev), H, W, *sum_table))
    plan2 = fused_mdes._plan(*sum_table)
    k2 = check_kernel("kernel_K2", k2_args, [i for i, c in enumerate(plan2[0]) if c[0] == "cnt"],
                      flush)
    check_hard_shapes(dev, flush)
    del flush
    k4 = check_k4(dev)

    # 5. serve through the full-width paper detector
    cfg = load_config("configs/gen1_optimized.py")
    t0 = time.perf_counter()
    serve = make_server(cfg, "OptimizedRepresentation", H, W, IMG, 0.03, device="cuda")
    randomize_preds_(serve.model, torch.Generator(device=dev).manual_seed(1))
    n_params = sum(p.numel() for p in serve.model.parameters())
    build_s = time.perf_counter() - t0
    requests = [fake_batch(100 + 10 * r) for r in range(REQUESTS + 1)]
    serve(requests[-1])  # warm-up: cuDNN algorithm choice, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, counts = [], []
    fs.reset_launches()
    for blk in requests[:REQUESTS]:
        t = time.perf_counter()
        dets, n = serve(blk)
        counts.append(n.tolist())  # host copy: waits for the device
        times.append((time.perf_counter() - t) * 1e3)
    launches = dict(fs.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    say("serve", requests=REQUESTS, batch=B, events_per_window=N, img=IMG,
        params=n_params, build_s=build_s, ms_per_request=times,
        median_ms=statistics.median(times), peak_mem_bytes=peak,
        detections_per_image=counts, launches=launches, tf32=tf32_state())
    require(launches[fs.K1] == REQUESTS, f"K1 launches {launches} for {REQUESTS} requests")
    require(dets.shape == (B, 300, 6) and bool(torch.isfinite(dets).all()), "detections")
    require(all(0 < c <= 300 for cs in counts for c in cs), f"detection counts {counts}")
    stages, preds = serve_stages(serve, requests[0], dev)
    say("serve_stages_ms", tf32=tf32_state(), **stages)
    torch.backends.cudnn.allow_tf32 = True
    tf32_times = []
    for blk in requests[:REQUESTS]:
        t = time.perf_counter()
        serve(blk)[1].tolist()
        tf32_times.append((time.perf_counter() - t) * 1e3)
    torch.backends.cudnn.allow_tf32 = False
    say("serve_tf32", ms_per_request=tf32_times, median_ms=statistics.median(tf32_times),
        tf32={"cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": False})
    del serve

    fs.reset_launches()
    out = fused_mdes.mdes_fused_batched(requests[0].to(dev), H, W, *sum_table)
    torch.cuda.synchronize()
    launches_sum_only = dict(fs.LAUNCHES)
    require(launches_sum_only[fs.K2] == 1 and bool(torch.isfinite(out).all()),
            f"sum-only MDES path launches {launches_sum_only}")
    say("mdes_sum_only", channels=len(sum_only), launches=launches_sum_only)

    # 6. a shrunk detector, and NMS, on the card vs the same on the CPU
    small = load_config("configs/gen1_optimized.py",
                        overrides=["model.depth_multiple=0.2", "model.width_multiple=0.125"])
    ref_blocks = fake_batch(7, n_windows=2, n_events=5000)
    servers = {d: make_server(small, "OptimizedRepresentation", H, W, 320, 0.03, device=d)
               for d in ("cpu", "cuda")}
    randomize_preds_(servers["cpu"].model, torch.Generator().manual_seed(2))
    servers["cuda"].model.load_state_dict(servers["cpu"].model.state_dict())
    (r_g, p_g), (r_c, p_c) = ([a.cpu() for a in servers[d].run(ref_blocks)[:2]]
                              for d in ("cuda", "cpu"))
    # NMS box for box at the serve shape, on tie-free scores (uniform input
    # regions tie scores exactly, and no framework promises an order of ties)
    nms_in = tie_free_predictions(B, preds.shape[1], 2, seed=3)
    d_c, n_c = non_max_suppression(nms_in, conf_thres=0.03)
    d_g, n_g = (a.cpu() for a in non_max_suppression(nms_in.to(dev), conf_thres=0.03))
    errs = {
        "rep": (r_g - r_c).abs().max().item(),
        "boxes": (p_g[..., :4] - p_c[..., :4]).abs().max().item(),
        "scores": (p_g[..., 4:] - p_c[..., 4:]).abs().max().item(),
        "nms_dets": (d_g - d_c).abs().max().item(),
    }
    say("reference", max_abs_err=errs, nms_detections_card=n_g.tolist(),
        nms_detections_cpu=n_c.tolist(),
        tolerance="rep 0.06 (x255), boxes 1e-2 px, scores 1e-4; NMS counts equal, dets 1e-5",
        tf32=tf32_state())
    require(errs["rep"] <= 0.06 and errs["boxes"] <= 1e-2 and errs["scores"] <= 1e-4,
            f"card vs CPU reference: {errs}")
    require(torch.equal(n_g, n_c) and errs["nms_dets"] <= 1e-5 and int(n_c.min()) > 0,
            f"NMS card vs CPU: {errs}, counts {n_g.tolist()} vs {n_c.tolist()}")

    # 7-10. training
    train_launches, k3_args = train_phase(dev)
    k3 = check_k3(k3_args)
    train_rolls = roll_key(k3_args)
    del k3_args
    warp_phase(dev)
    train_reference(dev)
    # K steps a call (both EMA cadences) and the bf16 step through K3's bf16
    # instantiation
    f32_state, ms_batches, f32_loss, multi_launches = multi_step_phase(dev)
    bf16_launches, k3_bf16_args = bf16_train_phase(dev, f32_state, ms_batches, f32_loss)
    del f32_state, ms_batches
    k3_bf16 = check_k3(k3_bf16_args, "kernel_K3_bf16")
    del k3_bf16_args
    bf16_reference(dev)
    # 11-12. event-space augmentation, and training through the CLIs
    mosaic_launches = event_mosaic_phase(dev)
    trainer_launches = trainer_phase(dev)
    multi_trainer_k1 = multi_step_trainer_phase(dev)
    # 13-14. the representation library and the GWD ranking
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    rep_launches, rep_kernels = representations_phase(dev, flush)
    del flush
    gwd_launches = gwd_phase(dev)
    # 15. the channel search
    search_launches = search_phase(dev)
    # 16-19. published-format Gen1 files, and Mini N-ImageNet classification
    published_launches = gen1_published_format_phase(dev)
    classify_launches, cls_blocks = classify_phase(dev)
    classify_reference(dev)
    from event_representation_study_tpu_torch.reps.dispatch import batched_representation

    _, _, k1_cls_args = capture_kernel_inputs(
        lambda: batched_representation("OptimizedRepresentation", 224, 224)(cls_blocks))
    del cls_blocks
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    k1_cls = check_kernel("kernel_K1_nimagenet", k1_cls_args, cnt_cols, flush)
    del flush, k1_cls_args
    # 20-22. the detector zoo, bf16 evaluation, the shrunk families card vs CPU
    zoo_k1, zoo_rolls, zoo_k4 = zoo_phase(dev, {train_rolls})
    half_k1 = zoo_half_phase(dev)
    zoo_reference(dev)
    # 23-24. the training variants and deploy tools; their shrunk steps card vs CPU
    variant_k1, variant_k3 = variants_phase(dev)
    variants_reference(dev)
    # 25. the 1 Mpx (Gen4) path: release files to training, serving and baking
    gen4_k1, gen4_k3, k1_gen4 = gen4_phase(dev, cnt_cols)
    # 26. original-image data: the image-folder step (K3 on RGB tiles), the
    # Trainer, the pixel demo, --save-img (K1), torch_convert, the plots
    k3_img_args, img_launches = images_phase(dev)
    k3_img = check_k3(k3_img_args, "kernel_K3_images")
    del k3_img_args
    # 27-30. the parallel layer: the Trainer through NCCL as a world of one,
    # then 2 gloo ranks sharing the card (event sharding, data and tensor
    # parallel steps)
    ddp_k1, ddp_k3 = trainer_ddp_phase(dev)
    par = parallel_phases(dev)

    rep_k1, rep_k2 = (sum(c[k] for c in rep_launches.values()) for k in (fs.K1, fs.K2))
    k1["launches_by_path"] = {"serve": launches[fs.K1], "train": train_launches[fs.K1],
                              "event_mosaic": mosaic_launches, "trainer": trainer_launches,
                              "representations": rep_k1, "gwd": gwd_launches[fs.K1],
                              "search": search_launches[fs.K1],
                              "gen1_published_format": published_launches,
                              "classify": classify_launches, "zoo": zoo_k1,
                              "zoo_half": half_k1, **variant_k1, "gen4": gen4_k1,
                              "multi_step": sum(n.get(fs.K1, 0) for n in multi_launches.values()),
                              "multi_step_trainer": multi_trainer_k1,
                              "bf16_train": bf16_launches[fs.K1],
                              "images_save_img": img_launches["save_img_k1"],
                              "images_torch_convert": img_launches["convert_k1"],
                              "images_plots": img_launches["plots_k1"],
                              "trainer_ddp": ddp_k1,
                              **{name: n["K1"] for name, n in par.items()}}
    k2["launches_by_path"] = {"mdes_sum_only": launches_sum_only[fs.K2],
                              "representations": rep_k2, "gwd": gwd_launches[fs.K2],
                              "search": search_launches[fs.K2],
                              "parallel_event_shard": par["parallel_event_shard"]["K2"]}
    for entry in (k1, k2):
        entry["launches"] = sum(entry["launches_by_path"].values())
    # the main figures stay those of the serve shape; the new shapes beside them
    for entry, shapes in ((k1, {"event_stack": "EventStack", "time_surface": "TimeSurface"}),
                          (k2, {"histogram": "EventHistogram", "voxel_grid": "VoxelGrid"})):
        entry["by_shape"] = {"ergo12_serve" if entry is k1 else "mdes_sum_only": {
            k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}}
        for label, name in shapes.items():
            entry["by_shape"][label] = {
                **{k: rep_kernels[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms", "max_abs_err",
                                                     "share_of_representation")},
                "launches": rep_launches[name][entry["name"]]}
        if entry is k1:
            for label, e, n in (("nimagenet", k1_cls, classify_launches),
                                ("gen4_1mpx", k1_gen4, gen4_k1)):
                entry["by_shape"][label] = {
                    **{k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                         "max_abs_err")}, "launches": n}
        entry["max_abs_err"] = max(v["max_abs_err"] for v in entry["by_shape"].values())
    multi_k3 = sum(n.get("roll_rows", 0) for n in multi_launches.values())
    k3["launches_by_path"] = {"train": train_launches["roll_rows"],
                              "zoo": sum(r["launches"] for r in zoo_rolls.values()),
                              **variant_k3, "gen4": gen4_k3, "multi_step": multi_k3,
                              "bf16_train": bf16_launches["roll_rows"],
                              "images": img_launches["step"] + img_launches["trainer"],
                              "trainer_ddp": ddp_k3, "parallel_ddp": par["parallel_ddp"]["K3"],
                              "parallel_tp": par["parallel_tp"]["K3"]}
    k3["launches"] = sum(k3["launches_by_path"].values())
    # the main figures stay those of the paper step (640²); each other shape
    # of the zoo's steps beside them, held in zoo_phase
    k3["by_shape"] = {"train_640": {
        **{k: k3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "max_abs_err")},
        "launches": train_launches["roll_rows"] + multi_k3 + ddp_k3 + zoo_rolls.get(
            train_rolls, {}).get("launches", 0)},
        # the bf16 step's rolls: the same shapes, 2-byte elements
        "train_640_bf16": {
            **{k: k3_bf16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err", "per_launch")},
            "launches": bf16_launches["roll_rows"]},
        # the image-folder step's rolls: RGB tiles, 12-byte pixels
        "images_640_rgb": {
            **{k: k3_img[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "max_abs_err", "per_launch")},
            "launches": img_launches["step"] + img_launches["trainer"]}}
    for r in zoo_rolls.values():
        if r["check"] is not None:
            k3["by_shape"][f"{r['config']}_{r['img']}"] = {
                **{k: r["check"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms", "max_abs_err", "per_launch")},
                "launches": r["launches"]}
    k3["max_abs_err"] = max(v["max_abs_err"] for v in k3["by_shape"].values())
    k4["launches_by_path"] = {"zoo": zoo_k4}
    k4["launches"] = sum(zoo_k4.values())
    print(json.dumps({"kernels": [k1, k2, k3, k4]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
