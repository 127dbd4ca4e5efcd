#!/usr/bin/env python3
"""Drive the PyTorch port (``event_representation_study_tpu_torch``) on one
CUDA card and check it.

Phases, one printed line each:
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
   S, the widest and narrowest column counts, B=1, the event mosaic's
   200,000-event rows), exactly equal to the plain version, with their times.
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
Then the ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: exit code non-zero
and no result line.

    python3 chip_smoke.py
"""
from __future__ import annotations

import copy
import json
import math
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

    # library yardstick: index_add_ + scatter_reduce_ into preallocated outputs
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

    ms = cuda_ms(lambda: fs.segment_reduce_sorted(*kernel_args), flush=flush)
    ms_warm = cuda_ms(lambda: fs.segment_reduce_sorted(*kernel_args))
    plain_ms = cuda_ms(lambda: fs.segment_reduce_sorted_plain(*kernel_args), flush=flush)
    library_ms = cuda_ms(library, flush=flush)
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
    "ks32_km8": (2, N, S, 32, 8, "uniform"),
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
    equal: the values make every sum exact) and on the CPU; their times."""
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
        row0 = args[0][-1]
        cases[name] = {"shape": {"B": bsz, "N": n, "S": s, "Ks": ks, "Km": km}, "layout": layout,
                       "events_in_densest_pixel": int(torch.unique_consecutive(
                           row0[row0 < s], return_counts=True)[1].max()),
                       **checks, "ms": ms, "bound_ms": segment_reduce_bound(args[0], ks, km, s)[0]}
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


def capture_roll_inputs(fn):
    """Run ``fn`` and return its result with the arguments it passed to the
    per-row roll (K3's wrapper), one tuple per call."""
    from event_representation_study_tpu_torch.ops import warp

    seen = []
    real = warp.roll_rows

    def roll_rows(*args):
        seen.append(args)
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


def train_setup(dev, n_batches: int):
    """The full-width detector, its train state and step (separable warp),
    and ``n_batches`` batches of B windows with the paper's strong
    augmentation planned for each. Returns (state, step, batches, info)."""
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops.warp import separable_hyp_eligible
    from event_representation_study_tpu_torch.parallel.train_step import (
        init_train_state, make_train_step)
    from event_representation_study_tpu_torch.train.optim import (
        accumulation_steps, build_optimizer, with_accumulation)
    from event_representation_study_tpu_torch.utils.config import load_config

    cfg = load_config("configs/gen1_optimized.py")
    hyp = dict(cfg["data_aug"])
    require(separable_hyp_eligible(hyp, IMG), "the paper recipe must fit the separable warp")
    t0 = time.perf_counter()
    model = build_model(cfg, 2, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
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
    step = make_train_step(loss_config(cfg), "OptimizedRepresentation", (H, W), IMG,
                           warp_impl="separable", device=dev)
    info = {"build_s": time.perf_counter() - t0, "accumulate": k_acc,
            "params": sum(p.numel() for p in model.parameters())}
    rng = np.random.default_rng(0)
    batches = [make_batch(fake_batch(1000 + 10 * i), fake_labels(rng), hyp, rng)
               for i in range(n_batches)]
    return state, step, batches, info


def train_phase(dev):
    """The full-width train step; returns (launches of the timed steps,
    the K3 arguments captured in the warm-up step)."""
    from event_representation_study_tpu_torch.ops import fused_scatter as fs
    from event_representation_study_tpu_torch.ops import roll
    from event_representation_study_tpu_torch.ops.image import letterbox_image
    from event_representation_study_tpu_torch.parallel.train_step import batch_on_device
    from event_representation_study_tpu_torch.reps.event_mosaic import mosaic_event_rep

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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.reset_launches()
    roll.reset_launches()
    times, per_step, i = [], [], 1
    for epoch, count in TRAIN_STEPS.items():
        for _ in range(count):
            t = time.perf_counter()
            state, parts = step(state, batches[i], epoch)
            vals = {k: v.item() for k, v in parts.items()}  # host copy: waits
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            per_step.append(dict(epoch=epoch, **vals))
            i += 1
    launches = {**fs.LAUNCHES, **roll.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
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

    # where a step's device time goes: its stages replayed one by one;
    # event_mosaic is the other executor of the same plan (aug_mode="event"),
    # which replaces ergo12 + letterbox + warp
    stages = {k: [] for k in ("ergo12", "letterbox", "warp", "forward_loss", "backward",
                              "optimizer_ema", "event_mosaic")}
    for j in range(3):
        batch = batch_on_device(batches[j], dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        rep = step.rep_fn(batch.events)
        ev[1].record()
        img = letterbox_image(rep, IMG)
        ev[2].record()
        imgs = (step.warp(img, batch.aug, IMG) / 255.0).permute(0, 3, 1, 2)
        ev[3].record()
        model.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(model, imgs, batch, 5)
        ev[4].record()
        loss.backward()
        ev[5].record()
        step.apply_update(state)
        ev[6].record()
        mosaic_event_rep(batch.events, batch.aug, "OptimizedRepresentation", (H, W), IMG)
        ev[7].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(stages, zip(ev, ev[1:])):
            stages[k].append(a.elapsed_time(b))
    say("train_stages_ms", epoch=5, tf32=tf32_state(),
        **{k: statistics.median(v) for k, v in stages.items()},
        all_runs=stages)
    del state, model, step, batches
    torch.cuda.empty_cache()
    return launches, k3_args


def check_k3(k3_args):
    """K3 against its plain version at the train step's pass V and pass H
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
    # 4 B (f32 C=5), 2 B (bf16 C=5)
    for dtype in (torch.float32, torch.bfloat16):
        for c in (12, 5):
            xs = torch.randn((2, 37, 101, c), generator=gen, device=dev).to(dtype)
            ss = torch.randint(-9, 80, (2, 37), generator=gen, device=dev, dtype=torch.int32)
            checks[f"width.{dtype}.C{c}"] = torch.equal(roll.roll_rows(xs, ss, 40),
                                                        roll.roll_rows_plain(xs, ss, 40))
    del flush
    say("kernel_K3", passes=passes, **checks, max_abs_err=max(errs),
        tolerance="exact (data movement)",
        library="torch.gather along W into a preallocated output, index precomputed")
    require(all(checks.values()), f"K3 disagrees with its plain version: {checks}")
    total = {k: sum(p[k] for p in passes.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": roll.K3, "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
            "max_abs_err": max(errs), "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": "bytes",
            "library_ms": total["library_ms"], "per_launch": passes}


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


def train_reference(dev):
    """One train step of a shrunk detector at 128 px, batch 4, mosaic and
    mixup at 1.0, on the card and on the CPU from the same weights."""
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.parallel.train_step import (
        TrainState, make_train_step)
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.optim import build_optimizer
    from event_representation_study_tpu_torch.utils.config import load_config

    small = load_config("configs/gen1_optimized.py",
                        overrides=["model.depth_multiple=0.2", "model.width_multiple=0.125"])
    hyp = dict(small["data_aug"], mosaic=1.0, mixup=1.0)
    img = 128
    rng = np.random.default_rng(8)
    batch = make_batch(fake_batch(9, n_windows=4, n_events=5000), fake_labels(rng, 4, img), hyp,
                       rng, img)
    base = build_model(small, 2, device="cpu", generator=torch.Generator().manual_seed(4))
    randomize_preds_(base, torch.Generator().manual_seed(6))
    out = {}
    for d in ("cpu", dev):
        model = copy.deepcopy(base).to(d)
        opt = build_optimizer(model, solver_config(small))
        opt.count = 1500  # past the warmup: every group has a learning rate
        state = TrainState(model, opt, ema_init(model), 0)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_train_step(loss_config(small), "OptimizedRepresentation", (H, W), img,
                               warp_impl="separable", device=d)
        state, parts = step(state, batch, 0)
        out[d] = {
            "parts": {k: v.item() for k, v in parts.items()},
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "delta": {n: (p.detach() - p0[n]).cpu() for n, p in model.named_parameters()},
            "bn": {k: v.cpu() for k, v in model.state_dict().items() if "running" in k},
        }

    def leafwise(key):
        """Largest card-CPU difference of a leaf over its largest CPU entry
        plus 1e-3 of the largest over all leaves."""
        got, want = out[dev][key], out["cpu"][key]
        top = max(v.abs().max().item() for v in want.values())
        return max(((got[k] - want[k]).abs().max() / (want[k].abs().max() + 1e-3 * top)).item()
                   for k in want)

    c, g = out["cpu"]["parts"], out[dev]["parts"]
    errs = {"loss_rel": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
            "grads": leafwise("grads"), "updates": leafwise("delta"), "bn_stats": leafwise("bn")}
    say("train_reference", parts_card=g, parts_cpu=c, errors=errs,
        tolerance="loss 1e-4 relative; gradients and parameter updates 2e-2, BN statistics "
                  "2e-3, of each leaf's largest CPU entry plus 1e-3 of the largest over all "
                  "leaves; positive anchors equal", tf32=tf32_state())
    require(g["num_pos"] == c["num_pos"] > 0, f"positive anchors {g['num_pos']} vs {c['num_pos']}")
    require(errs["loss_rel"] <= 1e-4 and errs["grads"] <= 2e-2 and errs["updates"] <= 2e-2
            and errs["bn_stats"] <= 2e-3, f"train step card vs CPU: {errs}")


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


def _trainer_fixture(root):
    """Synthetic Gen1 splits from the port's writer: training 2 recordings x
    16 boxes, validation 1 x 16, 200,000 events a recording; Blosc-ZSTD
    chunks when this process can encode them (a Blosc codec, and h5py: the
    HDF5 subset used without h5py, ``events/h5lite.py``, has no chunks).
    Returns (what wrote it, seconds)."""
    from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
    from event_representation_study_tpu_torch.events import blosc_codec, h5lite

    hdf5 = "h5lite" if blosc_codec.h5py is h5lite else "h5py"
    blosc = blosc_codec.available() and hdf5 == "h5py"
    t0 = time.perf_counter()
    for split, files, seed in (("training.h5", 2, 1), ("validation.h5", 1, 2)):
        write_gen1_fixture(root / split, num_files=files, boxes_per_file=TRAINER_BOXES,
                           events_per_file=200_000, seed=seed, blosc=blosc)
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
    from event_representation_study_tpu_torch.ops.image import letterbox_image
    from event_representation_study_tpu_torch.ops.nms import non_max_suppression
    from event_representation_study_tpu_torch.reps import fused_mdes
    from event_representation_study_tpu_torch.reps.ergo12 import (
        AGGREGATIONS, FUNCTIONS, WINDOW_INDEXES)
    from event_representation_study_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
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
    with torch.inference_mode():  # where a request's device time goes
        blk = requests[0].to(dev)
        rep = serve.rep_fn(blk)
        x = (letterbox_image(rep, IMG) / 255.0).permute(0, 3, 1, 2)
        preds = serve.model(x)
        say("serve_stages_ms", tf32=tf32_state(), **{
            "h2d": cuda_ms(lambda: requests[0].to(dev), 5),
            "ergo12": cuda_ms(lambda: serve.rep_fn(blk), 5),
            "letterbox": cuda_ms(lambda: letterbox_image(rep, IMG) / 255.0, 5),
            "detector": cuda_ms(lambda: serve.model(x), 5),
            "nms": cuda_ms(lambda: non_max_suppression(preds, conf_thres=0.03), 5),
        })
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
    warp_phase(dev)
    train_reference(dev)
    # 11-12. event-space augmentation, and training through the CLIs
    mosaic_launches = event_mosaic_phase(dev)
    trainer_launches = trainer_phase(dev)

    k1["launches"] = launches[fs.K1] + train_launches[fs.K1] + mosaic_launches + trainer_launches
    k1["launches_by_path"] = {"serve": launches[fs.K1], "train": train_launches[fs.K1],
                              "event_mosaic": mosaic_launches, "trainer": trainer_launches}
    k2["launches"] = launches_sum_only[fs.K2]
    k2["launches_by_path"] = {"mdes_sum_only": launches_sum_only[fs.K2]}
    k3["launches"] = train_launches["roll_rows"]
    k3["launches_by_path"] = {"train": train_launches["roll_rows"]}
    print(json.dumps({"kernels": [k1, k2, k3]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
