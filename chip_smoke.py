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
5. serve: the full-width ``configs/gen1_optimized.py`` detector serves
   requests of 8 windows through ``make_server``; the kernel launch counters
   are zeroed before and read after, and K1 must run once per request.
   mdes_sum_only drives ``mdes_fused_batched`` on a sum-only table, the path
   of K2, the same way.
6. reference: a shrunk detector serves the same windows on the card and on
   the CPU; representation and predictions must agree, and NMS must match box
   for box on tie-free predictions at the serve shape.
Then the ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: exit code non-zero
and no result line.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

H, W, N, B = 240, 304, 50_000, 8
S = H * W
IMG = 640
REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
REPLACES = "event_representation_study_tpu/ops/pallas_scatter.py"
SOURCE = "event_representation_study_tpu_torch/csrc/fused_segment_reduce.cu"


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

    seg_s, offs, vs, vm, num_segments = kernel_args
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
    err_cpu = (k_sum.cpu() - c_sum).abs().max().item()
    require(all(checks.values()), f"{label}: kernel disagrees with its plain version: {checks}")

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

    # the kernel reads the CSR offsets, the Ks+Km value columns of the valid
    # events (not the sorted ids) and writes the (B, S, Ks+Km) outputs
    n_valid = int(offs[:, -1].sum().item())
    nbytes = 4 * (offs.numel() + n_valid * (ks + km) + bsz * num_segments * (ks + km))
    flops = n_valid * (ks + km)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    say(label, shape={"B": bsz, "N": n, "S": num_segments, "Ks": ks, "Km": km},
        max_abs_err_vs_plain_card=err, max_abs_err_vs_plain_cpu=err_cpu,
        tolerance="sums rtol 1e-5 atol 1e-4 (plain uses float atomics); max and count columns exact",
        **checks, ms_l2_flushed=ms, ms_warm_l2=ms_warm, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(t_bytes, t_ops), bytes=nbytes, flops=flops,
        tf32=tf32_state())
    return {
        "name": fs.K1 if km else fs.K2, "route": "cuda", "source": SOURCE,
        "replaces": f"{REPLACES}:{99 if km else 63}",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


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


def randomize_preds_(model, generator):
    """Random pred-conv weights, so that scores vary and NMS has work (the
    seeded init leaves them at zero, as the reference does)."""
    with torch.no_grad():
        for name, mod in model.head.named_children():
            if "_pred_" in name:
                std = (1.0 / mod.weight[0].numel()) ** 0.5
                mod.weight.normal_(0.0, std, generator=generator)
                mod.bias.normal_(0.0, 0.5, generator=generator)


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
    report = cuda_build.build()
    say("build", seconds=time.perf_counter() - t0,
        compiled={cuda_build.SOURCE: report and report[0]},
        ptxas=[ln for ln in (report[1] if report else "").splitlines() if "ptxas info" in ln])

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
        tolerance=2e-4, glue_sort_gather_columns_offsets_ms=glue_ms,
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

    k1["launches"] = launches[fs.K1]
    k2["launches"] = launches_sum_only[fs.K2]
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
