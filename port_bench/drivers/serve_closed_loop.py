"""Timed loop of serving: one client in a closed loop, each request one
window of events through the port's ``cli/infer.py::make_server(...).run``
(ERGO-12 on K1, letterbox, the detector in eval mode, ``ops/nms.py``).

A request is timed from the call to ``Server.run`` until its detections
are on the host; the client then sends the next window. Set-up builds the
server, loads the benchmark's seeded weights (the class-pred bias that
the configuration fixes, so that every request has candidates above the
confidence threshold; the BatchNorm statistics from a pass of the plain
reference over ``calibration_windows`` windows that are never served) and
serves ``warmup_requests`` windows. The process is left as
``cli/infer.py`` leaves it: PyTorch's own threads, the collector as it is.
After the window the port is freed, and the plain reference
(``reference/<config>.py``) computes a sample of the completed requests,
drawn from the seed; each of the port's answers is judged against it, the
reference following the port's suppression choice by choice
(``judge.py::detection_gaps``). :func:`controls` gives the readings that
set the limits from above (``controls.py``).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from port_bench import core, judge, tracing, yardstick
from port_bench.weights import seeded_state

GAPS = ("box_gap_px", "score_gap", "decision_gap")


def _serve_probe(server, counters):
    """Spans around the request's stages for a traced run; NMS closes on a
    synchronise, so its span is its host time until the outputs are
    ready. Returns the undo."""
    from event_representation_study_tpu_torch.cli import infer
    from event_representation_study_tpu_torch.events.core import EventBlock
    from event_representation_study_tpu_torch.ops import fused_scatter

    k1 = counters.setdefault("k1_calls", [])
    sync = ((lambda _out: torch.cuda.synchronize(server.device))
            if server.device.type == "cuda" else None)
    undo = [tracing.wrap_attr(EventBlock, "to", "h2d"),
            tracing.wrap_attr(server, "rep_fn", "representation"),
            tracing.wrap_attr(infer, "letterbox_image", "letterbox"),
            tracing.wrap_attr(infer, "non_max_suppression", "nms", after=sync),
            tracing.wrap_attr(fused_scatter, "segment_reduce_sorted", "k1",
                              before=lambda *a: k1.append(yardstick.segment_reduce_args(*a))),
            tracing.module_span(server.model, "detector")]
    return lambda: [u() for u in reversed(undo)]


def request(pool, i: int):
    """Request ``i``: window ``i`` of the pool as a one-window block on the
    host, as a camera stream hands it over."""
    from event_representation_study_tpu_torch.events.core import EventBlock

    ev = pool.events(i)
    return EventBlock(x=ev[None, 0], y=ev[None, 1], t=ev[None, 2], p=ev[None, 3],
                      num=np.array([ev.shape[1]], np.int32))


def run(ctx: core.Context) -> core.Run:
    from event_representation_study_tpu_torch.cli import infer
    from event_representation_study_tpu_torch.ops import fused_scatter

    cfg, tr, dev = ctx.cell.config["program"], ctx.cell.traffic, ctx.device
    reference, traffic = ctx.cell.reference(), ctx.cell.traffic_maker()
    data = cfg["data"]
    H, W, img = data["height"], data["width"], data["img_size"]
    server = infer.make_server(cfg, reference.REPRESENTATION, H, W, img,
                               conf_thres=tr["conf_thres"], device=dev)
    meta = reference.model(cfg, "meta")
    pool = traffic.from_traffic(tr, ctx.seed)
    weights = served_weights(ctx.cell, reference, pool, ctx.seed, dev)
    server.model.load_state_dict(weights)

    def serve(i):
        rep, preds, dets, n = server.run(request(pool, i))
        return dets[0, :int(n[0])].cpu()

    warm = int(tr["warmup_requests"])
    for i in range(warm):
        serve(i)
    counters: dict = {}
    undo = _serve_probe(server, counters) if ctx.trace else (lambda: None)
    fused_scatter.reset_launches()
    lat_ms, answers, failed, i = [], {}, 0, warm
    rep = preds = dets = n = None
    seconds = ctx.window_seconds
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    try:
        with tracing.Profiled(ctx.trace, dev) as prof:
            while time.perf_counter() - t0 < seconds:
                blk = request(pool, i)
                ts = time.perf_counter()
                try:
                    rep, preds, dets, n = server.run(blk)
                    out = dets[0, :int(n[0])].cpu()
                except RuntimeError:
                    failed += 1
                else:
                    lat_ms.append((time.perf_counter() - ts) * 1e3)
                    answers[i] = out
                i += 1
        window_s = prof.t_end - t0
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    k1_launches = fused_scatter.LAUNCHES[fused_scatter.K1]
    precision = yardstick.precision_in_use()
    del server, rep, preds, dets, n
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = core.Run(setup_s=setup_s, window_s=window_s, attempted=i - warm, failed=failed,
                   memory_peak_bytes=peak, trace=prof.summary)
    run.extra.update(latencies_ms=lat_ms, requests=len(lat_ms),
                     peak_flops=yardstick.PEAK_FLOPS[precision], precision=precision,
                     k1_bytes=yardstick.bytes_of_calls(counters.get("k1_calls", [])))
    if ctx.trace:
        run.extra["flops_per_request"] = yardstick.forward_flops(
            meta, (1, reference.CHANNELS, img, img), train=False)
        run.extra["rep_s"] = run.trace.device_s("representation")
        run.extra["nms_s"] = run.trace.host_s("nms")
    run.extra["info"] = {"precision": precision, "k1_launches": k1_launches,
                         "requests": len(lat_ms), "memory_peak_bytes": peak,
                         "latency_deciles_ms": (statistics.quantiles(lat_ms, n=10)
                                                if len(lat_ms) > 1 else None)}

    done = sorted(answers)
    rng = np.random.default_rng(ctx.seed)
    sample = sorted(rng.choice(done, size=min(int(tr["sample_requests"]), len(done)),
                               replace=False).tolist()) if done else []
    want = reference.serve_answers(cfg, weights, [pool.events(j) for j in sample], img, H, W,
                                   dev)
    run.checks = ctx.checks(readings([answers[j] for j in sample], want, tr, reference))
    run.extra["info"].update(
        checked_requests=len(sample),
        candidates_per_request=float(np.mean([int((p[:, 4] > tr["conf_thres"]).sum())
                                              for p in want])) if want else 0.0,
        detections_per_request=float(np.mean([len(answers[j]) for j in sample]))
        if sample else 0.0)
    return run


def served_weights(cell: core.Cell, reference, pool, seed: int, dev) -> Dict[str, torch.Tensor]:
    """The served weights: seeded, with the BatchNorm statistics of
    ``calibration_windows`` windows of the pool that are never served."""
    cfg, tr = cell.config["program"], cell.traffic
    data = cfg["data"]
    calib = [pool.events(len(pool) - 1 - j) for j in range(int(tr["calibration_windows"]))]
    return reference.calibrated_state(
        cfg, seeded_state(reference.model(cfg, "meta"), seed, dev, cell.config["weights"]["serve"]),
        calib, data["img_size"], data["height"], data["width"], dev)


def readings(answers, want, tr: Dict, reference) -> Dict[str, float]:
    """The numbers compared (:data:`GAPS`): the worst over the checked
    requests of each answer's gaps (``judge.py::detection_gaps``)."""
    gaps = np.array([judge.detection_gaps(dets, pairs, tr["conf_thres"], reference.IOU_THRES,
                                          reference.MAX_DET)
                     for dets, pairs in zip(answers, want)]).reshape(-1, len(GAPS))
    worst = gaps.max(axis=0) if len(gaps) else np.full(len(GAPS), np.inf)
    return dict(zip(GAPS, map(float, worst)))


def controls(cell: core.Cell, seed: int, dev, lower) -> Iterator[Tuple[str, Dict[str, float]]]:
    """The control (the reference under ``lower``, the precision below the
    configuration's, its answers through the frozen copy of the port's
    NMS) and two answers altered where they are produced: ``rescored``
    (each request's first detection scored 0.1 lower) and ``dropped``
    (that detection dropped), on a sample of requests drawn as a run's."""
    from port_bench.reference.frozen.ops import nms

    ref, traffic = cell.reference(), cell.traffic_maker()
    cfg, tr = cell.config["program"], cell.traffic
    data = cfg["data"]
    pool = traffic.from_traffic(tr, seed)
    rng = np.random.default_rng(seed)
    sample = sorted(rng.choice(np.arange(tr["warmup_requests"], 10 * tr["sample_requests"]),
                               size=int(tr["sample_requests"]), replace=False).tolist())
    weights = served_weights(cell, ref, pool, seed, dev)

    def answers():
        return ref.serve_answers(cfg, weights, [pool.events(j) for j in sample],
                                 data["img_size"], data["height"], data["width"], dev)

    def served(pairs):
        """What the port's NMS keeps from ``pairs``: the frozen copy of it."""
        xywh = torch.cat([(pairs[:, :2] + pairs[:, 2:4]) / 2, pairs[:, 2:4] - pairs[:, :2]], 1)
        nc = int(pairs[:, 5].max()) + 1
        pred = torch.cat([xywh[::nc], torch.ones(len(pairs) // nc, 1),
                          pairs[:, 4].reshape(-1, nc)], dim=1)
        dets, n = nms.non_max_suppression(pred[None].float(), conf_thres=tr["conf_thres"])
        return dets[0, :int(n[0])]

    want = answers()
    with lower():
        low = answers()
    yield "control", readings([served(p) for p in low], want, tr, ref)
    sound = [served(p) for p in want]
    rescored = []
    for k in sound:
        k = k.clone()
        if len(k):
            k[0, 4] -= 0.1
        rescored.append(k)
    yield "rescored", readings(rescored, want, tr, ref)
    yield "dropped", readings([k[1:] for k in sound], want, tr, ref)
