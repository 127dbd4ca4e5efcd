"""Timed loop of detector training: the calls of the port's
``train/engine.py::Trainer._train_epoch``.

Set-up builds the port's ``Trainer`` around the benchmark's synthetic Gen1
split (``traffic/gen1_windows.py``; the Trainer's ``Gen1H5`` is swapped for
it while the Trainer is built), loads the benchmark's seeded weights, and
resumes the optimizer, the accumulation and the EMA at the start of epoch
``epoch`` of an ``epochs``-epoch run. It then drives the first ``check_steps``
steps through the window's own feed (``parallel/mesh.py::device_prefetch``
over the Trainer's ``EventBatchLoader``) and call (``Trainer.train_step``),
which also warms every shape, and keeps what the correctness check
compares: each step's loss, every leaf's first gradient as the optimizer
holds it, every leaf's change after the steps, and the change of every
BatchNorm statistic and of every entry of the EMA. The window then runs
steps until ``--seconds`` have passed and closes on a device synchronise.

Afterwards the port's state is freed and the plain reference
(``reference/<config>.py::train_readings``) repeats the checked steps from
the same weights and inputs. :func:`controls` gives the readings that set
the limits from above (``controls.py``).
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from port_bench import core, judge, tracing, yardstick
from port_bench.weights import seeded_state


def _train_probe(counters: Dict):
    """Spans around the train step's stages for a traced run: the port's
    module-level functions that the step looks up at call time, and the
    backward pass. Returns the undo."""
    from event_representation_study_tpu_torch.ops import fused_scatter
    from event_representation_study_tpu_torch.parallel import train_step as ts

    calls = []

    def k1_args(*args):
        calls.append(yardstick.segment_reduce_args(*args))

    undo = [tracing.wrap_attr(ts, "batch_on_device", "h2d"),
            tracing.wrap_attr(ts, "mosaic_event_rep", "representation"),
            tracing.wrap_attr(ts, "letterbox_image", "letterbox"),
            tracing.wrap_attr(ts, "detection_loss", "loss"),
            tracing.wrap_attr(ts, "ema_update", "ema"),
            tracing.wrap_attr(fused_scatter, "segment_reduce_sorted", "k1", before=k1_args),
            tracing.wrap_attr(torch.Tensor, "backward", "backward")]
    counters["k1_calls"] = calls
    return lambda: [u() for u in reversed(undo)]


def first_gradient(opt, p0: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every leaf's gradient of the first step as the optimizer holds it
    after that step: the accumulator's running mean while it accumulates;
    after an update, the momentum (zero before it) less the weight decay
    term of the ``weight`` group."""
    if getattr(opt, "mini_step", 0):
        return dict(opt.acc)
    inner = getattr(opt, "inner", opt)
    wd = inner.cfg.weight_decay
    weight = set(inner.groups["weight"])
    return {n: m.float() - wd * p0[n] if n in weight else m.float()
            for n, m in inner.momentum.items()}


def run(ctx: core.Context) -> core.Run:
    from event_representation_study_tpu_torch.ops import fused_scatter, roll
    from event_representation_study_tpu_torch.parallel.mesh import device_prefetch
    from event_representation_study_tpu_torch.train import engine

    cfg, tr, dev = ctx.cell.config["program"], ctx.cell.traffic, ctx.device
    reference, traffic = ctx.cell.reference(), ctx.cell.traffic_maker()
    bsz, epoch, img = tr["batch_size"], tr["epoch"], cfg["data"]["img_size"]
    ds = traffic.from_traffic(tr, ctx.seed)
    val = traffic.from_traffic(dict(tr, length=bsz, unique_windows=1), ctx.seed + 1)

    real_h5 = engine.Gen1H5
    engine.Gen1H5 = lambda root, task="train", num_events=None: ds if task == "train" else val
    try:
        trainer = engine.Trainer(cfg, "synthetic", batch_size=bsz, epochs=tr["epochs"],
                                 nominal_batch_size=tr["nominal_batch_size"],
                                 seed=ctx.seed, augment=True, aug_mode="auto",
                                 output_dir=str(ctx.tmp / "train"), device=dev)
    finally:
        engine.Gen1H5 = real_h5
    resume = reference.resume_point(tr, cfg, len(ds))
    got = (trainer.accumulate, trainer.accum_warmup_steps, trainer.solver_cfg.steps_per_epoch)
    want = (resume["accumulate"], resume["accumulate_warmup"],
            resume["solver"]["steps_per_epoch"])
    if got != want:
        raise core.HarnessError(f"the Trainer's accumulation and schedule {got} are not the "
                                f"reference's {want}")
    net = trainer.model
    meta = reference.model(cfg, "meta")
    state = seeded_state(meta, ctx.seed, dev, ctx.cell.config["weights"]["train"])
    net.load_state_dict(state)
    # resume at the start of `epoch`: updates done, microsteps, EMA blends
    opt = trainer.state.opt_state
    updates = resume["solver"]["update"]
    opt.inner.count = updates
    opt.gradient_step = updates
    trainer.state.step = resume["microsteps"]
    with torch.no_grad():
        for k, v in trainer.state.ema.variables.items():
            v.copy_(net.state_dict()[k])
    trainer.state.ema = trainer.state.ema._replace(updates=resume["microsteps"])
    trainer.prepare_for_epoch(epoch)

    feed = device_prefetch(trainer.train_loader, trainer.mesh)
    losses = []
    n_check = int(ctx.cell.work["check_steps"])
    for k in range(n_check):
        batch, _ = next(feed)
        trainer.state, parts = trainer.train_step(trainer.state, batch, epoch)
        losses.append(parts["loss"])
        if k == 0:
            grad1 = judge.leaf_norms(first_gradient(opt, state))
    params = dict(net.named_parameters())
    change = judge.leaf_norms({n: params[n].detach() - state[n] for n in params})
    buffers = judge.leaf_norms({n: b - state[n] for n, b in net.named_buffers()
                                if b.is_floating_point()})
    ema = judge.leaf_norms({n: v - state[n] for n, v in trainer.state.ema.variables.items()})
    check_losses = [float(v) for v in losses]
    del state

    counters: Dict = {}
    undo = _train_probe(counters) if ctx.trace else (lambda: None)
    fused_scatter.reset_launches()
    roll.reset_launches()
    window_loss, steps, wait = [], 0, 0.0
    seconds = ctx.window_seconds
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    try:
        with tracing.Profiled(ctx.trace, dev) as prof:
            while time.perf_counter() - t0 < seconds:
                t = time.perf_counter()
                with tracing.span("loader"):
                    try:
                        batch, _ = next(feed)
                    except StopIteration:  # a new loader epoch
                        feed = device_prefetch(trainer.train_loader, trainer.mesh)
                        batch, _ = next(feed)
                wait += time.perf_counter() - t
                trainer.state, parts = trainer.train_step(trainer.state, batch, epoch)
                if trainer.state.step % trainer.log_interval == 0:
                    trainer.writer.log({k: float(v) for k, v in parts.items()},
                                       trainer.state.step)
                window_loss.append(parts["loss"])
                steps += 1
        window_s = prof.t_end - t0
    finally:
        undo()
        feed.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finite = torch.isfinite(torch.stack(window_loss)).cpu().numpy() if window_loss else []
    k1_launches = fused_scatter.LAUNCHES[fused_scatter.K1]
    k3_launches = roll.LAUNCHES[roll.K3]
    precision = yardstick.precision_in_use()
    del trainer, net, opt, params, parts, batch, feed, losses, window_loss
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = core.Run(setup_s=setup_s, window_s=window_s, attempted=steps * bsz,
                   failed=int((~np.asarray(finite, bool)).sum()) * bsz,
                   memory_peak_bytes=peak, trace=prof.summary)
    run.extra.update(samples=steps * bsz, steps=steps, loader_wait_s=wait,
                     peak_flops=yardstick.PEAK_FLOPS[precision], precision=precision,
                     k1_bytes=yardstick.bytes_of_calls(counters.get("k1_calls", [])))
    if ctx.trace:
        run.extra["flops_per_step"] = 3 * yardstick.forward_flops(
            meta, (bsz, reference.CHANNELS, img, img), train=True)
    run.extra["info"] = {"precision": precision, "k1_launches": k1_launches,
                         "k3_launches": k3_launches, "steps": steps, "memory_peak_bytes": peak,
                         "check_losses": check_losses}

    want = reference.train_readings(
        cfg, seeded_state(meta, ctx.seed, dev, ctx.cell.config["weights"]["train"]), ds,
        resume, bsz, img, ctx.seed, epoch, n_check, dev)
    got = {"losses": check_losses, "grad1": grad1, "change": change, "buffers": buffers,
           "ema": ema}
    gaps, worst = readings(got, want)
    run.checks = ctx.checks(gaps)
    run.extra["info"].update(reference_losses=want["losses"], worst_leaves=worst,
                             leaves_compared=len(judge.moving_leaves(want["grad1"])),
                             leaves=len(want["grad1"]))
    return run


def readings(got: Dict, want: Dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """The numbers compared, and the leaf each was read
    at: the step losses; the first gradient, every leaf; the change after
    the checked steps of every leaf that moves (``judge.moving_leaves``),
    of every BatchNorm statistic, and of every entry of the EMA but the
    parameters that do not move."""
    moving = judge.moving_leaves(want["grad1"])
    still = set(want["grad1"]) - set(moving)
    gaps, worst = {"loss_gap": judge.loss_gap(got["losses"], want["losses"])}, {}
    for name, key, leaves in (("grad_gap", "grad1", None), ("change_gap", "change", moving),
                              ("buffer_gap", "buffers", None),
                              ("ema_gap", "ema", [k for k in want["ema"] if k not in still])):
        gaps[name], worst[name] = judge.worst_leaf_gap(got[key], want[key], leaves)
    return gaps, worst


def controls(cell: core.Cell, seed: int, dev, lower) -> Iterator[Tuple[str, Dict[str, float]]]:
    """The control (the reference in the port's place under ``lower``, the
    precision below the configuration's) and the planted faults of the
    reference (``reference.FAULTS``), each read against the sound
    reference at the cell's own size."""
    ref, traffic = cell.reference(), cell.traffic_maker()
    cfg, tr = cell.config["program"], cell.traffic
    ds = traffic.from_traffic(tr, seed)
    resume = ref.resume_point(tr, cfg, len(ds))
    meta = ref.model(cfg, "meta")

    def train(fault=None):
        return ref.train_readings(
            cfg, seeded_state(meta, seed, dev, cell.config["weights"]["train"]), ds, resume,
            tr["batch_size"], cfg["data"]["img_size"], seed, tr["epoch"],
            int(cell.work["check_steps"]), dev, fault=fault)

    want = train()
    with lower():
        yield "control", readings(train(), want)[0]
    for fault in ref.FAULTS:
        yield fault, readings(train(fault), want)[0]
