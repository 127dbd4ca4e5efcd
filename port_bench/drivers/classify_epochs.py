"""Timed loop of Mini N-ImageNet classification: the port's
``train/classifier.py::ClassifierTrainer.run_epoch(train=True)`` epoch
after epoch, built as ``cli/classify.py`` builds it.

Set-up writes the benchmark's synthetic ``.npz`` tree under the run's
temporary directory (the traffic's ``traffic/<generator>.py``), builds the dataset,
the ResNet and the trainer with the configuration's settings, loads the
benchmark's seeded weights, and runs the first epoch: its first
``check_steps`` steps are the ones the correctness check compares (each
loss, every leaf's first gradient from Adam's first moment, every leaf's
change after them), and the epoch warms every shape. The window then runs
whole epochs until ``--seconds`` have passed; ``run_epoch`` reads every
step's logits back, so the window ends synchronised. Afterwards the port is
freed and the plain reference repeats the checked steps. :func:`controls`
gives the readings that set the limits from above (``controls.py``).
"""
from __future__ import annotations

import tempfile
import time
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from port_bench import core, judge, tracing, yardstick
from port_bench.weights import seeded_state


def _classify_probe(trainer, counters):
    """Spans around a classification step's stages for a traced run."""
    from event_representation_study_tpu_torch.ops import fused_scatter

    k1 = counters.setdefault("k1_calls", [])
    undo = [tracing.wrap_attr(trainer, "_batch_of", "host_batch"),
            tracing.wrap_attr(trainer, "rep_fn", "representation"),
            tracing.wrap_attr(trainer.optimizer, "step", "optimizer"),
            tracing.wrap_attr(fused_scatter, "segment_reduce_sorted", "k1",
                              before=lambda *a: k1.append(yardstick.segment_reduce_args(*a))),
            tracing.wrap_attr(torch.Tensor, "backward", "backward")]
    return lambda: [u() for u in reversed(undo)]


def run(ctx: core.Context) -> core.Run:
    from event_representation_study_tpu_torch.cli.classify import read_list
    from event_representation_study_tpu_torch.data.nimagenet import NImageNetDataset
    from event_representation_study_tpu_torch.models.resnet import EventResNet
    from event_representation_study_tpu_torch.ops import fused_scatter
    from event_representation_study_tpu_torch.train.classifier import ClassifierTrainer

    cfg, tr, dev = ctx.cell.config["program"], ctx.cell.traffic, ctx.device
    reference, traffic = ctx.cell.reference(), ctx.cell.traffic_maker()
    files, _ = traffic.write_tree(ctx.tmp / "tree", ctx.cell.config["dataset"], tr,
                                         ctx.seed)
    listing = ctx.tmp / "train.txt"
    listing.write_text("\n".join(files))
    files, labels = read_list(listing)
    ds = NImageNetDataset(files, labels, loader_type=cfg["loader_type"],
                          slice_length=int(cfg["slice_length"]),
                          reshape_method=cfg["reshape_method"],
                          augment=cfg["augment"] == "True")
    net = EventResNet(num_classes=int(cfg["num_classes"]), arch=cfg["model"],
                      stem_kernel=int(cfg["kernel_size"]),
                      in_channels=int(cfg["channel_size"]))
    trainer = ClassifierTrainer(net, ds.representation, int(cfg["num_classes"]),
                                optimizer=cfg["optimizer"], lr=float(cfg["learning_rate"]),
                                weight_decay=float(cfg["weight_decay"]),
                                seed=int(cfg["seed"]), device=dev)
    trainer.init()
    meta = reference.model(cfg, "meta")
    state = seeded_state(meta, ctx.seed, dev)
    net.load_state_dict(state)
    bsz, n_check = int(cfg["batch_size"]), int(ctx.cell.work["check_steps"])

    seen = {"steps": 0, "losses": []}
    real_step = trainer.train_step
    b1 = trainer.optimizer.defaults["betas"][0]
    named = dict(net.named_parameters())

    def counted_step(batch, labels_t):
        loss, logits = real_step(batch, labels_t)
        seen["steps"] += 1
        seen["losses"].append(loss)
        if seen["steps"] == 1:  # Adam's first moment after one step is (1 - b1) g
            st = trainer.optimizer.state
            seen["grad1"] = judge.leaf_norms({n: st[p]["exp_avg"] / (1 - b1)
                                              for n, p in named.items() if "exp_avg" in st[p]})
        if seen["steps"] == n_check:
            seen["change"] = judge.leaf_norms({n: p.detach() - state[n]
                                               for n, p in named.items()})
        return loss, logits

    trainer.train_step = counted_step
    order_rng = np.random.default_rng(ctx.seed)
    trainer.run_epoch(ds, bsz, train=True, rng=order_rng)  # the checked steps and warm-up
    if seen["steps"] < n_check:
        raise core.HarnessError(f"an epoch of {seen['steps']} steps cannot hold the "
                                f"{n_check} checked steps")
    check_losses = [float(v) for v in seen["losses"][:n_check]]
    del state

    counters: dict = {}
    undo = _classify_probe(trainer, counters) if ctx.trace else (lambda: None)
    fused_scatter.reset_launches()
    steps0, load_s, epochs = seen["steps"], 0.0, 0
    seconds = ctx.window_seconds
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    try:
        with tracing.Profiled(ctx.trace, dev) as prof:
            while time.perf_counter() - t0 < seconds:
                out = trainer.run_epoch(ds, bsz, train=True, rng=order_rng)
                load_s += out["load_s"]
                epochs += 1
        window_s = prof.t_end - t0
    finally:
        undo()
    steps = seen["steps"] - steps0
    window_losses = seen["losses"][steps0:]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    k1_launches = fused_scatter.LAUNCHES[fused_scatter.K1]
    precision = yardstick.precision_in_use()
    finite = torch.isfinite(torch.stack(window_losses)).cpu().numpy() if window_losses else []
    del trainer, net, named, real_step, seen["losses"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = core.Run(setup_s=setup_s, window_s=window_s, attempted=steps * bsz,
                   failed=int((~np.asarray(finite, bool)).sum()) * bsz,
                   memory_peak_bytes=peak, trace=prof.summary)
    run.extra.update(samples=steps * bsz, steps=steps, load_s=load_s,
                     peak_flops=yardstick.PEAK_FLOPS[precision], precision=precision,
                     k1_bytes=yardstick.bytes_of_calls(counters.get("k1_calls", [])))
    if ctx.trace:
        run.extra["flops_per_step"] = 3 * yardstick.forward_flops(
            meta, (bsz, int(cfg["channel_size"]), 224, 224), train=True)
    run.extra["info"] = {"precision": precision, "k1_launches": k1_launches, "steps": steps,
                         "epochs": epochs, "load_s": load_s, "memory_peak_bytes": peak,
                         "check_losses": check_losses}

    want = reference.train_readings(cfg, seeded_state(meta, ctx.seed, dev), files, labels,
                                    ctx.seed, n_check, dev)
    got = {"losses": check_losses, "grad1": seen["grad1"], "change": seen["change"]}
    gaps, worst = readings(got, want)
    run.checks = ctx.checks(gaps)
    run.extra["info"].update(reference_losses=want["losses"], worst_leaves=worst,
                             leaves_compared=len(judge.moving_leaves(want["grad1"])),
                             leaves=len(want["grad1"]))
    return run


def readings(got: Dict, want: Dict) -> Tuple[Dict[str, float], Dict[str, str]]:
    """The numbers compared and the leaf each was read at:
    the step losses, the first gradient of every leaf, the change after
    the checked steps of every leaf that moves."""
    moving = judge.moving_leaves(want["grad1"])
    grad_gap, grad_leaf = judge.worst_leaf_gap(got["grad1"], want["grad1"])
    change_gap, change_leaf = judge.worst_leaf_gap(got["change"], want["change"], moving)
    return ({"loss_gap": judge.loss_gap(got["losses"], want["losses"]), "grad_gap": grad_gap,
             "change_gap": change_gap}, {"grad_gap": grad_leaf, "change_gap": change_leaf})


def controls(cell: core.Cell, seed: int, dev, lower) -> Iterator[Tuple[str, Dict[str, float]]]:
    """The control (the reference in the port's place under ``lower``, the
    precision below the configuration's) and the planted fault
    ``half_batch`` of the reference, each read against the sound reference
    at the cell's own size."""
    ref, traffic = cell.reference(), cell.traffic_maker()
    cfg = cell.config["program"]
    with tempfile.TemporaryDirectory() as tmp:
        files, labels = traffic.write_tree(tmp, cell.config["dataset"], cell.traffic, seed)
        meta = ref.model(cfg, "meta")

        def train(**kw):
            return ref.train_readings(cfg, seeded_state(meta, seed, dev), files, labels, seed,
                                      int(cell.work["check_steps"]), dev, **kw)

        want = train()
        with lower():
            yield "control", readings(train(), want)[0]
        yield "half_batch", readings(train(half_batch=True), want)[0]
