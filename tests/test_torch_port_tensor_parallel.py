"""Tensor parallelism (``parallel/tensor_parallel.py``, M18) on 2 gloo ranks
of a ("data", "model") = (1, 2) mesh: the shrunk detector's convolutions
and Linear layers sharded by output channel, one train step (ERGO-12 ->
letterbox -> detector -> loss -> SGD -> EMA, 128 px) against the same
step replicated on each rank, as the JAX package's ``test_train.py::
test_train_step_dp_x_tp``:

- ``count_tp_sharded`` > 10 for the parameters, the momentum and the EMA,
  before and after the step (the update stays sharded);
- the loss within 2e-4 relative of the replicated step's (JAX's
  tolerance), and every leaf's update (this rank's rows of a sharded one)
  within 2e-2 of its scale (as ``test_torch_port_train_step.py``);
- the first leaf, the stem's convolution, sharded and moved by more than
  1e-3 of its weights' scale: the pred convs start random, since at their
  zero init no gradient reaches a layer below them and the stem moves by
  its weight decay alone (~1e-6 of its scale), which the sharded backward
  (the input gradients summed over the axis) could get wrong unseen;
- the output-channel rule itself (``tp_spec_for``) on torch layouts.
``test_torch_port_ddp_step.py`` holds the same sharded step against JAX's
step on the same weights.
"""
import copy

import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.parallel.mesh import make_mesh
from event_representation_study_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelConv2d,
    count_tp_sharded,
    shard_state_tp,
    tp_spec_for,
)
from event_representation_study_tpu_torch.parallel.train_step import (
    Batch,
    init_train_state,
    make_train_step,
)
from event_representation_study_tpu_torch.train.losses import LossConfig
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils.config import load_config
from torch_port_helpers import CFG_PATH, SMALL, SpawnedGroup, _leafwise, assert_close

H = W = 64
IMG, B, CAP, M = 128, 4, 2048, 4
SOLVER = dict(epochs=300, steps_per_epoch=1000)


def _batch():
    evs = [generate_fake_events(1500, H, W, 50_000, seed=60 + i) for i in range(B)]
    gt = np.zeros((B, M, 4), np.float32)
    gt[:, 0] = [20, 24, 90, 100]
    mask = np.zeros((B, M), np.float32)
    mask[:, 0] = 1
    return Batch(None, stack_blocks([from_structured(e, CAP) for e in evs]),
                 np.zeros((B, M), np.int64), gt, mask)


def random_preds_(model, seed: int = 2):
    """Random pred-conv weights and biases (the seeded init zeroes the
    weights, as the reference does)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, conv in model.head.named_children():
            if "_pred_" in name:
                conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=g)
                conv.bias.normal_(0.0, 0.5, generator=g)


def tp_worker(rank, world):
    mesh = make_mesh(axis_names=("data", "model"), shape=(1, world), device="cpu")
    model = build_model(load_config(CFG_PATH, overrides=SMALL), 2, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    random_preds_(model)
    opt = build_optimizer(model, SolverConfig(**SOLVER))
    opt.count = 1500  # past the warmup: every group moves
    state = init_train_state(model, opt)
    ref = copy.deepcopy(state)
    kw = dict(representation="OptimizedRepresentation", rep_hw=(H, W), img_size=IMG,
              device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ref, ref_parts = make_train_step(LossConfig(2), **kw)(ref, _batch(), 5)

    state = shard_state_tp(state, mesh)
    counts = {"params": count_tp_sharded(state.model),
              "momentum": count_tp_sharded(state.opt_state),
              "ema": count_tp_sharded(state.ema.variables)}
    step = make_train_step(LossConfig(2), group=mesh.group("data"), **kw)
    state, parts = step(state, _batch(), 5)
    counts_after = {"params": count_tp_sharded(state.model),
                    "momentum": count_tp_sharded(state.opt_state),
                    "whole_state": count_tp_sharded(state)}
    got, want, start = {}, {}, {}
    for n, p in state.model.named_parameters():
        r = p.shape[0] if getattr(p, "tp_axis", None) else None
        rows = slice(rank * r, (rank + 1) * r) if r else slice(None)
        got[n] = p.detach().numpy().copy()
        want[n] = dict(ref.model.named_parameters())[n].detach()[rows].numpy().copy()
        start[n] = before[n][rows].numpy().copy()
    return {"counts": counts, "counts_after": counts_after, "got": got, "want": want,
            "before": start, "loss": float(parts["loss"]), "ref_loss": float(ref_parts["loss"]),
            "first": next(iter(got)),
            "first_sharded": getattr(next(state.model.parameters()), "tp_axis", None) == "model",
            "column_parallel": sum(isinstance(m, ColumnParallelConv2d)
                                   for m in state.model.modules())}


@pytest.fixture(scope="module")
def ranks():
    return SpawnedGroup(tp_worker, world=2).results()


def test_shards_are_counted(ranks):
    for r in ranks:
        assert all(v > 10 for v in r["counts"].values()), r["counts"]
        assert r["counts_after"]["params"] == r["counts"]["params"]
        assert r["counts_after"]["momentum"] == r["counts"]["momentum"]
        assert r["counts_after"]["whole_state"] == sum(r["counts"].values())
        assert r["column_parallel"] > 10


def test_loss_matches_the_replicated_step(ranks):
    for r in ranks:
        assert np.isfinite(r["loss"])
        assert_close("tp loss", r["loss"], r["ref_loss"], atol=0, rtol=2e-4)


def test_update_matches_the_replicated_step(ranks):
    for rank, r in enumerate(ranks):
        first = r["first"]
        assert r["first_sharded"]  # its rows of the replicated leaf
        stem = np.abs(r["want"][first] - r["before"][first]).max()
        assert stem > 1e-3 * np.abs(r["before"][first]).max(), stem  # gradients reached it
        assert_close(f"parameter update / leaf scale, rank {rank}",
                     _leafwise(r["got"], r["want"], minus=r["before"]), 0.0, atol=2e-2)


def test_tp_spec_for_splits_output_channels():
    assert tp_spec_for((64, 32, 3, 3), 2) == ("model", None, None, None)  # OIHW
    assert tp_spec_for((10, 32), 2) == ("model", None)  # Linear (out, in)
    assert tp_spec_for((63, 32, 3, 3), 2) == ()  # does not divide
    assert tp_spec_for((64,), 2) == ()  # rank 1 stays replicated
    assert tp_spec_for((1, 8), 2) == ()
