"""The port's Swin-V2-L detector (``configs/gen1_swinvit.py``) against the
benchmark's plain reference of it (``port_bench/reference/gen1_swinvit.py``,
plain torch, nothing of the port) on the CPU, from one seeded state
(``port_bench/weights.py::seeded_state``): the Swin at its fixed 'large'
preset, the neck and head at depth 0.2 / width 0.125, a 64² input. The
backbone's maps are then 16/8/4/2: stage 0 pads 16² to 24² and its second
block shifts by 6 under the -100 mask; stages 1-3 shrink the window to the
map. Its four outputs are pooled to the fixed 72/36/18/9 grid, so the neck
and head run at the 576² cell's shapes.

- Eval boxes and scores agree; with the reference's planted fault
  ``no_shift_mask`` (the shifted blocks attend without the mask) the boxes
  miss by far more than the tolerance.
- One train step (an ATSS epoch, class preds at their init, as the cell's
  weights): the loss, every leaf's gradient, the SGD update (the port's
  ``FusedSGD`` and its parameter groups against the reference's written-out
  update) and the neck's BatchNorm statistics agree.

Where the two differ in float32: the reference computes the position
bias's MLP on the 23² table of offsets and gathers it, the port on all
144² pairs of a window, so the bias differs by rounding; everything after
the backbone is the same operations on both sides.
"""
import json
import math
import pathlib
import statistics

import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.models import build_model
from event_representation_study_tpu_torch.train.losses import LossConfig, detection_loss
from event_representation_study_tpu_torch.train.optim import SolverConfig, build_optimizer
from event_representation_study_tpu_torch.utils.config import load_config
from port_bench.reference import gen1_swinvit as reference
from port_bench.reference.frozen.train.losses import detection_loss as ref_detection_loss
from port_bench.weights import seeded_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = load_config(str(ROOT / "configs/gen1_swinvit.py"),
                  overrides=["model.depth_multiple=0.2", "model.width_multiple=0.125"])
TRAIN_WEIGHTS = json.loads((ROOT / "port_bench/configs/gen1_swinvit.json").read_text())[
    "weights"]["train"]
SEED, B, IMG, M = 2 ** 31 + 18, 2, 64, 4
SOLVER = SolverConfig(epochs=300, steps_per_epoch=1000)
UPDATE = 1500  # past the warm-up: every group at its full rate
# eval: float32 rounding of the position bias carried through 24 blocks;
# boxes are decoded pixels on the 576² grid (~1e3 at random weights)
BOX_ATOL_PX, SCORE_ATOL = 2e-3, 1e-5
# train: a leaf's largest difference over its largest entry or the median
# leaf's, whichever is larger (the harness's floor: leaves in front of a
# train-mode BatchNorm have gradients of ~1e-8 that are rounding alone).
# The two agree to 2.4e-13 in float64; in float32 the worst leaf, stage 0's
# first proj bias (a sum over every token that cancels), reads ~1e-3: the
# two sum it in another order. BatchNorm statistics and the loss see the
# bias's rounding only.
GRAD_TOL, UPDATE_TOL, LOSS_RTOL, BN_TOL = 5e-3, 5e-3, 1e-5, 1e-5


def _state(overrides):
    return seeded_state(reference.model(CFG, "meta"), SEED, "cpu", overrides)


def _images():
    return torch.from_numpy(np.random.default_rng(SEED).uniform(
        0.0, 1.0, (B, 12, IMG, IMG)).astype(np.float32))


def _labels():
    rng = np.random.default_rng(SEED + 1)
    xy = rng.uniform(100, 476, (B, M, 2))
    wh = rng.uniform(40, 160, (B, M, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    return (torch.as_tensor(rng.integers(0, 2, (B, M))), torch.as_tensor(boxes),
            torch.ones((B, M)))


def _leaf_gap(pairs, slack=None):
    """(worst gap, its leaf) over ``pairs`` ((leaf, got, want) tensors, made
    one at a time): a leaf's largest difference, less its ``slack`` if any,
    over its largest entry or the median leaf's, whichever is larger."""
    diff, scale = {}, {}
    for k, got, want in pairs:
        diff[k] = float((got - want).abs().max()) - (slack[k] if slack else 0.0)
        scale[k] = float(want.abs().max())
    median = statistics.median(scale.values())
    return max((max(d, 0.0) / max(scale[k], median, 1e-30), k) for k, d in diff.items())


class TestEval:
    """Eval decodes; the class-scoped state is freed before the train step."""

    @pytest.fixture(scope="class")
    def eval_case(self):
        """One seeded state (class preds random, temperatures at log 10), one
        input and the port's eval decode of it, shared by both cases."""
        state = _state({"*.logit_scale": TRAIN_WEIGHTS["*.logit_scale"]})
        port = build_model(CFG, 2, device="cpu")
        port.load_state_dict(state)
        x = _images()
        with torch.no_grad():
            return state, x, port.eval()(x)

    @pytest.mark.parametrize("fault", [None, "no_shift_mask"])
    def test_eval_detections_match_the_reference(self, eval_case, fault):
        state, x, got = eval_case
        ref = reference.model(CFG, "cpu", fault)
        ref.load_state_dict(state)
        with torch.no_grad():
            want = ref.eval()(x)
        assert got.shape == want.shape == (B, 36 * 36 + 18 * 18 + 9 * 9, 7)
        box_gap = float((got[..., :4] - want[..., :4]).abs().max())
        score_gap = float((got[..., 4:] - want[..., 4:]).abs().max())
        print(f"SWIN_REF fault={fault} box_gap_px={box_gap:.3g} score_gap={score_gap:.3g}")
        if fault is None:
            assert box_gap <= BOX_ATOL_PX and score_gap <= SCORE_ATOL
        else:  # the mask moves the boxes by tenths of a pixel at least
            assert box_gap > 100 * BOX_ATOL_PX


def test_train_step_matches_the_reference():
    """One step of each, the port's first, the reference built after it and
    updated a leaf at a time (the two 195M-parameter models, their
    gradients and the state take ~4 GB)."""
    state = _state(TRAIN_WEIGHTS)
    x, gt = _images(), _labels()
    lcfg = LossConfig(2, strides=(16, 32, 64))
    losses, bn, nets = {}, {}, {}
    for name, loss_fn in (("port", detection_loss), ("ref", ref_detection_loss)):
        net = nets[name] = (build_model(CFG, 2, device="cpu") if name == "port"
                            else reference.model(CFG, "cpu"))
        net.load_state_dict(state)
        net.train()
        outputs = net(x)
        loss, _ = loss_fn(outputs, *gt, [tuple(f.shape[2:]) for f in outputs[0]], 0, lcfg)
        loss.backward()
        losses[name] = float(loss.detach())
        del outputs, loss
        params = dict(net.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        if name == "port":
            opt = build_optimizer(net, SOLVER)
            opt.count = UPDATE
            opt.update(grads)
            del opt
        else:
            for k, p in params.items():
                reference.sgd_update({k: p}, {k: grads[k]}, {k: torch.zeros_like(p)},
                                     dict(SOLVER._asdict()), UPDATE)
        bn[name] = {k: b for k, b in net.named_buffers()
                    if k.startswith("neck.") and b.is_floating_point()}
    got, want = (dict(nets[n].named_parameters()) for n in ("port", "ref"))
    grad_gap, grad_at = _leaf_gap((k, got[k].grad, p.grad) for k, p in want.items())
    # an update is read as the parameter's change, whose float32 rounding is
    # one ulp of the parameter: a leaf of large entries and a small update
    # (the temperatures, ~2.3, move by ~1e-5) differs by that ulp alone
    ulp = {k: torch.finfo(torch.float32).eps * float(v.abs().max()) for k, v in state.items()}
    update_gap, update_at = _leaf_gap(
        ((k, got[k].detach() - state[k], p.detach() - state[k]) for k, p in want.items()), ulp)
    bn_gap, bn_at = _leaf_gap((k, bn["port"][k], b) for k, b in bn["ref"].items())
    loss_gap = abs(losses["port"] - losses["ref"]) / abs(losses["ref"])
    print(f"SWIN_REF loss_gap={loss_gap:.3g} grad_gap={grad_gap:.3g} ({grad_at}) "
          f"update_gap={update_gap:.3g} ({update_at}) bn_gap={bn_gap:.3g} ({bn_at})")
    assert math.isfinite(losses["ref"]) and loss_gap <= LOSS_RTOL
    assert bn["ref"] and grad_gap <= GRAD_TOL and update_gap <= UPDATE_TOL
    assert bn_gap <= BN_TOL
    # the update reached every group: a decayed temperature, a LayerNorm scale
    for k in ("backbone.stage0_block1.attn.logit_scale", "backbone.stage0_block0.norm1.weight"):
        assert not torch.equal(want[k], state[k]), k
