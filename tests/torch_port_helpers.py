"""Shared parts of the PyTorch-port parity tests (tests/test_torch_port_*.py):
the comparison that reports its error, a shrunk paper config, random JAX
detector variables drawn with numpy, and the detector and serve pairs built
on them."""
import functools
import json
import os

import numpy as np
import torch

CFG_PATH = "configs/gen1_optimized.py"
SMALL = ["model.depth_multiple=0.2", "model.width_multiple=0.125"]


def assert_close(what: str, got, want, atol: float, rtol: float = 0.0) -> None:
    """``np.testing.assert_allclose`` (``assert_array_equal`` when both
    tolerances are 0) that first prints the max abs error on a
    ``PARITY {...}`` line. ``pytest -rP`` shows the lines of passing tests:

        JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_*.py -rP | grep PARITY
    """
    got, want = np.asarray(got), np.asarray(want)
    err = (float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
           if got.shape == want.shape and got.size else None)
    test = os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0]
    print("PARITY " + json.dumps({"test": test, "what": what, "max_abs_err": err,
                                  "rtol": rtol, "atol": atol}))
    if rtol == 0 and atol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def small_cfg():
    from event_representation_study_tpu.utils.config import load_config

    return load_config(CFG_PATH, overrides=SMALL)


def random_jax_variables(jax_model, img_size: int, channels: int = 12, seed: int = 1):
    """Every leaf of the JAX Detector's {"params", "batch_stats"} drawn from
    numpy: kernels N(0, 1/fan_in), BN scales/variances and residual scales
    U(0.5, 1.5), biases and means N(0, 0.1^2). The pred convs start at zero
    weights, so initial weights would prove nothing about them."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        functools.partial(jax_model.init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, img_size, img_size, channels)),
    )
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var", "alpha"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: tree[k] for k in ("params", "batch_stats")}


DET_IMG = 128


def detector_pair():
    """(jax_model, variables, port model, NHWC input) on the same weights."""
    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch

    cfg = small_cfg()
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jax_model, DET_IMG)
    model = build_model(cfg, num_classes=2, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    x = np.random.default_rng(0).normal(size=(2, DET_IMG, DET_IMG, 12)).astype(np.float32)
    return jax_model, variables, model, x


# a square sensor fills the letterboxed image: uniform padding would give
# many anchors exactly tied scores, whose NMS order no framework promises
SERVE = dict(H=64, W=64, CAP=2048, IMG=128, CONF=0.3, REP="OptimizedRepresentation")


def serve_pair():
    """Fake windows through the JAX serve path (batched_representation +
    letterbox_image + model.apply + non_max_suppression, as cli/infer.py
    composes them) and the port's make_server(device="cpu") on the same
    converted weights. Returns (got, want, server): [rep, preds, dets, n]."""
    import jax

    from event_representation_study_tpu.events import from_structured as jax_from_structured
    from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu.ops.image import letterbox_image as jax_letterbox
    from event_representation_study_tpu.ops.nms import non_max_suppression as jax_nms
    from event_representation_study_tpu.reps.dispatch import (
        batched_representation as jax_batched_representation,
    )
    from event_representation_study_tpu_torch.cli import infer
    from event_representation_study_tpu_torch.events import (
        from_structured,
        generate_fake_events,
        stack_blocks,
    )
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch

    c = SERVE
    cfg = small_cfg()
    evs = [generate_fake_events(n, height=c["H"], width=c["W"], duration_us=200_000, seed=s)
           for n, s in [(1800, 21), (3000, 22)]]  # the second keeps its last CAP
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jax_model, c["IMG"])
    rep_fn = jax_batched_representation(c["REP"], c["H"], c["W"])

    @jax.jit
    def jax_serve(blocks):
        rep = rep_fn(blocks)
        preds = jax_model.apply(variables, jax_letterbox(rep, c["IMG"]) / 255.0, False)
        return (rep, preds) + tuple(jax_nms(preds, conf_thres=c["CONF"]))

    want = [np.asarray(a) for a in jax_serve(
        jax_stack_blocks([jax_from_structured(e, c["CAP"]) for e in evs]))]
    server = infer.make_server(cfg, c["REP"], c["H"], c["W"], c["IMG"], c["CONF"], device="cpu")
    server.model.load_state_dict(flax_to_torch(variables), strict=True)
    got = [a.numpy() for a in server.run(stack_blocks([from_structured(e, c["CAP"]) for e in evs]))]
    return got, want, server


def train_outputs(jax_model, variables, model, x):
    """Train-mode (BatchNorm on batch statistics) outputs of both:
    (stem feats NHWC, cls_scores, reg_distri) as numpy, port then JAX."""
    import jax

    want = jax.jit(
        lambda v, a: jax_model.apply(v, a, True, mutable=["batch_stats"])[0]
    )(variables, x)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = ([f.permute(0, 2, 3, 1).numpy() for f in got[0]], got[1].numpy(), got[2].numpy())
    want = ([np.asarray(f) for f in want[0]], np.asarray(want[1]), np.asarray(want[2]))
    return got, want


def eval_outputs(jax_model, variables, model, x):
    """Eval-mode decoded (B, A, 5+nc) of both as numpy, port then JAX."""
    import jax

    want = np.asarray(jax.jit(lambda v, a: jax_model.apply(v, a, False))(variables, x))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    return got, want
