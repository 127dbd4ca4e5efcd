"""Shared parts of the PyTorch-port parity tests (tests/test_torch_port_*.py):
the comparison that reports its error, a shrunk paper config, random JAX
detector variables drawn with numpy, the detector and serve pairs built on
them, and a NumPy stand-in for the search's BNN surrogate.

Importing this module sets torch to one intra-op thread, for the whole
process. The test lane runs six xdist workers on the machine's cores; torch's
default of one thread per core in each of them starves the other workers'
torch and JAX work (the trainer file read 690.5 s in the lane against
36.2 s alone). Every worker imports every test module while it collects, and a
process spawned by :class:`SpawnedGroup` imports this module to unpickle
its target, so the policy holds for each of them before their first test.
A port test file imports its helpers from here; one that imports nothing
from here runs on torch's default threads only when it runs alone. A file
whose float32 reading at one thread exceeds its bound takes torch's
default back with :func:`default_torch_threads` and says which reading."""
import functools
import json
import os

import numpy as np
import pytest
import torch

TORCH_DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)

CFG_PATH = "configs/gen1_optimized.py"
SMALL = ["model.depth_multiple=0.2", "model.width_multiple=0.125"]


def assert_close(what: str, got, want, atol: float, rtol: float = 0.0) -> None:
    """``np.testing.assert_allclose`` (``assert_array_equal`` when both
    tolerances are 0) that first prints the max abs error on a
    ``PARITY {...}`` line. ``pytest -rP`` shows the lines of passing tests:

        JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_*.py -rP | grep PARITY
    """
    got, want = np.asarray(got), np.asarray(want)
    if got.shape == want.shape and got.size:
        g, w = got.astype(np.float64), want.astype(np.float64)
        with np.errstate(invalid="ignore"):  # equal infinities count as 0
            err = float(np.abs(np.where(g == w, 0.0, g - w)).max())
    else:
        err = None
    test = os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0]
    print("PARITY " + json.dumps({"test": test, "what": what, "max_abs_err": err,
                                  "rtol": rtol, "atol": atol}))
    if rtol == 0 and atol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def flax_to_torch_shapes(shapes):
    """State-dict names and shapes of ``convert.flax_to_torch`` from a tree
    of leaves with a ``shape`` (``jax.ShapeDtypeStruct``s), allocating
    nothing."""
    from event_representation_study_tpu_torch.utils.convert import _converted

    zero = np.float32(0)
    return {name: () if arr is None else tuple(arr.shape)
            for name, arr in _converted(shapes, lambda v: np.broadcast_to(zero, v.shape))}


def small_cfg():
    from event_representation_study_tpu.utils.config import load_config

    return load_config(CFG_PATH, overrides=SMALL)


def random_jax_variables(jax_model, img_size: int, channels: int = 12, seed: int = 1):
    """Every leaf of the JAX Detector's {"params", "batch_stats"} drawn from
    numpy (:func:`random_variables`)."""
    import jax.numpy as jnp

    return random_variables(jax_model, jnp.zeros((1, img_size, img_size, channels)), seed=seed)


def random_variables(jax_module, *inputs, seed: int = 1, **init_kwargs):
    """Every leaf of a Flax module's {"params", "batch_stats"} at the given
    inputs drawn from numpy: kernels N(0, 1/fan_in), BN scales/variances and
    residual scales U(0.5, 1.5), biases, means and the rest N(0, 0.1^2).
    The pred convs start at zero weights, so initial weights would prove
    nothing about them."""
    import jax

    shapes = jax.eval_shape(functools.partial(jax_module.init, **init_kwargs),
                            jax.random.PRNGKey(0), *inputs)
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
    return {k: tree[k] for k in ("params", "batch_stats") if k in tree}


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


@pytest.fixture(scope="module")
def default_torch_threads():
    """torch's default intra-op threads (one a core) while a test module that
    uses this fixture runs, one thread again after it."""
    torch.set_num_threads(TORCH_DEFAULT_THREADS)
    yield
    torch.set_num_threads(1)


# -- the search (tests/test_torch_port_search_*.py) --------------------------

SEARCH_DRAWS = 24


def _option_blocks(option_counts):
    off = np.concatenate([[0], np.cumsum(option_counts)]).astype(int)
    return [(off[d], off[d + 1]) for d in range(len(option_counts))]


def fake_categorical(observations, option_counts):
    """(draws, obs, total) float32 kernels peaked at each observation's
    options, with noise seeded by the number of observations."""
    X = np.asarray(observations)
    rng = np.random.default_rng(1000 + len(X))
    logits = rng.normal(0.0, 1.0, (SEARCH_DRAWS, len(X), int(sum(option_counts))))
    out = np.zeros_like(logits)
    for d, (a, b) in enumerate(_option_blocks(option_counts)):
        logits[:, np.arange(len(X)), a + X[:, d]] += 2.5
        e = np.exp(logits[..., a:b])
        out[..., a:b] = e / e.sum(-1, keepdims=True)
    return out.astype(np.float32)


def fake_mixed(cat_obs, option_counts, cont_obs, n_continuous):
    X = np.asarray(cont_obs, np.float64)
    rng = np.random.default_rng(2000 + len(X))
    cat = fake_categorical(cat_obs, option_counts) if len(option_counts) else \
        np.zeros((SEARCH_DRAWS, len(X), 0), np.float32)
    locs = np.clip(X[None] + rng.normal(0, 0.05, (SEARCH_DRAWS,) + X.shape), 0, 1)
    sqrt_prec = 4.0 + 2.0 * rng.random((SEARCH_DRAWS,) + X.shape)
    return cat, locs.astype(np.float32), sqrt_prec.astype(np.float32)


@pytest.fixture
def fake_surrogates(monkeypatch):
    """Both packages' ``bnn.fit_categorical_kernels`` and
    ``bnn.fit_mixed_kernels`` (looked up at call time in both) replaced by
    one NumPy function of the observations: the same draws in JAX and in
    the port, whose generators differ."""
    from event_representation_study_tpu.search import bnn as j_bnn
    from event_representation_study_tpu_torch.search import bnn as t_bnn

    for mod in (j_bnn, t_bnn):
        monkeypatch.setattr(mod, "fit_categorical_kernels",
                            lambda _seed, obs, counts, **kw: fake_categorical(obs, counts))
        monkeypatch.setattr(mod, "fit_mixed_kernels",
                            lambda _seed, c, counts, x, nc, **kw: fake_mixed(c, counts, x, nc))


# -- the detector zoo (tests/test_torch_port_zoo_*.py) ------------------------


def nchw(x):
    """NHWC numpy -> NCHW tensor view."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    """NCHW tensor -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def close_to_scale(what, got, want, rel=1e-4):
    """assert_close at ``rel`` of the largest magnitude of ``want``."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert_close(what, got, want, atol=rel * float(np.abs(want).max()) + 1e-6)


def port_bn_stats(module):
    """The port module's BatchNorm statistics as flat Flax leaves."""
    from event_representation_study_tpu_torch.utils.convert import to_flax_leaves

    return {k: v for k, v in to_flax_leaves(module.state_dict()).items()
            if k.startswith("batch_stats/")}


def jax_leaves(tree, prefix):
    """A nested JAX/NumPy tree as flat ``prefix/a/b/leaf`` arrays."""
    import jax

    return {prefix + "/" + "/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def compare_stats(what, port_module, jax_stats):
    """The port's BatchNorm statistics against JAX's updated ones (1e-4
    relative plus 1e-5)."""
    got, want = port_bn_stats(port_module), jax_leaves(jax_stats, "batch_stats")
    assert set(got) == set(want) and want
    for k in want:
        assert_close(f"{what} {k}", got[k], want[k], atol=1e-5, rtol=1e-4)


def zoo_pair(name, width, img, seed=1):
    """Eval decodes of the shrunk config ``name`` (depth 0.2, ``width``) on
    one random (2, img, img, 12) input: {"jax_<dtype>": array,
    "port_<dtype>": tensor} for float32 and bfloat16, one set of weights."""
    import jax
    import jax.numpy as jnp

    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.utils.config import load_config
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch

    cfg = load_config(f"configs/{name}.py", overrides=[
        "model.depth_multiple=0.2", f"model.width_multiple={width}"])
    jm = jax_build_model(cfg, num_classes=2)
    x = np.random.default_rng(0).normal(size=(2, img, img, 12)).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), seed=seed)
    out = {}
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jmd = jax_build_model(cfg, num_classes=2, dtype=jdtype)
        out[f"jax_{dtype}"] = np.asarray(jax.jit(lambda v, a: jmd.apply(v, a, False))(
            variables, x))
        model = build_model(cfg, 2, device="cpu", dtype=dtype)
        model.load_state_dict(flax_to_torch(variables), strict=True)
        with torch.no_grad():
            out[f"port_{dtype}"] = model.eval()(nchw(x))
    return out


def bf16_errors(out):
    """Mean absolute errors (boxes, scores) of each bf16 output against its
    framework's float32 output, and the direct port-vs-JAX statistics."""
    pf, pb = out[f"port_{torch.float32}"].numpy(), out[f"port_{torch.bfloat16}"].numpy()
    jf, jb = out[f"jax_{torch.float32}"], out[f"jax_{torch.bfloat16}"]

    def mean(a, b, sl):
        return float(np.abs(a[..., sl] - b[..., sl]).mean())

    box, cls = slice(0, 4), slice(5, None)
    d_box = np.abs(pb[..., box] - jb[..., box])
    d_cls = np.abs(pb[..., cls] - jb[..., cls])
    return {
        "range": float(np.abs(jf[..., box]).max()),
        "port": (mean(pb, pf, box), mean(pb, pf, cls)),
        "jax": (mean(jb, jf, box), mean(jb, jf, cls)),
        "direct": (float(d_box.mean()), float(np.quantile(d_box, 0.99)), float(d_cls.mean()),
                   float(d_cls.max())),
    }


def check_bf16(name, out):
    """The bf16 rules of the zoo tests: float32 decoded boxes, the port's
    mean error against its float32 output within 2x JAX's (plus 1e-3 of
    the box range, 1e-4 in scores), and the direct port-vs-JAX bounds."""
    got = out[f"port_{torch.bfloat16}"]
    assert got.dtype == torch.float32
    boxes = got[..., :4]
    # boxes decoded in float32, not rounded to bf16
    assert float((boxes.to(torch.bfloat16).to(torch.float32) == boxes).float().mean()) < 0.5
    e = bf16_errors(out)
    floor = (1e-3 * e["range"], 1e-4)
    for i, what in enumerate(("boxes", "scores")):
        assert_close(f"{name} bf16 {what}: port mean err vs f32 (atol: 2 x JAX's + floor)",
                     e["port"][i], 0.0, atol=2 * e["jax"][i] + floor[i])
    box_mean, box_p99, cls_mean, cls_max = e["direct"]
    assert_close(f"{name} bf16 port vs JAX boxes mean / range", box_mean / e["range"], 0.0,
                 atol=5e-3)
    assert_close(f"{name} bf16 port vs JAX boxes p99 / range", box_p99 / e["range"], 0.0,
                 atol=8e-2)
    assert_close(f"{name} bf16 port vs JAX scores mean", cls_mean, 0.0, atol=2e-2)
    assert_close(f"{name} bf16 port vs JAX scores max", cls_max, 0.0, atol=0.5)


# -- a whole train step of a zoo config (tests/test_torch_port_zoo_train*.py)

ZOO_STEP = dict(H=64, IMG=128, CAP=2048, M=16, START_UPDATE=1500, EPOCH=5,
                SOLVER=dict(epochs=300, steps_per_epoch=1000))


def _with_grad_spy(tx):
    """An optax transform whose state also carries the last gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)

    return optax.GradientTransformation(init, update)


def zoo_step_pair(config: str, batch: int = 4):
    """One whole train step (ERGO-12, letterbox, separable warp with mosaic
    and mixup at 1.0, TAL at epoch 5, SGD past its warmup) of the config
    shrunk to depth 0.2 / width 0.125 at 128 px, on ``batch`` windows, in
    both packages from the same random weights and batch: (port, jax,
    before) as flat Flax-path dicts of grads, params, batch_stats and the
    loss parts."""
    import jax
    import jax.numpy as jnp

    from event_representation_study_tpu.data.augment import plan_augment_batch as jax_plan
    from event_representation_study_tpu.events import from_structured as jax_from_structured
    from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu.ops.warp import AugPlan as JaxAugPlan
    from event_representation_study_tpu.parallel import train_step as jax_train_step
    from event_representation_study_tpu.train import ema as jax_ema
    from event_representation_study_tpu.train import losses as jax_losses
    from event_representation_study_tpu.train import optim as jax_optim
    from event_representation_study_tpu_torch.data.augment import plan_augment_batch
    from event_representation_study_tpu_torch.events import (
        from_structured, generate_fake_events, stack_blocks)
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops.image import letterbox_labels
    from event_representation_study_tpu_torch.ops.warp import AugPlan
    from event_representation_study_tpu_torch.parallel.train_step import (
        Batch, TrainState, make_train_step)
    from event_representation_study_tpu_torch.train import optim
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.losses import LossConfig
    from event_representation_study_tpu_torch.utils.config import load_config
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves

    c = ZOO_STEP
    H = W = c["H"]
    IMG, B, CAP, M = c["IMG"], batch, c["CAP"], c["M"]
    cfg = load_config(f"configs/{config}.py",
                      overrides=["model.depth_multiple=0.2", "model.width_multiple=0.125"])
    hd = cfg["model"]["head"]
    loss_cfg = dict(num_classes=2, strides=tuple(hd["strides"]), reg_max=hd["reg_max"],
                    iou_type=hd["iou_type"])
    jax_model = jax_build_model(cfg, num_classes=2)
    variables = random_variables(jax_model, jnp.zeros((1, IMG, IMG, 12)), seed=3)
    # the class preds at their init (zero kernels, prior bias -4.6), as a run
    # starts: random ones put every score near 0.5, and the varifocal loss's
    # gradient then swamps the step in float32 noise
    for name, leaf in variables["params"]["head"].items():
        if name.startswith("cls_pred_"):
            leaf["kernel"] = np.zeros_like(leaf["kernel"])
            leaf["bias"] = np.full_like(leaf["bias"], -np.log(99.0))
    rng = np.random.default_rng(11)
    evs = [generate_fake_events(1500, H, W, 50_000, seed=30 + i) for i in range(B)]
    labels = []
    for _ in range(B):
        xywh = np.concatenate([rng.uniform(0.25, 0.75, (2, 2)), rng.uniform(0.15, 0.4, (2, 2))], 1)
        norm = np.concatenate([rng.integers(0, 2, (2, 1)), xywh], 1).astype(np.float32)
        labels.append(letterbox_labels(norm, H, W, IMG))
    hyp = dict(cfg["data_aug"], mosaic=1.0, mixup=1.0)
    plan, lab, nl = plan_augment_batch(labels, IMG, hyp, np.random.default_rng(9), M)
    plan_j, _, _ = jax_plan(labels, IMG, hyp, np.random.default_rng(9), M)
    assert all(np.array_equal(plan[k], plan_j[k]) for k in plan)
    mask = (np.arange(M)[None] < nl[:, None]).astype(np.float32)

    tx_j = _with_grad_spy(jax_optim.build_optimizer(variables["params"],
                                                    jax_optim.SolverConfig(**c["SOLVER"])))
    opt0 = tx_j.init(variables["params"])
    state_j = jax_train_step.TrainState(
        variables["params"], variables["batch_stats"],
        (opt0[0]._replace(count=jnp.int32(c["START_UPDATE"])), opt0[1]),
        jax_ema.EMAState(variables, jnp.int32(0)), jnp.int32(0))
    step_j = jax_train_step.make_train_step(
        jax_model, jax_losses.LossConfig(**loss_cfg), tx_j,
        representation="OptimizedRepresentation", rep_hw=(H, W), img_size=IMG, donate=False,
        warp_impl="separable")
    batch_j = jax_train_step.Batch(
        None, jax_stack_blocks([jax_from_structured(e, CAP) for e in evs]),
        lab[..., 0].astype(np.int32), lab[..., 1:5], mask,
        JaxAugPlan(**{k: jnp.asarray(v) for k, v in plan.items()}))
    new_j, parts_j = step_j(state_j, batch_j, c["EPOCH"])
    want = {"grads": jax_leaves(new_j.opt_state[1], "params"),
            "params": jax_leaves(new_j.params, "params"),
            "batch_stats": jax_leaves(new_j.batch_stats, "batch_stats"),
            "parts": {k: float(v) for k, v in parts_j.items()}}

    model = build_model(cfg, 2, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    opt = optim.build_optimizer(model, optim.SolverConfig(**c["SOLVER"]))
    opt.count = c["START_UPDATE"]
    state = TrainState(model, opt, ema_init(model), 0)
    step = make_train_step(LossConfig(**loss_cfg), "OptimizedRepresentation", (H, W), IMG,
                           warp_impl="separable", device="cpu")
    batch = Batch(None, stack_blocks([from_structured(e, CAP) for e in evs]), lab[..., 0],
                  lab[..., 1:5], mask, AugPlan(**plan))
    state, parts = step(state, batch, c["EPOCH"])
    got = {"grads": to_flax_leaves({n: p.grad for n, p in model.named_parameters()}),
           "params": to_flax_leaves(dict(model.named_parameters())),
           "batch_stats": port_bn_stats(model),
           "parts": {k: float(v) for k, v in parts.items()}}
    before = {**jax_leaves(variables["params"], "params"),
              **jax_leaves(variables["batch_stats"], "batch_stats")}
    return got, want, before


def _leafwise(got, want, minus=None):
    """The largest difference of a leaf over its largest JAX entry plus 1e-3
    of the largest over all leaves. With ``minus`` (the parameters before
    the step) the updates are compared, less one float32 ulp of each
    parameter: storing p + u rounds the update by up to that much."""
    ulp = {k: 0.0 for k in want}
    if minus is not None:
        ulp = {k: np.spacing(np.abs(minus[k]).astype(np.float32)) for k in want}
        got = {k: got[k] - minus[k] for k in want}
        want = {k: want[k] - minus[k] for k in want}
    top = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.maximum(np.abs(got[k] - want[k]) - ulp[k], 0.0).max())
               / (float(np.abs(want[k]).max()) + 1e-3 * top) for k in want)


def check_zoo_step(name, part, got, want, before):
    """One comparison of :func:`zoo_step_pair`'s outputs: loss terms 1e-4
    relative and equal positive anchors; gradients and parameter updates
    2e-2 over each leaf's scale; BatchNorm statistics 2e-3 relative plus
    1e-4."""
    if part == "loss_terms":
        for k in ("loss", "cls", "iou", "dfl"):
            assert_close(f"{name} {k}", got["parts"][k], want["parts"][k], atol=0, rtol=1e-4)
        assert got["parts"]["num_pos"] == want["parts"]["num_pos"] > 0
    elif part == "gradients":
        assert set(got["grads"]) == set(want["grads"])
        assert_close(f"{name} gradients / leaf scale", _leafwise(got["grads"], want["grads"]),
                     0.0, atol=2e-2)
    elif part == "updated_parameters":
        assert set(got["params"]) == set(want["params"])
        assert_close(f"{name} parameter update / leaf scale",
                     _leafwise(got["params"], want["params"], before), 0.0, atol=2e-2)
    else:
        assert part == "batch_statistics"
        assert set(got["batch_stats"]) == set(want["batch_stats"])
        for k in want["batch_stats"]:
            assert_close(f"{name} {k}", got["batch_stats"][k], want["batch_stats"][k],
                         atol=1e-4, rtol=2e-3)


ZOO_STEP_PARTS = ("loss_terms", "gradients", "updated_parameters", "batch_statistics")


# -- a whole train step of each training variant (tests/test_torch_port_step_*.py)

VARIANT_STEP = dict(H=64, IMG=128, B=4, CAP=2048, M=8, START_UPDATE=1500, MAX_EPOCH=10,
                    SOLVER=dict(epochs=300, steps_per_epoch=1000))
# mode -> (train-step mode, epoch, extra overrides): fuse-ab at a TAL epoch,
# the plain distillation at an ATSS epoch (the ns student assigns by TAL at
# any epoch), the learned representation at a TAL epoch
VARIANTS = {
    "fuseab": ("fuseab", 5, []),
    "distill": ("distill", 2, []),
    "distill_ns": ("distill", 2, ["model.type=YOLOv6s"]),
    "learned": ("plain", 5, ["data.representation=LearnedRepresentation",
                             "data.height=64", "data.width=64"]),
}


def variant_step_pair(variant: str):
    """One whole train step of a training variant of the shrunk paper
    detector (depth 0.2, width 0.125) at 128 px on 4 inputs, in both
    packages from the same random weights and batch: ``variant`` is
    "fuseab", "distill" (with ``distill_feat``), "distill_ns" (a YOLOv6s
    student) or "learned" (raw events of a 64 x 64 sensor into the
    quantization layer); the others feed random 0..1 images. The teacher
    of a distillation is the student's weights plus noise (the reference
    distils from a trained teacher; two unrelated random networks put the
    feature KD's spatial softmax in a cliff regime). Returns (port, jax,
    before) as :func:`zoo_step_pair` does, plus the port teacher's
    BatchNorm statistics before and after the step under "teacher_bn"."""
    import jax
    import jax.numpy as jnp

    from event_representation_study_tpu.events import from_structured as jax_from_structured
    from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu.parallel import train_step as jax_train_step
    from event_representation_study_tpu.train import ema as jax_ema
    from event_representation_study_tpu.train import losses as jax_losses
    from event_representation_study_tpu.train import optim as jax_optim
    from event_representation_study_tpu_torch.events import (
        from_structured, generate_fake_events, stack_blocks)
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.parallel.train_step import (
        Batch, TrainState, make_train_step)
    from event_representation_study_tpu_torch.train import optim
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.losses import LossConfig
    from event_representation_study_tpu_torch.utils.config import load_config
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves

    c = VARIANT_STEP
    mode, epoch, extra = VARIANTS[variant]
    H = W = c["H"]
    IMG, B, M = c["IMG"], c["B"], c["M"]
    cfg = load_config(CFG_PATH, overrides=SMALL + extra)
    hd = cfg["model"]["head"]
    loss_cfg = dict(num_classes=2, strides=tuple(hd["strides"]), reg_max=hd["reg_max"],
                    iou_type=hd["iou_type"])
    learned = variant == "learned"
    rep = "LearnedRepresentation" if learned else None
    kw = dict(fuse_ab=variant == "fuseab", distill_ns=variant == "distill_ns")
    jax_model = jax_build_model(cfg, num_classes=2, representation=rep, img_size=IMG, **kw)
    rng = np.random.default_rng(11)
    if learned:
        evs = [generate_fake_events(1500, H, W, 50_000, seed=30 + i) for i in range(B)]
        x_j = jax_stack_blocks([jax_from_structured(e, c["CAP"]) for e in evs])
        x_p = stack_blocks([from_structured(e, c["CAP"]) for e in evs])
    else:
        x_j = rng.uniform(0, 1, (B, IMG, IMG, 12)).astype(np.float32)
        x_p = x_j
    variables = random_variables(jax_model, x_j, seed=3, train=True)
    # the class preds at their init, as in zoo_step_pair
    for name, leaf in variables["params"]["head"].items():
        if name.startswith("cls_pred_"):
            leaf["kernel"] = np.zeros_like(leaf["kernel"])
            leaf["bias"] = np.full_like(leaf["bias"], -np.log(99.0))
    xy = rng.uniform(8, 70, (B, M, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 55, (B, M, 2))], -1).astype(np.float32)
    labels = rng.integers(0, 2, (B, M)).astype(np.int32)
    mask = (np.arange(M)[None] < rng.integers(2, M + 1, (B, 1))).astype(np.float32)

    teacher_j = teacher_p = None
    if mode == "distill":
        t_model = jax_build_model(cfg, num_classes=2)
        t_rng = np.random.default_rng(5)
        # a plain student has the teacher's tree: no second init trace
        t_base = (variables if variant == "distill"
                  else random_variables(t_model, x_j, seed=3, train=True))
        t_vars = jax.tree_util.tree_map_with_path(
            lambda path, v: v + 0.1 * float(np.std(v)) * t_rng.normal(size=v.shape).astype(
                np.float32) if path[-1].key not in ("var",) else v, t_base)
        teacher_j = (t_model, t_vars)
        teacher_p = build_model(cfg, 2, device="cpu")
        teacher_p.load_state_dict(flax_to_torch(t_vars), strict=True)

    tx_j = _with_grad_spy(jax_optim.build_optimizer(variables["params"],
                                                    jax_optim.SolverConfig(**c["SOLVER"])))
    opt0 = tx_j.init(variables["params"])
    state_j = jax_train_step.TrainState(
        variables["params"], variables["batch_stats"],
        (opt0[0]._replace(count=jnp.int32(c["START_UPDATE"])), opt0[1]),
        jax_ema.EMAState(variables, jnp.int32(0)), jnp.int32(0))
    # no EMA on either side: the step tests compare gradients, parameters
    # and statistics (test_torch_port_train_step.py holds the EMA)
    step_j = jax_train_step.make_train_step(
        jax_model, jax_losses.LossConfig(**loss_cfg), tx_j, representation=rep, rep_hw=(H, W),
        img_size=IMG, donate=False, mode=mode, teacher=teacher_j, max_epoch=c["MAX_EPOCH"],
        distill_feat=True, update_ema=False)
    batch_j = jax_train_step.Batch(None if learned else x_j, x_j if learned else None,
                                   labels, boxes, mask)
    new_j, parts_j = step_j(state_j, batch_j, epoch)
    want = {"grads": jax_leaves(new_j.opt_state[1], "params"),
            "params": jax_leaves(new_j.params, "params"),
            "batch_stats": jax_leaves(new_j.batch_stats, "batch_stats"),
            "parts": {k: float(v) for k, v in parts_j.items()}}

    model = build_model(cfg, 2, device="cpu", representation=rep, img_size=IMG, **kw)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    opt = optim.build_optimizer(model, optim.SolverConfig(**c["SOLVER"]))
    opt.count = c["START_UPDATE"]
    state = TrainState(model, opt, ema_init(model), 0)
    step = make_train_step(LossConfig(**loss_cfg), rep, (H, W), IMG, mode=mode, device="cpu",
                           teacher=teacher_p, max_epoch=c["MAX_EPOCH"], distill_feat=True,
                           update_ema=False)
    batch = Batch(None if learned else x_p, x_p if learned else None, labels, boxes, mask)
    t_bn0 = None if teacher_p is None else {k: v.clone() for k, v in teacher_p.state_dict().items()}
    state, parts = step(state, batch, epoch)
    got = {"grads": to_flax_leaves({n: p.grad for n, p in model.named_parameters()}),
           "params": to_flax_leaves(dict(model.named_parameters())),
           "batch_stats": port_bn_stats(model),
           "parts": {k: float(v) for k, v in parts.items()}}
    if teacher_p is not None:
        got["teacher_state"] = (t_bn0, teacher_p.state_dict())
    before = {**jax_leaves(variables["params"], "params"),
              **jax_leaves(variables["batch_stats"], "batch_stats")}
    return got, want, before


# A distillation step's class KD: the student's class preds start at their
# init, so its scores are uniform and each row's KL is the difference of two
# terms of size ~d that leaves ~2 d^2 (d the teacher's softmax offset from
# 1/2 at T = 20); float32 rounding of the logs moves it by up to ~1e-3
# relative (3.5e-4 measured between the packages, 4e-6 in float64 on their
# teacher scores). It, and the class loss that holds it, are held to 1e-3;
# the total loss to 1e-4 like every other term.
KD_CLS_STEP_RTOL = 1e-3


def check_variant_step(name, part, got, want, before):
    """:func:`check_zoo_step`, with each variant's own loss terms (the ab
    branch's, the KD terms) beside the base terms: 1e-4 relative, the class
    KD and the class loss of a distillation step 1e-3
    (``KD_CLS_STEP_RTOL``)."""
    if part != "loss_terms":
        return check_zoo_step(name, part, got, want, before)
    distill = "kd_cls" in want["parts"]
    for k in want["parts"]:
        if k.endswith("num_pos"):
            assert got["parts"][k] == want["parts"][k] > 0, k
        else:
            rtol = KD_CLS_STEP_RTOL if distill and k in ("cls", "kd_cls") else 1e-4
            assert_close(f"{name} {k}", got["parts"][k], want["parts"][k], atol=1e-7,
                         rtol=rtol)
    assert set(got["parts"]) == set(want["parts"])


# -- a train step on an image-folder batch (tests/test_torch_port_image_step*.py)

IMAGE_STEP = dict(S=64, EPOCH=0, START_UPDATE=1500, SOLVER=dict(epochs=300, steps_per_epoch=1000))


def image_step_batch(root):
    """The first batch (4 tiles, a partner pool of 2, the paper recipe with
    mosaic and mixup at 1.0) of the port's ImageBatchLoader over a
    ``write_image_folder`` train split at 64 px."""
    from event_representation_study_tpu_torch.data import image_dataset

    s = IMAGE_STEP["S"]
    image_dataset.write_image_folder(root, n=8, seed=0, tasks=("train",))
    loader = image_dataset.ImageBatchLoader(
        image_dataset.ImageFolderDataset(root, task="train", img_size=s, max_labels=4), 4,
        img_size=s, shuffle=True, seed=3,
        hyp=dict(small_cfg()["data_aug"], mosaic=1.0, mixup=1.0), partner_pool=2)
    return next(iter(loader))[0]


def image_step_models(dtype):
    """(loss config kwargs, JAX variables, JAX model, port model): the
    shrunk paper detector at 3 channels computing in ``dtype`` in both
    packages, from the same random weights (the class preds at their
    init)."""
    import jax
    import jax.numpy as jnp

    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch

    cfg = small_cfg()
    hd = cfg["model"]["head"]
    loss_kw = dict(num_classes=2, strides=tuple(hd["strides"]), reg_max=hd["reg_max"],
                   iou_type=hd["iou_type"])
    s = IMAGE_STEP["S"]
    variables = random_variables(jax_build_model(cfg, num_classes=2), jnp.zeros((1, s, s, 3)),
                                 seed=3)
    for name, leaf in variables["params"]["head"].items():
        if name.startswith("cls_pred_"):
            leaf["kernel"] = np.zeros_like(leaf["kernel"])
            leaf["bias"] = np.full_like(leaf["bias"], -np.log(99.0))
    variables = jax.tree.map(lambda a: np.asarray(a, dtype), variables)
    jax_model = jax_build_model(cfg, num_classes=2, dtype=jnp.dtype(dtype))
    model = build_model(cfg, 2, num_channels=3, device="cpu")
    model.load_state_dict(flax_to_torch(jax.tree.map(np.copy, variables)), strict=True)
    return loss_kw, variables, jax_model, model.to(getattr(torch, np.dtype(dtype).name))


def jax_image_step(jax_model, loss_kw, variables, batch_j):
    """The JAX package's train step (separable warp, no EMA, SGD past its
    warmup) on ``batch_j``: (gradients as flat Flax paths, loss parts)."""
    import jax.numpy as jnp

    from event_representation_study_tpu.parallel import train_step as jax_train_step
    from event_representation_study_tpu.train import ema as jax_ema
    from event_representation_study_tpu.train import losses as jax_losses
    from event_representation_study_tpu.train import optim as jax_optim

    c = IMAGE_STEP
    tx_j = _with_grad_spy(jax_optim.build_optimizer(variables["params"],
                                                    jax_optim.SolverConfig(**c["SOLVER"])))
    opt0 = tx_j.init(variables["params"])
    state_j = jax_train_step.TrainState(
        variables["params"], variables["batch_stats"],
        (opt0[0]._replace(count=jnp.int32(c["START_UPDATE"])), opt0[1]),
        jax_ema.EMAState(variables, jnp.int32(0)), jnp.int32(0))
    step_j = jax_train_step.make_train_step(
        jax_model, jax_losses.LossConfig(**loss_kw), tx_j, representation=None,
        rep_hw=(c["S"], c["S"]), img_size=c["S"], donate=False, warp_impl="separable",
        update_ema=False)
    new_j, parts_j = step_j(state_j, batch_j, c["EPOCH"])
    return jax_leaves(new_j.opt_state[1], "params"), {k: float(v) for k, v in parts_j.items()}


# -- process groups (tests/test_torch_port_{event_shard,dist,ddp_step,tensor_parallel}.py) --

GROUP_TIMEOUT_S = 600  # a spawned group's whole run, start to results, under a loaded lane


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_worker(fn, rank, world, port, join, queue, kwargs):
    """One rank (torch on one thread, as this module's import set it): a
    gloo group over ``tcp://`` through the port's ``init_distributed``
    (unless ``join`` is false: then ``fn`` gets the free ``port`` to make
    its own), then ``fn(rank, world, **kwargs)``; puts (rank, result) or
    (rank, the traceback)."""
    import datetime
    import traceback

    try:
        from event_representation_study_tpu_torch.parallel.dist import init_distributed

        if join:
            got = init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                                   timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
            assert got == (rank, world), got
        else:
            kwargs = dict(kwargs, port=port)
        queue.put((rank, fn(rank, world, **kwargs)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise


class SpawnedGroup:
    """``world`` spawned processes, each a rank of a gloo group running
    ``fn(rank, world, **kwargs)`` (``fn`` importable without JAX: a
    module-level function of a test module whose JAX imports sit inside
    its fixtures). Start it, do the JAX side meanwhile, then
    :meth:`results` waits: the list of each rank's return value."""

    def __init__(self, fn, world: int = 2, join: bool = True, **kwargs):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_group_worker,
                                  args=(fn, r, world, port, join, self.queue, kwargs))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        import queue as queue_mod

        out = {}
        try:
            for _ in self.procs:  # drain before joining
                rank, res = self.queue.get(timeout=GROUP_TIMEOUT_S)
                if isinstance(res, str) and res.startswith("Traceback"):
                    raise AssertionError(f"rank {rank} failed:\n{res}")
                out[rank] = res
        except queue_mod.Empty:
            raise AssertionError(f"the group gave no result in {GROUP_TIMEOUT_S} s") from None
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        return [out[r] for r in range(len(self.procs))]
