"""The 1 Mpx (Gen4) slice as a whole, in both packages: recordings of the
1280x720 sensor consolidated into a split (``data/gen4.py``), read by
``Gen4Dataset`` (70,000-event windows cut to 4,096 here), and one whole
train step of the shrunk paper detector (depth 0.2, width 0.125,
``num_classes=3``) at 128 px: ERGO-12 over the 921,600 pixels, letterbox
(1280x720 -> 128x72 in a 128-px frame), the separable warp with mosaic and
mixup at 1.0, TAL (epoch 5), loss, backward, SGD past its warmup, from the
same random weights; and the Evaler's decode of detections back to the
1280x720 sensor and its COCO AP over 3 classes.

Tolerances, as ``tests/test_torch_port_zoo_train.py`` holds a step (the
comparison of ``torch_port_helpers.check_zoo_step``): loss terms 1e-4
relative and equal positive anchors; gradients and parameter updates 2e-2
of each leaf's scale; BatchNorm statistics 2e-3 relative plus 1e-4. The
Evaler's inputs are one tie-free NumPy prediction stream for both
packages (a detector's scores tie exactly over the letterbox's padding
band, and no two frameworks order ties alike): detections per image equal,
AP and AP50 within 1e-6."""
import numpy as np
import pytest
import torch

from event_representation_study_tpu.data import gen4 as jax_gen4
from event_representation_study_tpu.data.loader import EventBatchLoader as JaxLoader
from event_representation_study_tpu.train.evaler import Evaler as JaxEvaler
from event_representation_study_tpu_torch.data import gen4
from event_representation_study_tpu_torch.data.loader import EventBatchLoader
from event_representation_study_tpu_torch.train import evaler
from torch_port_helpers import ZOO_STEP_PARTS, assert_close, check_zoo_step

H, W = gen4.GEN4_H, gen4.GEN4_W
IMG, B, CAP, M = 128, 4, 4096, 16
START_UPDATE, EPOCH = 1500, 5
SOLVER = dict(epochs=300, steps_per_epoch=1000)


def _recordings(root, seed: int):
    """Two recordings of 40,000 events, half of them inside the boxes of
    the label timestamp they precede; 6 label timestamps a recording, each
    with boxes of all 3 classes (60-300 px sides), one crossing the left
    edge and one under the 60-px diagonal that the consolidation drops."""
    rng = np.random.default_rng(seed)
    files = []
    for r in range(2):
        n = 40_000
        t = np.sort(rng.integers(0, 1_200_000, n))
        x, y = rng.integers(0, W, n), rng.integers(0, H, n)
        stamps = np.sort(rng.choice(np.arange(150_000, 1_200_000, 1000), 6, replace=False))
        boxes = []
        for ts in stamps:
            for c in range(3):
                bw, bh = rng.uniform(60, 300, 2)
                bx, by = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
                boxes.append([ts, bx, by, bw, bh, c])
                inside = np.flatnonzero((t <= ts) & (t > ts - 60_000))
                inside = inside[rng.random(len(inside)) < 0.5]
                x[inside] = (bx + rng.random(len(inside)) * bw).astype(int)
                y[inside] = (by + rng.random(len(inside)) * bh).astype(int)
            boxes.append([ts, -40.0, 100.0, 140.0, 90.0, 1])  # crosses the left edge
            boxes.append([ts, 600.0, 300.0, 30.0, 30.0, 2])  # diagonal 42 px: dropped
        path = root / f"rec{r}.npz"
        np.savez(path, x=x, y=y, t=t, p=rng.integers(0, 2, n) > 0, boxes=np.asarray(boxes))
        files.append(str(path))
    return files


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen4_split")
    files = _recordings(root, 3)
    gen4.consolidate_npz(files, root / "training.h5")
    gen4.consolidate_npz(files, root / "validation.h5")
    return root


def test_datasets_agree(split):
    ds = gen4.Gen4Dataset(split / "training.h5", num_events=CAP)
    jds = jax_gen4.Gen4Dataset(split / "training.h5", num_events=CAP)
    assert (ds.height, ds.width, len(ds), ds.classes) == (jds.height, jds.width, len(jds),
                                                          jds.classes) == (H, W, 12, list(
                                                              gen4.GEN4_CLASSES))
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert a.num_events == b.num_events == CAP and a.num_labels == b.num_labels == 4
        assert_close(f"window {i} events", a.events, b.events, atol=0)
        assert_close(f"window {i} labels", a.labels, b.labels, atol=0)


@pytest.fixture(scope="module")
def step_pair(split):
    """One whole train step of both packages on the first B windows."""
    import jax
    import jax.numpy as jnp

    from event_representation_study_tpu.data.augment import plan_augment_batch as jax_plan
    from event_representation_study_tpu.events import EventBlock as JaxBlock
    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu.ops.warp import AugPlan as JaxAugPlan
    from event_representation_study_tpu.parallel import train_step as jax_train_step
    from event_representation_study_tpu.train import ema as jax_ema
    from event_representation_study_tpu.train import losses as jax_losses
    from event_representation_study_tpu.train import optim as jax_optim
    from event_representation_study_tpu_torch.data.augment import plan_augment_batch
    from event_representation_study_tpu_torch.events import EventBlock
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops.image import letterbox_labels
    from event_representation_study_tpu_torch.ops.warp import AugPlan
    from event_representation_study_tpu_torch.parallel.train_step import (
        Batch, TrainState, make_train_step)
    from event_representation_study_tpu_torch.train import optim
    from event_representation_study_tpu_torch.train.ema import ema_init
    from event_representation_study_tpu_torch.train.losses import LossConfig
    from event_representation_study_tpu_torch.utils.convert import flax_to_torch, to_flax_leaves
    from torch_port_helpers import (
        _with_grad_spy, jax_leaves, port_bn_stats, random_variables, small_cfg)

    ds = gen4.Gen4Dataset(split / "training.h5", num_events=CAP)
    samples = [ds[i] for i in range(0, 2 * B, 2)]
    ev = np.stack([s.events for s in samples])
    num = np.array([s.num_events for s in samples], np.int32)
    labels = [letterbox_labels(s.labels[:s.num_labels], H, W, IMG) for s in samples]
    cfg = small_cfg()
    hd = cfg["model"]["head"]
    loss_cfg = dict(num_classes=3, strides=tuple(hd["strides"]), reg_max=hd["reg_max"],
                    iou_type=hd["iou_type"])
    hyp = dict(cfg["data_aug"], mosaic=1.0, mixup=1.0)
    plan, lab, nl = plan_augment_batch(labels, IMG, hyp, np.random.default_rng(9), M)
    plan_j, lab_j, _ = jax_plan(labels, IMG, hyp, np.random.default_rng(9), M)
    assert all(np.array_equal(plan[k], plan_j[k]) for k in plan) and np.array_equal(lab, lab_j)
    mask = (np.arange(M)[None] < nl[:, None]).astype(np.float32)

    jax_model = jax_build_model(cfg, num_classes=3)
    variables = random_variables(jax_model, jnp.zeros((1, IMG, IMG, 12)), seed=3)
    # the class preds at their init (zero kernels, prior bias -4.6), as a run starts
    for name, leaf in variables["params"]["head"].items():
        if name.startswith("cls_pred_"):
            leaf["kernel"] = np.zeros_like(leaf["kernel"])
            leaf["bias"] = np.full_like(leaf["bias"], -np.log(99.0))
    tx_j = _with_grad_spy(jax_optim.build_optimizer(variables["params"],
                                                    jax_optim.SolverConfig(**SOLVER)))
    opt0 = tx_j.init(variables["params"])
    state_j = jax_train_step.TrainState(
        variables["params"], variables["batch_stats"],
        (opt0[0]._replace(count=jnp.int32(START_UPDATE)), opt0[1]),
        jax_ema.EMAState(variables, jnp.int32(0)), jnp.int32(0))
    step_j = jax_train_step.make_train_step(
        jax_model, jax_losses.LossConfig(**loss_cfg), tx_j,
        representation="OptimizedRepresentation", rep_hw=(H, W), img_size=IMG, donate=False,
        warp_impl="separable")
    batch_j = jax_train_step.Batch(
        None, JaxBlock(*(jnp.asarray(ev[:, k]) for k in range(4)), jnp.asarray(num)),
        lab[..., 0].astype(np.int32), lab[..., 1:5], mask,
        JaxAugPlan(**{k: jnp.asarray(v) for k, v in plan.items()}))
    new_j, parts_j = step_j(state_j, batch_j, EPOCH)
    want = {"grads": jax_leaves(new_j.opt_state[1], "params"),
            "params": jax_leaves(new_j.params, "params"),
            "batch_stats": jax_leaves(new_j.batch_stats, "batch_stats"),
            "parts": {k: float(v) for k, v in parts_j.items()}}
    jax.clear_caches()

    model = build_model(cfg, 3, device="cpu")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    opt = optim.build_optimizer(model, optim.SolverConfig(**SOLVER))
    opt.count = START_UPDATE
    state = TrainState(model, opt, ema_init(model), 0)
    step = make_train_step(LossConfig(**loss_cfg), "OptimizedRepresentation", (H, W), IMG,
                           warp_impl="separable", device="cpu")
    batch = Batch(None, EventBlock(*(torch.from_numpy(ev[:, k]) for k in range(4)),
                                   torch.from_numpy(num)),
                  lab[..., 0], lab[..., 1:5], mask, AugPlan(**plan))
    state, parts = step(state, batch, EPOCH)
    got = {"grads": to_flax_leaves({n: p.grad for n, p in model.named_parameters()}),
           "params": to_flax_leaves(dict(model.named_parameters())),
           "batch_stats": port_bn_stats(model),
           "parts": {k: float(v) for k, v in parts.items()}}
    before = {**jax_leaves(variables["params"], "params"),
              **jax_leaves(variables["batch_stats"], "batch_stats")}
    return got, want, before


@pytest.mark.parametrize("part", ZOO_STEP_PARTS)
def test_gen4_train_step_like_jax(step_pair, part):
    check_zoo_step("gen4", part, *step_pair)


class _Predictions:
    """The k-th call's (B, A, 8) predictions, the same in both packages:
    boxes (cx, cy, w, h) clustered in the 128-px frame, objectness 1,
    distinct class scores over 3 classes."""

    def __init__(self):
        self.calls = 0

    def __call__(self, n_rows: int) -> np.ndarray:
        rng = np.random.default_rng(100 + self.calls)
        self.calls += 1
        a = 120
        centres = rng.uniform(20, 108, (n_rows, 6, 2))
        cxy = np.take_along_axis(centres, rng.integers(0, 6, (n_rows, a, 1)), 1)
        cxy = cxy + rng.normal(0, 3, (n_rows, a, 2))
        wh = rng.uniform(6, 30, (n_rows, a, 2))
        scores = rng.permutation(n_rows * a * 3).reshape(n_rows, a, 3) / (n_rows * a * 3)
        return np.concatenate([cxy, wh, np.ones((n_rows, a, 1)), scores], -1).astype(np.float32)


def test_evaler_decodes_1mpx_like_jax(split):
    import jax.numpy as jnp

    runs = {}
    for name in ("port", "jax"):
        preds, counts = _Predictions(), []
        if name == "port":
            ev = evaler.Evaler(torch.nn.Identity(), EventBatchLoader(
                gen4.Gen4Dataset(split, "val", num_events=CAP), B, img_size=IMG,
                shuffle=False, drop_last=False), 3, None, IMG, conf_thres=0.3, device="cpu")
            ev._eval_step = lambda v, b: torch.from_numpy(preds(len(b.gt_mask)))
            real = evaler.non_max_suppression

            def spy(p, **kw):
                out = real(p, **kw)
                counts.extend(out[1].tolist())
                return out

            evaler.non_max_suppression = spy
            try:
                stats = ev.run(None)
            finally:
                evaler.non_max_suppression = real
        else:
            ev = JaxEvaler(None, JaxLoader(jax_gen4.Gen4Dataset(split, "val", num_events=CAP), B,
                                           img_size=IMG, shuffle=False, drop_last=False),
                           3, None, IMG, conf_thres=0.3)
            ev._eval_step = lambda v, b: jnp.asarray(preds(len(b.gt_mask)))
            nms = ev._nms

            def jax_spy(p):
                out = nms(p)
                counts.extend(np.asarray(out[1]).tolist())
                return out

            ev._nms = jax_spy
            stats = ev.run(None)
        runs[name] = (stats, counts)
    (got, counts), (want, jax_counts) = runs["port"], runs["jax"]
    assert len(counts) == 12 and sum(counts) > 12
    assert_close("detections per image", counts, jax_counts, atol=0)
    for key in ("AP", "AP50"):
        assert_close(f"Evaler {key} at 1280x720", got[key], want[key], atol=1e-6)


@pytest.mark.parametrize("shape,new", [((720, 1280), 640), ((720, 1280), 128),
                                       ((240, 304), 128), ((240, 304), 640)])
def test_letterbox_resizes_like_jax(shape, new):
    """``letterbox_image`` against ``jax.image.resize``'s "linear" method:
    downsampling (1280x720 to 640 or 128, Gen1 to 128) widens the triangle
    kernel, upsampling (Gen1 to 640) is plain bilinear; within 1e-5 of the
    0..255 scale."""
    import jax.numpy as jnp

    from event_representation_study_tpu.ops.image import letterbox_image as jax_letterbox
    from event_representation_study_tpu_torch.ops.image import letterbox_image

    x = np.random.default_rng(0).random((2, *shape, 3)).astype(np.float32) * 255
    x[:, ::7] = 0.0  # sparse rows, as an event representation has
    got = letterbox_image(torch.from_numpy(x), new).numpy()
    assert_close(f"letterbox {shape} -> {new}", got, np.asarray(jax_letterbox(jnp.asarray(x), new)),
                 atol=1e-5 * 255)


def test_infer_serves_a_dat_file(tmp_path):
    """``cli/infer.py`` on a Prophesee ``.dat`` recording of the 1 Mpx sensor
    (the sensor size taken from the events, as the JAX CLI takes it), with
    3 classes: detections in sensor coordinates."""
    import pathlib

    from event_representation_study_tpu_torch.cli import infer
    from event_representation_study_tpu_torch.events.prophesee import EVENT_DTYPE, write_dat

    rng = np.random.default_rng(4)
    ev = np.zeros(20_000, EVENT_DTYPE)
    ev["x"], ev["y"] = rng.integers(0, W, len(ev)), rng.integers(0, H, len(ev))
    ev["x"][-1], ev["y"][-1] = W - 1, H - 1
    ev["t"], ev["p"] = np.sort(rng.integers(0, 10**6, len(ev))), rng.choice([-1, 1], len(ev))
    write_dat(tmp_path / "rec_td.dat", ev, H, W)
    conf = pathlib.Path(__file__).resolve().parents[1] / "configs/gen1_optimized.py"
    dets = infer.main(["--events", str(tmp_path / "rec_td.dat"), "--conf", str(conf),
                       "--device", "cpu", "--img-size", str(IMG), "--num-events", str(CAP),
                       "--conf-thres", "0.001", "--override", "model.depth_multiple=0.2",
                       "model.width_multiple=0.125", "data.num_classes=3"])
    assert dets.ndim == 2 and dets.shape[1] == 6 and len(dets) > 0 and np.isfinite(dets).all()
    assert (dets[:, [0, 2]] <= W).all() and (dets[:, [1, 3]] <= H).all()
    assert set(dets[:, 5].astype(int)) <= {0, 1, 2}
