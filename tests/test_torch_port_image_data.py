"""Image-folder data in the port (``data/image_dataset.py``, the image
helpers of ``data/augment.py``, the Trainer's ``data.type=images`` path)
against the JAX package on the same inputs: a synthetic folder written by
``write_image_folder`` (RGB frames of mixed sizes, one box each, one
background-only image a split).

Tolerances: the augment helpers, the dataset's samples and the loaders'
batches (images, labels, masks, indices, AugPlan) exactly (the same NumPy,
scipy and cv2 calls on the same generator states); the warped model input
2e-3 on the 0..255 scale (the separable warp's float32 arithmetic, as in
test_torch_port_warp.py). The train step on image batches is held in
test_torch_port_image_step.py.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.data import augment as jax_augment
from event_representation_study_tpu.data import image_dataset as jax_images
from event_representation_study_tpu.ops import warp as jax_warp
from event_representation_study_tpu_torch.data import augment, image_dataset
from event_representation_study_tpu_torch.ops import warp
from torch_port_helpers import assert_close, small_cfg

S = 64
HYP = dict(small_cfg()["data_aug"], mosaic=1.0, mixup=1.0)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_folder")
    boxes = image_dataset.write_image_folder(root, n=8, seed=0)
    return root, boxes


def _helper_outputs(name):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (48, 56, 3)).astype(np.float32)
    labels = np.array([[0, 4.0, 6.0, 30.0, 28.0], [1, 20.0, 10.0, 50.0, 44.0]], np.float32)
    tiles = [rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
             for h, w in ((30, 40), (40, 30), (32, 32), (20, 36))]
    out = {}
    for pkg, mod in (("port", augment), ("jax", jax_augment)):
        if name == "random_affine":
            out[pkg] = mod.random_affine(img, labels, HYP["degrees"], HYP["translate"],
                                         HYP["scale"], HYP["shear"], (40, 44), random.Random(5))
        elif name == "mixup":
            out[pkg] = mod.mixup(img, labels, img[::-1] * 0.5, labels[:1],
                                 np.random.default_rng(3))
        elif name == "flip_augment":
            r = random.Random(2)
            out[pkg] = [mod.flip_augment(img, labels[:, [0, 1, 2, 3, 4]] / 64.0, 0.5, 0.5, r)
                        for _ in range(6)]
        else:
            labs = [labels.copy(), labels[:1].copy(), np.zeros((0, 5), np.float32), labels.copy()]
            out[pkg] = mod.mosaic_augmentation(32, tiles, labs, random.Random(7))
    return out["port"], out["jax"]


@pytest.mark.parametrize("name", ["random_affine", "mixup", "flip_augment",
                                  "mosaic_augmentation"])
def test_augment_helpers_equal_jax(name):
    got, want = _helper_outputs(name)
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(f"{name} output {i}", g, w, atol=0)


@pytest.mark.parametrize("task", ["train", "val"])
def test_dataset_samples_equal_jax(folder, task):
    root, boxes = folder
    got = image_dataset.ImageFolderDataset(root, task=task, img_size=S, cache_ram=True)
    want = jax_images.ImageFolderDataset(root, task=task, img_size=S, cache_ram=True)
    assert len(got) == len(want) == 8 and got.height == got.width == S
    assert got._shape_cache == want._shape_cache
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g.image.shape[:2] == boxes[got.img_paths[i].stem][:2]
        assert_close(f"{task} image {i}", g.image, w.image, atol=0)
        assert_close(f"{task} labels {i}", g.labels, w.labels, atol=0)
        assert (g.num_labels, g.index) == (w.num_labels, w.index)
    assert got[7].num_labels == 0 and got[0].image is got[0].image  # background; RAM cache


def _loader_pair(root, kind):
    kw = (dict(batch_size=4, shuffle=False, drop_last=False) if kind == "val" else
          dict(batch_size=2, shuffle=True, seed=3, hyp=HYP, partner_pool=2))
    task = "val" if kind == "val" else "train"
    return (image_dataset.ImageBatchLoader(
                image_dataset.ImageFolderDataset(root, task=task, img_size=S, max_labels=4),
                img_size=S, **kw),
            jax_images.ImageBatchLoader(
                jax_images.ImageFolderDataset(root, task=task, img_size=S, max_labels=4),
                img_size=S, **kw))


@pytest.fixture(scope="module")
def batches(folder):
    root, _ = folder
    return {kind: tuple(list(loader) for loader in _loader_pair(root, kind))
            for kind in ("val", "augment")}


@pytest.mark.parametrize("kind", ["val", "augment"])
def test_loader_batches_equal_jax(batches, kind):
    got, want = batches[kind]
    assert len(got) == len(want) == (2 if kind == "val" else 4)
    for b, ((g, gi), (w, wi)) in enumerate(zip(got, want)):
        assert_close(f"{kind} batch {b} indices", gi, wi, atol=0)
        for field in ("images", "gt_labels", "gt_bboxes", "gt_mask"):
            assert_close(f"{kind} batch {b} {field}", getattr(g, field), getattr(w, field),
                         atol=0)
        assert g.events is None and w.events is None
        if kind == "val":
            assert g.aug is None and w.aug is None and g.images.max() <= 1.0
            continue
        assert g.images.shape == (4, S, S, 3) and g.gt_labels.shape[0] == 2  # B + pool tiles
        for field in g.aug._fields:
            assert_close(f"{kind} batch {b} aug.{field}", getattr(g.aug, field),
                         getattr(w.aug, field), atol=0)


def test_warped_input_matches_jax(batches):
    """The separable warp of the 0..255 tiles (K3's plain version here), the
    step's model input before /255, with the labelled rows kept."""
    for b, (g, _) in enumerate(batches["augment"][0]):
        got = warp.compose_warp_separable(torch.from_numpy(g.images), g.aug.to("cpu"), S)
        want = jax_warp.compose_warp_separable(
            jnp.asarray(g.images), jax_warp.AugPlan(*map(jnp.asarray, g.aug)), S)
        n = g.gt_labels.shape[0]
        assert_close(f"warped batch {b}", got[:n].numpy(), np.asarray(want)[:n], atol=2e-3)


def test_trainer_epoch_on_images(folder, tmp_path):
    """The port's Trainer on the folder (data.type=images, --augment): a
    3-channel stem, the image executor with the separable warp, an epoch and
    an evaluation with a finite AP and a checkpoint."""
    from event_representation_study_tpu_torch.train.engine import Trainer

    root, _ = folder
    cfg = small_cfg()
    cfg["data"] = dict(cfg["data"], type="images", cache_ram=True)
    tr = Trainer(cfg, root, batch_size=2, epochs=1, img_size=S, output_dir=tmp_path / "run",
                 eval_interval=1, augment=True, device="cpu")
    assert tr.representation is None and tr.aug_mode == "image"
    assert tr.warp_impl == "separable"
    assert tr.model.backbone.stem.conv.weight.shape[1] == 3
    tr.train()
    assert tr.state.step == len(tr.train_loader) == 4
    assert (tmp_path / "run" / "last_ckpt").exists()
    assert np.isfinite(tr.evaler.run(tr.state.ema.variables)["AP"])
