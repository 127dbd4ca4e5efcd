"""Where the image-folder train step's forward + loss goes on a CUDA card,
against the event step's: forward + loss and backward of the full-width
paper detector (CUDA-event ms, the median of 5 replays after 2 warm-ups) on

- 3 batches of 8 RGB tiles from ``ImageBatchLoader`` over a synthetic folder
  (``write_image_folder``, frames around 240x304, the config's recipe) at
  640², as the loader gives them (256 label slots: 32 a tile x 4 mosaic
  tiles x 2 mixup partners), and cut to 64 slots (every valid label kept);
- each of those with a contiguous NCHW model input in place of the step's
  NCHW view of NHWC memory;
- chip_smoke.py's event train batches (8 x 50,000 events, 64 label slots),
  both input layouts.

One ``FWD_SPLIT {...}`` line, then the card line. float32, TF32 off.

    python3 scripts/torch_image_step_split.py
"""
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the same configs, batches and train state)

REPLAYS = 5


def cut(batch, slots: int):
    from event_representation_study_tpu_torch.parallel.train_step import Batch

    return Batch(batch.images, batch.events, batch.gt_labels[:, :slots],
                 batch.gt_bboxes[:, :slots], batch.gt_mask[:, :slots], batch.aug)


def forward_backward_ms(state, step, batches, dev, nchw=False, reps=REPLAYS):
    """Median CUDA-event ms of forward + loss and of backward over ``reps``
    replays of ``step``'s stages on ``batches`` in turn."""
    from event_representation_study_tpu_torch.parallel.train_step import batch_on_device

    out = []
    for r in range(reps):
        batch = batch_on_device(batches[r % len(batches)], dev)
        imgs = step.images_of(batch)
        if nchw:
            imgs = imgs.contiguous()
        torch.cuda.synchronize()
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        state.model.zero_grad(set_to_none=True)
        loss, _ = step.loss_fn(state.model, imgs, batch, 5)
        e1.record()
        loss.backward()
        e2.record()
        torch.cuda.synchronize()
        out.append((e0.elapsed_time(e1), e1.elapsed_time(e2)))
    return {"forward_loss": statistics.median(o[0] for o in out),
            "backward": statistics.median(o[1] for o in out)}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from event_representation_study_tpu_torch.data.image_dataset import write_image_folder
    from event_representation_study_tpu_torch.models import build_model
    from event_representation_study_tpu_torch.ops import cuda_build
    from event_representation_study_tpu_torch.parallel.train_step import (
        init_train_state, make_train_step)
    from event_representation_study_tpu_torch.train.optim import build_optimizer
    from event_representation_study_tpu_torch.utils.config import load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    dev = torch.device("cuda")
    cfg = load_config("configs/gen1_optimized.py", overrides=["data.type=images"])
    with tempfile.TemporaryDirectory() as tmp:
        write_image_folder(tmp, n=3 * cs.B, seed=0, h_range=cs.IMAGES_HW[0],
                           w_range=cs.IMAGES_HW[1], tasks=("train",))
        batches, _ = cs.image_batches(pathlib.Path(tmp), 3, dict(cfg["data_aug"]))
    short = [cut(b, 64) for b in batches]
    assert all(b.gt_mask[:, 64:].sum() == 0 for b in batches), "a label past 64 slots"
    model = build_model(cfg, cfg["data"]["num_classes"], num_channels=3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    cs.randomize_preds_(model, torch.Generator(device=dev).manual_seed(6), which="reg_pred")
    state = init_train_state(model, build_optimizer(model, cs.solver_config(cfg)))
    step = make_train_step(cs.loss_config(cfg), None, (cs.IMG, cs.IMG), cs.IMG,
                           warp_impl="separable", device=dev)
    forward_backward_ms(state, step, batches, dev, reps=2)  # warm-up
    res = {"images_256_slots": forward_backward_ms(state, step, batches, dev),
           "images_64_slots": forward_backward_ms(state, step, short, dev),
           "images_256_slots_nchw": forward_backward_ms(state, step, batches, dev, nchw=True),
           "images_64_slots_nchw": forward_backward_ms(state, step, short, dev, nchw=True)}
    del state, model, step
    torch.cuda.empty_cache()
    state, step, batches, _ = cs.train_setup(dev, 3)
    forward_backward_ms(state, step, batches, dev, reps=2)
    res["events_64_slots"] = forward_backward_ms(state, step, batches, dev)
    res["events_64_slots_nchw"] = forward_backward_ms(state, step, batches, dev, nchw=True)
    print("FWD_SPLIT " + json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
