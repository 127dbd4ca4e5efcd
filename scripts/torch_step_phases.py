"""chip_smoke.py's train phases alone, for an A/B of two trees on one
card: builds the kernels, warms the card with ERGO-12, then runs the
phases named after the tree's tag, of the ``chip_smoke.py`` in the current
directory, and prints their lines: ``steps`` (the default) runs
``multi_step_phase`` and ``bf16_train_phase`` (``multi_step``,
``bf16_train``, ...), ``gen4`` runs ``gen4_phase`` (``gen4_train``, ...).
Run it from each tree's root in turn, e.g. parent, change, change, parent
in one call:

    for t in parent change change parent; do
        (cd "$t" && python3 /path/to/scripts/torch_step_phases.py "$t" steps gen4); done
"""
import pathlib
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path.cwd()))
    import chip_smoke as cs
    from event_representation_study_tpu_torch.ops import cuda_build
    from event_representation_study_tpu_torch.reps import fused_mdes
    from event_representation_study_tpu_torch.reps.ergo12 import (
        AGGREGATIONS, FUNCTIONS, WINDOW_INDEXES)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    blocks = cs.fake_batch(0).to("cuda")
    for _ in range(5):  # the card's clocks ramp up before anything is timed
        fused_mdes.ergo12_fused_batched(blocks, cs.H, cs.W)
    torch.cuda.synchronize()
    dev = torch.device("cuda")
    phases = sys.argv[2:] or ["steps"]
    if "steps" in phases:
        state, batches, loss, _ = cs.multi_step_phase(dev)
        cs.bf16_train_phase(dev, state, batches, loss)
        del state, batches
        torch.cuda.empty_cache()
    if "gen4" in phases:
        # ERGO-12's count columns, as chip_smoke.main computes them
        plan = fused_mdes._plan(WINDOW_INDEXES, FUNCTIONS, AGGREGATIONS)
        cs.gen4_phase(dev, [i for i, c in enumerate(plan[0]) if c[0] == "cnt"])
    print("PHASES_DONE", sys.argv[1] if len(sys.argv) > 1 else pathlib.Path.cwd().name,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
