"""Where a train step's time goes on a CUDA card: device busy time and idle
share of the port's train step, from a torch.profiler trace.

Builds the full-width ``configs/gen1_optimized.py`` train state and batches
as chip_smoke.py's train phase does (8 fake Gen1 windows of 50,000 events,
640², the paper's strong augmentation through the separable warp, float32,
cuDNN TF32 off), takes 2 warm-up steps, then profiles STEPS steps exactly as
``train_step`` runs them (epoch 5, TAL). Busy time is the union of the CUDA
kernel intervals inside a step's window; idle share is 1 - busy / window.
One JSON line per step, the largest device kernels, then the card line.

    python3 scripts/torch_train_profile.py
"""
import json
import pathlib
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the same train state and batches)
from chip_smoke import union_us  # noqa: E402

STEPS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, step, batches, _ = chip_smoke.train_setup(torch.device("cuda"), STEPS + 2)
    for b in batches[:2]:  # warm-up: cuDNN algorithm choice, kernel build and load
        state, parts = step(state, b, 5)
        parts["loss"].item()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, b in enumerate(batches[2:]):
            with record_function(f"step_{i}"):
                state, parts = step(state, b, 5)
                parts["loss"].item()
                torch.cuda.synchronize()

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("step_")]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    windows = {e.name: (e.time_range.start, e.time_range.end) for e in events
               if e.device_type != cuda and e.name.startswith("step_")}
    for name, (lo, hi) in sorted(windows.items(), key=lambda kv: kv[1][0]):
        busy = union_us(spans, lo, hi)
        print(json.dumps({"window": name, "wall_ms": (hi - lo) / 1e3,
                          "device_busy_ms": busy / 1e3,
                          "idle_share": 1.0 - busy / (hi - lo) if hi > lo else None,
                          "kernels": sum(1 for s, _ in spans if lo <= s < hi)}), flush=True)
    per_name = {}
    for e in kernels:
        per_name[e.name[:80]] = per_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    print(json.dumps({"top_device_kernels_ms_total": {k: v / 1e3 for k, v in top},
                      "steps": STEPS}), flush=True)
    print(json.dumps({"device_events": len(spans), "tf32": chip_smoke.tf32_state()}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
