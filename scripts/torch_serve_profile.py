"""Where a serve request's time goes on a CUDA card: device busy time and
idle share per stage of the port's serving path, from a torch.profiler trace.

Builds the full-width ``configs/gen1_optimized.py`` server as chip_smoke.py
does (8 fake Gen1 windows of 50,000 events per request, 640², float32, cuDNN
TF32 off), then:
- ``request``: REQUESTS requests exactly as ``Server.__call__`` runs them;
- ``stage``: one request split at its stage boundaries (h2d, ergo12,
  letterbox, detector, nms), with a device synchronise around each stage so
  its kernels run inside its window.
Busy time is the union of the CUDA kernel intervals inside a window; idle
share is 1 - busy / window. One JSON line each, then the card line.

    python3 scripts/torch_serve_profile.py
"""
import json
import pathlib
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the same fake requests and weights)

REQUESTS = 3


def union_us(intervals, lo, hi) -> float:
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from event_representation_study_tpu_torch.cli.infer import make_server
    from event_representation_study_tpu_torch.ops.image import letterbox_image
    from event_representation_study_tpu_torch.ops.nms import non_max_suppression
    from event_representation_study_tpu_torch.utils.config import load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = load_config("configs/gen1_optimized.py")
    serve = make_server(cfg, "OptimizedRepresentation", chip_smoke.H, chip_smoke.W,
                        chip_smoke.IMG, 0.03, device="cuda")
    chip_smoke.randomize_preds_(serve.model, torch.Generator(device=dev).manual_seed(1))
    reqs = [chip_smoke.fake_batch(100 + 10 * r) for r in range(REQUESTS)]
    for blk in reqs[:2]:  # warm-up: cuDNN algorithm choice, kernel build and load
        serve(blk)[1].tolist()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, blk in enumerate(reqs):
            with record_function(f"request_{i}"):
                serve(blk)[1].tolist()
        torch.cuda.synchronize()
        with torch.inference_mode():
            with record_function("stage_h2d"):
                blk = reqs[0].to(dev)
                torch.cuda.synchronize()
            with record_function("stage_ergo12"):
                rep = serve.rep_fn(blk)
                torch.cuda.synchronize()
            with record_function("stage_letterbox"):
                x = (letterbox_image(rep, chip_smoke.IMG) / 255.0).permute(0, 3, 1, 2)
                torch.cuda.synchronize()
            with record_function("stage_detector"):
                preds = serve.model(x)
                torch.cuda.synchronize()
            with record_function("stage_nms"):
                non_max_suppression(preds, conf_thres=0.03)[1].tolist()

    events = prof.events()
    marks = ("request_", "stage_")  # record_function ranges, mirrored on the device
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith(marks)]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    windows = {e.name: (e.time_range.start, e.time_range.end) for e in events
               if e.device_type != cuda and e.name.startswith(marks)}
    for name, (lo, hi) in sorted(windows.items(), key=lambda kv: kv[1][0]):
        busy = union_us(spans, lo, hi)
        print(json.dumps({"window": name, "wall_ms": (hi - lo) / 1e3,
                          "device_busy_ms": busy / 1e3,
                          "idle_share": 1.0 - busy / (hi - lo) if hi > lo else None,
                          "kernels": sum(1 for s, _ in spans if lo <= s < hi)}), flush=True)
    per_name = {}
    for e in kernels:
        per_name[e.name[:80]] = per_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    print(json.dumps({"top_device_kernels_ms_total": {k: v / 1e3 for k, v in top}}), flush=True)
    print(json.dumps({"device_events": len(spans), "tf32": chip_smoke.tf32_state()}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
