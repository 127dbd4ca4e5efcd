"""The benchmark's yardstick: the card's published peaks, the precision a
run used, the least bytes of a segment reduction (K1/K2), and model FLOPs
counted on the frozen reference models at a cell's shapes.

Peaks: NVIDIA H100 SXM data sheet, dense rates; float32 outside the tensor
cores 67 TFLOP/s, TF32 495, bf16 989; HBM3 3.35 TB/s.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Optional

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def precision_in_use() -> str:
    """The arithmetic a float32 model runs in now: bfloat16 under CUDA
    autocast, TF32 when either TF32 switch is on, else float32."""
    if torch.is_autocast_enabled("cuda"):
        return "bfloat16"
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        return "tf32"
    return "float32"


def card_power() -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi`` reads them (None
    where it is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {"name": None, "power_limit": None}
    name, _, limit = out.splitlines()[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def segment_reduce_bytes(n_valid: int, rows: int, ks: int, km: int, num_segments: int) -> int:
    """The least bytes any segment reduction moves (a copy of
    ``chip_smoke.py::segment_reduce_bound``): each of the ``n_valid`` valid
    events' id and Ks+Km float32 values read once, the (rows, S, Ks+Km)
    outputs written once. The ids of padding events are not counted."""
    return 4 * (n_valid * (1 + ks + km) + rows * num_segments * (ks + km))


def segment_reduce_args(seg_s: torch.Tensor, vs: torch.Tensor, vm, num_segments: int):
    """What :func:`segment_reduce_bytes` needs from a call's arguments, the
    valid count left on the device (read after the window):
    (n_valid tensor, rows, Ks, Km, S)."""
    km = 0 if vm is None else vm.shape[1]
    return ((seg_s < num_segments).sum(), seg_s.shape[0], vs.shape[1], km, num_segments)


def bytes_of_calls(calls) -> int:
    """Total least bytes of the recorded :func:`segment_reduce_args`."""
    return sum(segment_reduce_bytes(int(n), b, ks, km, s) for n, b, ks, km, s in calls)


def forward_flops(model: torch.nn.Module, shape, train: bool) -> int:
    """FLOPs of one forward pass of ``model`` (a module on the ``meta``
    device) on an input of ``shape``, as ``torch.utils.flop_counter``
    counts them: 2 per multiply-add of every convolution, matmul and
    linear layer; nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    model.train(train)
    x = torch.empty(shape, device="meta")
    with FlopCounterMode(display=False) as counter:
        model(x)
    return int(counter.get_total_flops())
