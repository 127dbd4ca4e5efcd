"""Per-row dynamic slice ("roll"): the port of the JAX package's
``ops/pallas_roll.py`` (Pallas kernel ``_roll_kernel``, K3).

``roll_rows(x, starts, w_out)[b, r] = x[b, r, s : s + w_out, :]`` with
``s = clamp(starts[b, r], 0, W_in - w_out)``: the semantics of the JAX
package's ``roll_rows_xla`` (a gather in CLIP mode). Its Pallas twin clamps
after padding W to a multiple of 8, so for ``W_in % 8 != 0`` and starts
past ``W_in - w_out`` it reads the pad; that quirk is not carried over.

On a CUDA tensor :func:`roll_rows` launches the hand-written kernel
``csrc/roll_rows.cu`` or raises; on a CPU tensor it runs the plain PyTorch
version :func:`roll_rows_plain`.
"""
from __future__ import annotations

import torch

from .cuda_build import load_library

K3 = "roll_rows"
# kernel launches, added to only where the kernel is launched
LAUNCHES = {K3: 0}


def reset_launches() -> None:
    LAUNCHES[K3] = 0


def _check(x, starts, w_out: int) -> None:
    if x.dim() != 4 or x.element_size() not in (4, 2) or not x.is_floating_point():
        raise ValueError(f"x must be a (B, R, W, C) float tensor of 4- or 2-byte "
                         f"elements, got {x.dtype} {tuple(x.shape)}")
    if starts.dtype != torch.int32 or starts.shape != x.shape[:2]:
        raise ValueError(f"starts must be int32 {tuple(x.shape[:2])}, got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    if not 1 <= w_out <= x.shape[2]:
        raise ValueError(f"w_out={w_out} outside 1..W_in={x.shape[2]}")
    if starts.device != x.device:
        raise ValueError("x and starts must share one device")
    if not (x.is_contiguous() and starts.is_contiguous()):
        raise ValueError("x and starts must be contiguous")


def roll_rows(x: torch.Tensor, starts: torch.Tensor, w_out: int) -> torch.Tensor:
    """``x`` (B, R, W_in, C), ``starts`` (B, R) int32 -> (B, R, w_out, C)."""
    _check(x, starts, w_out)
    if x.is_cuda:
        return _launch(x, starts, w_out)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return roll_rows_plain(x, starts, w_out)


def _launch(x, starts, w_out: int):
    B, R, w_in, C = x.shape
    lib = load_library(K3)
    out = torch.empty((B, R, w_out, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.roll_rows(x.data_ptr(), starts.data_ptr(), out.data_ptr(),
                            B * R, w_in, w_out, C, x.element_size(), stream)
    if err:
        msg = lib.roll_rows_error_string(err).decode()
        raise RuntimeError(f"roll_rows launch failed: CUDA error {err} ({msg})")
    LAUNCHES[K3] += 1
    return out


def roll_rows_plain(x: torch.Tensor, starts: torch.Tensor, w_out: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one ``torch.gather`` along W with
    an index expanded over the channels."""
    B, R, w_in, C = x.shape
    s = starts.to(torch.int64).clamp(0, w_in - w_out)
    idx = s[..., None] + torch.arange(w_out, device=x.device)
    return torch.gather(x, 2, idx[..., None].expand(B, R, w_out, C))
