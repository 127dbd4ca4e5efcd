"""Fused multi-column segment reduction: the port of the JAX package's
``ops/pallas_scatter.py`` (Pallas kernels ``_kernel`` and
``_kernel_sum_only``).

Pipeline per batch:
1. torch glue (:func:`sort_columns`): one stable sort by segment id (equal to
   JAX's two-key sort on (segment, position)), a gather of the per-event
   carry streams, and the value columns from ``columns_fn``.
2. :func:`segment_reduce_sorted`: per-segment sums of ``Ks`` columns and
   maxes of ``Km`` columns. On a CUDA tensor it launches the hand-written
   kernel ``csrc/fused_segment_reduce.cu`` (K1 when ``Km > 0``, K2 when
   ``Km == 0``), which finds each pixel tile's event range in the sorted ids
   itself, or raises; on a CPU tensor it runs the plain PyTorch version
   :func:`segment_reduce_sorted_plain` (``index_add_`` and
   ``scatter_reduce_("amax")``).

Padding events carry a segment id >= ``num_segments`` and are dropped.
Empty segments give sum 0 and max ``NEG_INF``; callers decide the fill.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda_build import load_library

NEG_INF = -3.4e38
KS_MAX = 32  # compiled limits of csrc/fused_segment_reduce.cu
KM_MAX = 16

K1 = "fused_segment_reduce"  # sum + max columns
K2 = "fused_segment_reduce_sum_only"
# kernel launches per kernel, added to only where the kernel is launched
LAUNCHES = {K1: 0, K2: 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sort_columns(seg, carry, columns_fn):
    """Sort glue. ``seg`` (B, N) int32 ids (invalid >= num_segments),
    ``carry`` per-event (B, N) streams that ride the sort, ``columns_fn``
    ``(sorted_pos, *sorted_carry) -> (vs (B, Ks, N), vm (B, Km, N) | None)``.
    Returns ``(seg_s, vs, vm)``."""
    seg_s, order = torch.sort(seg, dim=1, stable=True)
    carry_s = [torch.gather(c, 1, order) for c in carry]
    vs, vm = columns_fn(order.to(torch.int32), *carry_s)
    return seg_s, vs.contiguous(), None if vm is None else vm.contiguous()


def fused_segment_reduce(seg, carry, columns_fn, num_segments: int):
    """``(sums (B, S, Ks), maxes (B, S, Km) or None)``; maxes is None when
    ``columns_fn`` yields no max columns (the sum-only kernel K2)."""
    return segment_reduce_sorted(*sort_columns(seg, carry, columns_fn), num_segments)


def _check(seg_s, vs, vm) -> None:
    if vs.dim() != 3 or vs.dtype != torch.float32:
        raise ValueError(f"vs must be float32 (B, Ks, N), got {vs.dtype} {tuple(vs.shape)}")
    B, ks, n = vs.shape
    if not 1 <= ks <= KS_MAX:
        raise ValueError(f"Ks={ks} outside the compiled range 1..{KS_MAX}")
    if seg_s.dtype != torch.int32 or seg_s.shape != (B, n):
        raise ValueError(f"seg_s must be int32 {(B, n)}, got {seg_s.dtype} {tuple(seg_s.shape)}")
    tensors = [seg_s, vs]
    if vm is not None:
        if vm.dtype != torch.float32 or vm.dim() != 3 or vm.shape[::2] != (B, n):
            raise ValueError(f"vm must be float32 (B, Km, N), got {vm.dtype} {tuple(vm.shape)}")
        if vm.shape[1] > KM_MAX:
            raise ValueError(f"Km={vm.shape[1]} above the compiled limit Km <= {KM_MAX}")
        tensors.append(vm)
    if any(t.device != vs.device for t in tensors):
        raise ValueError("seg_s, vs and vm must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("seg_s, vs and vm must be contiguous")


def segment_reduce_sorted(
    seg_s, vs, vm: Optional[torch.Tensor], num_segments: int
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-segment sums of ``vs`` and maxes of ``vm`` over events whose
    ids ``seg_s`` (B, N) int32 are sorted ascending in every row."""
    _check(seg_s, vs, vm)
    if vm is not None and vm.shape[1] == 0:
        vm = None
    if vs.is_cuda:
        return _launch(seg_s, vs, vm, num_segments)
    if vs.device.type != "cpu":
        raise ValueError(f"no kernel for device {vs.device}")
    return segment_reduce_sorted_plain(seg_s, vs, vm, num_segments)


def _launch(seg_s, vs, vm, num_segments: int):
    B, ks, n = vs.shape
    km = 0 if vm is None else vm.shape[1]
    lib = load_library("fused_segment_reduce")
    sums = torch.empty((B, num_segments, ks), dtype=torch.float32, device=vs.device)
    maxes = (
        torch.empty((B, num_segments, km), dtype=torch.float32, device=vs.device)
        if km else None
    )
    with torch.cuda.device(vs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_segment_reduce(
            seg_s.data_ptr(), vs.data_ptr(), vm.data_ptr() if km else None,
            sums.data_ptr(), maxes.data_ptr() if km else None,
            B, n, num_segments, ks, km, stream,
        )
    if err:
        msg = lib.fused_segment_reduce_error_string(err).decode()
        raise RuntimeError(f"fused_segment_reduce launch failed: CUDA error {err} ({msg})")
    LAUNCHES[K1 if km else K2] += 1
    return sums, maxes


def segment_reduce_sorted_plain(seg_s, vs, vm, num_segments: int):
    """Plain PyTorch version of the kernel: ``index_add_`` for the sums and
    ``scatter_reduce_("amax")`` over a ``NEG_INF``-filled output for the
    maxes. Ids >= ``num_segments`` go to a dropped trash row."""
    B, ks, n = vs.shape
    S = num_segments
    rows = torch.arange(B, device=vs.device)[:, None] * (S + 1)
    idx = (seg_s.to(torch.int64).clamp_max(S) + rows).reshape(-1)
    sums = torch.zeros((B * (S + 1), ks), dtype=torch.float32, device=vs.device)
    sums.index_add_(0, idx, vs.transpose(1, 2).reshape(B * n, ks))
    sums = sums.view(B, S + 1, ks)[:, :S].contiguous()
    if vm is None:
        return sums, None
    km = vm.shape[1]
    maxes = torch.full((B * (S + 1), km), NEG_INF, dtype=torch.float32, device=vs.device)
    maxes.scatter_reduce_(
        0, idx[:, None].expand(-1, km), vm.transpose(1, 2).reshape(B * n, km),
        "amax", include_self=True,
    )
    return sums, maxes.view(B, S + 1, km)[:, :S].contiguous()
