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

The reduction is registered as the operator
``torch.ops.ers.segment_reduce_sorted`` (:func:`_reduce_op`): its fake
version gives the output shapes, so ``torch.export`` records K1/K2 as one
node of a serving graph (``utils/export.py``), and a loaded graph calls the
same implementation, which launches the kernel on a CUDA tensor (counting
the launch) and runs the plain version on a CPU tensor.

The kernel is compiled for at most ``KS_MAX`` sum and ``KM_MAX`` max
columns. Wider tables (a 12-channel MDES table of variances needs 36 sum
columns) are cut into column groups that fit (:func:`column_groups`), each
reduced over the same sorted ids, and the outputs concatenated: columns are
independent, so the result is the same as one wide reduction.

Padding events carry a segment id >= ``num_segments`` and are dropped.
Empty segments give sum 0 and max ``NEG_INF``; callers decide the fill.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from .cuda_build import load_library

NEG_INF = -3.4e38
KS_MAX = 32  # compiled limits of csrc/fused_segment_reduce.cu, per launch
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
    if ks < 1:
        raise ValueError(f"Ks={ks}: the reduction needs at least one sum column")
    if seg_s.dtype != torch.int32 or seg_s.shape != (B, n):
        raise ValueError(f"seg_s must be int32 {(B, n)}, got {seg_s.dtype} {tuple(seg_s.shape)}")
    tensors = [seg_s, vs]
    if vm is not None:
        if vm.dtype != torch.float32 or vm.dim() != 3 or vm.shape[::2] != (B, n):
            raise ValueError(f"vm must be float32 (B, Km, N), got {vm.dtype} {tuple(vm.shape)}")
        tensors.append(vm)
    if any(t.device != vs.device for t in tensors):
        raise ValueError("seg_s, vs and vm must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("seg_s, vs and vm must be contiguous")


def column_groups(ks: int, km: int) -> List[Tuple[range, range]]:
    """The (sum columns, max columns) of each launch: as few launches as
    ``KS_MAX`` and ``KM_MAX`` allow, the columns spread evenly over them.
    A table within the limits is one group."""
    n = max(math.ceil(ks / KS_MAX), math.ceil(km / KM_MAX), 1)

    def split(k):
        q, r = divmod(k, n)
        starts = [i * q + min(i, r) for i in range(n + 1)]
        return [range(starts[i], starts[i + 1]) for i in range(n)]

    return list(zip(split(ks), split(km)))


def segment_reduce_sorted(
    seg_s, vs, vm: Optional[torch.Tensor], num_segments: int
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-segment sums of ``vs`` and maxes of ``vm`` over events whose
    ids ``seg_s`` (B, N) int32 are sorted ascending in every row."""
    _check(seg_s, vs, vm)
    if vm is not None and vm.shape[1] == 0:
        vm = None
    if not (vs.is_cuda or vs.device.type == "cpu"):
        raise ValueError(f"no kernel for device {vs.device}")

    def reduce(seg_s, vs, vm, num_segments):
        sums, maxes = _reduce_op(seg_s, vs, vm, num_segments)
        return sums, maxes if vm is not None else None

    groups = column_groups(vs.shape[1], 0 if vm is None else vm.shape[1])
    if len(groups) == 1:
        return reduce(seg_s, vs, vm, num_segments)
    sums, maxes = [], []
    for s_cols, m_cols in groups:
        # every launch needs a sum column: a group without one reduces
        # column 0 again and drops it
        g_vs = vs[:, s_cols.start:s_cols.stop] if len(s_cols) else vs[:, :1]
        g_vm = vm[:, m_cols.start:m_cols.stop].contiguous() if len(m_cols) else None
        g_sums, g_maxes = reduce(seg_s, g_vs.contiguous(), g_vm, num_segments)
        if len(s_cols):
            sums.append(g_sums)
        if g_maxes is not None:
            maxes.append(g_maxes)
    return torch.cat(sums, dim=2), torch.cat(maxes, dim=2) if maxes else None


@torch.library.custom_op("ers::segment_reduce_sorted", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _reduce_op(seg_s: torch.Tensor, vs: torch.Tensor, vm: Optional[torch.Tensor],
               num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch's reduction: the kernel for a CUDA tensor, the plain
    version for a CPU tensor. The maxes are (B, S, 0) without ``vm``."""
    if vs.is_cuda:
        sums, maxes = _launch(seg_s, vs, vm, num_segments)
    else:
        sums, maxes = segment_reduce_sorted_plain(seg_s, vs, vm, num_segments)
    if maxes is None:
        maxes = sums.new_empty((vs.shape[0], num_segments, 0))
    return sums, maxes


@_reduce_op.register_fake
def _(seg_s, vs, vm, num_segments):
    km = 0 if vm is None else vm.shape[1]
    return (vs.new_empty((vs.shape[0], num_segments, vs.shape[1])),
            vs.new_empty((vs.shape[0], num_segments, km)))


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
