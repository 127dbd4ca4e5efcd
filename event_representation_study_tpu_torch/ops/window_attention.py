"""Swin-V2 window attention core, from the qkv projection's output to the
output projection's input, as one autograd function (kernel K4).

For each window and head of ``qkv`` (B_, N, 3C), with C = heads x 32:
q and k divided by their norm + 1e-6, ``S = scale q̂ k̂ᵀ + bias + mask``,
a softmax over each row of S, and ``P v`` written as (B_, N, C). ``scale``
(heads,) is ``exp(clamp(logit_scale))``, ``bias`` (heads, N, N) the
continuous position bias, ``mask`` (nW, N, N) the additive shift mask of
window ``w mod nW`` or None; both are computed by the caller, whose autograd
carries their gradients on from what the backward returns.

On CUDA tensors :class:`WindowAttention` launches the hand-written kernels of
``csrc/window_attention.cu`` (forward; backward and the fixed-order sum of
the bias and scale gradients over windows) or raises. On CPU tensors it runs
their algorithm in plain PyTorch (:func:`attention_forward_plain`,
:func:`attention_backward_plain`): the saved log-sum-exp, dS, the
normalisation's Jacobian, the windows cut into the same groups and their
partial sums added in group order. ``models/swin_vit.py`` calls it only
where :func:`fused` holds; elsewhere it runs its own plain code.
"""
from __future__ import annotations

import functools

import torch

from .cuda_build import load_library

K4 = "window_attention"
K4_BACKWARD = "window_attention_backward"
# kernel launches, added to only where a kernel is launched (the backward
# counts its launch of the backward kernel and of the sum as one)
LAUNCHES = {K4: 0, K4_BACKWARD: 0}
MAX_TOKENS = 144  # 12 x 12: the kernels' tile
HEAD_DIM = 32
EPS = 1e-6
CPU_SLOTS = 132  # blocks the CPU version pretends run at once (an H100's SMs)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused(qkv: torch.Tensor, num_heads: int) -> bool:
    """Whether the kernels take a call on ``qkv`` (B_, N, 3C): a float32
    CUDA tensor, at most 144 tokens a window, head dim 32."""
    return (qkv.is_cuda and qkv.dtype == torch.float32 and qkv.shape[1] <= MAX_TOKENS
            and qkv.shape[2] == 3 * HEAD_DIM * num_heads)


@functools.lru_cache(maxsize=64)
def forward_chunk(windows: int, heads: int, positions: int, slots: int) -> int:
    """Windows a forward block walks in order: ``positions`` lists of windows
    (one a shift mask's window, or one list without a mask) are cut into
    chunks, one block per (chunk, position, head), ``slots`` at once (one an
    SM); the chunk is chosen for the fewest steps on the longest path, waves
    x (windows a block + 1 for its table of bias and mask)."""
    per = windows // positions
    best = None
    for cut in range(1, per + 1):
        chunk = -(-per // cut)
        blocks = heads * positions * -(-per // chunk)
        cost = -(-blocks // slots) * (chunk + 1)
        if best is None or cost < best[0]:
            best = (cost, chunk)
    return best[1]


@functools.lru_cache(maxsize=64)
def backward_group(windows: int, heads: int, slots: int) -> int:
    """Windows a backward block walks in order. The backward runs one block
    per (group, head), ``slots`` at once (one an SM); the group is chosen for
    the fewest windows on the longest path, waves x windows a block, and of
    equals the fewest groups. It depends on the shapes and the card only, so
    a run's sums over windows are taken in the same order every time."""
    best = None
    for cut in range(1, windows + 1):
        group = -(-windows // cut)
        blocks = -(-windows // group) * heads
        cost = -(-blocks // slots) * group
        if best is None or cost < best[0]:
            best = (cost, group)
    return best[1]


def window_attention(qkv, scale, bias, mask, num_heads: int) -> torch.Tensor:
    """``qkv`` (B_, N, 3C), ``scale`` (heads,) or (heads, 1, 1), ``bias``
    (heads, N, N), ``mask`` (nW, N, N) or None -> (B_, N, C). The log-sum-exp
    is saved only where a gradient will be asked for."""
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qkv, scale, bias))
    return WindowAttention.apply(qkv, scale.reshape(-1), bias, mask, num_heads, save)


class WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, scale, bias, mask, num_heads, save):
        qkv, scale, bias = qkv.contiguous(), scale.contiguous(), bias.contiguous()
        _check(qkv, scale, bias, mask, num_heads)
        if qkv.is_cuda:
            out, lse = _forward_cuda(qkv, scale, bias, mask, num_heads, save)
        else:
            out, lse = attention_forward_plain(qkv, scale, bias, mask, num_heads)
        if save:
            ctx.save_for_backward(qkv, scale, bias, mask, out, lse)
            ctx.num_heads = num_heads
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        qkv, scale, bias, mask, out, lse = ctx.saved_tensors
        h = ctx.num_heads
        dout = dout.contiguous()
        if dout.is_cuda:
            dqkv, dscale, dbias = _backward_cuda(qkv, out, dout, lse, scale, bias, mask, h)
        else:
            group = backward_group(qkv.shape[0], h, CPU_SLOTS)
            dqkv, dscale, dbias = attention_backward_plain(qkv, out, dout, lse, scale, bias,
                                                           mask, h, group)
        return dqkv, dscale, dbias, None, None, None


def _check(qkv, scale, bias, mask, h: int) -> None:
    B_, N, C3 = qkv.shape
    if C3 != 3 * HEAD_DIM * h or not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"qkv must be (B_, N <= {MAX_TOKENS}, 3 x {h} x {HEAD_DIM}), got "
                         f"{tuple(qkv.shape)}")
    if scale.shape != (h,) or bias.shape != (h, N, N):
        raise ValueError(f"scale must be ({h},) and bias ({h}, {N}, {N}), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    tensors = [scale, bias] + ([] if mask is None else [mask])
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (N, N)
                             or B_ % mask.shape[0] or not mask.is_contiguous()):
        raise ValueError(f"mask must be contiguous (nW, {N}, {N}) with nW dividing {B_}, got "
                         f"{tuple(mask.shape)}")
    if any(t.dtype != qkv.dtype or t.device != qkv.device for t in tensors):
        raise ValueError("qkv, scale, bias and mask must share one dtype and device")
    if qkv.is_cuda and qkv.dtype != torch.float32:
        raise ValueError(f"the kernels take float32, got {qkv.dtype}")
    if not qkv.is_cuda and qkv.device.type != "cpu":
        raise ValueError(f"no kernel for device {qkv.device}")


def _stream_call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        msg = load_library(K4).window_attention_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} ({msg})")


def _slots(device) -> int:
    """Blocks of either kernel that run at once: one an SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _forward_cuda(qkv, scale, bias, mask, h: int, save: bool):
    B_, N, C3 = qkv.shape
    lib = load_library(K4)
    out = torch.empty((B_, N, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B_, h, N), dtype=qkv.dtype, device=qkv.device) if save else None
    positions = 1 if mask is None else mask.shape[0]
    chunk = forward_chunk(B_, h, positions, _slots(qkv.device))
    with torch.cuda.device(qkv.device):
        _stream_call(lib.window_attention_fwd, qkv.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), B_, N, h,
                     0 if mask is None else mask.shape[0], chunk)
    LAUNCHES[K4] += 1
    return out, lse


def _backward_cuda(qkv, out, dout, lse, scale, bias, mask, h: int):
    B_, N, _ = qkv.shape
    lib = load_library(K4)
    dev = qkv.device
    group = backward_group(B_, h, _slots(dev))
    groups = -(-B_ // group)
    dqkv = torch.empty_like(qkv)
    dbias_part = torch.empty((groups, h, N, N), dtype=qkv.dtype, device=dev)
    dscale_part = torch.empty((groups, h), dtype=qkv.dtype, device=dev)
    dbias, dscale = torch.empty_like(bias), torch.empty_like(scale)
    with torch.cuda.device(dev):
        _stream_call(lib.window_attention_bwd, qkv.data_ptr(), out.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                     None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
                     dbias_part.data_ptr(), dscale_part.data_ptr(), dbias.data_ptr(),
                     dscale.data_ptr(), B_, N, h, 0 if mask is None else mask.shape[0], group)
    LAUNCHES[K4_BACKWARD] += 1
    return dqkv, dscale, dbias


def _split(qkv, h: int):
    """q̂, k̂, v (B_, h, N, 32) and the norms |q|, |k| (B_, h, N, 1)."""
    B_, N, C3 = qkv.shape
    q, k, v = qkv.reshape(B_, N, 3, h, C3 // (3 * h)).permute(2, 0, 3, 1, 4)
    nq = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    nk = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
    return q / (nq + EPS), k / (nk + EPS), v, nq, nk


def _scores(qh, kh, scale, bias, mask):
    s = (qh @ kh.transpose(-2, -1)) * scale[:, None, None] + bias
    if mask is not None:
        B_, h, N, _ = s.shape
        nW = mask.shape[0]
        s = (s.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(B_, h, N, N)
    return s


def attention_forward_plain(qkv, scale, bias, mask, num_heads: int):
    """The forward kernel's algorithm in plain PyTorch: (out (B_, N, C),
    log-sum-exp (B_, heads, N)). Each row: its max m, e = exp(S - m), its sum
    l, P = e / l, lse = m + log l."""
    B_, N, C3 = qkv.shape
    qh, kh, v, _, _ = _split(qkv, num_heads)
    s = _scores(qh, kh, scale, bias, mask)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    out = ((e / l) @ v).transpose(1, 2).reshape(B_, N, C3 // 3)
    return out, (m + torch.log(l)).squeeze(-1)


def _norm_backward(g, xh, nrm, dot):
    """dx for x̂ = x / (|x| + eps) from g = dL/dx̂; ``dot`` = x̂ . g a row."""
    return g / (nrm + EPS) - xh * torch.where(nrm > 0, dot / nrm, torch.zeros_like(nrm))


def attention_backward_plain(qkv, out, dout, lse, scale, bias, mask, num_heads: int,
                             group: int):
    """The backward kernels' algorithm in plain PyTorch: (dqkv, dscale
    (heads,), dbias (heads, N, N)). P from q̂, k̂ and the log-sum-exp; dS =
    P o (dP - rowsum(dO o O)); dv = Pᵀ dO; G = dS k̂, dq̂ = scale G, dk̂ =
    scale dSᵀ q̂, through the normalisation's Jacobian. dbias sums dS and
    dscale sums q̂ . G over windows: each group of ``group`` windows in window
    order, then the groups' partials in group order."""
    B_, N, C3 = qkv.shape
    h = num_heads
    qh, kh, v, nq, nk = _split(qkv, h)
    p = torch.exp(_scores(qh, kh, scale, bias, mask) - lse[..., None])
    go = dout.reshape(B_, N, h, -1).transpose(1, 2)
    o = out.reshape(B_, N, h, -1).transpose(1, 2)
    ds = p * (go @ v.transpose(-2, -1) - (go * o).sum(-1, keepdim=True))
    dv = p.transpose(-2, -1) @ go
    gk = scale[:, None, None] * (ds.transpose(-2, -1) @ qh)
    dk = _norm_backward(gk, kh, nk, (kh * gk).sum(-1, keepdim=True))
    G = ds @ kh
    dot = (qh * G).sum(-1, keepdim=True)  # (B_, h, N, 1)
    dq = _norm_backward(scale[:, None, None] * G, qh, nq, scale[:, None, None] * dot)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B_, N, C3)
    dbias = torch.zeros_like(bias)
    dscale = torch.zeros_like(scale)
    row_dots = dot.sum((2, 3))  # (B_, h)
    for g0 in range(0, B_, group):
        part_b, part_s = torch.zeros_like(bias), torch.zeros_like(scale)
        for w in range(g0, min(B_, g0 + group)):
            part_b = part_b + ds[w]
            part_s = part_s + row_dots[w]
        dbias = dbias + part_b
        dscale = dscale + part_s
    return dqkv, dscale, dbias

