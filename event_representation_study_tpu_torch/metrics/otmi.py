"""The OTMI quadrant protocol (port of the JAX package's ``metrics/otmi.py``;
the reference is representations/representation_search/
compute_otmi.py:96-211), host orchestration with the kernel math of
:mod:`.gw` on the device.

Protocol, with the reference's boundary conventions and shifted-coordinate
masks:
1. split the sensor into 4 quadrants (asymmetric >= / > bounds,
   compute_otmi.py:109-133);
2. drop the densest quadrant (:134-135);
3. for each other quadrant: min-shift x, y (quadrants 2-4, :139-147),
   normalize x, y by (dim-1)//2, t and p to [0, 1]; keep the events whose
   shifted coordinates lie below the half-sensor (:164-173);
4. crop the representation to the matching quadrant (with the reference's
   off-by-one overlap), append x/y positional embeddings, keep the pixels
   with a nonzero representation (:177-202);
5. C_p = the mean over the kept quadrants of the kernel cost (:204-211).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from .gw import sampled_kernel_cost


def _quadrants(events: np.ndarray, height: int, width: int):
    x, y = events[:, 0], events[:, 1]
    hx, hy = width / 2 - 1, height / 2 - 1
    first = events[(x >= 0) & (x <= hx) & (y >= 0) & (y <= hy)]
    second = events[(x > hx) & (x <= width - 1) & (y >= 0) & (y <= hy)]
    third = events[(x >= 0) & (x <= hx) & (y > hy) & (y <= height - 1)]
    fourth = events[(x > hx) & (x <= width - 1) & (y > hy) & (y <= height - 1)]
    return [first, second, third, fourth]


def _pad_cloud(X: np.ndarray, capacity: int):
    n = min(len(X), capacity)
    out = np.zeros((capacity, X.shape[1]), np.float32)
    out[:n] = X[:n]
    mask = np.zeros(capacity, np.float32)
    mask[:n] = 1.0
    return out, mask


def _bucket_capacity(n: int, minimum: int = 4096) -> int:
    """Next power of two >= n: clouds are never truncated (a dense rep
    quadrant can exceed 16k nonzero pixels)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def _rep_boxes(rep_size: int):
    """(x0, x1, y0, y1) of the 4 rep quadrants, with the reference's
    off-by-one overlap (:150-155)."""
    half = rep_size // 2
    return (
        (0, half, 0, half),
        (half - 1, rep_size, 0, half),
        (0, half, half - 1, rep_size),
        (half - 1, rep_size, half - 1, rep_size),
    )


def _dense_cost_np(Xs: np.ndarray, Xt: np.ndarray, h: float = 0.7) -> float:
    """CPU twin of the reference's C_p math (compute_otmi.py:35-91: pairwise
    distances -> Gaussian kernels -> the mean of the padded |Ks - Kt|), dense
    NumPy in float64."""
    def kern(X):
        sq = (X**2).sum(1)
        C = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2 * X @ X.T, 0))
        std = np.sqrt((C**2).mean() / 2)
        return np.exp(-((C / (h * std)) ** 2) / 2)

    Ks, Kt = kern(Xs), kern(Xt)
    L = max(len(Xs), len(Xt))
    A = np.zeros((L, L)); A[: len(Xs), : len(Xs)] = Ks
    B = np.zeros((L, L)); B[: len(Xt), : len(Xt)] = Kt
    return float(np.abs(A - B).mean())


def otmi(
    events: np.ndarray,  # (N, 4) columns x, y, t, p
    rep: np.ndarray,  # (H_rep, W_rep, C)
    height: int,
    width: int,
    rep_size: int,
    h: float = 0.7,
    capacity: Optional[int] = None,
    backend: str = "tiled",  # "tiled" (sampled_kernel_cost on device) | "cpu-dense"
    device="cuda",
) -> float:
    """C_p of one sample, the protocol on the host; with ``backend="tiled"``
    each quadrant's kernel cost runs on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``; raises where CUDA is absent). ``"cpu-dense"``
    is the reference's dense NumPy math and ignores ``device``."""
    if backend not in ("tiled", "cpu-dense"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "tiled":
        device = resolve_device(device)
    events = np.asarray(events, np.float64)
    quads = _quadrants(events, height, width)
    sizes = [q.shape[0] for q in quads]
    densest = sizes.index(max(sizes))

    for i in range(1, 4):  # min-shift quadrants 2-4 (compute_otmi.py:139-147)
        if len(quads[i]):
            quads[i] = quads[i].copy()
            quads[i][:, 0] -= quads[i][:, 0].min()
            quads[i][:, 1] -= quads[i][:, 1].min()

    costs = []
    for i, q in enumerate(quads):
        if i == densest or len(q) == 0:
            continue
        x = q[:, 0] / ((width - 1) // 2)
        y = q[:, 1] / ((height - 1) // 2)
        t = q[:, 2]
        span = t[-1] - t[0] if len(t) > 1 and t[-1] != t[0] else 1.0
        t = (t - t[0]) / span
        p = q[:, 3]
        pr = (p.max() - p.min()) or 1.0
        p = (p - p.min()) / pr
        mask = (q[:, 0] < (width - 1) // 2) & (q[:, 1] < (height - 1) // 2)
        cloud_s = np.stack([x[mask], y[mask], t[mask], p[mask]], axis=-1)

        x0, x1, y0, y1 = _rep_boxes(rep_size)[i]
        crop = rep[y0:y1, x0:x1, :]
        hh, ww = crop.shape[:2]
        pe_x = np.repeat(np.arange(hh).reshape(hh, 1), ww, axis=1) / max(hh - 1, 1)
        pe_y = np.repeat(np.arange(ww).reshape(1, ww), hh, axis=0) / max(ww - 1, 1)
        flat = np.concatenate([crop, pe_x[..., None], pe_y[..., None]], axis=2)
        flat = flat.reshape(-1, rep.shape[2] + 2)
        flat = flat[np.abs(flat[:, :-2]).sum(-1) > 0]

        if len(cloud_s) == 0 or len(flat) == 0:
            continue
        if backend == "cpu-dense":
            costs.append(_dense_cost_np(cloud_s, flat.astype(np.float64), h=h))
            continue
        # per-cloud capacities: the small rep cloud keeps its own bucket
        Xs, ms = _pad_cloud(cloud_s.astype(np.float32), capacity or _bucket_capacity(len(cloud_s)))
        Xt, mt = _pad_cloud(flat.astype(np.float32), capacity or _bucket_capacity(len(flat)))
        costs.append(float(sampled_kernel_cost(
            *(torch.from_numpy(a).to(device) for a in (Xs, ms, Xt, mt)), h=h)))

    return float(np.mean(costs)) if costs else float("nan")


def _event_cloud(x, y, t, p, member, shift: bool, half_w: int, half_h: int):
    """One quadrant's event cloud (N, 4), kept rows first, and its counts
    (members, kept) on the host."""
    big = 3.4e38
    if shift:  # min-shift quadrants 2-4 (compute_otmi.py:139-147)
        x = x - torch.min(torch.where(member, x, big))
        y = y - torch.min(torch.where(member, y, big))
    t0 = torch.min(torch.where(member, t, big))
    t1 = torch.max(torch.where(member, t, -big))
    span = torch.where(t1 != t0, t1 - t0, 1.0)
    pmin = torch.min(torch.where(member, p, big))
    pmax = torch.max(torch.where(member, p, -big))
    pr = torch.where(pmax != pmin, pmax - pmin, 1.0)
    keep = member & (x < half_w) & (y < half_h)
    cloud = torch.stack([x / half_w, y / half_h, (t - t0) / span, (p - pmin) / pr], dim=-1)
    cloud = torch.where(keep[:, None], cloud, 0.0)
    cloud = cloud[torch.argsort((~keep).to(torch.uint8), stable=True)]
    return cloud, int(torch.sum(member)), int(torch.sum(keep))


def _rep_cloud(rep, box):
    """One rep quadrant's cloud (pixels, C + 2): crop, positional
    embeddings, nonzero pixels first; and their count on the host."""
    x0, x1, y0, y1 = box
    crop = rep[y0:y1, x0:x1, :]
    hh, ww, C = crop.shape
    ar_h = torch.arange(hh, dtype=torch.float32, device=rep.device)
    ar_w = torch.arange(ww, dtype=torch.float32, device=rep.device)
    pe_x = ar_h.reshape(hh, 1).expand(hh, ww) / max(hh - 1, 1)
    pe_y = ar_w.reshape(1, ww).expand(hh, ww) / max(ww - 1, 1)
    flat = torch.cat([crop, pe_x[..., None], pe_y[..., None]], dim=2).reshape(hh * ww, C + 2)
    nz = torch.sum(torch.abs(flat[:, :-2]), dim=-1) > 0
    flat = torch.where(nz[:, None], flat, 0.0)
    return flat[torch.argsort((~nz).to(torch.uint8), stable=True)], int(torch.sum(nz))


def _compact(cloud, n: int, cap: int, chunk: int):
    """The first ``n`` rows of a kept-first cloud in ``rows`` rows (``n``
    rounded up to the tile, at most ``cap``) and their row mask."""
    rows = min(cap, max(chunk, -(-n // chunk) * chunk))
    X = torch.zeros((rows, cloud.shape[1]), dtype=torch.float32, device=cloud.device)
    X[: min(rows, cloud.shape[0])] = cloud[:rows]
    return X, (torch.arange(rows, device=cloud.device) < min(n, rows)).to(torch.float32)


def otmi_batched(
    events,  # (B, N, 4) float32, columns x, y, t, p; time-sorted per sample
    ev_mask,  # (B, N) 1.0 for real events
    reps,  # (B, H_rep, W_rep, C)
    height: int,
    width: int,
    rep_size: int,
    h: float = 0.7,
    chunk: int = 512,
) -> torch.Tensor:
    """C_p of a batch, the whole protocol in tensor ops on the inputs'
    device: quadrant split, densest drop, min-shift, normalization,
    keep-masking, rep crop + positional embedding + nonzero filter, and the
    tiled kernel cost. Returns (B,) float32, NaN where every quadrant is
    skipped, as in :func:`otmi`.

    An event cloud is carried at most at N/2 rows, the JAX package's
    capacity: a quadrant with more than half the events is the densest,
    whose weight is 0. The JAX package carries every cloud at that static
    capacity (rep clouds at their largest crop), maps the samples in
    sequence and runs the 4 quadrants as one call. Here samples and
    quadrants run in sequence, a quadrant of weight 0 is not computed (its
    cost is multiplied by 0 there), and each cloud is cut to its valid rows
    rounded up to the tile: padding rows are masked inside
    :func:`sampled_kernel_cost`, so the values match :func:`otmi` up to the
    float32 order of the sums.

    Assumes time-sorted events, so that the reference's positional t[0] /
    t[-1] span (compute_otmi.py:159-162) equals the masked min/max."""
    hx, hy = width / 2 - 1, height / 2 - 1
    half_w, half_h = (width - 1) // 2, (height - 1) // 2
    boxes = _rep_boxes(rep_size)
    cap_ev = ((events.shape[1] // 2 + chunk) // chunk) * chunk

    out = []
    for ev, m, rep in zip(events, ev_mask, reps):
        x, y, t, p = ev.unbind(-1)
        valid = m > 0
        quad = (x > hx).to(torch.int32) + 2 * (y > hy).to(torch.int32)
        densest = int(torch.argmax(torch.stack([torch.sum(valid & (quad == i))
                                                for i in range(4)])))
        costs = []
        for i in range(4):
            if i == densest:
                continue
            ev_cloud, n_mem, n_keep = _event_cloud(x, y, t, p, valid & (quad == i), i >= 1,
                                                   half_w, half_h)
            rep_cloud, n_nz = _rep_cloud(rep, boxes[i])
            if min(n_mem, n_keep, n_nz) == 0:
                continue
            Xs, ms = _compact(ev_cloud, n_keep, cap_ev, chunk)
            Xt, mt = _compact(rep_cloud, n_nz, rep_cloud.shape[0], chunk)
            costs.append(sampled_kernel_cost(Xs, ms, Xt, mt, h=h, chunk=chunk))
        out.append(torch.stack(costs).mean() if costs else
                   torch.tensor(float("nan"), device=events.device))
    return torch.stack(out).to(torch.float32)
