"""Gromov-Wasserstein representation-ranking metrics (port of the JAX
package's ``metrics/gw.py``; the reference runs POT and sklearn on the CPU,
representations/representation_search/{gromov_wasserstein.py,
compute_otmi.py}).

- :func:`gaussian_kernels`: ``compute_kernel`` (gromov_wasserstein.py:10-36),
  K = exp(-(C/(h*std))^2/2) with std = sqrt(mean(C^2)/2).
- :func:`entropic_gromov_wasserstein`: entropic GW by mirror descent with
  log-domain Sinkhorn projections (Peyré et al. 2016), in place of POT's
  conditional-gradient ``gromov_wasserstein(..., 'kl_loss')``.
- :func:`sampled_kernel_cost`: the production C_p metric. The reference calls
  POT's ``sampled_gromov_wasserstein`` with ``max_iter=0`` and a loss that
  ignores its arguments and returns ``|pad(Ks) - pad(Kt)|``
  (compute_otmi.py:71-91), so its estimate converges to the plain mean of
  that padded difference: computed here exactly, in row tiles, so the
  O(n^2) kernels never exist whole.

Dense matmul, exp and reductions in plain torch, on the inputs' device; no
hand kernel (the JAX package leaves this work to XLA).
"""
from __future__ import annotations

import torch

from .. import resolve_device


def pairwise_sq_dists(X, Y):
    """Squared euclidean distances (n, d) x (m, d) -> (n, m)."""
    xx = torch.sum(X * X, dim=1)[:, None]
    yy = torch.sum(Y * Y, dim=1)[None, :]
    return torch.clamp(xx + yy - 2 * (X @ Y.T), min=0.0)


def mean_sq_dist(X, mask):
    """mean_{i,j} ||x_i - x_j||^2 over valid points without the n^2 matrix:
    2/n^2 * (n * sum||x||^2 - ||sum x||^2). The closed form cancels in
    float32 for clouds far from the origin; it is the JAX package's."""
    n = torch.sum(mask)
    Xm = X * mask[:, None]
    s2 = torch.sum(torch.sum(Xm * Xm, dim=1))
    s = torch.sum(Xm, dim=0)
    return 2 * (n * s2 - torch.sum(s * s)) / torch.clamp(n * n, min=1.0)


def kernel_bandwidth(X, mask, h: float):
    """h * std with std = sqrt(mean(C^2)/2) (gromov_wasserstein.py:28-33)."""
    return h * torch.sqrt(mean_sq_dist(X, mask) / 2.0)


def _kernel_sum_tiled(Xp, n_valid, bw, chunk: int):
    """sum_{i,j < n} exp(-d2_ij / (2 bw^2)) over a compacted cloud whose
    rows are a multiple of ``chunk``, one row tile at a time."""
    pad_to = Xp.shape[0]
    col_valid = (torch.arange(pad_to, dtype=torch.float32, device=Xp.device) < n_valid)[None, :]
    acc = torch.zeros((), dtype=torch.float32, device=Xp.device)
    for start in range(0, pad_to, chunk):
        rs = Xp[start:start + chunk]
        r_idx = (start + torch.arange(chunk, dtype=torch.float32, device=Xp.device))[:, None]
        K = torch.exp(-pairwise_sq_dists(rs, Xp) / (2.0 * bw * bw))
        acc = acc + torch.sum(K * (r_idx < n_valid) * col_valid)
    return acc


def _rpad(X, mask, chunk: int):
    """Valid rows (masked), zero rows up to a multiple of ``chunk``."""
    cap = X.shape[0]
    out = torch.zeros((-(-cap // chunk) * chunk, X.shape[1]), dtype=torch.float32, device=X.device)
    out[:cap] = X * mask[:, None]
    return out


def sampled_kernel_cost(Xs, mask_s, Xt, mask_t, h: float = 0.7, chunk: int = 512):
    """Deterministic C_p: the mean over the (L x L)-padded square of
    ``|Ks - Kt|``, L = max(n, m), for compacted clouds (valid rows first; the
    two clouds may have different row capacities).

    Only the q x q block, q = min(n, m), compares the kernels: outside it one
    kernel is zero, so the rest is two kernel sums,

        total = sum_{q x q} |Ks - Kt| + (sum_{n x n} Ks - sum_{q x q} Ks)
                                      + (sum_{m x m} Kt - sum_{q x q} Kt).

    The P x P block (P the smaller padded capacity, >= q) is taken in row
    tiles of ``chunk``; a larger cloud adds one tiled self-kernel sum. The
    tile size changes only the float32 order of the sums."""
    hs = kernel_bandwidth(Xs, mask_s, h)
    ht = kernel_bandwidth(Xt, mask_t, h)
    n = torch.sum(mask_s)
    m = torch.sum(mask_t)
    L = torch.maximum(n, m)
    q = torch.minimum(n, m)
    Xs_p = _rpad(Xs, mask_s, chunk)
    Xt_p = _rpad(Xt, mask_t, chunk)
    P = min(Xs_p.shape[0], Xt_p.shape[0])
    iP = torch.arange(P, dtype=torch.float32, device=Xs.device)

    zero = torch.zeros((), dtype=torch.float32, device=Xs.device)
    B_qq, S_qq, T_qq, S_blk, T_blk = zero, zero, zero, zero, zero
    for start in range(0, P, chunk):
        r = iP[start:start + chunk, None]
        Ks = torch.exp(-pairwise_sq_dists(Xs_p[start:start + chunk], Xs_p[:P]) / (2.0 * hs * hs))
        Ks = Ks * (r < n) * (iP[None, :] < n)
        Kt = torch.exp(-pairwise_sq_dists(Xt_p[start:start + chunk], Xt_p[:P]) / (2.0 * ht * ht))
        Kt = Kt * (r < m) * (iP[None, :] < m)
        qm = (r < q) * (iP[None, :] < q)
        B_qq = B_qq + torch.sum(torch.abs(Ks - Kt) * qm)
        S_qq = S_qq + torch.sum(Ks * qm)
        T_qq = T_qq + torch.sum(Kt * qm)
        S_blk = S_blk + torch.sum(Ks)
        T_blk = T_blk + torch.sum(Kt)
    S_full = _kernel_sum_tiled(Xs_p, n, hs, chunk) if Xs_p.shape[0] > P else S_blk
    T_full = _kernel_sum_tiled(Xt_p, m, ht, chunk) if Xt_p.shape[0] > P else T_blk
    total = B_qq + (S_full - S_qq) + (T_full - T_qq)
    return total / torch.clamp(L * L, min=1.0)


def _gw_loss_terms(loss: str):
    """Decomposition L(a,b) = f1(a) + f2(b) - h1(a) h2(b) (Peyré et al.)."""
    if loss == "square":
        return (
            lambda a: a**2,
            lambda b: b**2,
            lambda a: a,
            lambda b: 2 * b,
        )
    if loss == "kl":
        eps = 1e-15
        return (
            lambda a: a * torch.log(torch.clamp(a, min=eps)) - a,
            lambda b: b,
            lambda a: a,
            lambda b: torch.log(torch.clamp(b, min=eps)),
        )
    raise ValueError(loss)


def entropic_gromov_wasserstein(C1, C2, p, q, loss: str = "kl", epsilon: float = 5e-3,
                                max_iter: int = 100, sinkhorn_iter: int = 50):
    """Entropic GW: mirror descent on the coupling with log-domain Sinkhorn
    projections. Returns (T, gw_dist), gw_dist under the same loss
    decomposition, for the coupling rounded onto U(p, q)."""
    f1, f2, h1, h2 = _gw_loss_terms(loss)
    n, m = C1.shape[0], C2.shape[0]
    ones_m = torch.ones((1, m), dtype=C1.dtype, device=C1.device)
    ones_n = torch.ones((n, 1), dtype=C1.dtype, device=C1.device)
    constC = f1(C1) @ p[:, None] @ ones_m + ones_n @ q[None, :] @ f2(C2).T
    hC1 = h1(C1)
    hC2 = h2(C2)

    def tens(T):
        return constC - hC1 @ T @ hC2.T

    def sinkhorn(K_log):
        f = torch.zeros(n, dtype=C1.dtype, device=C1.device)
        g = torch.zeros(m, dtype=C1.dtype, device=C1.device)
        for _ in range(sinkhorn_iter):
            f = epsilon * (torch.log(p) - torch.logsumexp((g[None, :] + K_log) / epsilon, dim=1))
            g = epsilon * (torch.log(q) - torch.logsumexp((f[:, None] + K_log) / epsilon, dim=0))
        return torch.exp((f[:, None] + g[None, :] + K_log) / epsilon)

    T = p[:, None] * q[None, :]
    for _ in range(max_iter):
        T = sinkhorn(-tens(T))  # mirror step; the prior is folded in
    # round onto U(p, q) (Altschuler et al. 2017) so the value is that of a
    # feasible coupling: an unconverged Sinkhorn iterate can undercut the
    # exact optimum
    r = p / torch.clamp(T.sum(dim=1), min=1e-30)
    T = T * torch.clamp(r, max=1.0)[:, None]
    c = q / torch.clamp(T.sum(dim=0), min=1e-30)
    T = T * torch.clamp(c, max=1.0)[None, :]
    err_r = p - T.sum(dim=1)
    err_c = q - T.sum(dim=0)
    T = T + err_r[:, None] * err_c[None, :] / torch.clamp(torch.sum(torch.abs(err_r)), min=1e-30)
    return T, torch.sum(tens(T) * T)


def gaussian_kernels(Xs, Xt, h: float = 0.7):
    """Full (small-n) kernels of two clouds (gromov_wasserstein.py:10-36)."""
    Cs = torch.sqrt(pairwise_sq_dists(Xs, Xs))
    Ct = torch.sqrt(pairwise_sq_dists(Xt, Xt))
    std1 = torch.sqrt(torch.mean(Cs**2) / 2)
    std2 = torch.sqrt(torch.mean(Ct**2) / 2)
    Ks = torch.exp(-((Cs / (h * std1)) ** 2) / 2)
    Kt = torch.exp(-((Ct / (h * std2)) ** 2) / 2)
    return Ks, Kt


def gw_distance(Xs, Xt, h: float = 0.7, loss: str = "kl", epsilon: float = 5e-3,
                device="cuda"):
    """Exact-path OTMI: kernels + entropic GW (OTMI.solve,
    gromov_wasserstein.py:39-69). Arrays or tensors in; runs on ``device``
    (``cuda`` unless the caller passes ``"cpu"``; raises where CUDA is
    absent)."""
    device = resolve_device(device)
    Ks, Kt = gaussian_kernels(torch.as_tensor(Xs, dtype=torch.float32, device=device),
                              torch.as_tensor(Xt, dtype=torch.float32, device=device), h)
    n, m = Ks.shape[0], Kt.shape[0]
    p = torch.full((n,), 1.0 / n, device=Ks.device)
    q = torch.full((m,), 1.0 / m, device=Ks.device)
    _, gw = entropic_gromov_wasserstein(Ks, Kt, p, q, loss=loss, epsilon=epsilon)
    return gw
