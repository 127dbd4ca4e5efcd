"""Exact Gromov-Wasserstein by conditional gradient — a host-side NumPy
reference replicating the algorithm behind POT's
``ot.gromov.gromov_wasserstein(Ks, Kt, p, q, 'kl_loss')``
(gromov_wasserstein.py:66-69 in the reference), used to anchor the
entropic solver (metrics/gw.py) without POT (a copy of the JAX package's
``metrics/gw_exact.py``).

Algorithm (Peyré, Cuturi & Solomon 2016; Titouan et al.): with the loss
decomposition L(a, b) = f1(a) + f2(b) - h1(a) h2(b), the GW objective

    J(T) = <constC - hC1 T hC2^T, T>,
    constC = f1(C1) p 1^T + 1 q^T f2(C2)^T

is quadratic in T. Conditional gradient iterates:
1. grad = 2 (constC - hC1 T hC2^T)            (symmetric C1, C2)
2. G = argmin_{G in U(p,q)} <grad, G>          (exact EMD — linear program)
3. closed-form line search on the quadratic J(T + a (G - T)), a in [0, 1].

The EMD subproblem is solved exactly with scipy's HiGHS LP (POT uses a
network simplex — same optimum, different algorithm). Small-n only (the
anchor tests use n, m <= 48); the production path stays on device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import linprog
from scipy.sparse import csr_matrix


def _loss_terms(loss: str):
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
            lambda a: a * np.log(np.clip(a, eps, None)) - a,
            lambda b: b,
            lambda a: a,
            lambda b: np.log(np.clip(b, eps, None)),
        )
    raise ValueError(loss)


def emd_exact(p: np.ndarray, q: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Exact optimal transport plan argmin_{G in U(p,q)} <cost, G> via LP."""
    n, m = cost.shape
    # row-sum and column-sum equality constraints (drop one redundant row)
    rows = []
    cols = []
    data = []
    for i in range(n):
        rows.extend([i] * m)
        cols.extend(range(i * m, (i + 1) * m))
        data.extend([1.0] * m)
    for j in range(m - 1):
        rows.extend([n + j] * n)
        cols.extend(range(j, n * m, m))
        data.extend([1.0] * n)
    A = csr_matrix((data, (rows, cols)), shape=(n + m - 1, n * m))
    b = np.concatenate([p, q[:-1]])
    res = linprog(
        cost.ravel(), A_eq=A, b_eq=b, bounds=(0, None), method="highs"
    )
    if not res.success:  # pragma: no cover
        raise RuntimeError(f"EMD LP failed: {res.message}")
    return res.x.reshape(n, m)


def gromov_wasserstein_cg(
    C1: np.ndarray,
    C2: np.ndarray,
    p: np.ndarray,
    q: np.ndarray,
    loss: str = "kl",
    max_iter: int = 100,
    tol: float = 1e-9,
    init: np.ndarray = None,
) -> Tuple[np.ndarray, float]:
    """Returns (T, gw_value) — the exact-CG twin of POT's solver. ``init``
    overrides the product-coupling start (GW is a non-convex QP; CG converges
    to a local optimum of the chosen basin, exactly like POT)."""
    f1, f2, h1, h2 = _loss_terms(loss)
    n, m = C1.shape[0], C2.shape[0]
    constC = (
        f1(C1) @ p[:, None] @ np.ones((1, m))
        + np.ones((n, 1)) @ q[None, :] @ f2(C2).T
    )
    hC1, hC2 = h1(C1), h2(C2)

    def tens(T):
        return constC - hC1 @ T @ hC2.T

    def obj(T):
        return float(np.sum(tens(T) * T))

    def q2(A, B):
        return float(np.sum((hC1 @ A @ hC2.T) * B))

    T = p[:, None] * q[None, :] if init is None else np.asarray(init, np.float64)
    prev = obj(T)
    for _ in range(max_iter):
        grad = 2.0 * tens(T)
        G = emd_exact(p, q, grad)
        D = G - T
        # J(T + aD) = J(T) + a*b + a^2*c (symmetric kernels)
        b_lin = float(np.sum(constC * D)) - 2.0 * q2(T, D)
        c_quad = -q2(D, D)
        if c_quad > 1e-18:
            alpha = float(np.clip(-b_lin / (2.0 * c_quad), 0.0, 1.0))
        else:
            alpha = 1.0 if (b_lin + c_quad) < 0 else 0.0
        if alpha <= 0:
            break
        T = T + alpha * D
        cur = obj(T)
        if abs(prev - cur) < tol:
            break
        prev = cur
    return T, obj(T)
