"""Chimera hierarchy-based multi-objective scalarization — the mechanism
behind gryffin's multi-objective mode (the reference scalarizes objective
vectors through the external ``matter-chimera`` package before the BO loop,
gryffin/src/gryffin/observation_processor/observation_processor.py:7,14,88;
exercised by gryffin/tests/test_gryffin.py test_multiobjective).

Implemented from the published construction (Hase, Roch, Aspuru-Guzik,
"Chimera: enabling hierarchy based multi-objective optimization for
self-driving laboratories", Chem. Sci. 2018): objectives are ranked by
priority, each with a tolerance; a sample's merit is decided by the FIRST
objective in the hierarchy whose tolerance it violates (offset so that
violating level k is always worse than satisfying levels <= k), and samples
satisfying every tolerance compete on the last objective. Thresholds adapt
down the hierarchy: level k's tolerance window is computed over the region
that satisfies levels < k.

Contract (tested): (1) any sample violating level 0 ranks worse than every
sample satisfying it; (2) within the all-satisfied region, the LAST
objective orders samples; (3) 'max' goals are sign-flipped; (4) absolute
tolerances are thresholds in raw objective units.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def scalarize_observations(objectives, observations, objective_key="obj"):
    """Map multi-objective observation dicts to single-merit dicts
    (observation_processor.py:80-94): rows with every objective finite get
    the Chimera merit under ``objective_key``; rows with any non-finite
    objective become measured-infeasible (NaN merit)."""
    names = [o["name"] for o in objectives]
    rows, idx, out = [], [], []
    for i, obs in enumerate(observations):
        obs = dict(obs)
        vals = [obs.get(n, np.nan) for n in names]
        if np.all(np.isfinite(vals)):
            rows.append(vals)
            idx.append(i)
            obs[objective_key] = np.nan  # filled below
        elif any(n in obs for n in names):
            obs[objective_key] = np.nan  # measured infeasible
        out.append(obs)
    if rows:
        merit = chimera_scalarize(
            np.asarray(rows, np.float64),
            [o.get("goal", "min") for o in objectives],
            [o.get("tolerance", 1.0) for o in objectives],
            [o.get("absolute", False) for o in objectives],
        )
        for i, m in zip(idx, merit):
            out[i][objective_key] = float(m)
    return out


def chimera_scalarize(
    objs: np.ndarray,  # (n, K) raw objective values, hierarchy order
    goals: Sequence[str],  # 'min' | 'max' per objective
    tolerances: Sequence[float],
    absolutes: Optional[Sequence[bool]] = None,
) -> np.ndarray:
    """(n,) merit values — smaller is better (feed the 'min' BO path)."""
    objs = np.asarray(objs, np.float64)
    n, K = objs.shape
    assert len(goals) == len(tolerances) == K
    absolutes = [False] * K if absolutes is None else list(absolutes)

    # goal-adjust: everything becomes a minimization
    f = objs.copy()
    for k, g in enumerate(goals):
        if g == "max":
            f[:, k] = -f[:, k]

    # normalize each objective over the observation set to [0, 1]
    lo = f.min(axis=0)
    hi = f.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    fn = (f - lo) / span

    merit = np.zeros(n)
    assigned = np.zeros(n, bool)
    domain = np.ones(n, bool)  # satisfies all previous levels
    for k in range(K):
        fk = fn[:, k]
        if absolutes[k]:
            thr_raw = -tolerances[k] if goals[k] == "max" else tolerances[k]
            thr = (thr_raw - lo[k]) / span[k]
        else:
            dmin = fk[domain].min()
            dmax = fk[domain].max()
            thr = dmin + float(tolerances[k]) * (dmax - dmin)
        satisfied = domain & (fk <= thr)
        if not satisfied.any():
            # degenerate window: keep the argmin of this level in play
            best = np.where(domain, fk, np.inf).argmin()
            satisfied = np.zeros(n, bool)
            satisfied[best] = True
        if k < K - 1:
            violated = domain & ~satisfied
            # first-violated level decides, offset above all deeper levels
            merit[violated] = fk[violated] + (K - 1 - k)
            assigned |= violated
            domain = satisfied
        else:
            merit[domain] = fk[domain]
            assigned |= domain
    assert assigned.all()
    return merit
