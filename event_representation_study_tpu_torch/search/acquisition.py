"""Acquisition optimization: a vectorized evolutionary search replacing
gryffin's DEAP genetic optimizer + multiprocessing fan-out
(gryffin/src/gryffin/acquisition/*, SURVEY §2.8 #9): the whole population
evaluates in one batched call per generation instead of one process per CPU.
A copy of the JAX package's ``search/acquisition.py``: the search runs in
NumPy on the host with the same random call sequence; only the acquisition
values come from ``search/kernels.py`` on the model's device.

Constraint handling matches gryffin's ``known_constraints``: infeasible
candidates are rejected at sampling time and after mutation (the constrained
evolution of genetic_optimizer.py:217).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .kernels import KernelModel, acquisition_values


def _feasible_mask(samples: np.ndarray, known_constraints) -> np.ndarray:
    if known_constraints is None:
        return np.ones(len(samples), bool)
    return np.array([bool(known_constraints(s)) for s in samples])


def random_feasible(
    rng: np.random.Generator,
    option_counts: Sequence[int],
    n: int,
    known_constraints=None,
    max_tries: int = 200,
) -> np.ndarray:
    """Constrained rejection sampling (gryffin random_sampler/:35-124)."""
    dims = len(option_counts)
    out = []
    for _ in range(max_tries):
        cand = np.stack(
            [rng.integers(0, c, n) for c in option_counts], axis=-1
        ).astype(np.int64)
        ok = _feasible_mask(cand, known_constraints)
        out.append(cand[ok])
        if sum(len(o) for o in out) >= n:
            break
    if not out:
        raise RuntimeError("no feasible samples found")
    return np.concatenate(out)[:n]


def optimize_acquisition(
    acq,
    option_counts: Sequence[int],
    rng: np.random.Generator,
    known_constraints=None,
    population: int = 200,
    generations: int = 10,
    mutation_rate: float = 0.2,
    elite_frac: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Minimize an acquisition over the categorical grid; ``acq`` is either a
    callable mapping (S, D) int candidates -> (S,) values, or a
    (KernelModel, lambda) pair for the plain (num + lam) * inv_den
    acquisition. Returns (sorted candidates, their acquisition values)."""
    if isinstance(acq, tuple):
        model, lam = acq

        def acq_fn(p):
            return acquisition_values(model, p, lam).cpu().numpy()
    else:
        acq_fn = acq

    pop = random_feasible(rng, option_counts, population, known_constraints)
    counts = np.asarray(option_counts)

    def evaluate(p):
        return np.asarray(acq_fn(p))

    vals = evaluate(pop)
    n_elite = max(int(elite_frac * population), 1)
    for _ in range(generations):
        order = np.argsort(vals)
        pop, vals = pop[order], vals[order]
        elite = pop[:n_elite]
        # tournament parents + uniform crossover
        a = pop[rng.integers(0, population // 2, population - n_elite)]
        b = pop[rng.integers(0, population // 2, population - n_elite)]
        mask = rng.random((population - n_elite, len(counts))) < 0.5
        children = np.where(mask, a, b)
        # categorical mutation
        mut = rng.random(children.shape) < mutation_rate
        resample = np.stack(
            [rng.integers(0, c, len(children)) for c in counts], axis=-1
        )
        children = np.where(mut, resample, children)
        ok = _feasible_mask(children, known_constraints)
        bad = ~ok
        if bad.any():
            children[bad] = random_feasible(
                rng, option_counts, int(bad.sum()), known_constraints
            )
        pop = np.concatenate([elite, children])
        vals = evaluate(pop)
    order = np.argsort(vals)
    return pop[order], vals[order]


def select_diverse(
    candidates: np.ndarray,
    values: np.ndarray,
    previous: Optional[np.ndarray],
    n: int = 1,
    diversity_penalty: float = 0.0,
) -> np.ndarray:
    """Diversity-penalized batch selection (gryffin
    sample_selector/sample_selector.py:137 ``select``): exact duplicates of
    already-evaluated samples are skipped; with ``diversity_penalty`` > 0 the
    acquisition of each candidate is additionally penalized by
    ``exp(-min hamming distance to prior samples)`` before ranking, pushing
    the batch apart (the reference's distance-based punishment)."""
    prev = [] if previous is None else [tuple(p) for p in previous]
    if diversity_penalty > 0 and prev:
        prev_arr = np.asarray(previous)
        dmin = np.min(
            (candidates[:, None, :] != prev_arr[None, :, :]).sum(-1), axis=1
        )
        span = max(values.max() - values.min(), 1e-9)
        values = values + diversity_penalty * span * np.exp(-dmin.astype(float))
        order = np.argsort(values)
        candidates, values = candidates[order], values[order]
    chosen = []
    for cand, v in zip(candidates, values):
        key = tuple(cand)
        if key in prev or any(tuple(c) == key for c in chosen):
            continue
        chosen.append(cand)
        if len(chosen) == n:
            break
    while len(chosen) < n and len(candidates):
        chosen.append(candidates[0])
    return np.asarray(chosen)


def enumerate_feasible(option_counts: Sequence[int], known_constraints=None,
                       limit: int = 4096) -> Optional[np.ndarray]:
    """All feasible combinations when the categorical grid is small — the
    exhaustive-option mode of gryffin's sample selector (fully-categorical
    spaces; the study's 7x7x4 grid has only 196 points, so the acquisition
    argmin is exact). Returns None when the grid exceeds ``limit``."""
    total = int(np.prod(option_counts))
    if total > limit:
        return None
    grids = np.meshgrid(*[np.arange(c) for c in option_counts], indexing="ij")
    cand = np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int64)
    if known_constraints is not None:
        cand = cand[_feasible_mask(cand, known_constraints)]
    return cand
