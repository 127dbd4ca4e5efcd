"""Greedy sequential channel search — the ERGO-12 optimization loop
(representations/representation_search/optimization.py:168-290).

For each of 12 channels: run ``budget`` BO iterations over
{window 0-6} x {7 measurement functions} x {4 aggregations} with the study's
constraint table (optimization.py:148-165), alternating +-1 sampling
strategies (:234-241); the objective is the mean OTMI C_p of the
representation built from the channels fixed so far plus the candidate
(:116-145). The best triple is frozen and the search moves to the next
channel (:252-263). The port of the JAX package's ``search/optimize.py``;
the surrogate runs on ``device``.
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..reps.mdes import AGGREGATIONS, FUNCTIONS
from .gryffin import CategoricalParam, Gryffin

WINDOW_OPTIONS = [str(i) for i in range(7)]


# The study's exact function->allowed-aggregations table
# (optimization.py:148-165 known_constraints_cat): count-like functions are
# restricted to {mean, sum} (their variance is 0 and max is uninformative),
# polarity may not use max.
POSSIBLE_SCENARIOS: Dict[str, List[str]] = {
    "timestamp": ["variance", "mean", "max", "sum"],
    "polarity": ["mean", "variance", "sum"],
    "count": ["mean", "sum"],
    "timestamp_pos": ["variance", "mean", "max", "sum"],
    "timestamp_neg": ["variance", "mean", "max", "sum"],
    "count_pos": ["mean", "sum"],
    "count_neg": ["mean", "sum"],
}


def default_known_constraints(params: Dict) -> bool:
    """known_constraints_cat (optimization.py:148-165), verbatim table."""
    return params["aggregation"] in POSSIBLE_SCENARIOS[params["function"]]


def search_space() -> List[CategoricalParam]:
    return [
        CategoricalParam("window", WINDOW_OPTIONS),
        CategoricalParam("function", list(FUNCTIONS)),
        CategoricalParam("aggregation", list(AGGREGATIONS)),
    ]


def sequential_optimization(
    measure: Callable[[List[Tuple[int, str, str]]], float],
    channels: int = 12,
    budget: int = 100,
    seed: int = 42,
    known_constraints: Callable[[Dict], bool] = default_known_constraints,
    save_path: Optional[str] = None,
    verbose: bool = True,
    bnn_train_steps: int = 2000,
    bnn_draws: int = 1000,
    db_path: Optional[str] = None,
    db_format: str = "json",
    device="cuda",
) -> List[Tuple[int, str, str]]:
    """``measure(triples)`` scores a partial representation (lower=better,
    e.g. mean OTMI over the chosen samples, optimization.py:116-145).

    Defaults follow the study's search loop: gryffin at its reference surrogate
    settings (2000 BNN train epochs, 1000 posterior draws,
    utilities/defaults.py:48-58), seed 42, budget 100 per channel. Every
    scored observation is appended to ``db_path`` (json/sqlite/pickle) like
    gryffin's database handlers. Recommendations violating
    ``known_constraints`` are rejected outright (the BO never scores them).
    The surrogate runs on ``device``: ``cuda`` unless the caller passes
    ``cpu``."""
    db = None
    if db_path is not None:
        from .db import DatabaseHandler

        db = DatabaseHandler(db_path, format=db_format)
    fixed: List[Tuple[int, str, str]] = []
    best_observations = []
    for ch in range(channels):
        gryffin = Gryffin(
            search_space(), known_constraints=known_constraints,
            random_seed=seed + ch,
            bnn_train_steps=bnn_train_steps, bnn_draws=bnn_draws, device=device,
        )
        observations: List[Dict] = []
        it = 0
        while it < budget:
            # alternating +-1 strategies (optimization.py:234-241)
            strategies = (-1, 1) if it % 2 == 0 else (1, -1)
            recs = gryffin.recommend(observations, sampling_strategies=strategies)
            for rec in recs:
                if known_constraints is not None and not known_constraints(rec):
                    raise AssertionError(
                        f"BO recommended an excluded combination: {rec}"
                    )
                triple = (int(rec["window"]), rec["function"], rec["aggregation"])
                c_p = measure(fixed + [triple])
                obs = dict(rec, obj=c_p, channel=ch)
                observations.append(obs)
                if db is not None:
                    db.log_observations([obs])
                it += 1
                if it >= budget:
                    break
        best = min(observations, key=lambda o: o["obj"])
        fixed.append((int(best["window"]), best["function"], best["aggregation"]))
        best_observations.append(best)
        if verbose:
            print(f"channel {ch}: best {best}")
        if save_path:
            with open(save_path, "wb") as f:
                pickle.dump(best_observations, f)
    return fixed
