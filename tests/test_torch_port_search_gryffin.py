"""The port's categorical Bayesian optimization (``Gryffin``,
``sequential_optimization``; torch on the CPU) against the JAX package's.

The two frameworks' generators differ, so the surrogate of both packages is
replaced by one NumPy function of the observations (``bnn.fit_*`` are
looked up at call time in both; ``torch_port_helpers.fake_surrogates``). With the same draws
and the same NumPy random call sequence, both packages must make the same
recommendations, exactly: the study's space with its constraint table
(exhaustive enumeration), a grid above the 4096 limit of enumeration (the
GA) and a measured-infeasible (NaN) observation (the FIA blend).
"""
import numpy as np
import pytest

from event_representation_study_tpu.search import gryffin as j_gryffin
from event_representation_study_tpu.search import optimize as j_optimize
from event_representation_study_tpu_torch.search import gryffin as t_gryffin
from event_representation_study_tpu_torch.search import optimize as t_optimize
from torch_port_helpers import fake_surrogates  # noqa: F401 (a fixture)


def _study_objective(rec):
    return abs(int(rec["window"]) - 3) / 6 + (rec["function"] != "count") \
        + (rec["aggregation"] != "sum") + 0.01 * len(rec["function"])


def _dejong(rec):
    x = np.array([2 * int(v[1:]) / 16 - 1 for v in rec.values()])
    return float(np.sum(x**2))


def _grid17():
    return [(f"p{i}", [f"o{j}" for j in range(17)]) for i in range(3)]


def _loop(pkg, case, **kw):
    """4 recommend rounds of 2 alternating strategies; a NaN observation
    (measured infeasible) after round 2 in the ``nan`` case."""
    if case == "grid17_ga":  # 17^3 = 4913 > 4096: the GA, not enumeration
        space = [pkg.CategoricalParam(n, o) for n, o in _grid17()]
        g, objective = pkg.Gryffin(space, random_seed=5, **kw), _dejong
    else:
        opt = j_optimize if pkg is j_gryffin else t_optimize
        g = pkg.Gryffin(opt.search_space(), known_constraints=opt.default_known_constraints,
                        random_seed=42, **kw)
        objective = _study_objective
    obs, recs_all = [], []
    for it in range(4):
        recs = g.recommend(obs, sampling_strategies=(-1, 1) if it % 2 == 0 else (1, -1))
        recs_all.append(recs)
        obs += [dict(r, obj=objective(r)) for r in recs]
        if case == "nan" and it == 1:
            obs.append(dict(obs[0], window="6", obj=float("nan")))
    return recs_all


@pytest.mark.parametrize("case", ["study_exhaustive", "grid17_ga", "nan"])
def test_gryffin_recommendations_match_jax(case, fake_surrogates):
    want = _loop(j_gryffin, case)
    got = _loop(t_gryffin, case, device="cpu")
    assert got == want
    if case != "grid17_ga":
        assert all(t_optimize.default_known_constraints(r) for recs in got for r in recs)


def test_sequential_optimization_matches_jax(fake_surrogates, tmp_path):
    """A 1-channel search on a toy measure fixes the same triple and scores
    the same sequence in both packages; the history lands in json."""
    target = (3, "count", "sum")

    def measure(scored):
        def fn(triples):
            w, f, a = triples[-1]
            scored.append(triples[-1])
            return abs(w - target[0]) / 6 + (f != target[1]) + (a != target[2])
        return fn

    seen_j, seen_t = [], []
    want = j_optimize.sequential_optimization(measure(seen_j), channels=1, budget=10, seed=3,
                                              verbose=False)
    got = t_optimize.sequential_optimization(measure(seen_t), channels=1, budget=10, seed=3,
                                             verbose=False, device="cpu",
                                             db_path=tmp_path / "h.json")
    assert got == want and seen_t == seen_j and len(seen_t) == 10
    assert all(a in t_optimize.POSSIBLE_SCENARIOS[f] for _, f, a in seen_t)
    assert t_optimize.POSSIBLE_SCENARIOS == j_optimize.POSSIBLE_SCENARIOS
