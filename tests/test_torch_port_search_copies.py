"""The search modules the port copies from the JAX package (NumPy and the
standard library: ``search/chimera.py``, ``search/db.py``,
``search/benchmarks.py``) against the originals, on the cases of
``tests/test_chimera.py`` and ``tests/test_search.py``: equal results."""
import sys

import numpy as np
import pytest

from event_representation_study_tpu.search import benchmarks as j_benchmarks
from event_representation_study_tpu.search import chimera as j_chimera
from event_representation_study_tpu.search import db as j_db
from event_representation_study_tpu.search import gryffin as j_gryffin
from event_representation_study_tpu_torch.search import benchmarks as t_benchmarks
from event_representation_study_tpu_torch.search import chimera as t_chimera
from event_representation_study_tpu_torch.search import db as t_db
from event_representation_study_tpu_torch.search import gryffin as t_gryffin
from torch_port_helpers import assert_close
from torch_port_helpers import fake_surrogates  # noqa: F401 (a fixture)

# (objectives, goals, tolerances, absolutes) of tests/test_chimera.py
CHIMERA_CASES = {
    "hierarchy": ([[0.0, 0.9], [0.2, 0.1], [1.0, 0.0], [0.9, 0.05]], ["min", "min"], [0.3, 1.0],
                  None),
    "max_goal_absolute": ([[9.0, 3.0], [6.0, 1.0], [4.0, 0.0]], ["max", "min"], [5.0, 1.0],
                          [True, False]),
    "degenerate_window": ([[0.0, 5.0], [1.0, 0.0], [2.0, 1.0]], ["min", "min"], [0.0, 1.0],
                          None),
    "three_levels": (np.random.default_rng(0).random((12, 3)).tolist(), ["min", "max", "min"],
                     [0.2, 0.5, 1.0], None),
}
OBJECTIVES = [{"name": "obj0", "goal": "min", "tolerance": 0.2},
              {"name": "obj1", "goal": "max", "tolerance": 0.1}]


def _multi_obs(n=6):
    rng = np.random.default_rng(0)
    return [{"a": f"a{rng.integers(4)}", "b": f"b{rng.integers(4)}",
             "obj0": float(rng.uniform()), "obj1": float(rng.uniform())} for _ in range(n)]


@pytest.mark.parametrize("case", list(CHIMERA_CASES))
def test_chimera_scalarize_vs_jax(case):
    objs, goals, tols, absolutes = CHIMERA_CASES[case]
    got = t_chimera.chimera_scalarize(np.array(objs), goals, tols, absolutes=absolutes)
    want = j_chimera.chimera_scalarize(np.array(objs), goals, tols, absolutes=absolutes)
    assert_close(f"chimera {case}", got, want, atol=0)


def test_scalarize_observations_vs_jax():
    obs = _multi_obs() + [{"a": "a0", "b": "b0", "obj0": float("nan"), "obj1": 0.5}]
    got = t_chimera.scalarize_observations(OBJECTIVES, obs)
    want = j_chimera.scalarize_observations(OBJECTIVES, obs)
    assert_close("merits", [o["obj"] for o in got], [o["obj"] for o in want], atol=0)


def test_gryffin_multiobjective_vs_jax(fake_surrogates):
    """``tests/test_chimera.py``'s multi-objective recommend, with and
    without a NaN objective, with the surrogates replaced as elsewhere."""
    params = [("a", [f"a{i}" for i in range(4)]), ("b", [f"b{i}" for i in range(4)])]
    obs = _multi_obs()
    recs = {}
    for pkg, kw in ((j_gryffin, {}), (t_gryffin, {"device": "cpu"})):
        g = pkg.Gryffin([pkg.CategoricalParam(n, o) for n, o in params], objectives=OBJECTIVES,
                        random_seed=1, **kw)
        recs[pkg] = [g.recommend(obs, sampling_strategies=(-1, 1)),
                     g.recommend(obs + [{"a": "a0", "b": "b0", "obj0": float("nan"), "obj1": 0.5}],
                                 sampling_strategies=(-1, 1))]
    assert recs[t_gryffin] == recs[j_gryffin]


@pytest.mark.parametrize("fmt", ["json", "sqlite", "pickle", "csv"])
def test_db_history_vs_jax(fmt, tmp_path):
    """Both handlers write and read back the same history (list-valued
    parameters included), appended in two calls."""
    obs = [{"obj": 0.5, "windows": [0, 2, 5], "function": "count"},
           {"obj": 0.25, "windows": [1, 3], "function": "timestamp"},
           {"obj": 0.125, "window": "3", "function": "polarity", "channel": 1}]
    hist = {}
    for pkg in (j_db, t_db):
        path = tmp_path / pkg.__name__.split(".")[0] / f"hist.{fmt}"
        db = pkg.DatabaseHandler(path, format=fmt)
        db.log_observations(obs[:1])
        db.log_observations(obs[1:])
        hist[pkg] = pkg.DatabaseHandler(path, format=fmt).load()
    assert [h["iteration"] for h in hist[t_db]] == [0, 1, 2]
    got, want = hist[t_db], hist[j_db]
    if fmt == "csv":  # missing cells read back as NaN, which != NaN
        got, want = (_nan_to_none(h) for h in (got, want))
    assert got == want


def _nan_to_none(rows):
    return [{k: (None if isinstance(v, float) and np.isnan(v) else v) for k, v in r.items()}
            for r in rows]


@pytest.mark.parametrize("fmt", ["csv", "xlsx"])
def test_db_table_formats_name_pandas_when_absent(fmt, tmp_path, monkeypatch):
    """csv and xlsx history files need pandas, which an installation may lack:
    the handler raises naming it (json, sqlite and pickle do not need it)."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    db = t_db.DatabaseHandler(tmp_path / f"hist.{fmt}", format=fmt)
    with pytest.raises(RuntimeError, match="need pandas"):
        db.log_observations([{"obj": 1.0}])
    t_db.DatabaseHandler(tmp_path / "hist.json", format="json").log_observations([{"obj": 1.0}])


@pytest.mark.parametrize("fn", ["cat_dejong", "cat_camel", "cat_ackley"])
def test_benchmarks_vs_jax(fn):
    num_opts = (7, 5)
    grid = [(i, j) for i in range(7) for j in range(5)]
    got = [getattr(t_benchmarks, fn)(s, num_opts) for s in grid]
    want = [getattr(j_benchmarks, fn)(s, num_opts) for s in grid]
    assert_close(fn, got, want, atol=0)
