"""The port's mixed-space Bayesian optimization (``MixedGryffin``,
``refine_descriptors``, ``cli/bo.py``; torch on the CPU) against the JAX
package's, with both surrogates replaced by one NumPy function of the
observations (``torch_port_helpers.fake_surrogates``).

Both packages recommend from one shared history each round. The genetic
optimizer's picks are NumPy draws: equal exactly. The Adam refiner takes 150
float32 steps, each divided by sqrt(v); where the acquisition is nearly flat
its gradients are rounding, which Adam scales up to whole steps, so a refined
coordinate can land elsewhere on a plateau. A pick is therefore held equal
(categorical) and within 1e-4 (continuous), or else its acquisition value
under the port's model within 1e-4 of the JAX pick's value under the same
model. ``refine_descriptors`` is held by what it preserves (see its test).
"""
import json

import numpy as np
import pytest
import torch

from event_representation_study_tpu.cli import bo as j_bo
from event_representation_study_tpu.search import mixed as j_mixed
from event_representation_study_tpu_torch.cli import bo as t_bo
from event_representation_study_tpu_torch.search import kernels as t_kernels
from event_representation_study_tpu_torch.search import mixed as t_mixed
from torch_port_helpers import assert_close
from torch_port_helpers import fake_surrogates  # noqa: F401 (a fixture)


def _space(pkg):
    desc = np.array([[0.0, 1.0], [1.0, 0.2], [2.0, 0.5]])
    return [pkg.CategoricalParamD("c", ["a", "b", "c"], desc),
            pkg.CategoricalParamD("d", ["u", "v"]),
            pkg.ContinuousParam("x", 0.0, 1.0, periodic=True),
            pkg.ContinuousParam("y", -2.0, 2.0),
            pkg.DiscreteParam("k", 1, 5)]


def _objective(r):
    return (r["x"] - 0.7) ** 2 + (0.0 if r["c"] == "b" else 0.4) + 0.1 * (r["d"] == "u") \
        + 0.05 * abs(r["k"] - 3) + 0.1 * r["y"] ** 2


def _record(monkeypatch, cls, log):
    """Log (model, lambda, pick) of every acquisition optimization."""
    real = cls._optimize

    def optimize(self, model, lam, *a, **k):
        out = real(self, model, lam, *a, **k)
        log.append((model, lam, out))
        return out

    monkeypatch.setattr(cls, "_optimize", optimize)


def _same_pick(got, want, exact: bool) -> bool:
    (gc, gx), (wc, wx) = got, want
    return np.array_equal(gc, wc) and (np.array_equal(gx, wx) if exact
                                       else np.abs(gx - wx).max() <= 1e-4)


@pytest.mark.parametrize("optimizer,dynamic", [("genetic", False), ("adam", False),
                                               ("adam", True)],
                         ids=["genetic", "adam", "adam_dynamic_descriptors"])
def test_mixed_gryffin_matches_jax(optimizer, dynamic, fake_surrogates, monkeypatch):
    """Static descriptors, a periodic dimension, a discrete one; the genetic
    and the Adam acquisition optimizers; dynamic descriptor refinement (both
    packages reshape with the port's refined descriptors, held against
    JAX's in the test below)."""
    monkeypatch.setattr(j_mixed, "refine_descriptors",
                        lambda D, v: t_mixed.refine_descriptors(D, v, device="cpu"))
    log_j, log_t = [], []
    _record(monkeypatch, j_mixed.MixedGryffin, log_j)
    _record(monkeypatch, t_mixed.MixedGryffin, log_t)
    kw = dict(random_seed=7, acquisition_optimizer=optimizer, dynamic_descriptors=dynamic)
    gj = j_mixed.MixedGryffin(_space(j_mixed), **kw)
    gt = t_mixed.MixedGryffin(_space(t_mixed), device="cpu", **kw)
    obs = []
    for it in range(3):  # a random round, then two of the optimizer
        strategies = (-1, 1) if it % 2 == 0 else (1, -1)
        want = gj.recommend(obs, sampling_strategies=strategies)
        got = gt.recommend(obs, sampling_strategies=strategies)
        if it == 0:
            assert got == want
        obs += [dict(r, obj=_objective(r)) for r in want]
    assert len(log_t) == len(log_j) == 4
    for (model, lam, got), (_, _, want) in zip(log_t, log_j):
        if _same_pick(got, want, exact=optimizer == "genetic"):
            continue
        assert optimizer == "adam", (got, want)
        values = [t_kernels.mixed_acquisition_values(
            model, c[None], torch.as_tensor(x[None], dtype=torch.float32), lam).item()
            for c, x in (got, want)]
        assert_close("acquisition value of the port's pick vs JAX's", values[0], values[1],
                     atol=1e-4 * max(1.0, abs(values[1])))


def test_refine_descriptors_vs_jax():
    """The refinement learns a per-column scale and bias of the descriptors
    that maximize each column's squared correlation with the objective. A
    column's correlation is invariant to both, so their gradients are zero
    up to rounding, and Adam scales rounding up to whole steps: in either
    package the learned scale and bias are what rounding makes of them
    (a quirk of the reference, kept). What both must hold: every refined
    column is an affine map of its input column, and its |correlation| with
    the objective equals the input's and JAX's (rtol 1e-4)."""
    rng = np.random.default_rng(1)
    y = rng.random(8)
    D = np.stack([y + rng.normal(0, 0.5, 8), rng.normal(0, 1, 8)], -1)
    got = t_mixed.refine_descriptors(D, y, device="cpu")
    want = j_mixed.refine_descriptors(D, y)

    def corr(a, b):
        return np.array([abs(np.corrcoef(a[:, j], b if b.ndim == 1 else b[:, j])[0, 1])
                         for j in range(a.shape[1])])

    assert np.isfinite(got).all()
    assert_close("|corr| of refined and input columns", corr(got, D), np.ones(2), atol=1e-5)
    assert_close("|corr| with the objective vs JAX", corr(got, y), corr(want, y), atol=0,
                 rtol=1e-4)
    assert_close("|corr| with the objective vs input", corr(got, y), corr(D, y), atol=0,
                 rtol=1e-4)


def test_bo_cli_matches_jax(fake_surrogates, tmp_path):
    """``cli/bo.py --device cpu`` writes the recommendations the JAX CLI
    writes, from one config and one observations file (Adam refiner)."""
    cfg = {"parameters": [
        {"name": "a", "type": "categorical", "options": ["x", "y", "z"],
         "descriptors": [[0.0], [1.0], [2.0]]},
        {"name": "lr", "type": "continuous", "low": 0.001, "high": 0.1},
        {"name": "k", "type": "discrete", "low": 1, "high": 9}],
        "objective": "min", "batch": 2}
    (tmp_path / "space.json").write_text(json.dumps(cfg))
    obs = [{"a": "x", "lr": 0.01, "k": 2, "obj": 1.0}, {"a": "y", "lr": 0.05, "k": 5, "obj": 0.2},
           {"a": "z", "lr": 0.002, "k": 8, "obj": 0.9}]
    (tmp_path / "obs.json").write_text(json.dumps(obs))
    args = ["--config", str(tmp_path / "space.json"), "--observations", str(tmp_path / "obs.json")]
    j_bo.main(args + ["--out", str(tmp_path / "want.json")])
    t_bo.main(args + ["--out", str(tmp_path / "got.json"), "--device", "cpu"])
    got = json.loads((tmp_path / "got.json").read_text())
    want = json.loads((tmp_path / "want.json").read_text())
    assert [(r["a"], r["k"]) for r in got] == [(r["a"], r["k"]) for r in want]
    # lr spans 0.099: 1e-4 of the normalized coordinate
    assert_close("continuous lr", [r["lr"] for r in got], [r["lr"] for r in want],
                 atol=1e-4 * 0.099)
