"""Bayesian-optimization facade with gryffin's public surface
(gryffin/src/gryffin/gryffin.py): categorical parameter spaces,
``recommend(observations, sampling_strategies)`` returning parameter dicts,
``known_constraints`` support, random fallback before enough observations.
The port of the JAX package's ``search/gryffin.py``.

The stack underneath: the mean-field VI surrogate (``bnn.py``) and the
batched kernel density (``kernels.py``) run in torch on ``device``; the
acquisition search (``acquisition.py``) runs in NumPy on the host with the
JAX package's random call sequence, so with the same surrogate draws both
packages make the same recommendations. Sampling strategies are the
reference's alternating lambda values (+1 exploit / -1 explore, gryffin's
AcquisitionFunction blending).

Feasibility handling follows the reference:
- the feasible-volume fraction is estimated by constrained sampling
  (gryffin.py:70-92 estimate_feas_fraction) and scales inv_vol;
- observations whose objective is NaN are *measured infeasible* points; with
  any present, the acquisition becomes the FIA blend
  ``w * p(infeasible|x) + (1-w) * acq_norm`` with ``w = frac_infeasible``
  (acquisition.py:689-792 _fia_acquisition, feas_param=1.0), where
  p(infeasible|x) is the Bayes posterior over the two kernel densities
  (kernel_evaluations.pyx:247-293).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass
class CategoricalParam:
    name: str
    options: List[str]


class Gryffin:
    def __init__(
        self,
        parameters: Sequence[CategoricalParam],
        objective: str = "min",
        known_constraints: Optional[Callable[[Dict], bool]] = None,
        random_seed: int = 42,
        num_random: int = 2,
        bnn_train_steps: int = 500,
        bnn_draws: int = 200,
        feas_param: float = 1.0,
        objectives: Optional[Sequence[Dict]] = None,
        device="cuda",
    ):
        """``objectives`` switches on gryffin's multi-objective mode: a
        hierarchy of ``{"name", "goal", "tolerance", "absolute"}`` dicts
        scalarized through Chimera before the BO loop (the reference's
        observation_processor.py:14,88); the scalarized merit is minimized
        regardless of ``objective``. The surrogate and the kernel density
        run on ``device`` (``cuda`` unless the caller passes ``cpu``)."""
        self.device = resolve_device(device)
        self.params = list(parameters)
        self.objective = objective
        self.objectives = list(objectives) if objectives else None
        if self.objectives is not None:
            self.objective = "min"  # Chimera merit is always minimized
        self.known_constraints = known_constraints
        self.rng = np.random.default_rng(random_seed)
        self.num_random = num_random
        self.bnn_train_steps = bnn_train_steps
        self.bnn_draws = bnn_draws
        self.feas_param = feas_param
        self.option_counts = tuple(len(p.options) for p in self.params)
        self._seed = random_seed
        self._feas_frac: Optional[float] = None

    # -- encoding ----------------------------------------------------------
    def _encode(self, obs: Dict) -> np.ndarray:
        return np.array(
            [p.options.index(obs[p.name]) for p in self.params], np.int64
        )

    def _decode(self, vec) -> Dict:
        return {p.name: p.options[int(v)] for p, v in zip(self.params, vec)}

    def _constraint_vec(self):
        if self.known_constraints is None:
            return None
        return lambda v: self.known_constraints(self._decode(v))

    def feasible_fraction(self, n_samples: int = 2048) -> float:
        """Monte-Carlo estimate of the feasible-volume fraction
        (gryffin.py:70-92 / utilities estimate_feas_fraction)."""
        if self.known_constraints is None:
            return 1.0
        if self._feas_frac is None:
            rng = np.random.default_rng(self._seed + 12345)
            cand = np.stack(
                [rng.integers(0, c, n_samples) for c in self.option_counts],
                axis=-1,
            )
            ok = np.array([self.known_constraints(self._decode(v)) for v in cand])
            self._feas_frac = float(max(ok.mean(), 1.0 / n_samples))
        return self._feas_frac

    # -- main API ----------------------------------------------------------
    def recommend(
        self,
        observations: Sequence[Dict],
        sampling_strategies: Sequence[float] = (-1, 1),
        objective_key: str = "obj",
    ) -> List[Dict]:
        from . import bnn
        from .acquisition import (
            enumerate_feasible,
            optimize_acquisition,
            random_feasible,
            select_diverse,
        )
        from .kernels import KernelModel, acquisition_values, feasibility_posterior

        if self.objectives is not None:
            from .chimera import scalarize_observations

            observations = scalarize_observations(
                self.objectives, observations, objective_key)
        n_batch = len(sampling_strategies)
        scored = [o for o in observations if objective_key in o]
        feas = [o for o in scored if np.isfinite(o.get(objective_key, np.nan))]
        infeas = [o for o in scored if not np.isfinite(o.get(objective_key, np.nan))]
        if len(feas) < self.num_random:
            cand = random_feasible(
                self.rng, self.option_counts, n_batch, self._constraint_vec()
            )
            return [self._decode(c) for c in cand]

        X_feas = np.stack([self._encode(o) for o in feas])
        X_all = (
            np.concatenate([X_feas, np.stack([self._encode(o) for o in infeas])])
            if infeas
            else X_feas
        )
        y = np.array([float(o[objective_key]) for o in feas])
        if self.objective == "max":
            y = -y
        # normalize objectives like gryffin's observation processor
        y_span = y.max() - y.min()
        y_n = (y - y.min()) / (y_span if y_span > 0 else 1.0)

        # looked up at call time, so that a caller can replace the surrogate
        cat_probs = bnn.fit_categorical_kernels(
            self._seed + len(scored), X_all, self.option_counts,
            train_steps=self.bnn_train_steps, n_draws=self.bnn_draws, device=self.device,
        )
        cat_probs = torch.as_tensor(cat_probs, dtype=torch.float32, device=self.device)
        offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(self.option_counts)])[:-1],
                                  device=self.device)
        feas_frac = self.feasible_fraction()
        inv_vol = 1.0 / (float(np.prod(self.option_counts)) * feas_frac)
        nf = len(feas)
        model = KernelModel(
            cat_probs=cat_probs[:, :nf],
            offsets=offsets,
            objs=torch.as_tensor(y_n, dtype=torch.float32, device=self.device),
            inv_vol=inv_vol,
        )
        frac_infeas = len(infeas) / len(scored)
        infeas_model = None
        if infeas:
            infeas_model = KernelModel(
                cat_probs=cat_probs[:, nf:],
                offsets=offsets,
                objs=torch.zeros((len(infeas),), device=self.device),
                inv_vol=inv_vol,
            )

        # normalization range for the FIA blend, estimated over random
        # feasible proposals (Acquisition.propose's acq_min/max estimate)
        probe = random_feasible(
            self.rng, self.option_counts, 256, self._constraint_vec()
        )

        # exhaustive-option mode (sample_selector's fully-categorical path):
        # small grids get the exact acquisition argmin instead of the GA
        exhaustive = enumerate_feasible(
            self.option_counts, self._constraint_vec()
        )

        selected = []
        prev = X_all
        for lam_strategy in sampling_strategies:
            lam = float(lam_strategy)
            if infeas_model is not None and 0.0 < frac_infeas < 1.0:
                pv = acquisition_values(model, probe, lam).cpu().numpy()
                acq_min, acq_max = float(pv.min()), float(pv.max())
                inv_range = 1.0 / max(acq_max - acq_min, 1e-9)
                w = frac_infeas ** self.feas_param

                def acq_fn(p, _lam=lam, _w=w, _a0=acq_min, _ir=inv_range):
                    a = (acquisition_values(model, p, _lam) - _a0) * _ir
                    pi = feasibility_posterior(model, infeas_model, p, frac_infeas)
                    return (_w * pi + (1.0 - _w) * a).cpu().numpy()

                acq = acq_fn
            else:
                acq = (model, lam)
            if exhaustive is not None:
                if isinstance(acq, tuple):
                    vals = acquisition_values(model, exhaustive, lam).cpu().numpy()
                else:
                    vals = np.asarray(acq(exhaustive))
                order = np.argsort(vals)
                cands, vals = exhaustive[order], vals[order]
            else:
                cands, vals = optimize_acquisition(
                    acq, self.option_counts, self.rng, self._constraint_vec()
                )
            pick = select_diverse(
                cands, vals,
                np.concatenate([prev] + [
                    np.asarray(selected).reshape(-1, len(self.params))
                ]) if selected else prev,
                n=1, diversity_penalty=0.1,
            )
            selected.append(pick[0])
        return [self._decode(s) for s in selected]
