"""Mixed-parameter Bayesian optimization — completes the gryffin surface
beyond the study's categorical case: continuous and discrete parameters
(torch_interface/bnn.py:183-249 heads), static descriptors with the
kernel-reshaping math (kernel_prob_reshaping.pyx), and DYNAMIC descriptor
refinement (gryffin/src/gryffin/descriptor_generator/: learn a linear map of
the descriptors whose induced option embedding correlates with the
objective, then reshape the kernels in the learned space).

The acquisition is the same vectorized GA as the categorical path, extended
with Gaussian mutation + clipping on the continuous axes (the reference
offers adam|genetic refiners; genetic is what the study used).

The port of the JAX package's ``search/mixed.py``: the surrogate, the kernel
density and both Adam loops (the acquisition refiner and the descriptor
refinement) run in torch on ``device``; the random proposals and the GA
keep the JAX package's NumPy call sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .kernels import mixed_acquisition_values


@dataclasses.dataclass
class CategoricalParamD:
    name: str
    options: List[str]
    descriptors: Optional[np.ndarray] = None  # (n_options, n_desc)


@dataclasses.dataclass
class ContinuousParam:
    name: str
    low: float
    high: float
    # periodic continuous kernel (kernel_evaluations.pyx:29-43, kernel type
    # 1): distances wrap across [low, high] — for angular/cyclic parameters
    periodic: bool = False


@dataclasses.dataclass
class DiscreteParam:
    """Integer grid in [low, high] — gryffin treats these as continuous with
    rounding at decode time."""

    name: str
    low: int
    high: int


def refine_descriptors(
    descriptors: np.ndarray,  # (n_options, n_desc)
    option_values: np.ndarray,  # (n_options,) mean objective per option
    steps: int = 200,
    lr: float = 0.1,
    device="cuda",
) -> np.ndarray:
    """Dynamic refinement (descriptor_generator/generator.py): learn a
    diagonal + bias transform W of the descriptors maximizing the squared
    correlation between each transformed descriptor column and the per-option
    objective landscape. Options the BO found good move together in the
    refined space, sharpening the reshaped kernels. A column's correlation
    is invariant to its scale and bias, though, so their gradients are zero
    up to rounding, which Adam scales up to whole steps: the result is each
    column under an affine map that rounding picks, in the JAX package too
    (kept as it is). Adam (the update of ``optax.adam``) runs on ``device``:
    ``cuda`` unless the caller passes ``cpu``."""
    device = resolve_device(device)
    D = torch.as_tensor(descriptors, dtype=torch.float32, device=device)
    y = torch.as_tensor(option_values, dtype=torch.float32, device=device)
    y = (y - y.mean()) / (y.std(unbiased=False) + 1e-9)
    yc = y - y.mean()
    scale = torch.ones(D.shape[1], device=device, requires_grad=True)
    bias = torch.zeros(D.shape[1], device=device, requires_grad=True)
    opt = torch.optim.Adam([scale, bias], lr=lr)
    for _ in range(steps):
        T = D * scale[None, :] + bias[None, :]
        Tc = T - T.mean(dim=0, keepdim=True)
        num = (Tc * yc[:, None]).sum(dim=0)
        den = torch.sqrt((Tc**2).sum(dim=0) * (yc**2).sum() + 1e-9)
        opt.zero_grad()
        (-torch.mean((num / den) ** 2)).backward()
        opt.step()
    with torch.no_grad():
        return (D * scale[None, :] + bias[None, :]).cpu().numpy()


class MixedGryffin:
    """recommend() over mixed spaces with gryffin's surface."""

    def __init__(
        self,
        parameters: Sequence,
        objective: str = "min",
        known_constraints: Optional[Callable[[Dict], bool]] = None,
        random_seed: int = 42,
        num_random: int = 2,
        bnn_train_steps: int = 500,
        bnn_draws: int = 200,
        dynamic_descriptors: bool = False,
        acquisition_optimizer: str = "adam",
        objectives: Optional[Sequence[Dict]] = None,
        device="cuda",
    ):
        # gryffin's package default is "adam" (utilities/defaults.py:11-32);
        # the study's categorical search configures "genetic"
        # (optimization.py:223)
        assert acquisition_optimizer in ("adam", "genetic")
        self.device = resolve_device(device)
        self.params = list(parameters)
        # multi-objective: Chimera hierarchy scalarized to a min-merit
        # before the BO loop (observation_processor.py:14,88)
        self.objectives = list(objectives) if objectives else None
        if self.objectives is not None:
            objective = "min"
        self.cat_params = [p for p in self.params if isinstance(p, CategoricalParamD)]
        self.num_params = [
            p for p in self.params
            if isinstance(p, (ContinuousParam, DiscreteParam))
        ]
        self.objective = objective
        self.known_constraints = known_constraints
        self.rng = np.random.default_rng(random_seed)
        self.num_random = num_random
        self.bnn_train_steps = bnn_train_steps
        self.bnn_draws = bnn_draws
        self.dynamic_descriptors = dynamic_descriptors
        self.option_counts = tuple(len(p.options) for p in self.cat_params)
        self._seed = random_seed
        self.acquisition_optimizer = acquisition_optimizer
        self._periodic_mask = np.array(
            [float(getattr(p, "periodic", False)) for p in self.num_params],
            np.float32,
        )

    # -- encode / decode -----------------------------------------------
    def _encode(self, obs: Dict) -> Tuple[np.ndarray, np.ndarray]:
        cat = np.array(
            [p.options.index(obs[p.name]) for p in self.cat_params], np.int64
        )
        cont = np.array(
            [
                (float(obs[p.name]) - p.low) / (p.high - p.low)
                for p in self.num_params
            ],
            np.float64,
        )
        return cat, cont

    def _decode(self, cat, cont) -> Dict:
        out = {}
        for p, v in zip(self.cat_params, cat):
            out[p.name] = p.options[int(v)]
        for p, v in zip(self.num_params, cont):
            raw = p.low + float(np.clip(v, 0, 1)) * (p.high - p.low)
            out[p.name] = int(round(raw)) if isinstance(p, DiscreteParam) else raw
        return out

    def _random(self, n):
        cat = (
            np.stack([self.rng.integers(0, c, n) for c in self.option_counts], -1)
            if self.option_counts
            else np.zeros((n, 0), np.int64)
        )
        cont = self.rng.random((n, len(self.num_params)))
        if self.known_constraints is not None:
            keep = [
                i for i in range(n)
                if self.known_constraints(self._decode(cat[i], cont[i]))
            ]
            cat, cont = cat[keep], cont[keep]
        return cat, cont

    def _random_n(self, n, max_tries=50):
        cats, conts = [], []
        got = 0
        for _ in range(max_tries):
            c, x = self._random(n)
            cats.append(c)
            conts.append(x)
            got += len(c)
            if got >= n:
                break
        return np.concatenate(cats)[:n], np.concatenate(conts)[:n]

    # -- main API --------------------------------------------------------
    def recommend(
        self,
        observations: Sequence[Dict],
        sampling_strategies: Sequence[float] = (-1, 1),
        objective_key: str = "obj",
    ) -> List[Dict]:
        if self.objectives is not None:
            from .chimera import scalarize_observations

            observations = scalarize_observations(
                self.objectives, observations, objective_key)
        n_batch = len(sampling_strategies)
        valid = [o for o in observations if np.isfinite(o.get(objective_key, np.nan))]
        if len(valid) < self.num_random:
            cat, cont = self._random_n(n_batch)
            return [self._decode(c, x) for c, x in zip(cat, cont)]

        from . import bnn
        from .kernels import MixedKernelModel, reshape_probs

        cat_X = np.stack([self._encode(o)[0] for o in valid])
        cont_X = np.stack([self._encode(o)[1] for o in valid])
        y = np.array([float(o[objective_key]) for o in valid])
        if self.objective == "max":
            y = -y
        span = y.max() - y.min()
        y_n = (y - y.min()) / (span if span > 0 else 1.0)

        # looked up at call time, so that a caller can replace the surrogate
        cat_probs, locs, sqrt_prec = (
            torch.as_tensor(a, dtype=torch.float32, device=self.device)
            for a in bnn.fit_mixed_kernels(
                self._seed + len(valid), cat_X, self.option_counts, cont_X,
                len(self.num_params), train_steps=self.bnn_train_steps,
                n_draws=self.bnn_draws, device=self.device,
            )
        )

        # descriptor reshaping (static and/or dynamically refined)
        descs = []
        for d, p in enumerate(self.cat_params):
            D = p.descriptors
            if D is not None and self.dynamic_descriptors and len(valid) >= 4:
                opt_vals = np.zeros(len(p.options))
                for k in range(len(p.options)):
                    m = cat_X[:, d] == k
                    opt_vals[k] = y_n[m].mean() if m.any() else y_n.mean()
                D = refine_descriptors(np.asarray(D, np.float64), opt_vals,
                                       device=self.device)
            descs.append(D)
        if any(d is not None for d in descs) and sum(self.option_counts):
            cat_probs = reshape_probs(cat_probs, descs, self.option_counts)

        offsets = (
            np.concatenate([[0], np.cumsum(self.option_counts)])[:-1]
            if self.option_counts
            else np.zeros((0,), np.int64)
        )
        vol = float(np.prod(self.option_counts)) if self.option_counts else 1.0
        model = MixedKernelModel(
            cat_probs=cat_probs,
            offsets=torch.as_tensor(offsets, dtype=torch.int64, device=self.device),
            locs=locs,
            sqrt_prec=sqrt_prec,
            objs=torch.as_tensor(y_n, dtype=torch.float32, device=self.device),
            inv_vol=1.0 / vol,
            periodic=torch.as_tensor(self._periodic_mask, device=self.device),
        )

        selected = []
        for lam in sampling_strategies:
            cat, cont = self._optimize(model, float(lam))
            selected.append((cat, cont))
        return [self._decode(c, x) for c, x in selected]

    def _optimize(self, model, lam, population=200, generations=10,
                  mutation_rate=0.25):
        if self.acquisition_optimizer == "adam" and self.num_params:
            return self._optimize_adam(model, lam, population)
        return self._optimize_genetic(model, lam, population, generations,
                                      mutation_rate)

    def _optimize_adam(self, model, lam, population=200, top_k=16,
                       steps=150, lr=0.05):
        """Gradient acquisition refinement, the package-default optimizer
        (gryffin/src/gryffin/acquisition/gradient_optimizer/, ~525 LoC of
        hand-rolled Adam + naive steppers; defaults.py:11-32 "adam"). Random
        feasible proposals are refined: Adam on the continuous coordinates
        (one batched loop over the whole top-k batch through torch autograd
        replaces the per-proposal process fan-out, acquisition.py:115-137),
        then a naive coordinate-descent pass over each categorical dimension
        (the discrete one-hot stepper's effect, exact for small option
        counts). Periodic dims wrap mod 1 instead of clipping."""
        cat, cont = self._random_n(population)
        vals = self._values(model, cat, cont, lam)
        order = np.argsort(vals)[:top_k]
        cat, cont = cat[order], cont[order]
        per = torch.as_tensor(self._periodic_mask, device=self.device)[None, :] > 0

        def wrap(x):
            return torch.where(per, torch.remainder(x, 1.0), torch.clamp(x, 0.0, 1.0))

        x = torch.as_tensor(cont, dtype=torch.float32, device=self.device).requires_grad_()
        opt = torch.optim.Adam([x], lr=lr)
        for _ in range(steps):
            opt.zero_grad()
            mixed_acquisition_values(model, cat, wrap(x), lam).sum().backward()
            opt.step()
        with torch.no_grad():
            cont = wrap(x).cpu().numpy().astype(np.float64)
        # naive categorical stepper: exact best option per dim, in turn
        for d, count in enumerate(self.option_counts):
            trial_cat = np.repeat(cat, count, axis=0)
            trial_cat[:, d] = np.tile(np.arange(count), len(cat))
            trial_cont = np.repeat(cont, count, axis=0)
            v = self._values(model, trial_cat, trial_cont, lam).reshape(len(cat), count)
            cat[:, d] = np.argmin(v, axis=1)
        vals = self._values(model, cat, cont, lam)
        if self.known_constraints is not None:
            feas = np.array([
                self.known_constraints(self._decode(c, x))
                for c, x in zip(cat, cont)
            ])
            if feas.any():
                vals = np.where(feas, vals, np.inf)
            else:  # all refined points infeasible: fall back to feasible draw
                rc, rx = self._random_n(1)
                return rc[0], rx[0]
        best = int(np.argmin(vals))
        return cat[best], cont[best]

    def _values(self, model, cat, cont, lam) -> np.ndarray:
        """Acquisition values of (cat, cont) candidates as NumPy."""
        x = torch.as_tensor(cont, dtype=torch.float32, device=self.device)
        return mixed_acquisition_values(model, cat, x, lam).cpu().numpy()

    def _optimize_genetic(self, model, lam, population=200, generations=10,
                          mutation_rate=0.25):
        """GA over the mixed space: categorical resampling + Gaussian
        perturbation of continuous genes (genetic_optimizer.py's constrained
        evolution with gryffin's continuous mutations)."""
        cat, cont = self._random_n(population)

        def evaluate(c, x):
            return self._values(model, c, x, lam)

        vals = evaluate(cat, cont)
        n_elite = max(population // 5, 1)
        for _ in range(generations):
            order = np.argsort(vals)
            cat, cont, vals = cat[order], cont[order], vals[order]
            e_cat, e_cont = cat[:n_elite], cont[:n_elite]
            n_child = population - n_elite
            a = self.rng.integers(0, population // 2, n_child)
            b = self.rng.integers(0, population // 2, n_child)
            if cat.shape[1]:
                mask = self.rng.random((n_child, cat.shape[1])) < 0.5
                c_cat = np.where(mask, cat[a], cat[b])
                mut = self.rng.random(c_cat.shape) < mutation_rate
                res = np.stack(
                    [self.rng.integers(0, c, n_child) for c in self.option_counts],
                    -1,
                )
                c_cat = np.where(mut, res, c_cat)
            else:
                c_cat = np.zeros((n_child, 0), np.int64)
            if cont.shape[1]:
                w = self.rng.random((n_child, cont.shape[1]))
                c_cont = w * cont[a] + (1 - w) * cont[b]
                mut = self.rng.random(c_cont.shape) < mutation_rate
                c_cont = np.clip(
                    np.where(mut, c_cont + self.rng.normal(0, 0.1, c_cont.shape),
                             c_cont),
                    0.0, 1.0,
                )
            else:
                c_cont = np.zeros((n_child, 0))
            if self.known_constraints is not None:
                for i in range(n_child):
                    tries = 0
                    while not self.known_constraints(
                        self._decode(c_cat[i], c_cont[i])
                    ) and tries < 20:
                        rc, rx = self._random_n(1)
                        c_cat[i], c_cont[i] = rc[0], rx[0]
                        tries += 1
            cat = np.concatenate([e_cat, c_cat])
            cont = np.concatenate([e_cont, c_cont])
            vals = evaluate(cat, cont)
        best = int(np.argmin(vals))
        return cat[best], cont[best]
