"""Kernel-density acquisition math on tensors: the port of the JAX package's
``search/kernels.py`` (gryffin's Cython inner loop,
gryffin/src/gryffin/bayesian_network/kernel_evaluations.pyx).

For a candidate x, each (posterior draw, observation) contributes a product
kernel over dimensions:
- continuous: (1/sqrt(2 pi)) * sqrt_prec * exp(-0.5 (sqrt_prec (x - loc))^2)
  (kernel_evaluations.pyx:19-26 ``_gauss``)
- categorical: cat_probs[draw, obs, offset + x] (:146-151)
probs[obs] = mean over draws (:156-168); the acquisition numerator/
denominator are num = sum_obs objs*probs, inv_den = 1/(inv_vol + sum probs)
(:171-193). All draws of all candidates are evaluated in one batched
reduction, as in the JAX package (which drops the reference's 10%-draw
early exit).

Plain tensor functions on the model's device: the JAX package wrote no
Pallas kernel here (its version is XLA einsums), so neither does the port.
Candidates may be NumPy arrays or tensors; results are tensors on the
model's device. ``search/native/`` holds the float64 C twin of
:func:`kernel_contribution` and :func:`reshape_probs_one_dim`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INV_SQRT_2PI = 0.3989422804014327


def _index(samples, device) -> torch.Tensor:
    return torch.as_tensor(samples, device=device).to(torch.int64)


def _float(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass
class KernelModel:
    """Posterior kernels for categorical search spaces (the study's case:
    every MDES dimension is categorical, optimization.py:148-165)."""

    cat_probs: torch.Tensor  # (draws, obs, total_options) float32
    offsets: torch.Tensor  # (num_dims,) int64 start of each dim's option block
    objs: torch.Tensor  # (obs,) normalized objective values
    inv_vol: float  # 1 / feasible-volume estimate

    @property
    def device(self) -> torch.device:
        return self.cat_probs.device


def categorical_probs(model: KernelModel, samples) -> torch.Tensor:
    """probs (num_samples, obs): mean over draws of the product over dims of
    the categorical kernel probabilities at each candidate."""
    idx = model.offsets.to(torch.int64)[None, :] + _index(samples, model.device)  # (S, D)
    p = model.cat_probs[:, :, idx]  # (draws, obs, S, D)
    return torch.prod(p, dim=-1).mean(dim=0).T  # (S, obs)


def kernel_contribution(model: KernelModel, samples):
    """(num, inv_den) per candidate (kernel_evaluations.pyx:171-193)."""
    probs = categorical_probs(model, samples)  # (S, obs)
    num = probs @ model.objs
    den = probs.sum(dim=-1)
    return num, 1.0 / (model.inv_vol + den)


def acquisition_values(model: KernelModel, samples, lam: float) -> torch.Tensor:
    """(num + lambda * inv_vol) * inv_den: gryffin's per-strategy
    acquisition (acquisition.py:255 with sampling_param = strategy *
    inverse_volume, gryffin.py:373-375); minimized. At unexplored points the
    value is the strategy lambda, so lambda=-1 is pure exploration and +1
    pure exploitation regardless of the grid size."""
    num, inv_den = kernel_contribution(model, samples)
    return (num + float(lam) * model.inv_vol) * inv_den


def regression_surrogate(model: KernelModel, samples) -> torch.Tensor:
    """Kernel-regression prediction (kernel_evaluations.pyx:195-216)."""
    probs = categorical_probs(model, samples)
    return (probs @ model.objs) / (probs.sum(dim=-1) + 1e-12)


def kernel_density(model: KernelModel, samples) -> torch.Tensor:
    """Mean kernel density of a candidate under the model's observation set
    (kernel_evaluations.pyx:218-245 get_kernel_density)."""
    return categorical_probs(model, samples).mean(dim=-1)


def feasibility_posterior(feas_model: KernelModel, infeas_model: KernelModel, samples,
                          prior_infeas: float) -> torch.Tensor:
    """p(infeasible | x) by Bayes over the two kernel densities
    (kernel_evaluations.pyx:247-293 posterior; bayesian_network.py:128-140
    prior split)."""
    d_feas = kernel_density(feas_model, samples)
    d_infeas = kernel_density(infeas_model, samples)
    num = prior_infeas * d_infeas
    den = (1.0 - prior_infeas) * d_feas + num
    return num / (den + 1e-12)


def reshape_probs_one_dim(cat_probs: torch.Tensor, descriptors: torch.Tensor) -> torch.Tensor:
    """Descriptor-space reshaping of one categorical dimension's kernels
    (gryffin/src/gryffin/bayesian_network/kernel_prob_reshaping.pyx:30-70):
    per (draw, obs): the prob-weighted average descriptor, per-option
    descriptor distances, softmax(-distance).

    cat_probs (draws, obs, n_options); descriptors (n_options, n_desc). As in
    the JAX package, the full per-descriptor average vector is used (the
    Cython loop keeps only the last descriptor's average)."""
    K = descriptors.shape[0]
    avg = torch.einsum("sok,kd->sod", cat_probs, descriptors)
    diff = K * (descriptors[None, None, :, :] - avg[:, :, None, :])
    dist = torch.sqrt(torch.mean(diff * diff, dim=-1))  # (s, o, K)
    return torch.softmax(-dist, dim=-1)


def reshape_probs(cat_probs: torch.Tensor, descriptors_per_dim, option_counts) -> torch.Tensor:
    """Per-dimension descriptor reshaping over the concatenated option axis;
    dims with ``None`` descriptors keep their raw kernels (gryffin's naive
    vs static categories)."""
    out = []
    off = 0
    for count, desc in zip(option_counts, descriptors_per_dim):
        block = cat_probs[..., off: off + count]
        if desc is not None:
            block = reshape_probs_one_dim(block, _float(desc, cat_probs.device))
        out.append(block)
        off += count
    return torch.cat(out, dim=-1)


@dataclasses.dataclass
class MixedKernelModel:
    """Kernels for mixed categorical + continuous spaces
    (kernel_evaluations.pyx:19-26 gaussian factors x :146-151 categorical)."""

    cat_probs: torch.Tensor  # (draws, obs, total_options) (total may be 0)
    offsets: torch.Tensor  # (Dcat,)
    locs: torch.Tensor  # (draws, obs, Dc) (Dc may be 0)
    sqrt_prec: torch.Tensor  # (draws, obs, Dc)
    objs: torch.Tensor  # (obs,)
    inv_vol: float
    # per-continuous-dim periodic flag (kernel type 1,
    # kernel_evaluations.pyx:30-43,132-140): the Gaussian distance wraps
    # across the normalized [0, 1] range; 0.0 = plain (type 0)
    periodic: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.objs.device


def mixed_probs(model: MixedKernelModel, cat_samples, cont_samples) -> torch.Tensor:
    """probs (S, obs): mean over draws of the product kernel. ``cont_samples``
    may be a tensor that requires grad (the Adam acquisition optimizer)."""
    prod = None
    if model.cat_probs.shape[-1]:
        idx = model.offsets.to(torch.int64)[None, :] + _index(cat_samples, model.device)
        prod = torch.prod(model.cat_probs[:, :, idx], dim=-1)  # (draws, obs, S)
    if model.locs.shape[-1]:
        x = cont_samples if torch.is_tensor(cont_samples) else _float(cont_samples, model.device)
        d = torch.abs(x[None, None, :, :] - model.locs[:, :, None, :])
        if model.periodic is not None and model.periodic.shape[0]:
            # closest distance across the boundary: min(d, range - d) with
            # unit normalized range (_gauss_periodic, pyx:29-43)
            d = torch.where(model.periodic > 0, torch.minimum(d, 1.0 - d), d)
        sp = model.sqrt_prec[:, :, None, :]
        g = torch.prod(INV_SQRT_2PI * sp * torch.exp(-0.5 * (sp * d) ** 2), dim=-1)
        prod = g if prod is None else prod * g
    return prod.mean(dim=0).T  # (S, obs)


def mixed_acquisition_values(model: MixedKernelModel, cat_samples, cont_samples,
                             lam: float) -> torch.Tensor:
    """Same lambda semantics as :func:`acquisition_values`:
    sampling_param = lambda * inv_vol (gryffin.py:373-375)."""
    probs = mixed_probs(model, cat_samples, cont_samples)
    num = probs @ model.objs
    den = probs.sum(dim=-1)
    return (num + float(lam) * model.inv_vol) / (model.inv_vol + den)
