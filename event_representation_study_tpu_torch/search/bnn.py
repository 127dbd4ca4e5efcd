"""Bayesian-neural-network surrogate for the categorical kernel density: the
port of the JAX package's ``search/bnn.py`` (gryffin's torchbnn surrogate,
gryffin/src/gryffin/torch_interface/bnn.py + numpy_graph.py).

Architecture and training follow the reference defaults
(utilities/defaults.py:48-58): 3 mean-field variational dense layers, hidden
size 6, 2000 Adam steps at lr 0.05, 1000 posterior weight draws. For
categorical parameters the network maps each observed one-hot configuration
to per-option logits; per (draw, observation) the softmax gives the
categorical kernel probabilities.

The JAX package fits in one jitted ``lax.scan`` and draws with a
``vmap``. Here the fit is an eager loop of ``torch.optim.Adam`` steps (the
same update as ``optax.adam``: b1 0.9, b2 0.999, eps 1e-8 outside the square
root) and the posterior draws are one batched pass. All randomness (initial
weights, every step's noise, the draws' noise) comes from one CPU
``torch.Generator`` seeded with the integer the JAX package gives
``PRNGKey``, drawn up front and copied to the device once: the fit is the
same function of the seed on the card and on the CPU, up to float rounding.
The two frameworks' generators differ, so a fit does not reproduce JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

HIDDEN = 6
N_LAYERS = 3
TRAIN_STEPS = 2000
LR = 0.05
N_DRAWS = 1000


@dataclasses.dataclass
class VIParams:
    """Mean-field weights: per layer a mean and a softplus-parametrized std
    of the weight (``mus``/``rhos``) and of the bias (``mub``/``rhob``)."""

    mus: List[torch.Tensor]
    rhos: List[torch.Tensor]
    mub: List[torch.Tensor]
    rhob: List[torch.Tensor]

    def leaves(self) -> List[torch.Tensor]:
        return [*self.mus, *self.rhos, *self.mub, *self.rhob]

    def noise_shapes(self) -> List[Tuple[int, ...]]:
        """Shapes of the noise ``_forward`` takes: weight, bias per layer."""
        return [tuple(t.shape) for pair in zip(self.mus, self.mub) for t in pair]


def _leaf(a, device) -> torch.Tensor:
    """A float32 copy (never a view of the caller's array: Adam updates it
    in place)."""
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device, requires_grad=True)


def _init(gen: torch.Generator, dims: Sequence[int], device) -> VIParams:
    """Weight means N(0, 0.1^2), bias means 0, every rho -3 (JAX ``_init``)."""
    n = len(dims) - 1
    mus = [torch.randn((dims[i], dims[i + 1]), generator=gen) * 0.1 for i in range(n)]
    return VIParams(
        [_leaf(m, device) for m in mus],
        [_leaf(np.full((dims[i], dims[i + 1]), -3.0), device) for i in range(n)],
        [_leaf(np.zeros(dims[i + 1]), device) for i in range(n)],
        [_leaf(np.full(dims[i + 1], -3.0), device) for i in range(n)],
    )


def vi_params_from_numpy(params, device="cpu") -> VIParams:
    """Weights of the JAX package's ``VIParams`` (or any object with
    ``mus``/``rhos``/``mub``/``rhob`` sequences of arrays) as float32 leaves
    that require grad."""
    return VIParams(*([_leaf(a, device) for a in getattr(params, k)]
                      for k in ("mus", "rhos", "mub", "rhob")))


def draw_noise(gen: torch.Generator, p: VIParams, n: int) -> List[torch.Tensor]:
    """Standard-normal noise for ``n`` passes, in ``_forward``'s order, on
    the CPU: a list of (n, *shape) tensors."""
    return [torch.randn((n, *s), generator=gen) for s in p.noise_shapes()]


def _forward(p: VIParams, eps, x: torch.Tensor) -> torch.Tensor:
    """Logits of one weight sample per leading index of ``eps`` (or of one
    sample when the noise has no leading axis); tanh between layers."""
    h = x
    n = len(p.mus)
    for i in range(n):
        w = p.mus[i] + F.softplus(p.rhos[i]) * eps[2 * i]
        b = p.mub[i] + F.softplus(p.rhob[i]) * eps[2 * i + 1]
        h = h @ w + b.unsqueeze(-2)
        if i < n - 1:
            h = torch.tanh(h)
    return h


def _kl(p: VIParams, prior_std: float = 1.0) -> torch.Tensor:
    """KL of the mean-field posterior from N(0, prior_std^2), summed over
    every weight and bias."""
    mu = torch.cat([t.reshape(-1) for t in p.mus + p.mub])
    std = F.softplus(torch.cat([t.reshape(-1) for t in p.rhos + p.rhob]))
    return torch.sum(torch.log(prior_std / std) + (std**2 + mu**2) / (2 * prior_std**2) - 0.5)


def one_hot_inputs(observations: torch.Tensor, option_counts: Sequence[int]) -> torch.Tensor:
    """(obs, total) float32 concatenated one-hots of (obs, dims) indices."""
    return torch.cat([F.one_hot(observations[:, d], c) for d, c in enumerate(option_counts)],
                     dim=-1).to(torch.float32)


def _option_blocks(option_counts):
    off = np.concatenate([[0], np.cumsum(option_counts)]).astype(int)
    return [(int(off[d]), int(off[d + 1])) for d in range(len(option_counts))]


def categorical_nll(logits, observations, option_counts) -> torch.Tensor:
    """Sum over dims of the mean negative log-likelihood of the observed
    options under each dim's softmax."""
    nll = logits.new_zeros(())
    for d, (a, b) in enumerate(_option_blocks(option_counts)):
        logp = torch.log_softmax(logits[:, a:b], dim=-1)
        nll = nll - logp.gather(-1, observations[:, d: d + 1]).mean()
    return nll


def categorical_probs_of(logits, option_counts) -> torch.Tensor:
    """Per-dim softmax of the logits' option blocks, concatenated."""
    return torch.cat([torch.softmax(logits[..., a:b], dim=-1)
                      for a, b in _option_blocks(option_counts)], dim=-1)


def categorical_loss(p: VIParams, eps, x_in, observations, option_counts) -> torch.Tensor:
    """NLL + 1e-3 KL / obs, the JAX fit's ``loss_fn``."""
    nll = categorical_nll(_forward(p, eps, x_in), observations, option_counts)
    return nll + 1e-3 * _kl(p) / max(observations.shape[0], 1)


def train(p: VIParams, loss_fn: Callable, noise: List[torch.Tensor], lr: float = LR) -> VIParams:
    """Adam on ``loss_fn(p, eps)``, one step per leading index of ``noise``.
    ``torch.optim.Adam`` makes the update of ``optax.adam``: m / (1 - b1^t)
    over sqrt(v / (1 - b2^t)) + 1e-8."""
    # fused on the card: one launch a step for all leaves (on the CPU the
    # fused step fans tiny tensors out to the thread pool, which is slower)
    opt = torch.optim.Adam(p.leaves(), lr=lr, fused=p.mus[0].is_cuda)
    for t in range(noise[0].shape[0]):
        opt.zero_grad()
        loss_fn(p, [e[t] for e in noise]).backward()
        opt.step()
    return p


def _setup(seed: int, in_dim: int, out_dim: int, train_steps: int, n_draws: int, device):
    """Initial weights and all noise, drawn on the CPU from ``seed``, then
    copied to ``device`` once."""
    gen = torch.Generator().manual_seed(int(seed))
    p = _init(gen, (in_dim,) + (HIDDEN,) * (N_LAYERS - 1) + (out_dim,), device)
    train_noise = [e.to(device) for e in draw_noise(gen, p, train_steps)]
    draw_noise_ = [e.to(device) for e in draw_noise(gen, p, n_draws)]
    return p, train_noise, draw_noise_


def fit_categorical_kernels(
    seed: int,
    observations,  # (obs, dims) int option indices
    option_counts: Tuple[int, ...],
    train_steps: int = TRAIN_STEPS,
    n_draws: int = N_DRAWS,
    device="cuda",
) -> torch.Tensor:
    """cat_probs (n_draws, obs, total_options) float32 on ``device``: the
    posterior categorical kernels around each observation."""
    device = resolve_device(device)
    obs = torch.as_tensor(np.asarray(observations), dtype=torch.int64).to(device)
    x_in = one_hot_inputs(obs, option_counts)
    total = int(sum(option_counts))
    p, train_noise, draws = _setup(seed, total, total, train_steps, n_draws, device)
    train(p, lambda q, eps: categorical_loss(q, eps, x_in, obs, option_counts), train_noise)
    with torch.no_grad():
        return categorical_probs_of(_forward(p, draws, x_in), option_counts)


def mixed_heads(logits, total: int, n_continuous: int):
    """(categorical logits, loc in (0, 1), sqrt precision >= 1): the heads of
    gryffin's BNN (torch_interface/bnn.py:183-249), the Gamma-precision
    scale collapsed to its mean; the floor keeps kernels from flattening
    early in training."""
    cat = logits[..., :total]
    loc = torch.sigmoid(logits[..., total: total + n_continuous])
    sqrt_prec = F.softplus(logits[..., total + n_continuous:]) + 1.0
    return cat, loc, sqrt_prec


def mixed_loss(p: VIParams, eps, x_in, cat_obs, option_counts, cont_obs,
               n_continuous: int) -> torch.Tensor:
    """The JAX mixed fit's ``loss_fn``: categorical NLL + Gaussian NLL of the
    continuous coordinates + 1e-3 KL / obs."""
    total = int(sum(option_counts))
    cat, loc, sqrt_prec = mixed_heads(_forward(p, eps, x_in), total, n_continuous)
    nll = categorical_nll(cat, cat_obs, option_counts)
    if n_continuous:
        z = sqrt_prec * (cont_obs - loc)
        nll = nll + torch.mean(0.5 * z * z - torch.log(sqrt_prec))
    n_obs = cont_obs.shape[0] if n_continuous else cat_obs.shape[0]
    return nll + 1e-3 * _kl(p) / max(n_obs, 1)


def mixed_inputs(cat_obs: torch.Tensor, option_counts, cont_obs: torch.Tensor,
                 n_continuous: int) -> torch.Tensor:
    parts = [one_hot_inputs(cat_obs, option_counts)] if len(option_counts) else []
    if n_continuous:
        parts.append(cont_obs)
    return torch.cat(parts, dim=-1)


def fit_mixed_kernels(
    seed: int,
    cat_obs,  # (obs, Dcat) int option indices (Dcat may be 0)
    option_counts: Tuple[int, ...],
    cont_obs,  # (obs, Dc) float in [0, 1] (Dc may be 0)
    n_continuous: int,
    train_steps: int = TRAIN_STEPS,
    n_draws: int = N_DRAWS,
    device="cuda",
):
    """Mixed categorical + continuous kernels: softmax kernels for the
    categorical dims, Normal kernels (loc, sqrt precision) for the
    continuous ones. Returns (cat_probs (draws, obs, total_options),
    locs (draws, obs, Dc), sqrt_prec (draws, obs, Dc)) on ``device``."""
    device = resolve_device(device)
    cat_t = torch.as_tensor(np.asarray(cat_obs), dtype=torch.int64).to(device)
    cont_t = torch.as_tensor(np.asarray(cont_obs), dtype=torch.float32).to(device)
    x_in = mixed_inputs(cat_t, option_counts, cont_t, n_continuous)
    total = int(sum(option_counts))
    p, train_noise, draws = _setup(seed, x_in.shape[-1], total + 2 * n_continuous,
                                   train_steps, n_draws, device)
    train(p, lambda q, eps: mixed_loss(q, eps, x_in, cat_t, option_counts, cont_t,
                                       n_continuous), train_noise)
    with torch.no_grad():
        cat, loc, sqrt_prec = mixed_heads(_forward(p, draws, x_in), total, n_continuous)
        if len(option_counts):
            cat_p = categorical_probs_of(cat, option_counts)
        else:
            cat_p = cat.new_zeros((n_draws, x_in.shape[0], 0))
    return cat_p, loc, sqrt_prec
