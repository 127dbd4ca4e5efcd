"""The port's mean-field BNN surrogate (``search/bnn.py``) against the JAX
package's ``search/bnn.py`` on the same weights and the same noise.

The frameworks' random generators differ, so forward pass, KL, loss,
gradients and Adam steps are held against JAX on weights carried by
``vi_params_from_numpy`` and noise drawn with NumPy (rtol 1e-5 for one
pass, 1e-4 after 20 Adam steps against ``optax.adam``); the fit itself is
held by its sense. Gradient entries are compared with an absolute floor of
1e-6 of the largest entry (entries far below it carry only rounding). Adam
divides each step by sqrt(v), so a weight whose gradient is near zero moves
by rounding: after 20 steps weights have an absolute floor of 2e-5, 2e-5 of
the 1.0 that 20 steps at lr 0.05 can move a weight.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from event_representation_study_tpu.search import bnn as jb
from event_representation_study_tpu_torch.search import bnn as tb
from torch_port_helpers import assert_close

COUNTS = (7, 7, 4)
TOTAL = sum(COUNTS)
OBS = np.array([[0, 1, 2], [3, 4, 1], [6, 0, 3], [2, 2, 0], [5, 6, 2]])
N_CONT = 2
CONT = np.array([[0.1, 0.8], [0.5, 0.3], [0.9, 0.6], [0.2, 0.2], [0.7, 0.95]])


def _jax_params(rng, dims):
    """Random VIParams of the JAX package (rhos spread around -3)."""
    n = len(dims) - 1
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    return jb.VIParams(
        tuple(f(rng.normal(0, 0.3, (dims[i], dims[i + 1]))) for i in range(n)),
        tuple(f(rng.normal(-3, 0.5, (dims[i], dims[i + 1]))) for i in range(n)),
        tuple(f(rng.normal(0, 0.1, dims[i + 1])) for i in range(n)),
        tuple(f(rng.normal(-3, 0.5, dims[i + 1])) for i in range(n)),
    )


def _noise(rng, dims, lead=()):
    """NumPy noise in ``_forward``'s order (weight, bias per layer)."""
    out = []
    for i in range(len(dims) - 1):
        out.append(rng.normal(size=lead + (dims[i], dims[i + 1])).astype(np.float32))
        out.append(rng.normal(size=lead + (dims[i + 1],)).astype(np.float32))
    return out


def _jax_cat_loss(p, eps, onehot, obs):
    """The JAX categorical fit's ``loss_fn`` (bnn.py:113-123) on given noise."""
    logits = jb._forward(p, eps, onehot)
    offsets = np.concatenate([[0], np.cumsum(COUNTS)])[:-1]
    nll = 0.0
    for d in range(len(COUNTS)):
        logp = jax.nn.log_softmax(logits[:, offsets[d]: offsets[d] + COUNTS[d]], axis=-1)
        nll -= jnp.mean(jnp.take_along_axis(logp, obs[:, d: d + 1], axis=-1))
    return nll + 1e-3 * jb._kl(p) / obs.shape[0]


def _jax_mixed_loss(p, eps, x_in, obs, cont):
    """The JAX mixed fit's ``loss_fn`` (bnn.py:209-230) on given noise."""
    logits = jb._forward(p, eps, x_in)
    offsets = np.concatenate([[0], np.cumsum(COUNTS)])[:-1]
    loc = jax.nn.sigmoid(logits[:, TOTAL: TOTAL + N_CONT])
    sqrt_prec = jax.nn.softplus(logits[:, TOTAL + N_CONT:]) + 1.0
    nll = 0.0
    for d in range(len(COUNTS)):
        logp = jax.nn.log_softmax(logits[:, offsets[d]: offsets[d] + COUNTS[d]], axis=-1)
        nll -= jnp.mean(jnp.take_along_axis(logp, obs[:, d: d + 1], axis=-1))
    z = sqrt_prec * (cont - loc)
    nll += jnp.mean(0.5 * z * z - jnp.log(sqrt_prec))
    return nll + 1e-3 * jb._kl(p) / obs.shape[0]


def _leaves_np(jp):
    return [np.asarray(a) for a in (*jp.mus, *jp.rhos, *jp.mub, *jp.rhob)]


def _assert_grads(what, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        floor = 1e-6 * max(float(np.abs(w).max()), 1e-12)
        assert_close(f"{what} grad leaf {i}", g, w, atol=floor, rtol=1e-5)


@pytest.mark.parametrize("head", ["categorical", "mixed"])
def test_forward_kl_loss_and_gradient_vs_jax(head):
    rng = np.random.default_rng(1 if head == "categorical" else 2)
    obs_t = torch.as_tensor(OBS)
    x_t = tb.one_hot_inputs(obs_t, COUNTS)
    if head == "mixed":
        cont_t = torch.as_tensor(CONT, dtype=torch.float32)
        x_t = tb.mixed_inputs(obs_t, COUNTS, cont_t, N_CONT)
    dims = (x_t.shape[1], tb.HIDDEN, tb.HIDDEN, TOTAL + (2 * N_CONT if head == "mixed" else 0))
    jp = _jax_params(rng, dims)
    eps = _noise(rng, dims)
    tp = tb.vi_params_from_numpy(jp)
    eps_t = [torch.as_tensor(e) for e in eps]
    x_j, obs_j = jnp.asarray(x_t.numpy()), jnp.asarray(OBS)

    assert_close("forward", tb._forward(tp, eps_t, x_t).detach().numpy(),
                 np.asarray(jax.jit(jb._forward)(jp, eps, x_j)), atol=0, rtol=1e-5)
    assert_close("kl", tb._kl(tp).item(), float(jax.jit(jb._kl)(jp)), atol=0, rtol=1e-5)
    if head == "categorical":
        loss_t = tb.categorical_loss(tp, eps_t, x_t, obs_t, COUNTS)
        want_loss, want_g = jax.jit(jax.value_and_grad(_jax_cat_loss))(jp, eps, x_j, obs_j)
    else:
        loss_t = tb.mixed_loss(tp, eps_t, x_t, obs_t, COUNTS, cont_t, N_CONT)
        want_loss, want_g = jax.jit(jax.value_and_grad(_jax_mixed_loss))(
            jp, eps, x_j, obs_j, jnp.asarray(CONT, jnp.float32))
    assert_close(f"{head} loss", loss_t.item(), float(want_loss), atol=0, rtol=1e-5)
    loss_t.backward()
    _assert_grads(head, [t.grad.numpy() for t in tp.leaves()], _leaves_np(want_g))


def test_batched_draws_vs_jax_vmap():
    """The posterior draws' one batched pass equals JAX's vmap of
    ``_forward`` over the draws' noise."""
    rng = np.random.default_rng(4)
    dims = (TOTAL, tb.HIDDEN, tb.HIDDEN, TOTAL)
    jp = _jax_params(rng, dims)
    eps = _noise(rng, dims, lead=(16,))
    x = tb.one_hot_inputs(torch.as_tensor(OBS), COUNTS)
    want = jax.jit(jax.vmap(lambda e: jb._forward(jp, e, jnp.asarray(x.numpy()))))(eps)
    got = tb._forward(tb.vi_params_from_numpy(jp), [torch.as_tensor(e) for e in eps], x)
    assert got.shape == (16, len(OBS), TOTAL)
    assert_close("batched forward", got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_adam_steps_vs_optax():
    """20 steps of ``bnn.train`` (torch.optim.Adam) against ``optax.adam`` on
    JAX's loss, both on one NumPy noise sequence."""
    rng = np.random.default_rng(5)
    dims = (TOTAL, tb.HIDDEN, tb.HIDDEN, TOTAL)
    jp = _jax_params(rng, dims)
    steps = 20
    noise = _noise(rng, dims, lead=(steps,))
    obs_t = torch.as_tensor(OBS)
    x_t = tb.one_hot_inputs(obs_t, COUNTS)
    x_j, obs_j = jnp.asarray(x_t.numpy()), jnp.asarray(OBS)

    tp = tb.vi_params_from_numpy(jp)
    tb.train(tp, lambda q, e: tb.categorical_loss(q, e, x_t, obs_t, COUNTS),
             [torch.as_tensor(e) for e in noise])

    tx = optax.adam(tb.LR)

    @jax.jit
    def step(p, opt, eps):
        g = jax.grad(_jax_cat_loss)(p, eps, x_j, obs_j)
        up, opt = tx.update(g, opt)
        return optax.apply_updates(p, up), opt

    p, opt = jp, tx.init(jp)
    for t in range(steps):
        p, opt = step(p, opt, [e[t] for e in noise])
    for i, (g, w) in enumerate(zip(tp.leaves(), _leaves_np(p))):
        assert_close(f"leaf {i} after {steps} Adam steps", g.detach().numpy(), w, atol=2e-5,
                     rtol=1e-4)


def test_fit_categorical_kernels_sense():
    """The fitted kernels put more than uniform mass on each observation's
    own options, are normalized per dim, and are a function of the seed."""
    cp = tb.fit_categorical_kernels(11, OBS, COUNTS, train_steps=300, n_draws=64, device="cpu")
    assert cp.shape == (64, len(OBS), TOTAL) and cp.dtype == torch.float32
    off = np.concatenate([[0], np.cumsum(COUNTS)])
    mean = cp.mean(0).numpy()
    for d, c in enumerate(COUNTS):
        np.testing.assert_allclose(cp[..., off[d]: off[d + 1]].sum(-1).numpy(), 1.0, rtol=1e-5)
        own = mean[np.arange(len(OBS)), off[d] + OBS[:, d]]
        assert (own > 1.0 / c).all(), (d, own)
    again = tb.fit_categorical_kernels(11, OBS, COUNTS, train_steps=300, n_draws=64,
                                       device="cpu")
    assert torch.equal(cp, again)


def test_fit_mixed_kernels_sense():
    """The mixed head: categorical kernels as above, continuous kernels
    whose mean location moves toward each observation (closer than the
    untrained 0.5) with sqrt precision >= 1; no categorical dims gives an
    empty option axis."""
    cp, loc, sp = tb.fit_mixed_kernels(3, OBS, COUNTS, CONT, N_CONT, train_steps=300,
                                       n_draws=64, device="cpu")
    assert cp.shape == (64, len(OBS), TOTAL) and loc.shape == sp.shape == (64, len(OBS), N_CONT)
    assert bool((sp >= 1.0).all()) and bool(torch.isfinite(loc).all())
    own = cp.mean(0).numpy()[np.arange(len(OBS)), OBS[:, 0]]
    assert (own > 1.0 / COUNTS[0]).all(), own
    dist = np.abs(loc.mean(0).numpy() - CONT).mean()
    assert dist < np.abs(0.5 - CONT).mean(), dist
    cp0, loc0, _ = tb.fit_mixed_kernels(3, np.zeros((5, 0), np.int64), (), CONT, N_CONT,
                                        train_steps=20, n_draws=8, device="cpu")
    assert cp0.shape == (8, 5, 0) and loc0.shape == (8, 5, N_CONT)


def test_fit_is_chaotic_and_its_mean_over_draws_is_not():
    """Why ``chip_smoke.py`` holds one seed's fit card vs CPU draw by draw
    only after 200 steps, and after the full 2000 by the mean over draws:
    on the CPU, -1e-6 on one initial weight leaves the draws within 1e-3
    after 200 steps but moves them after 2000 (printed on the ``CHAOS``
    line), while the mean over the draws, the kernel density's input, stays
    within 0.05 (chip_smoke's FIT_MEAN_TOLERANCE)."""
    obs = np.array([[0, 6, 0], [1, 3, 2], [6, 2, 0], [3, 0, 3]])
    obs_t = torch.as_tensor(obs)
    x = tb.one_hot_inputs(obs_t, COUNTS)

    def fit(steps, perturb):
        p, noise, draws = tb._setup(47, TOTAL, TOTAL, steps, 200, "cpu")
        with torch.no_grad():
            p.mus[0].mul_(1 + perturb)
        tb.train(p, lambda q, e: tb.categorical_loss(q, e, x, obs_t, COUNTS), noise)
        with torch.no_grad():
            return tb.categorical_probs_of(tb._forward(p, draws, x), COUNTS)

    for steps in (200, 2000):
        base, other = fit(steps, 0.0), fit(steps, -1e-6)
        if steps == 200:  # the replica is the fit itself
            assert torch.equal(base, tb.fit_categorical_kernels(
                47, obs, COUNTS, train_steps=200, n_draws=200, device="cpu"))
        draw_err = (base - other).abs().max().item()
        mean_err = (base.mean(0) - other.mean(0)).abs().max().item()
        print("CHAOS " + json.dumps({"steps": steps, "perturbation": -1e-6,
                                     "draw_max_abs": draw_err, "mean_max_abs": mean_err}))
        if steps == 200:
            assert draw_err <= 1e-3
        else:
            assert mean_err <= 0.05
