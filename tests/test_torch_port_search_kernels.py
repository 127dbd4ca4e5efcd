"""The port's kernel-density acquisition math (``search/kernels.py``, torch
on the CPU) against the JAX package's ``search/kernels.py`` on the same
float32 kernels, and against the port's float64 C evaluator
(``search/native``), which the port builds into its own ``_build/``.

Tolerances: rtol 1e-5 against JAX (float32 both, sums in another order);
rtol 1e-4 against the float64 C evaluator (the float32 rounding of the
kernels' product and mean, as the JAX package's own native test allows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.search import kernels as jk
from event_representation_study_tpu_torch.search import kernels as tk
from event_representation_study_tpu_torch.search import native
from torch_port_helpers import assert_close

COUNTS = (7, 7, 4)
DRAWS, OBS, N_SAMPLES = 50, 6, 20


def _normalized(rng, shape, counts):
    raw = rng.random(shape)
    off = np.concatenate([[0], np.cumsum(counts)])
    for d in range(len(counts)):
        sl = slice(off[d], off[d + 1])
        raw[..., sl] /= raw[..., sl].sum(-1, keepdims=True)
    return raw


@pytest.fixture(scope="module")
def draws():
    """The draws of ``tests/test_search.py::test_native_kernel_matches_xla``:
    50 draws of 6 observations over the study's 7 x 7 x 4 space."""
    rng = np.random.default_rng(0)
    raw = _normalized(rng, (DRAWS, OBS, sum(COUNTS)), COUNTS)
    offsets = np.concatenate([[0], np.cumsum(COUNTS)])[:-1]
    objs = rng.random(OBS)
    samples = np.stack([rng.integers(0, c, N_SAMPLES) for c in COUNTS], -1)
    return raw, offsets, objs, samples, 1.0 / np.prod(COUNTS)


def _models(raw, offsets, objs, inv_vol):
    jm = jk.KernelModel(cat_probs=jnp.asarray(raw, jnp.float32),
                        offsets=jnp.asarray(offsets, jnp.int32),
                        objs=jnp.asarray(objs, jnp.float32), inv_vol=float(inv_vol))
    tm = tk.KernelModel(cat_probs=torch.as_tensor(raw, dtype=torch.float32),
                        offsets=torch.as_tensor(offsets),
                        objs=torch.as_tensor(objs, dtype=torch.float32), inv_vol=float(inv_vol))
    return jm, tm


@pytest.mark.parametrize("fn", ["categorical_probs", "kernel_contribution", "acquisition_values",
                                "regression_surrogate", "kernel_density"])
def test_kernel_functions_vs_jax(draws, fn):
    raw, offsets, objs, samples, inv_vol = draws
    jm, tm = _models(raw, offsets, objs, inv_vol)
    for lam in ((-1.0, 1.0) if fn == "acquisition_values" else (None,)):
        extra_j = () if lam is None else (jnp.float32(lam),)
        extra_t = () if lam is None else (lam,)
        want = getattr(jk, fn)(jm, jnp.asarray(samples), *extra_j)
        got = getattr(tk, fn)(tm, samples, *extra_t)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.float32
            assert_close(f"{fn}[{i}] lam={lam}", g.numpy(), np.asarray(w), atol=0, rtol=1e-5)


def test_feasibility_posterior_vs_jax(draws):
    raw, offsets, objs, samples, inv_vol = draws
    jf, tf = _models(raw[:, :4], offsets, objs[:4], inv_vol)
    ji, ti = _models(raw[:, 4:], offsets, np.zeros(2), inv_vol)
    want = jk.feasibility_posterior(jf, ji, jnp.asarray(samples), 1 / 3)
    got = tk.feasibility_posterior(tf, ti, samples, 1 / 3)
    assert_close("p(infeasible | x)", got.numpy(), np.asarray(want), atol=0, rtol=1e-5)


def test_kernel_contribution_vs_c_evaluator(draws):
    """float32 torch against the float64 C twin on the same draws."""
    raw, offsets, objs, samples, inv_vol = draws
    n_num, n_inv, n_probs = native.kernel_contrib_categorical(
        raw, offsets.astype(np.int64), samples.astype(np.int64), objs, inv_vol)
    _, tm = _models(raw, offsets, objs, inv_vol)
    num, inv_den = tk.kernel_contribution(tm, samples)
    assert_close("num vs C", num.numpy(), n_num, atol=0, rtol=1e-4)
    assert_close("inv_den vs C", inv_den.numpy(), n_inv, atol=0, rtol=1e-4)
    assert_close("probs vs C", tk.categorical_probs(tm, samples).numpy(), n_probs, atol=0,
                 rtol=1e-4)


def test_reshape_probs_vs_jax_and_c():
    """Descriptor reshaping of one dim against JAX and the C twin, and the
    multi-dim dispatch with a naive (``None``) dim against JAX."""
    rng = np.random.default_rng(7)
    probs = _normalized(rng, (5, 3, 6), (6,))
    D = rng.random((6, 3))
    got = tk.reshape_probs_one_dim(torch.as_tensor(probs, dtype=torch.float32),
                                   torch.as_tensor(D, dtype=torch.float32)).numpy()
    want = np.asarray(jk.reshape_probs_one_dim(jnp.asarray(probs, jnp.float32),
                                               jnp.asarray(D, jnp.float32)))
    assert_close("reshape one dim vs JAX", got, want, atol=0, rtol=1e-5)
    assert_close("reshape one dim vs C", got, native.reshape_cat_probs_native(probs, D),
                 atol=2e-6, rtol=2e-5)
    full = np.concatenate([probs, _normalized(rng, (5, 3, 4), (4,))], -1)
    got = tk.reshape_probs(torch.as_tensor(full, dtype=torch.float32), [D, None], (6, 4)).numpy()
    want = np.asarray(jk.reshape_probs(jnp.asarray(full, jnp.float32), [D, None], (6, 4)))
    assert_close("reshape_probs [D, None] vs JAX", got, want, atol=0, rtol=1e-5)


@pytest.mark.parametrize("periodic", [(0.0, 0.0), (1.0, 0.0)], ids=["plain", "periodic"])
def test_mixed_kernels_vs_jax(periodic):
    """Mixed categorical (3 x 4 options) + continuous (2 dims) kernels."""
    rng = np.random.default_rng(3)
    draws, obs, counts = 20, 5, (3, 4)
    cat = _normalized(rng, (draws, obs, 7), counts)
    locs = rng.random((draws, obs, 2))
    sqrt_prec = 1.0 + 4 * rng.random((draws, obs, 2))
    objs = rng.random(obs)
    cat_s = np.stack([rng.integers(0, c, 30) for c in counts], -1)
    cont_s = rng.random((30, 2))
    cont_s[:5, 0] = [0.0, 0.02, 0.5, 0.97, 1.0]  # across the periodic boundary
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    jm = jk.MixedKernelModel(f32(cat), jnp.asarray([0, 3], jnp.int32), f32(locs), f32(sqrt_prec),
                             f32(objs), 1 / 12, periodic=f32(periodic))
    tm = tk.MixedKernelModel(t32(cat), torch.tensor([0, 3]), t32(locs), t32(sqrt_prec),
                             t32(objs), 1 / 12, periodic=t32(periodic))
    want = jk.mixed_probs(jm, jnp.asarray(cat_s), f32(cont_s))
    assert_close("mixed_probs", tk.mixed_probs(tm, cat_s, cont_s).numpy(), np.asarray(want),
                 atol=0, rtol=1e-5)
    for lam in (-1.0, 1.0):
        want = jk.mixed_acquisition_values(jm, jnp.asarray(cat_s), f32(cont_s), jnp.float32(lam))
        got = tk.mixed_acquisition_values(tm, cat_s, cont_s, lam)
        assert_close(f"mixed_acquisition_values lam={lam}", got.numpy(), np.asarray(want),
                     atol=0, rtol=1e-5)


@pytest.mark.parametrize("fault", ["bad_source", "no_compiler"])
def test_native_loader_raises_when_the_build_fails(fault, tmp_path, monkeypatch):
    """No fallback: a failed build raises with the compiler's output (the
    JAX package's loader returns None instead)."""
    if fault == "bad_source":
        src = tmp_path / "kernel_evaluator.c"
        src.write_text("this is not C;\n")
        monkeypatch.setattr(native, "SOURCE", src)
    else:
        monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="C build of kernel_evaluator.c failed") as e:
        native.load()
    if fault == "bad_source":
        assert "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_native_loader_rebuilds_an_edited_source(draws, tmp_path, monkeypatch):
    """The library is named by a hash of its source: an edited source builds
    a second library beside the first, which gives the same float64 values
    when the edit changes no code."""
    raw, offsets, objs, samples, inv_vol = draws
    want = native.kernel_contrib_categorical(raw, offsets, samples, objs, inv_vol)
    src = tmp_path / "kernel_evaluator.c"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    first = native.build()
    src.write_text(src.read_text() + "/* edited */\n")
    monkeypatch.setattr(native, "_lib", None)
    got = native.kernel_contrib_categorical(raw, offsets, samples, objs, inv_vol)
    assert native.library_path() != first
    assert sorted((tmp_path / "_build").glob("*.so")) == sorted([first, native.library_path()])
    for g, w in zip(got, want):
        assert_close("edited-source build vs packaged build", g, w, atol=0, rtol=1e-12)
