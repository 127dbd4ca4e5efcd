"""The port's GWD ranking (``metrics/{chosen_indexes,gw,gw_exact,otmi}.py``
and ``cli/gwd.py``) against the JAX package's on the same NumPy inputs.

Tolerances: the kernel cost rtol 2e-4 against JAX and against the float64
dense twin (float32 sums in another order and tiling); the entropic GW solver
rtol 1e-4 at n <= 48 (5,000 float32 Sinkhorn steps each side), and
``gw_distance`` with it; ``otmi`` and
``otmi_batched`` rtol 2e-4, as JAX holds its own pair; the CLI rtol 3e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.cli import gwd as jax_gwd
from event_representation_study_tpu.data.gen1 import write_gen1_fixture
from event_representation_study_tpu.events import generate_fake_events
from event_representation_study_tpu.metrics import chosen_indexes as jax_chosen_indexes
from event_representation_study_tpu.metrics import gw as jax_gw
from event_representation_study_tpu.metrics import gw_exact as jax_gw_exact
from event_representation_study_tpu.metrics import otmi as jax_otmi
from event_representation_study_tpu.reps import numpy_ref
from event_representation_study_tpu_torch.cli import gwd
from event_representation_study_tpu_torch.metrics import chosen_indexes, gw, gw_exact, otmi
from torch_port_helpers import assert_close


def _cloud(n, d, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, d)) * scale).astype(np.float32)


def _padded(X, cap):
    return np.pad(X, ((0, cap - len(X)), (0, 0))), (np.arange(cap) < len(X)).astype(np.float32)


def test_chosen_indexes():
    assert chosen_indexes.CHOSEN == jax_chosen_indexes.CHOSEN
    assert chosen_indexes.CONVERGENT_POSITIONS == jax_chosen_indexes.CONVERGENT_POSITIONS
    for name in chosen_indexes.CONVERGENT_POSITIONS:
        assert chosen_indexes.extract_indexes(name) == jax_chosen_indexes.extract_indexes(name)


def test_kernel_primitives():
    X, Y = _cloud(300, 4, 0), _cloud(200, 4, 1)
    Xp, mask = _padded(X, 384)
    assert_close("pairwise_sq_dists", gw.pairwise_sq_dists(torch.from_numpy(X), torch.from_numpy(Y)),
                 jax_gw.pairwise_sq_dists(jnp.asarray(X), jnp.asarray(Y)), rtol=1e-5, atol=1e-5)
    assert_close("kernel_bandwidth",
                 gw.kernel_bandwidth(torch.from_numpy(Xp), torch.from_numpy(mask), 0.7),
                 jax_gw.kernel_bandwidth(jnp.asarray(Xp), jnp.asarray(mask), 0.7), rtol=1e-6, atol=0)


# (rows, dims, capacity) of the source and target clouds: the larger cloud
# on either side (its self-kernel sum tiled), equal capacities
CLOUDS = {"s_larger": ((700, 4, 768), (450, 6, 512)), "t_larger": ((300, 4, 512), (450, 6, 1024)),
          "same_cap": ((300, 4, 512), (450, 6, 512))}


@pytest.mark.parametrize("case", list(CLOUDS))
@pytest.mark.parametrize("chunk", [128, 256])
def test_sampled_kernel_cost(case, chunk):
    (ns, ds, cs), (nt, dt, ct) = CLOUDS[case]
    Xs, Xt = _cloud(ns, ds, 0), _cloud(nt, dt, 1, 1.5)
    args = (*_padded(Xs, cs), *_padded(Xt, ct))
    got = float(gw.sampled_kernel_cost(*map(torch.from_numpy, args), chunk=chunk))
    want = float(jax_gw.sampled_kernel_cost(*map(jnp.asarray, args), chunk=chunk))
    assert_close(f"{case} chunk {chunk} vs JAX", got, want, rtol=2e-4, atol=0)
    dense = otmi._dense_cost_np(Xs.astype(np.float64), Xt.astype(np.float64))
    assert_close(f"{case} chunk {chunk} vs dense float64", got, dense, rtol=2e-4, atol=0)


@pytest.fixture(scope="module")
def kernels():
    """Gaussian kernels of two small clouds (n=24, m=30), port and JAX."""
    rng = np.random.default_rng(0)
    Xs = rng.normal(size=(24, 3)).astype(np.float32)
    Xt = np.concatenate([rng.normal(size=(30, 2)), rng.normal(size=(30, 1)) * 2], 1)
    Xt = Xt.astype(np.float32)
    got = gw.gaussian_kernels(torch.from_numpy(Xs), torch.from_numpy(Xt))
    want = jax_gw.gaussian_kernels(jnp.asarray(Xs), jnp.asarray(Xt))
    return got, want


@pytest.mark.parametrize("loss", ["kl", "square"])
def test_entropic_gromov_wasserstein(kernels, loss):
    (Ks, Kt), (jKs, jKt) = kernels
    assert_close("gaussian kernels", torch.cat([Ks.flatten(), Kt.flatten()]),
                 np.concatenate([np.ravel(jKs), np.ravel(jKt)]), rtol=1e-5, atol=1e-6)
    n, m = Ks.shape[0], Kt.shape[0]
    p, q = np.full(n, 1 / n, np.float32), np.full(m, 1 / m, np.float32)
    T, d = gw.entropic_gromov_wasserstein(Ks, Kt, torch.from_numpy(p), torch.from_numpy(q), loss=loss)
    jT, jd = jax_gw.entropic_gromov_wasserstein(jKs, jKt, jnp.asarray(p), jnp.asarray(q), loss=loss)
    assert_close(f"{loss}: gw", float(d), float(jd), rtol=1e-4, atol=0)
    assert_close(f"{loss}: coupling", T, jT, rtol=1e-4, atol=1e-6)
    # the coupling is feasible: its marginals are p and q
    assert_close(f"{loss}: row marginals", T.sum(1), p, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("loss", ["kl", "square"])
def test_gw_distance(loss):
    """Kernels + entropic GW of two clouds, end to end (the shapes of the
    ``kernels`` fixture)."""
    Xs, Xt = _cloud(24, 3, 2), _cloud(30, 4, 3, 2.0)
    got = gw.gw_distance(Xs, Xt, loss=loss, device="cpu")
    assert got.device.type == "cpu"
    assert_close(f"gw_distance {loss} vs JAX", float(got), float(jax_gw.gw_distance(Xs, Xt, loss=loss)),
                 rtol=1e-4, atol=0)


def test_entropic_against_exact_cg(kernels):
    """The anchor of tests/test_gw_exact.py on the port: CG-polishing the
    entropic coupling certifies its basin, at least as good as the product
    coupling's CG basin. The exact solver is the JAX package's to the bit."""
    (Ks, Kt), _ = kernels
    Ks_n, Kt_n = Ks.double().numpy(), Kt.double().numpy()
    n, m = len(Ks_n), len(Kt_n)
    p, q = np.full(n, 1 / n), np.full(m, 1 / m)
    T_cg, gw_cg = gw_exact.gromov_wasserstein_cg(Ks_n, Kt_n, p, q, loss="kl")
    cost = np.random.default_rng(1).random((5, 7))
    assert_close("gw_exact copy: emd_exact", gw_exact.emd_exact(p[:5] * n / 5, q[:7] * m / 7, cost),
                 jax_gw_exact.emd_exact(p[:5] * n / 5, q[:7] * m / 7, cost), atol=0)
    T_ent, gw_ent = gw.entropic_gromov_wasserstein(
        Ks, Kt, torch.full((n,), 1 / n), torch.full((m,), 1 / m), loss="kl")
    _, gw_polished = gw_exact.gromov_wasserstein_cg(Ks_n, Kt_n, p, q, loss="kl",
                                                    init=T_ent.double().numpy())
    assert gw_polished <= gw_cg + 0.02 * max(abs(gw_cg), 1e-3)
    assert float(gw_ent) >= gw_polished - 1e-6


@pytest.fixture(scope="module")
def otmi_batch():
    """3 ragged windows at 120x152 and their voxel grids (numpy_ref)."""
    H, W, N = 120, 152, 3000
    evs, reps, arr, mask = [], [], [], []
    for i in range(3):
        n = N - 400 * i
        ev = generate_fake_events(n, height=H, width=W, seed=20 + i)
        events = np.stack([ev["x"], ev["y"], ev["t"], ev["p"]], -1).astype(np.float64)
        evs.append(events)
        reps.append((numpy_ref.voxel_grid_np(ev, H, W) * 255.0).astype(np.float32))
        arr.append(np.pad(events, ((0, N - n), (0, 0))).astype(np.float32))
        mask.append((np.arange(N) < n).astype(np.float32))
    return H, W, evs, reps, np.stack(arr), np.stack(mask)


def test_otmi_host_and_batched(otmi_batch):
    H, W, evs, reps, arr, mask = otmi_batch
    want = np.array([jax_otmi.otmi(e, r, H, W, rep_size=H) for e, r in zip(evs, reps)])
    host = np.array([otmi.otmi(e, r, H, W, rep_size=H, device="cpu") for e, r in zip(evs, reps)])
    dense = np.array([otmi.otmi(e, r, H, W, rep_size=H, backend="cpu-dense")
                      for e, r in zip(evs, reps)])
    want_b = np.asarray(jax_otmi.otmi_batched(jnp.asarray(arr), jnp.asarray(mask),
                                              jnp.asarray(np.stack(reps)), H, W, rep_size=H))
    got_b = otmi.otmi_batched(torch.from_numpy(arr), torch.from_numpy(mask),
                              torch.from_numpy(np.stack(reps)), H, W, rep_size=H).numpy()
    assert_close("otmi host vs JAX", host, want, rtol=2e-4, atol=0)
    assert_close("otmi cpu-dense vs JAX", dense, want, rtol=2e-4, atol=0)
    assert_close("otmi_batched vs JAX", got_b, want_b, rtol=2e-4, atol=0)
    assert_close("otmi_batched vs host", got_b, host, rtol=2e-4, atol=0)


def test_otmi_protocol_sense():
    """A matching voxel grid scores lower than a scrambled one (the case
    of tests/test_gw.py::test_otmi_protocol)."""
    H, W = 120, 152
    ev = generate_fake_events(6000, height=H, width=W, seed=11)
    events = np.stack([ev["x"], ev["y"], ev["t"], ev["p"]], axis=-1).astype(np.float64)
    rep = numpy_ref.voxel_grid_np(ev, H, W) * 255.0
    scrambled = np.random.default_rng(0).permutation(rep.reshape(-1, 12)).reshape(rep.shape)
    c_match = otmi.otmi(events, rep, H, W, rep_size=H, capacity=4096, device="cpu")
    c_scram = otmi.otmi(events, scrambled, H, W, rep_size=H, capacity=4096, device="cpu")
    assert np.isfinite(c_match) and c_match < c_scram


def test_gwd_cli_host_and_batched_vs_jax(tmp_path, monkeypatch):
    """cli/gwd.py's host loop and --batched against the JAX CLI's host loop
    on one Gen1 fixture."""
    root = tmp_path / "gen1"
    root.mkdir()
    write_gen1_fixture(root / "validation.h5", num_files=2, boxes_per_file=2,
                       events_per_file=3000, seed=3)
    for mod in (jax_chosen_indexes, chosen_indexes):
        monkeypatch.setattr(mod, "extract_indexes", lambda name: [0, 1, 2])
    common = ["--data-path", str(root), "--num-events", "2048", "--img-size", "240",
              "--representation", "EventHistogram"]
    want = jax_gwd.main(common)
    host = gwd.main(common + ["--device", "cpu"])
    batched = gwd.main(common + ["--device", "cpu", "--batched"])
    assert np.isfinite(want)
    assert_close("gwd host vs JAX", host, want, rtol=3e-4, atol=0)
    assert_close("gwd --batched vs JAX", batched, want, rtol=3e-4, atol=0)
