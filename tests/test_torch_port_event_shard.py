"""Event-axis sharding (``parallel/event_shard.py``) on 2 gloo ranks of a
("data", "event") = (1, 2) mesh, against the JAX package on the same NumPy
events, and ``reps/fused_mdes.py::mdes_partials(pos_offset=...)`` against
JAX's.

One spawned group runs every sharded function (the module fixture); the
JAX references are computed in this process meanwhile:
- histogram and voxel grid: JAX's own sharded functions on the conftest's
  8-device CPU mesh (2 x 4);
- ERGO-12, two MDES tables (max + variance + mean + sum in SBN and SBT,
  and a sum-only one: K2's path) and the time surface: JAX's unsharded
  fused functions, Pallas in interpret mode (``tests/test_event_shard.py``
  holds JAX's sharded forms equal to them);
- TORE: JAX's per-sample ``tore``.
Sample 1 holds 700 events in a capacity of 2048, so its stream ends inside
shard 0 and shard 1 is all padding.

Tolerances: histogram, TORE, the time surface and MDES's max channels
exact against the port's unsharded result on the same rank (the
collectives add zeros and take maxes), the summed channels 1e-5; against
JAX: histogram exact, voxel grid 1e-3, ERGO-12 / MDES 1e-5 (rtol and atol;
partial sums combined by one SUM), time surface and TORE 1e-6 relative (exp
and log of equal inputs, as ``test_torch_port_reps.py``). ``mdes_partials``
at offsets 0 and 1024 against JAX's: sums 1e-5, maxes 1e-6 (XLA's and
torch's float32 time normalisation differ by an ulp).
"""
import numpy as np
import pytest
import torch

from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.parallel import event_shard
from event_representation_study_tpu_torch.parallel.mesh import Mesh, make_mesh
from event_representation_study_tpu_torch.reps import fused_mdes, fused_reps
from event_representation_study_tpu_torch.reps.ergo12 import (
    AGGREGATIONS,
    FUNCTIONS,
    WINDOW_INDEXES,
)
from event_representation_study_tpu_torch.reps.tore import tore
from torch_port_helpers import SpawnedGroup, assert_close

H, W, CAP = 16, 64, 2048
COUNTS = ((1500, 0), (700, 1))  # (events, seed); 700 < CAP / 2
TABLES = {
    "ergo12": (tuple(WINDOW_INDEXES), tuple(FUNCTIONS), tuple(AGGREGATIONS), "SBN"),
    "mdes_sbn": ((0, 4, 2, 6), ("timestamp", "count", "polarity", "timestamp_neg"),
                 ("max", "variance", "mean", "sum"), "SBN"),
    "mdes_sbt": ((0, 4, 2, 6), ("timestamp", "count", "polarity", "timestamp_neg"),
                 ("max", "variance", "mean", "sum"), "SBT"),
    "mdes_sum_only": ((0, 3, 5, 1), ("count_pos", "timestamp", "polarity", "count_neg"),
                      ("sum", "variance", "mean", "sum"), "SBN"),
}
EXACT = ("histogram", "tore", "time_surface")  # against the unsharded port


def _events():
    return [generate_fake_events(n, height=H, width=W, duration_us=100_000, seed=s)
            for n, s in COUNTS]


def _unsharded(blocks):
    out = {"histogram": fused_reps.histogram_fused_batched(blocks, H, W),
           "voxel_grid": fused_reps.voxel_grid_fused_batched(blocks, H, W),
           "time_surface": fused_reps.time_surface_fused_batched(blocks, H, W),
           "tore": tore(blocks, H, W)}
    for name, (w, f, a, st) in TABLES.items():
        out[name] = fused_mdes.mdes_fused_batched(blocks, H, W, w, f, a, st)
    return {k: v.numpy() for k, v in out.items()}


def shard_worker(rank, world):
    """Every sharded function on this rank's half of the stream, and the
    unsharded port functions on the whole batch."""
    mesh = make_mesh(axis_names=("data", "event"), shape=(1, world), device="cpu")
    assert (mesh.size("event"), mesh.index("event")) == (world, rank)
    blocks = stack_blocks([from_structured(e, CAP) for e in _events()])
    loc = event_shard.place_event_sharded(blocks, mesh)
    assert loc.x.shape == (len(COUNTS), CAP // world)
    sharded = {
        "histogram": event_shard.sharded_histogram(loc, H, W, mesh),
        "voxel_grid": event_shard.sharded_voxel_grid(loc, H, W, mesh),
        "time_surface": event_shard.sharded_time_surface(loc, H, W, mesh),
        "tore": event_shard.sharded_tore(loc, H, W, mesh),
        "ergo12_entry": event_shard.sharded_ergo12(loc, H, W, mesh),
    }
    for name, (w, f, a, st) in TABLES.items():
        sharded[name] = event_shard.sharded_mdes(loc, H, W, mesh, w, f, a, st)
    return {k: v.numpy() for k, v in sharded.items()}, _unsharded(blocks)


def _jax_references(evs):
    import jax

    from event_representation_study_tpu.events import from_structured as jax_from_structured
    from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
    from event_representation_study_tpu.parallel import event_shard as jax_event_shard
    from event_representation_study_tpu.reps import fused_mdes as jax_fused_mdes
    from event_representation_study_tpu.reps import fused_reps as jax_fused_reps
    from event_representation_study_tpu.reps.tore import tore as jax_tore
    from jax.sharding import Mesh

    blocks = jax_stack_blocks([jax_from_structured(e, CAP) for e in evs])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "event"))
    placed = jax_event_shard.place_event_sharded(blocks, mesh)
    want = {
        "histogram": jax_event_shard.sharded_histogram(placed, H, W, mesh),
        "voxel_grid": jax_event_shard.sharded_voxel_grid(placed, H, W, mesh),
        "time_surface": jax_fused_reps.time_surface_fused_batched(blocks, H, W, interpret=True),
        "tore": np.stack([jax.jit(jax_tore, static_argnums=(1, 2))(
            jax.tree.map(lambda l: l[i], blocks), H, W) for i in range(len(evs))]),
    }
    for name, (w, f, a, st) in TABLES.items():
        want[name] = jax_fused_mdes.mdes_fused_batched(blocks, H, W, w, f, a, st,
                                                       interpret=True)
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def results():
    group = SpawnedGroup(shard_worker, world=2)
    want = _jax_references(_events())
    return group.results(), want


@pytest.mark.parametrize("name", ["histogram", "voxel_grid", "time_surface", "tore",
                                  *TABLES])
def test_sharded_against_jax(results, name):
    ranks, want = results
    tol = {"histogram": (0, 0), "voxel_grid": (0, 1e-3), "time_surface": (1e-6, 0),
           "tore": (1e-6, 0)}.get(name, (1e-5, 1e-5))
    for rank, (got, _) in enumerate(ranks):
        assert got[name].shape == want[name].shape
        assert_close(f"{name} rank {rank} vs JAX", got[name], want[name],
                     rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("name", ["histogram", "voxel_grid", "time_surface", "tore",
                                  *TABLES])
def test_sharded_against_unsharded_port(results, name):
    """Both ranks give the whole batch's result, equal to the unsharded
    port's (exact where the work is counts, maxes and merges)."""
    ranks, _ = results
    atol = 0.0 if name in EXACT else 1e-5
    for rank, (got, whole) in enumerate(ranks):
        assert_close(f"{name} rank {rank} vs unsharded", got[name], whole[name], atol=atol,
                     rtol=atol)
    if name in TABLES:  # max channels exact: the empty-bin zeros and the maxes
        for c, agg in enumerate(TABLES[name][2]):
            if agg == "max":
                assert_close(f"{name} max channel {c}", ranks[0][0][name][..., c],
                             ranks[0][1][name][..., c], atol=0)
    if name == "ergo12":
        assert_close("sharded_ergo12", ranks[0][0]["ergo12_entry"], ranks[0][0]["ergo12"],
                     atol=0)


@pytest.mark.parametrize("offset", [0, CAP // 2])
def test_mdes_partials_pos_offset_against_jax(offset):
    """One slice of the stream through ``mdes_partials(pos_offset=...)``
    with the whole stream's metadata, in both packages."""
    import jax.numpy as jnp

    from event_representation_study_tpu.events import from_structured as jax_from_structured
    from event_representation_study_tpu.events import stack_blocks as jax_stack_blocks
    from event_representation_study_tpu.reps import fused_mdes as jax_fused_mdes

    evs = _events()
    blocks = stack_blocks([from_structured(e, CAP) for e in evs])
    jblocks = jax_stack_blocks([jax_from_structured(e, CAP) for e in evs])
    windows, funcs, aggs, st = TABLES["ergo12"]
    plan = fused_mdes._plan(windows, funcs, aggs)
    n = CAP // 2
    cols = slice(offset, offset + n)
    t = blocks.t.to(torch.float32)
    num = blocks.num.to(torch.int32)
    t0 = t[:, 0]
    span = t.gather(1, (num - 1).to(torch.int64)[:, None])[:, 0] - t0
    pos = torch.arange(CAP, dtype=torch.int32).expand(len(evs), CAP)
    t_s = (t - t0[:, None]) / torch.clamp(span[:, None], min=1.0)
    any_neg = fused_mdes.mdes_window_any_neg(blocks.p, pos, num, t_s, st)
    sums, maxes = fused_mdes.mdes_partials(
        blocks.x[:, cols], blocks.y[:, cols], t[:, cols], blocks.p[:, cols], num, H, W, plan,
        st, t0, span, any_neg, pos_offset=offset)
    j = {k: jnp.asarray(v.numpy()) for k, v in dict(t0=t0, span=span, any_neg=any_neg).items()}
    sums_j, maxes_j = jax_fused_mdes.mdes_partials(
        jblocks.x[:, cols], jblocks.y[:, cols], jblocks.t[:, cols], jblocks.p[:, cols],
        jblocks.num.astype(jnp.int32), H, W, plan, st, j["t0"], j["span"], j["any_neg"],
        pos_offset=offset, interpret=True)
    assert_close(f"mdes_partials sums, offset {offset}", sums.numpy(), np.asarray(sums_j),
                 atol=1e-5, rtol=1e-5)
    assert_close(f"mdes_partials maxes, offset {offset}", maxes.numpy(), np.asarray(maxes_j),
                 atol=1e-6)
    if offset:  # sample 1 ends inside shard 0: its slice here is all padding
        assert float(sums[1].abs().sum()) == 0.0


def test_capacity_must_divide_by_the_event_shards():
    mesh = Mesh(("event",), (3,), (0,), {"event": None}, torch.device("cpu"))
    blocks = stack_blocks([from_structured(e, CAP) for e in _events()])
    with pytest.raises(ValueError, match="does not divide by 3 event shards"):
        event_shard.place_event_sharded(blocks, mesh)
