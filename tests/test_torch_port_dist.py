"""The process-group layer (``parallel/dist.py``, ``parallel/mesh.py``) and
the data-parallel Trainer it drives (M11), on 2 spawned gloo ranks.

One spawned group (the module fixture), on each rank:
- ``cli/train.py`` under ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT``: it joins the group, prints ``distributed: process
  r/2``, trains the shrunk detector for an epoch on a Gen1 fixture (its
  loader striped over the ranks), evaluates the whole validation split on
  both ranks, writes checkpoints and metrics on rank 0 only, and leaves
  the group;
- ``init_distributed`` with explicit arguments, then again with none
  (the existing group); meshes of shape (2, 1) and (1, 2) with their
  groups; ``shard_batch``; the loader's stripes of a shuffled epoch.
Here: ``init_distributed`` single-process is (0, 1); a rank whose peer
never joins fails at the group's timeout; ``device_prefetch``.

Everything is exact: the two ranks' parameters, statistics and EMA after
the epoch are bit-equal, and the stripes equal JAX's ``_indices()``.
"""
import contextlib
import datetime
import io
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture
from event_representation_study_tpu_torch.data.loader import EventBatchLoader
from event_representation_study_tpu_torch.events import (
    from_structured,
    generate_fake_events,
    stack_blocks,
)
from event_representation_study_tpu_torch.parallel.dist import init_distributed
from event_representation_study_tpu_torch.parallel.mesh import (
    device_prefetch,
    make_mesh,
    shard_batch,
)
from event_representation_study_tpu_torch.parallel.train_step import Batch
from torch_port_helpers import SMALL, SpawnedGroup, free_port

DIST_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
             "COORDINATOR_ADDRESS")
WINDOWS = 8  # training windows: 2 batches of 2 a rank
STRIPE_LEN, STRIPE_SEED = 11, 3


class _Sized:
    """A dataset of ``n`` items, as far as a loader's index stream goes."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def _stripes(loader_cls, shard_id, num_shards):
    loader = loader_cls(_Sized(STRIPE_LEN), 2, shuffle=True, seed=STRIPE_SEED,
                        shard_id=shard_id, num_shards=num_shards)
    out = []
    for epoch in range(2):
        loader.epoch = epoch
        out.append(np.asarray(loader._indices()))
    return out


def _global_batch():
    evs = [generate_fake_events(300, 32, 32, 10_000, seed=i) for i in range(4)]
    rng = np.random.default_rng(0)
    return Batch(None, stack_blocks([from_structured(e, 512) for e in evs]),
                 rng.integers(0, 2, (4, 3)), rng.uniform(0, 60, (4, 3, 4)).astype(np.float32),
                 np.ones((4, 3), np.float32))


def dist_worker(rank, world, port, port2, root, out):
    from event_representation_study_tpu_torch.cli import train as train_cli
    from event_representation_study_tpu_torch.utils.convert import to_flax_leaves

    res = {}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tr = train_cli.main(["--data-path", root, "--device", "cpu", "--batch-size", "2",
                             "--epochs", "1", "--img-size", "64", "--num-events", "512",
                             "--eval-interval", "1", "--output-dir", f"{out}/rank{rank}",
                             "--override", *SMALL])
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        del os.environ[k]
    res["printed"] = printed.getvalue()
    res["left_the_group"] = not dist.is_initialized()
    res["state"] = to_flax_leaves(tr.state.model.state_dict())
    res["ema"] = to_flax_leaves(tr.state.ema.variables)
    res["steps"] = tr.state.step
    res["loader"] = (tr.train_loader.shard_id, tr.train_loader.num_shards,
                     len(tr.train_loader), len(tr.val_loader))
    res["written"] = sorted(p.name for p in (tr.output_dir).iterdir())

    res["join"] = init_distributed(f"127.0.0.1:{port2}", world, rank, device="cpu",
                                   timeout=datetime.timedelta(seconds=120))
    res["join_again"] = init_distributed()
    for shape in ((world, 1), (1, world)):
        mesh = make_mesh(axis_names=("data", "event"), shape=shape, device="cpu")
        sums = {}
        for axis in mesh.axis_names:
            x = torch.tensor([float(rank + 1)])
            g = mesh.group(axis)
            dist.all_reduce(x, group=g)
            sums[axis] = (mesh.size(axis), mesh.index(axis), float(x))
        res[f"mesh{shape}"] = sums
    mesh = make_mesh(device="cpu")
    local = shard_batch(mesh, _global_batch())
    res["shard_rows"] = (local.events.x.numpy(), local.gt_bboxes.numpy(),
                         local.events.num.numpy())
    res["stripes"] = _stripes(EventBatchLoader, rank, world)
    dist.destroy_process_group()
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen1_dist")
    write_gen1_fixture(root / "training.h5", num_files=1, boxes_per_file=WINDOWS,
                       events_per_file=4000, seed=31)
    write_gen1_fixture(root / "validation.h5", num_files=1, boxes_per_file=2,
                       events_per_file=2000, seed=32)
    out = tmp_path_factory.mktemp("dist_runs")
    return SpawnedGroup(dist_worker, world=2, join=False, port2=free_port(), root=str(root),
                        out=str(out)).results()


def test_init_distributed_single_process(monkeypatch):
    for k in DIST_VARS:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") == (0, 1)
    assert not dist.is_initialized()


def test_a_rank_without_its_peer_fails():
    """No quiet single-process run: rank 0 of 2 waits for rank 1 and fails
    at the timeout."""
    with pytest.raises(Exception):
        init_distributed(f"127.0.0.1:{free_port()}", 2, 0, device="cpu",
                         timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()


def test_cli_joins_and_leaves_the_group(ranks):
    for rank, r in enumerate(ranks):
        assert f"distributed: process {rank}/2" in r["printed"]
        assert r["left_the_group"]
        assert r["join"] == r["join_again"] == (rank, 2)


def test_trainer_stripes_its_loader(ranks):
    for rank, r in enumerate(ranks):
        shard_id, num_shards, n_train, n_val = r["loader"]
        assert (shard_id, num_shards) == (rank, 2)
        assert n_train == WINDOWS // 2 // 2  # batches of 2 from this rank's half
        assert n_val == 1  # the whole validation split (2 windows) on every rank
        assert r["steps"] == n_train


def test_ranks_train_one_model(ranks):
    a, b = ranks
    for what in ("state", "ema"):
        assert set(a[what]) == set(b[what])
        for k in a[what]:
            np.testing.assert_array_equal(a[what][k], b[what][k], err_msg=f"{what} {k}")


def test_only_rank_0_writes(ranks):
    assert {"metrics.jsonl", "last_ckpt", "best_ckpt"} <= set(ranks[0]["written"])
    assert ranks[1]["written"] == []


def test_mesh_axes_and_groups(ranks):
    for rank, r in enumerate(ranks):
        # (size, index, sum of rank + 1 over the axis's group)
        assert r["mesh(2, 1)"] == {"data": (2, rank, 3.0), "event": (1, 0, rank + 1.0)}
        assert r["mesh(1, 2)"] == {"data": (1, 0, rank + 1.0), "event": (2, rank, 3.0)}


def test_shard_batch_takes_this_ranks_rows(ranks):
    whole = _global_batch()
    for rank, r in enumerate(ranks):
        rows = slice(2 * rank, 2 * rank + 2)
        x, boxes, num = r["shard_rows"]
        np.testing.assert_array_equal(x, np.asarray(whole.events.x)[rows])
        np.testing.assert_array_equal(boxes, whole.gt_bboxes[rows])
        np.testing.assert_array_equal(num, np.asarray(whole.events.num)[rows])


def test_loader_stripes_equal_jax(ranks):
    from event_representation_study_tpu.data.loader import EventBatchLoader as JaxLoader

    seen = []
    for rank, r in enumerate(ranks):
        want = _stripes(JaxLoader, rank, 2)
        for got, w in zip(r["stripes"], want):
            np.testing.assert_array_equal(got, w)
        seen.append(r["stripes"][0])
    assert sorted(np.concatenate(seen).tolist()) == list(range(STRIPE_LEN))


def test_device_prefetch_keeps_order_and_extras():
    mesh = make_mesh(device="cpu")
    pulled = []

    def items():
        for i in range(5):
            pulled.append(i)
            b = _global_batch()
            yield b._replace(gt_mask=np.full((4, 3), float(i), np.float32)), np.array([i])

    it = device_prefetch(items(), mesh, size=3)
    first, extra = next(it)
    assert pulled == [0, 1, 2]  # the next size - 1 items' copies already issued
    assert torch.is_tensor(first.gt_mask) and float(first.gt_mask[0, 0]) == 0.0
    assert isinstance(extra, np.ndarray) and extra.tolist() == [0]
    assert torch.is_tensor(first.events.x) and first.events.x.dtype == torch.int32
    rest = [float(b.gt_mask[0, 0]) for b, _ in it]
    assert rest == [1.0, 2.0, 3.0, 4.0]
