"""The traffic makers and the weight maker are deterministic per seed, and
different seeds give different inputs; every window of a split differs."""
import numpy as np
import torch

from port_bench.traffic import gen1_windows, nimagenet_tree
from port_bench.weights import seeded_state

BIG = 2 ** 31 + 777  # a seed past 32 signed bits, as a run may be given


def _split(seed):
    return gen1_windows.SyntheticGen1(seed, length=50, unique=4, num_events=3000,
                                      duration_us=50_000)


def test_gen1_windows_per_seed():
    a, b, c = _split(BIG), _split(BIG), _split(BIG + 1)
    for i in (0, 3, 4, 49):
        sa, sb = a[i], b[i]
        assert np.array_equal(sa.events, sb.events) and np.array_equal(sa.labels, sb.labels)
        assert sa.num_labels == sb.num_labels >= 1
    assert not np.array_equal(a[0].events, c[0].events)
    rows = {a[i].events.tobytes() for i in range(len(a))}
    assert len(rows) == len(a)  # every window of the split differs
    ev = a[7].events
    assert ev.dtype == np.int32 and ev.shape == (4, 3000)
    assert ev[0].max() < 304 and ev[1].max() < 240 and set(np.unique(ev[3])) <= {-1, 1}
    assert (np.diff(ev[2]) >= 0).all() and ev[2, 0] == 0


def test_nimagenet_tree_per_seed(tmp_path):
    dataset, traffic = {"classes": 2, "files_per_class": 2}, {"events_per_file": 1000,
                                                              "duration_us": 10_000}
    fa, la = nimagenet_tree.write_tree(tmp_path / "a", dataset, traffic, BIG)
    fb, _ = nimagenet_tree.write_tree(tmp_path / "b", dataset, traffic, BIG)
    fc, _ = nimagenet_tree.write_tree(tmp_path / "c", dataset, traffic, BIG + 1)
    assert la == [0, 0, 1, 1]
    for x, y, z in zip(fa, fb, fc):
        ex, ey, ez = (np.load(f)["event_data"] for f in (x, y, z))
        assert np.array_equal(ex, ey) and not np.array_equal(ex, ez)
        assert ex.dtype.names == ("x", "y", "t", "p") and len(ex) == 1000


def test_seeded_weights_per_seed():
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8),
                              torch.nn.Linear(8, 4))
    rules = {"2.bias": {"fill": -5.5}, "2.weight": {"std_scale": 2.0}}
    a = seeded_state(net, BIG, "cpu", rules)
    b = seeded_state(net, BIG, "cpu", rules)
    c = seeded_state(net, BIG + 1, "cpu", rules)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["0.weight"], c["0.weight"])
    assert torch.equal(a["2.bias"], c["2.bias"]) and float(a["2.bias"][0]) == -5.5
    assert torch.equal(a["2.weight"], 2.0 * seeded_state(net, BIG, "cpu")["2.weight"])
    assert torch.equal(a["1.running_var"], torch.ones(8))
    net.load_state_dict(a)  # every leaf, nothing else
    std = float(a["0.weight"].std())
    assert 0.5 < std * (27 ** 0.5) < 1.5  # lecun normal: std sqrt(1 / fan_in)
