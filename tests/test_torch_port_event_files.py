"""Event files in both packages: Prophesee EVT2.0 ``.dat`` and N-MNIST
``.bin`` (written byte-equal, read equal, the streaming ``EventDatReader``
step by step), ROS1 bags of ``dvs_msgs/EventArray`` (written by one package
and read by the other), the five ev-licious stream filters, the ``.dat``,
``.bin`` and ``.bag`` branches of ``load_events_from_path``, and
``cli/convert.py`` with each filter and each output format. Everything is
host NumPy on both sides, so every comparison is exact."""
import numpy as np
import pytest

from event_representation_study_tpu.cli import convert as jax_convert
from event_representation_study_tpu.events import filters as jax_filters
from event_representation_study_tpu.events import h5_io as jax_h5_io
from event_representation_study_tpu.events import prophesee as jax_prophesee
from event_representation_study_tpu.events import rosbag as jax_rosbag
from event_representation_study_tpu_torch.cli import convert
from event_representation_study_tpu_torch.events import filters, h5_io, prophesee, rosbag
from torch_port_helpers import assert_close

H, W = 720, 1280
FILTERS = ("hot_pixel", "background_activity", "refractory", "random", "contrast_threshold")


def _events(n: int, height: int, width: int, seed: int, t_max: int = 2_000_000):
    """Structured events with sorted timestamps (runs of equal ones), and a
    few hot pixels holding a tenth of the events."""
    rng = np.random.default_rng(seed)
    ev = np.zeros(n, dtype=prophesee.EVENT_DTYPE)
    ev["x"] = rng.integers(0, width, n)
    ev["y"] = rng.integers(0, height, n)
    hot = rng.random(n) < 0.1
    ev["x"][hot] = rng.choice([3, 17, 40], hot.sum())
    ev["y"][hot] = 5
    ev["t"] = np.sort(rng.integers(0, t_max, n)) // 7 * 7
    ev["p"] = rng.choice([-1, 1], n)
    return ev


def _assert_events_equal(what, got, want):
    assert got.dtype == want.dtype, what
    for k in "xytp":
        assert_close(f"{what} {k}", got[k], want[k], atol=0)


def test_dat_written_byte_equal_and_read_like_jax(tmp_path):
    ev = _events(6000, H, W, 0)
    prophesee.write_dat(tmp_path / "port.dat", ev, H, W)
    jax_prophesee.write_dat(tmp_path / "jax.dat", ev, H, W)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()
    _assert_events_equal("read_dat", prophesee.read_dat(tmp_path / "jax.dat"),
                         jax_prophesee.read_dat(tmp_path / "port.dat"))
    _assert_events_equal("read_dat vs source", prophesee.read_dat(tmp_path / "port.dat"), ev)
    _assert_events_equal("load_events_from_path .dat",
                         h5_io.load_events_from_path(tmp_path / "port.dat"),
                         jax_h5_io.load_events_from_path(tmp_path / "port.dat"))
    with open(tmp_path / "port.dat", "rb") as f, open(tmp_path / "port.dat", "rb") as g:
        assert prophesee.parse_dat_header(f) == jax_prophesee.parse_dat_header(g)


def _stream(reader, t_mid: int):
    """A fixed sequence of streaming calls; the arrays each returns, with
    the reader's position after each."""
    out = []

    def keep(ev):
        out.append((ev, reader._idx, reader.is_done()))

    keep(reader.load_n_events(1000))
    keep(reader.load_delta_t(20_000))
    keep(reader.load_delta_t(0))
    reader.seek_time(t_mid)
    keep(reader.load_n_events(777))
    reader.seek_event(4000)
    keep(reader.load_delta_t(150_000))
    reader.seek_time(10**9)
    keep(reader.load_delta_t(5))
    reader.reset()
    keep(reader.load_n_events(10**6))
    return out, (len(reader), reader.height, reader.width, reader.ev_type)


def test_dat_reader_streams_like_jax(tmp_path):
    ev = _events(6000, H, W, 1)
    prophesee.write_dat(tmp_path / "rec_td.dat", ev, H, W)
    t_mid = int(ev["t"][2500])
    with prophesee.EventDatReader(tmp_path / "rec_td.dat") as r, \
            jax_prophesee.EventDatReader(tmp_path / "rec_td.dat") as jr:
        got, got_meta = _stream(r, t_mid)
        want, want_meta = _stream(jr, t_mid)
    assert got_meta == want_meta == (6000, H, W, 12)
    assert len(got) == len(want)
    for i, ((g, gi, gd), (w, wi, wd)) in enumerate(zip(got, want)):
        assert (gi, gd) == (wi, wd), i
        _assert_events_equal(f"stream call {i}", g, w)


def test_nmnist_bin_like_jax(tmp_path):
    ev = _events(3000, 34, 34, 2, t_max=300_000)
    prophesee.write_nmnist_bin(tmp_path / "port.bin", ev)
    jax_prophesee.write_nmnist_bin(tmp_path / "jax.bin", ev)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    _assert_events_equal(".bin", h5_io.load_events_from_path(tmp_path / "port.bin"),
                         jax_h5_io.load_events_from_path(tmp_path / "port.bin"))
    # timestamp-overflow rows (y == 240) add 2^13 us to every later event
    raw = np.fromfile(tmp_path / "port.bin", np.uint8).reshape(-1, 5)
    marker = np.array([[0, 240, 0, 0, 0]], np.uint8)
    np.concatenate([raw[:1000], marker, raw[1000:2000], marker, raw[2000:]]).tofile(
        tmp_path / "overflow.bin")
    got = prophesee.read_nmnist_bin(tmp_path / "overflow.bin")
    _assert_events_equal(".bin with overflow rows", got,
                         jax_prophesee.read_nmnist_bin(tmp_path / "overflow.bin"))
    assert len(got) == 3000 and got["t"][2500] == ev["t"][2500] + 2 * 2**13


@pytest.mark.parametrize("name", FILTERS)
def test_filters_like_jax(name):
    ev = _events(4000, 60, 80, 3, t_max=400_000)
    calls = {
        "hot_pixel": lambda f: f.hot_pixel_filter(ev, 60, 80),
        "background_activity": lambda f: f.background_activity_filter(ev, 60, 80, 10_000),
        "refractory": lambda f: f.refractory_period_filter(ev, 60, 80, 10_000),
        "random": lambda f: f.random_filter(ev, 3, np.random.default_rng(4)),
        "contrast_threshold": lambda f: f.contrast_threshold_filter(ev, 60, 80, 2),
    }
    got, want = calls[name](filters), calls[name](jax_filters)
    assert 0 < len(want) < len(ev)
    _assert_events_equal(name, got, want)


def test_rosbag_written_by_one_read_by_the_other(tmp_path):
    ev = _events(5000, 180, 240, 5)
    rosbag.write_events_to_rosbag(tmp_path / "port.bag", ev, height=180, width=240)
    jax_rosbag.write_events_to_rosbag(tmp_path / "jax.bag", ev, height=180, width=240)
    for src in ("port", "jax"):
        path = tmp_path / f"{src}.bag"
        h, jh = rosbag.RosbagEventHandle(path), jax_rosbag.RosbagEventHandle(path)
        assert (len(h), h.height, h.width) == (len(jh), jh.height, jh.width)
        _assert_events_equal(f"{src} bag, whole", h.get_between_idx(0, len(h)),
                             jh.get_between_idx(0, len(jh)))
        _assert_events_equal(f"{src} bag, time range", h.get_between_time(300_000, 900_000),
                             jh.get_between_time(300_000, 900_000))
        for a, b in zip(h.compute_time_windows(200_000, 100_000),
                        jh.compute_time_windows(200_000, 100_000)):
            assert_close(f"{src} bag time windows", a, b, atol=0)
        _assert_events_equal(f"{src} bag, load_events_from_path",
                             h5_io.load_events_from_path(path), ev)


@pytest.mark.parametrize("name", FILTERS)
def test_convert_cli_like_jax(name, tmp_path, monkeypatch):
    """``.dat`` -> ``.h5`` with one filter, the sensor size from the header;
    the random filter draws from ``np.random.default_rng()``, seeded here
    for both packages."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: real(7 if seed is None
                                                                          else seed))
    prophesee.write_dat(tmp_path / "in.dat", _events(3000, 60, 80, 6, t_max=300_000), 60, 80)
    args = [str(tmp_path / "in.dat"), "--filter", name, "--chunk", "1000"]
    convert.main(args + ["--output", str(tmp_path / "port.h5")])
    jax_convert.main(args + ["--output", str(tmp_path / "jax.h5")])
    got = h5_io.H5EventHandle(tmp_path / "port.h5")
    want = jax_h5_io.H5EventHandle(tmp_path / "jax.h5")
    assert (got.height, got.width) == (want.height, want.width) == (60, 80)
    assert 0 < len(got) == len(want) < 3000 or name == "hot_pixel"
    _assert_events_equal(f"convert --filter {name}", got.get_between_idx(0, len(got)),
                         want.get_between_idx(0, len(want)))
    got.close()
    want.close()
    # the port's file read by the JAX package's reader
    _assert_events_equal("port-written .h5 in JAX", jax_h5_io.load_events_from_path(
        tmp_path / "port.h5"), jax_h5_io.load_events_from_path(tmp_path / "jax.h5"))


@pytest.mark.parametrize("suffix", [".npz", ".bag"])
def test_convert_cli_outputs_like_jax(suffix, tmp_path):
    """``.bin`` in, ``.npz`` or ``.bag`` out, two filters in order."""
    prophesee.write_nmnist_bin(tmp_path / "in.bin", _events(2000, 34, 34, 8, t_max=200_000))
    args = [str(tmp_path / "in.bin"), "--filter", "refractory", "--filter", "hot_pixel"]
    convert.main(args + ["--output", str(tmp_path / f"port{suffix}")])
    jax_convert.main(args + ["--output", str(tmp_path / f"jax{suffix}")])
    got = h5_io.load_events_from_path(tmp_path / f"port{suffix}")
    _assert_events_equal(f"convert to {suffix}", got,
                         jax_h5_io.load_events_from_path(tmp_path / f"jax{suffix}"))
    assert 0 < len(got) < 2000
