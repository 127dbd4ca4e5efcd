"""The port's metrics writers and utilities against the JAX package's:

- ``utils/tb_native.py``: event files byte-equal to the JAX package's
  ``NativeTBWriter`` for the same calls (``time.time`` pinned in both),
  ``crc32c`` on the RFC 3720 vectors, and files read back with the
  installed ``tensorboard`` reader (scalars and an image);
- ``utils/observability.py``: the TensorBoard writer both ways (native and
  torch's ``SummaryWriter``), ``WandbWriter`` on a stub ``wandb`` module
  (wandb is never installed), ``MultiWriter.default`` with both flags and
  the warning that names a missing module;
- ``utils/tasks.py::TaskManager`` (results in submission order),
  ``utils/profiling.py``: ``SpeedMeter``, ``profile_trace`` on the CPU, and
  ``get_model_info``: parameters equal to the JAX package's count on the
  shrunk detector, FLOPs equal to a hand count on a two-conv module. The
  JAX figure is XLA's cost analysis, which counts elementwise work and
  skips the convolution taps that fall in the zero padding (most of a
  64² probe's deep levels), where FlopCounterMode, like the reference's
  thop, counts every tap: the two are printed side by side (1.43 against
  1.17 GFLOPs at 640 for the shrunk detector), not held to each other.
"""
import json
import logging
import re
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from event_representation_study_tpu.utils import tb_native as jax_tb
from event_representation_study_tpu_torch.utils import observability, profiling, tb_native
from event_representation_study_tpu_torch.utils.tasks import TaskManager
from torch_port_helpers import one_torch_thread, small_cfg  # noqa: F401

IMG = np.arange(6 * 5 * 3, dtype=np.uint8).reshape(6, 5, 3) * 2


def _drive(writer):
    writer.add_scalar("loss", 1.25, 3)
    writer.log({"a": 2, "b": np.float32(0.5), "skip": "text"}, 4)
    writer.add_image("img", IMG, 5)
    writer.add_image("chw", IMG.transpose(2, 0, 1), 6, dataformats="CHW")
    writer.log_images("batch", [IMG[..., 0], IMG], 7)
    writer.close()


def _event_file(log_dir):
    files = list(log_dir.glob("events.out.tfevents.*"))
    assert len(files) == 1
    return files[0]


def test_tb_native_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    _drive(tb_native.NativeTBWriter(tmp_path / "port"))
    _drive(jax_tb.NativeTBWriter(tmp_path / "jax"))
    got = _event_file(tmp_path / "port").read_bytes()
    want = _event_file(tmp_path / "jax").read_bytes()
    assert len(got) > 100 and got == want


@pytest.mark.parametrize("data,crc", [(b"", 0), (b"123456789", 0xE3069283),
                                      (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
                                      (bytes(range(32)), 0x46DD794E)])
def test_crc32c_vectors(data, crc):
    assert tb_native.crc32c(data) == crc == jax_tb.crc32c(data)


def _read_back(path):
    """(scalars {tag: [(step, value)]}, images [(tag, step, h, w, png)],
    file versions) of an event file, through tensorboard's record reader
    (the TFRecord framing and CRCs) and its Event parser; the raw loader, so
    that no migration rewrites simple values as tensors."""
    from tensorboard.backend.event_processing.event_file_loader import RawEventFileLoader
    from tensorboard.compat.proto import event_pb2
    from tensorboard.util import tensor_util

    scalars, images, versions = {}, [], []
    for raw in RawEventFileLoader(str(path)).Load():
        ev = event_pb2.Event.FromString(raw)
        if ev.file_version:
            versions.append(ev.file_version)
        for v in ev.summary.value:
            if v.HasField("image"):
                images.append((v.tag, ev.step, v.image.height, v.image.width,
                               v.image.encoded_image_string))
            elif v.HasField("tensor"):  # torch's SummaryWriter writes scalars so
                scalars.setdefault(v.tag, []).append(
                    (ev.step, float(tensor_util.make_ndarray(v.tensor))))
            else:
                scalars.setdefault(v.tag, []).append((ev.step, v.simple_value))
    return scalars, images, versions


@pytest.mark.parametrize("native", [True, False], ids=["native", "summary_writer"])
def test_tensorboard_writer_reads_back(tmp_path, native):
    w = observability.TensorBoardWriter(tmp_path, native=native)
    w.log({"loss": 0.75, "num_pos": 12, "name": "x"}, 1)
    w.log({"loss": 0.5}, 2)
    w.log_images("batch", [IMG], 2)
    w.close()
    scalars, images, versions = _read_back(_event_file(tmp_path))
    assert versions == ["brain.Event:2"]
    assert scalars["loss"] == [(1, 0.75), (2, 0.5)] and scalars["num_pos"] == [(1, 12.0)]
    assert "name" not in scalars
    assert [(t, s, h, w) for t, s, h, w, _ in images] == [("batch/0", 2, 6, 5)]
    png = images[0][4]
    assert png.startswith(b"\x89PNG")
    if native:
        import PIL.Image
        import io

        assert np.array_equal(np.asarray(PIL.Image.open(io.BytesIO(png))), IMG)


def test_tb_native_records_verify(tmp_path):
    """Every record's length CRC and data CRC, as the TFRecord framing has
    them."""
    import struct

    _drive(tb_native.NativeTBWriter(tmp_path))
    data = _event_file(tmp_path).read_bytes()
    off, n = 0, 0
    while off < len(data):
        (length,) = struct.unpack("<Q", data[off:off + 8])
        (len_crc,) = struct.unpack("<I", data[off + 8:off + 12])
        payload = data[off + 12:off + 12 + length]
        (data_crc,) = struct.unpack("<I", data[off + 12 + length:off + 16 + length])
        assert len_crc == tb_native.masked_crc(data[off:off + 8])
        assert data_crc == tb_native.masked_crc(payload)
        off += 16 + length
        n += 1
    assert off == len(data) and n == 1 + 2 + 2 + 2  # version, 2 scalars, 2 images, 2 logged


class _StubWandb(types.ModuleType):
    """The calls WandbWriter makes, recorded."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, project, config):
        self.calls.append(("init", project, config))
        return types.SimpleNamespace(finish=lambda: self.calls.append(("finish",)))

    def log(self, data, step):
        self.calls.append(("log", data, step))

    def Image(self, im):  # noqa: N802 (wandb's name)
        return ("image", np.asarray(im).shape)


def test_wandb_writer_on_a_stub(monkeypatch):
    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    w = observability.WandbWriter("proj", {"representation": "ERGO12"})
    w.log({"loss": 1.5}, 3)
    w.log_images("val", [IMG, IMG[..., 0]], 4)
    w.close()
    assert stub.calls == [("init", "proj", {"representation": "ERGO12"}),
                          ("log", {"loss": 1.5}, 3),
                          ("log", {"val": [("image", (6, 5, 3)), ("image", (6, 5))]}, 4),
                          ("finish",)]


@pytest.mark.parametrize("wandb", ["stub", "missing"])
def test_multi_writer_default(tmp_path, monkeypatch, caplog, wandb):
    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub if wandb == "stub" else None)
    with caplog.at_level(logging.WARNING, logger="observability"):
        mw = observability.MultiWriter.default(tmp_path, project="p", config={"k": 1},
                                               use_wandb=True, use_tensorboard=True)
    kinds = [type(w).__name__ for w in mw.writers]
    mw.log({"loss": 0.25}, 7)
    mw.log_images("x", [IMG], 7)  # JsonlWriter: a no-op
    mw.close()
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["loss"] == 0.25
    assert _read_back(_event_file(tmp_path / "tb"))[0]["loss"] == [(7, 0.25)]
    if wandb == "stub":
        assert kinds == ["JsonlWriter", "TensorBoardWriter", "WandbWriter"]
        assert stub.calls[0] == ("init", "p", {"k": 1}) and ("log", {"loss": 0.25}, 7) in stub.calls
        assert not caplog.records
    else:
        assert kinds == ["JsonlWriter", "TensorBoardWriter"]
        assert [r.getMessage() for r in caplog.records] == \
            ["metrics writer dropped: module 'wandb' is not installed"]
    assert observability.MultiWriter.default(tmp_path / "plain").writers[0].path.name == \
        "metrics.jsonl"


def test_task_manager_keeps_submission_order():
    with TaskManager(total=8, max_workers=4, queue_size=3) as tm:
        for i in range(8):
            tm.submit(lambda i=i: time.sleep(0.002 * (8 - i)) or i * i)
        assert tm.results() == [i * i for i in range(8)]


def test_speed_meter():
    m = profiling.SpeedMeter()
    assert m.summary() == {}
    x = torch.ones(4)
    for _ in range(2):
        with m.measure("infer", sync_value=x * 2):
            time.sleep(0.01)
        with m.measure("post", sync_value=np.ones(2)):
            pass
        with m.measure("pre"):
            pass
    m.add_samples(4)
    s = m.summary()
    assert set(s) == {"infer_ms_per_sample", "post_ms_per_sample", "pre_ms_per_sample"}
    assert 2 * 10 / 4 <= s["infer_ms_per_sample"] < 1e3


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(tmp_path) as prof:
        with profiling.annotate("ers_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "ers_span" for e in events)
    assert any(a.key == "ers_span" for a in prof.key_averages())


def test_model_flops_hand_count():
    m = torch.nn.Sequential(torch.nn.Conv2d(12, 8, 3, padding=1), torch.nn.Conv2d(8, 4, 1))
    # 2 per multiply-add: 64² positions x (8 x 12 x 9 + 4 x 8)
    want = 2 * 64 * 64 * (8 * 12 * 9 + 4 * 8)
    assert profiling.model_flops(m, torch.zeros(1, 12, 64, 64)) == want == 7_340_032
    assert profiling.get_model_info(m, img_size=640) == \
        f"Params: {908 / 1e6:.2f}M, Gflops: {want * 100 / 1e9:.2f}"
    assert m.training


def test_model_info_against_jax():
    from event_representation_study_tpu.models import build_model as jax_build_model
    from event_representation_study_tpu.utils.profiling import get_model_info as jax_info
    from event_representation_study_tpu_torch.models import build_model
    from torch_port_helpers import random_jax_variables

    cfg = small_cfg()
    jm = jax_build_model(cfg, num_classes=2)
    variables = random_jax_variables(jm, 64)
    want = jax_info(jm, variables, img_size=640, channels=12)
    model = build_model(cfg, 2, device="cpu")
    got = profiling.get_model_info(model, img_size=640, channels=12)
    parse = re.compile(r"Params: ([\d.]+)M, Gflops: ([\d.]+)")
    (gp, gf), (wp, wf) = (parse.fullmatch(s).groups() for s in (got, want))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax and gp == wp
    print("PARITY " + json.dumps({"test": "get_model_info", "what": "GFLOPs at 640, port "
                                  "(FlopCounterMode) vs JAX (XLA cost analysis)",
                                  "port": float(gf), "jax": float(wf), "tolerance": None}))
    assert float(gf) > 0 and float(wf) > 0
