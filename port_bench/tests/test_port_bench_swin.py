"""The ``gen1_swinvit.train`` cell rehearsed on the CPU, and the count
behind ``attn_roofline.swin``.

- The cell shrunk (``shrunk.py``'s copy, this configuration and traffic cut
  as the detector's are: depth 0.2, width 0.125, a few windows of 2,048
  events, at 128 px so that stages 0 and 1 pad and shift; the Swin at a
  small preset in the port and the reference alike, embed 32, depths
  2/2/2/2, heads 1/2/4/8, window 12), held to the cell's own limits, is correct
  when sound, and not with each of the reference's faults planted in the
  port: half the batch in the loss, an EMA blend skipped, the shift mask
  left out.
- A traced run keeps the attention's calls (a forward of every block a
  step) and their least time.
- ``attention.py`` counts the FLOPs that ``torch.utils.flop_counter``
  counts on the reference's attention, and a hand count of one window;
  the metric readers read the span ``attn``.
"""
import json

import pytest
import torch

from port_bench import attention, core, tracing
from port_bench import run as harness
from port_bench.reference.frozen.models import swin_vit as frozen_swin
from port_bench.tests.shrunk import shrunk_root
from port_bench.tests.test_port_bench_faults import _ema_blend_skipped, _half_batch_detector

from event_representation_study_tpu_torch.models import swin_vit

SEED = 2 ** 31 + 1818
CELL = "gen1_swinvit.train"
SMALL = (32, (2, 2, 2, 2), (1, 2, 4, 8))  # embed, depths, heads
CONFIG_CUTS = {"depth_multiple": 0.2, "width_multiple": 0.125}
# an ATSS epoch past the LR warm-up (at a TAL epoch with the class preds at
# their init the box terms weigh ~1e-6 and the shrunk model's float32
# gradients are rounding): 1,400 microsteps an epoch, 4 an update, the
# accumulation ramp's window 3 at update 1,050
TRAFFIC_CUTS = {"epoch": 3, "num_events": 2048, "unique_windows": 4, "length": 5600,
                "batch_size": 4, "nominal_batch_size": 16}
# the card's cell checks 4 steps, its first update after the 4th; here the
# ramp's window of 3 puts it after the 3rd: every compared loss and
# BatchNorm statistic before the update, the change and the EMA after it
CHECK_STEPS = 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    root = shrunk_root(tmp_path_factory.mktemp("bench"))
    bench = root / "port_bench"
    path = bench / "configs" / "gen1_swinvit.json"
    cfg = json.loads(path.read_text())
    cfg["program"]["model"].update(CONFIG_CUTS)
    cfg["program"]["data"]["img_size"] = 128
    path.write_text(json.dumps(cfg))
    path = bench / "traffic" / "strong_aug_b16.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **TRAFFIC_CUTS)))
    path = bench / "workloads" / f"{CELL}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), check_steps=CHECK_STEPS)))
    return root


@pytest.fixture(autouse=True)
def small_swin(monkeypatch):
    """The port's and the reference's Swin at the small preset."""
    embed, depths, heads = SMALL
    port = swin_vit.SwinTransformerV2ViT.__init__
    monkeypatch.setattr(port, "__defaults__", (embed, depths, heads) + port.__defaults__[3:])
    ref = frozen_swin.SwinTransformerV2.__init__
    monkeypatch.setattr(ref, "__defaults__", (embed, depths, heads) + ref.__defaults__[3:])


def _no_shift_mask(mp):
    """The port's shifted blocks attend without the -100 mask."""
    mp.setattr(swin_vit, "_CONSTANTS", {})
    real = swin_vit._shift_mask
    mp.setattr(swin_vit, "_shift_mask", lambda *a: 0.0 * real(*a))


def _run(root, trace=False):
    run, result = harness.execute(CELL, SEED, 1.0, trace, device=torch.device("cpu"), root=root)
    assert list(result)[-1] == "checks" and result["attempted"] > 0
    return run, result


def test_sound_run_is_correct(root):
    _, result = _run(root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert {"setup_s", "train_samples_per_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", [_half_batch_detector, _ema_blend_skipped, _no_shift_mask])
def test_fault_is_caught(root, fault, monkeypatch):
    fault(monkeypatch)
    _, result = _run(root)
    assert not result["correct"], result["checks"]


def test_traced_run_keeps_the_attention_calls(root):
    run, result = _run(root, trace=True)
    assert result["correct"], result["checks"]
    blocks = sum(SMALL[1])
    steps = run.extra["steps"]
    assert run.extra["info"]["attn_calls"] == blocks * steps and run.extra["attn_least_s"] > 0
    assert len(run.trace.spans["attn"]) == blocks * steps
    # the CPU has no device trace: the device metrics are left out, not zero
    assert not {"attn_roofline.swin", "attn_ms.swin", "device_idle.swin"} & set(
        result["metrics"])


@pytest.mark.parametrize("ws,n,shifted", [(12, 24, True), (12, 24, False), (8, 16, True),
                                          (4, 4, False), (2, 2, False)])
def test_attention_flops_equal_the_flop_counter(ws, n, shifted):
    """On the reference's attention, with and without a mask, at the
    windows the cell and the tests use (n the padded map's side)."""
    from torch.utils.flop_counter import FlopCounterMode

    dim, heads, batch = 64, 2, 3
    attn = frozen_swin.WindowAttention(dim, heads)
    x = torch.randn(batch * (n // ws) ** 2, ws * ws, dim)
    mask = frozen_swin.shift_mask(n, n, ws, ws // 2, "cpu") if shifted else None
    with FlopCounterMode(display=False) as counter:
        attn(x, ws, mask)
    call = attention.call_of(attn, x, ws, mask)
    assert attention.flops(call) == counter.get_total_flops()
    assert call.mask_windows == (mask.shape[0] if shifted else 0)


def test_attention_hand_count_of_one_window():
    """One 12 x 12 window of 192 channels, 6 heads, masked."""
    call = attention.AttnCall(windows=1, tokens=144, dim=192, heads=6, window=12, hidden=512,
                              mask_windows=1)
    qkv, proj = 2 * 144 * 192 * 576, 2 * 144 * 192 * 192
    scores = 2 * (6 * 144 * 144 * 32) * 2  # q kᵀ and attn v, 6 heads of 32
    cpb = 2 * 529 * 2 * 512 + 2 * 529 * 512 * 6
    assert attention.flops(call) == qkv + proj + scores + cpb
    weights = 192 * 576 + 576 + 192 * 192 + 192 + 2 * 512 + 512 + 512 * 6 + 6
    tables = 529 * 2 + 529 * 6 + 144 * 144
    assert attention.least_bytes(call) == 4 * (2 * 144 * 192 + weights + tables)
    peak = 67e12
    assert attention.least_seconds([call, call], peak) == pytest.approx(
        2 * max((qkv + proj + scores + cpb) / peak, attention.least_bytes(call) / 3.35e12))


def test_readers_read_the_attention_span():
    host = [("bench/window", 0.0, 1e6, 0.0), ("bench/attn", 100.0, 200.0, 400.0),
            ("bench/attn", 300.0, 400.0, 600.0)]
    summary = tracing.reduce_events(host, [("gemm", 0.0, 5e5)])
    run = core.Run(window_s=1.0, trace=summary, extra={"steps": 2, "attn_least_s": 250e-6})
    read = {name: core.load_module("metrics", name).read(run)
            for name in ("attn_roofline.swin", "attn_ms.swin", "device_idle.swin")}
    assert read["attn_roofline.swin"] == pytest.approx(25.0)  # 250 us of 1,000 us
    assert read["attn_ms.swin"] == pytest.approx(0.5)
    assert read["device_idle.swin"] == pytest.approx(50.0)
    untraced = core.Run(window_s=1.0, extra={"steps": 2})
    assert all(core.load_module("metrics", name).read(untraced) is None
               for name in ("attn_roofline.swin", "attn_ms.swin", "mfu.swin"))
    # a run of a cell without the attention's span reads nothing
    other = core.Run(window_s=1.0, trace=summary, extra={"steps": 2})
    assert core.load_module("metrics", "attn_roofline.swin").read(other) is None
