"""The Swin family (``configs/gen1_swinvit.py``: the genuine Swin-V2-L
backbone at its fixed 'large' preset, 216.4M parameters at full width)
against the JAX Detector on the CPU, eval decode in float32 and bfloat16,
at depth 0.2 / width 0.125 for the neck and head and a 64² input (the
backbone's maps 16/8/4/2: padded and shifted windows at 16², windows
shrunk to the map below). Tolerances as ``test_torch_port_zoo_detectors.py``.
"""
import numpy as np
import torch

from torch_port_helpers import assert_close, check_bf16, zoo_pair


def test_swin_detector_float32_and_bfloat16():
    out = zoo_pair("gen1_swinvit", 0.125, 64)
    got, want = out[f"port_{torch.float32}"].numpy(), out[f"jax_{torch.float32}"]
    assert got.shape == want.shape == (2, 36 * 36 + 18 * 18 + 9 * 9, 7)
    assert_close("swin boxes px", got[..., :4], want[..., :4], atol=1e-2)
    assert_close("swin scores", got[..., 4:], want[..., 4:], atol=1e-4)
    check_bf16("swin", out)
    assert np.isfinite(out[f"port_{torch.bfloat16}"].numpy()).all()
