"""K3's plain version (``ops/roll.py::roll_rows_plain``, what ``roll_rows``
runs for a CPU tensor) against the JAX package's per-row roll: the Pallas
kernel in interpret mode and its XLA twin ``roll_rows_xla``. Pure data
movement, so every comparison is exact (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_representation_study_tpu.ops.pallas_roll import roll_rows as jax_roll_rows
from event_representation_study_tpu.ops.pallas_roll import roll_rows_xla
from event_representation_study_tpu_torch.ops import roll
from torch_port_helpers import assert_close

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, s_lo, s_hi, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    s = rng.integers(s_lo, s_hi, shape[:2]).astype(np.int32)
    xt = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    xj = jnp.asarray(x, getattr(jnp, dtype))
    return xt, torch.from_numpy(s), xj, jnp.asarray(s)


# the cases of tests/test_pallas_roll.py plus odd C, R not divisible by 8
# and the separable warp's own (W_in = w_out + 2 pad + 1)
CASES = {
    "R16": ((2, 16, 40, 12), -5, 30, 24, "float32"),
    "R20": ((2, 20, 40, 12), -5, 30, 24, "float32"),
    "R3": ((2, 3, 40, 12), -5, 30, 24, "float32"),
    "bf16": ((1, 8, 32, 4), 0, 8, 24, "bfloat16"),
    "bf16_odd_C": ((2, 12, 40, 11), 0, 16, 24, "bfloat16"),
    "f32_odd_C_R13": ((3, 13, 48, 5), -3, 20, 32, "float32"),
    "warp_pass": ((2, 24, 67, 3), 0, 33, 35, "float32"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_roll_rows_plain_matches_jax(case):
    shape, s_lo, s_hi, w_out, dtype = CASES[case]
    xt, st, xj, sj = _inputs(shape, s_lo, s_hi, dtype, seed=len(case))
    got = roll.roll_rows(xt, st, w_out).to(torch.float32).numpy()
    assert got.shape == shape[:2] + (w_out, shape[3])
    want_xla = np.asarray(roll_rows_xla(xj, sj, w_out), np.float32)
    want_pallas = np.asarray(jax_roll_rows(xj, sj, w_out, interpret=True), np.float32)
    assert_close("vs roll_rows_xla", got, want_xla, atol=0)
    assert_close("vs Pallas interpret", got, want_pallas, atol=0)


def test_clamps_to_unpadded_width():
    """W_in % 8 != 0 with starts past W_in - w_out: the Pallas kernel pads W
    to a multiple of 8 before it clamps, so it reads the pad there
    (ADVICE.md:3); the port keeps ``roll_rows_xla``'s semantics, the clamp
    to the original W_in - w_out."""
    xt, st, xj, sj = _inputs((2, 10, 37, 6), -9, 40, "float32", seed=5)
    assert int(st.max()) > 37 - 20 and int(st.min()) < 0
    got = roll.roll_rows(xt, st, 20).numpy()
    assert_close("vs roll_rows_xla", got, np.asarray(roll_rows_xla(xj, sj, 20)), atol=0)
    s = st.clamp(0, 17).tolist()
    want = torch.stack([torch.stack([xt[b, r, s[b][r]:s[b][r] + 20] for r in range(10)])
                        for b in range(2)])
    assert_close("vs slices", got, want.numpy(), atol=0)


@pytest.mark.parametrize(
    "bad", ["int_x", "starts_dtype", "starts_shape", "w_out", "not_contiguous"]
)
def test_roll_rows_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((2, 3, 8, 4))
    s = torch.zeros((2, 3), dtype=torch.int32)
    w_out = 5
    if bad == "int_x":
        x = x.to(torch.int32)
    elif bad == "starts_dtype":
        s = s.to(torch.int64)
    elif bad == "starts_shape":
        s = s[:, :2]
    elif bad == "w_out":
        w_out = 9
    else:
        x = torch.zeros((2, 3, 8, 8))[..., ::2]
    with pytest.raises(ValueError):
        roll.roll_rows(x, s, w_out)
