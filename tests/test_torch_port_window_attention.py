"""The Swin-V2 window attention core (``ops/window_attention.py``, K4): the
plain PyTorch twin of the kernels' algorithm (saved log-sum-exp, dS, the
normalisation's Jacobian, sums over windows in groups) against autograd on
the model's plain code (``models/swin_vit.py::window_attention_plain``) in
float64 and float32; the model's dispatch; and, on a card, the kernels
against the plain code at the Swin-V2-L detector's stage-0 and stage-2
shapes (576², batch 16). The card's machine has no JAX, which
``tests/conftest.py`` imports, so the card tests run there without it:

    python3 -m pytest --noconftest tests/test_torch_port_window_attention.py -m card -q
"""
import math

import pytest
import torch

from event_representation_study_tpu_torch.models import swin_vit
from event_representation_study_tpu_torch.ops import window_attention as wa

TOL = {torch.float64: 1e-10, torch.float32: 2e-5}


def _inputs(windows, n, heads, mask_windows, dtype, seed, padded=0, device="cpu"):
    """qkv from a linear map of random tokens (the last ``padded`` rows and
    columns of each window's map zero, as the padded stage 3 gives), the
    block's scale, a CPB-like bias in (0, 16), and the shift mask."""
    g = torch.Generator().manual_seed(seed)
    ws = math.isqrt(n)
    c = heads * wa.HEAD_DIM
    x = torch.randn(windows, ws, ws, c, generator=g, dtype=torch.float64)
    if padded:
        x[:, ws - padded:] = 0
        x[:, :, ws - padded:] = 0
    w = torch.randn(c, 3 * c, generator=g, dtype=torch.float64) / math.sqrt(c)
    b = 0.1 * torch.randn(3 * c, generator=g, dtype=torch.float64)
    qkv = x.reshape(windows, n, c) @ w + b
    scale = torch.exp(torch.log(torch.tensor(10.0, dtype=torch.float64))
                      + 0.3 * torch.randn(heads, 1, 1, generator=g, dtype=torch.float64))
    bias = 16 * torch.sigmoid(torch.randn(heads, n, n, generator=g, dtype=torch.float64))
    mask = None
    if mask_windows:
        side = math.isqrt(mask_windows) * ws
        mask = torch.from_numpy(swin_vit._shift_mask(side, side, ws, ws // 2))
    return tuple(None if t is None else t.to(device=device, dtype=dtype)
                 for t in (qkv, scale, bias, mask))


def _leaves(qkv, scale, bias):
    return [t.detach().clone().requires_grad_(True) for t in (qkv, scale, bias)]


def _plain(qkv, scale, bias, mask, heads):
    """Outputs and gradients of qkv, scale and bias through autograd on the
    model's plain code, for a fixed random output gradient."""
    leaves = _leaves(qkv, scale, bias)
    out = swin_vit.window_attention_plain(*leaves, mask, heads)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(7),
                       dtype=torch.float64).to(out)
    out.backward(dout)
    return out.detach(), dout, [t.grad for t in leaves]


CASES = {  # windows, tokens, heads, mask windows, padded rows
    "ws12_shifted": (8, 144, 2, 4, 0),
    "ws12_unmasked": (3, 144, 3, 0, 0),
    "ws12_padded_stage3": (4, 144, 2, 4, 6),
    "ws4_shifted": (8, 16, 2, 4, 0),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_autograd_on_the_plain_code(case, dtype):
    windows, n, heads, mask_windows, padded = CASES[case]
    qkv, scale, bias, mask = _inputs(windows, n, heads, mask_windows, dtype, seed=1,
                                     padded=padded)
    want, dout, grads = _plain(qkv, scale, bias, mask, heads)
    leaves = _leaves(qkv, scale, bias)
    got = wa.window_attention(*leaves, mask, heads)
    got.backward(dout)
    for name, a, b in [("out", got.detach(), want)] + [
            (f"d{t}", leaf.grad, g) for t, leaf, g in zip(("qkv", "scale", "bias"), leaves, grads)]:
        err = ((a - b).abs().max() / b.abs().max()).item()
        print(f"PARITY {case} {dtype} {name} {err:.3g}")
        assert a.shape == b.shape and err <= TOL[dtype], (name, err)


@pytest.mark.parametrize("group", [1, 3, 8])
def test_groups_change_only_the_order_of_the_sums(group):
    qkv, scale, bias, mask = _inputs(8, 144, 2, 4, torch.float64, seed=2)
    out, lse = wa.attention_forward_plain(qkv, scale.reshape(-1), bias, mask, 2)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(3), dtype=out.dtype)
    args = (qkv, out, dout, lse, scale.reshape(-1), bias, mask, 2)
    dqkv, dscale, dbias = wa.attention_backward_plain(*args, group)
    ref = wa.attention_backward_plain(*args, 8)
    assert torch.equal(dqkv, ref[0])
    torch.testing.assert_close(dscale, ref[1], rtol=1e-12, atol=0)
    torch.testing.assert_close(dbias, ref[2], rtol=1e-12, atol=1e-14)


def test_log_sum_exp_is_the_rows():
    qkv, scale, bias, mask = _inputs(4, 144, 2, 4, torch.float64, seed=4)
    _, lse = wa.attention_forward_plain(qkv, scale.reshape(-1), bias, mask, 2)
    qh, kh, _, _, _ = wa._split(qkv, 2)
    s = wa._scores(qh, kh, scale.reshape(-1), bias, mask)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-13, atol=0)


@pytest.mark.parametrize("windows,heads,group", [
    (2304, 6, 105), (576, 12, 53), (144, 24, 9), (64, 48, 8), (1, 1, 1)])
def test_backward_group_fills_the_card(windows, heads, group):
    assert wa.backward_group(windows, heads, 132) == group


def test_module_takes_the_plain_path_on_the_cpu_and_in_half_precision(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernels' path was taken")

    monkeypatch.setattr(wa, "window_attention", refuse)
    torch.manual_seed(0)
    attn = swin_vit.WindowAttentionV2(64, 2)
    x = torch.randn(4, 144, 64)
    mask = torch.from_numpy(swin_vit._shift_mask(24, 24, 12, 6))
    qkv = attn.qkv(x)
    assert not wa.fused(qkv, 2)
    assert not wa.fused(qkv.to(torch.bfloat16), 2)
    y = attn(x, 12, mask)
    want = attn.proj(swin_vit.window_attention_plain(
        qkv, torch.exp(attn.logit_scale.clamp(max=math.log(100.0))),
        (16 * torch.sigmoid(attn.cpb_mlp_1(torch.relu(attn.cpb_mlp_0(
            swin_vit._constant(swin_vit._relative_coords_log, 12, device="cpu")))))).permute(2, 0, 1),
        mask, 2))
    assert torch.equal(y, want)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y16 = attn(x, 12, mask)
    assert y16.dtype == torch.bfloat16 and bool(torch.isfinite(y16).all())


def test_kernels_refuse_what_they_do_not_take():
    qkv, scale, bias, mask = _inputs(4, 144, 2, 4, torch.float32, seed=5)
    with pytest.raises(ValueError, match="qkv must be"):
        wa.window_attention(qkv[..., :-3], scale, bias, mask, 2)
    with pytest.raises(ValueError, match="mask must be"):
        wa.window_attention(qkv[:3], scale, bias, mask, 2)
    with pytest.raises(ValueError, match="share one dtype"):
        wa.window_attention(qkv, scale, bias, mask.double(), 2)


# stage 0 (2304 windows, 6 heads, shifted) and stage 2 (144 windows, 24 heads)
# of the Swin-V2-L detector at 576², batch 16
CARD_CASES = {"stage0_shifted": (2304, 144, 6, 144, 0), "stage2": (144, 144, 24, 0, 0)}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_match_the_plain_code_on_the_card(case, card):
    windows, n, heads, mask_windows, padded = CARD_CASES[case]
    qkv, scale, bias, mask = _inputs(windows, n, heads, mask_windows, torch.float32, seed=6,
                                     padded=padded, device=card)
    torch.backends.cuda.matmul.allow_tf32 = False
    want, dout, grads = _plain(qkv, scale, bias, mask, heads)
    runs = []
    for _ in range(2):
        leaves = _leaves(qkv, scale, bias)
        got = wa.window_attention(*leaves, mask, heads)
        got.backward(dout)
        runs.append([got.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dqkv", "dscale", "dbias"), runs[0], [want] + grads):
        err = ((a - b).abs().max() / b.abs().max()).item()
        print(f"PARITY card {case} {name} {err:.3g}")
        assert err <= 1e-4, (name, err)
    assert all(torch.equal(a, b) for a, b in zip(*runs)), "two runs differ"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels run only there")
    return torch.device("cuda", 0)

