"""The port's PRM primitives (cim_tpu_torch.prm.modules) against cim_tpu's
(cim_tpu.prm.modules), on the same inputs made with numpy from a seed:
- median_peak_filter and find_peaks: equal, on plateaus, at borders,
  under an even-count median where torch.median would differ;
- peak_stimulation, pr_conv and eb_linear: forward and backward (cim_tpu's
  custom VJPs) within 1e-5 relative; pr_conv at strides 1 and 2, with
  padding and dilation, on odd sizes.
Layouts: the port's NCHW / OIHW / (Dout, Din), cim_tpu's NHWC / HWIO /
(Din, Dout).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cim_tpu.prm import modules as jm
from cim_tpu_torch.prm import modules as tm

RTOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, rtol=RTOL):
    """Within rtol of the largest magnitude of want."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_median_is_jnp_median_not_torch_median():
    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32).reshape(1, 2, 2, 1)
    got = tm.median_peak_filter(_nchw(x)).item()
    assert got == float(jm.median_peak_filter(jnp.asarray(x)).reshape(())) == 2.5
    assert torch.median(torch.tensor([1.0, 2.0, 3.0, 4.0])).item() == 2.0


@pytest.mark.parametrize("hw", [(14, 14), (7, 9), (112, 112)], ids=["even196", "odd63", "even12544"])
def test_median_peak_filter_matches(hw):
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jm.median_peak_filter(jnp.asarray(x)))  # (B, 1, 1, C)
    got = tm.median_peak_filter(_nchw(x)).numpy()  # (B, C, 1, 1)
    np.testing.assert_array_equal(got[:, :, 0, 0], want[:, 0, 0, :])


def _peaks_case(name):
    rng = np.random.RandomState(5)
    if name == "random":
        return rng.randn(2, 12, 10, 3).astype(np.float32)
    if name == "quantized":  # many equal neighbours: plateaus everywhere
        return np.round(rng.rand(2, 11, 13, 2) * 3).astype(np.float32)
    if name == "even_median":
        # 16 values: the middle two are 2 (the corner peak) and 5, so the
        # jnp median is 3.5 and torch.median's 2
        return np.array([[2, 1, 5, 6], [1, 1, 7, 8], [0, 0, 9, 10], [0, 0.5, 11, 12]],
                        np.float32).reshape(1, 4, 4, 1)
    x = np.zeros((1, 8, 8, 1), np.float32)
    if name == "plateau":  # a 2x3 plateau on a plateau of zeros
        x[0, 3:5, 2:5, 0] = 2.0
    elif name == "borders":  # maxima on the corners and edges
        x[0, 0, 0, 0], x[0, 7, 7, 0], x[0, 0, 5, 0], x[0, 4, 7, 0] = 3, 4, 5, 6
    return x


@pytest.mark.parametrize("median", [True, False], ids=["median", "nomedian"])
@pytest.mark.parametrize("case", ["random", "quantized", "plateau", "borders", "even_median"])
def test_find_peaks_matches(case, median):
    x = _peaks_case(case)
    want = np.asarray(jm.find_peaks(jnp.asarray(x), 3, median))
    got = _nhwc(tm.find_peaks(_nchw(x), 3, median))
    np.testing.assert_array_equal(got, want)
    if case == "plateau":  # one peak, the plateau's last row-major position
        assert [tuple(p) for p in np.argwhere(got[0, :, :, 0])] == [(4, 4), (7, 7)]


def _reference_peaks(x):
    """The reference's peak test (prm_modules.py:9-55): the argmax of
    max_pool2d(return_indices) over the -inf padded map is the position
    itself, i.e. the first row-major maximum of its window."""
    t = _nchw(x)
    h, w = t.shape[-2:]
    _, idx = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(t, (1, 1, 1, 1), value=float("-inf")), 3, 1,
        return_indices=True)
    element = torch.arange((h + 2) * (w + 2)).view(1, 1, h + 2, w + 2)[..., 1:-1, 1:-1]
    return _nhwc(idx == element)


@pytest.mark.parametrize("case", ["random", "quantized", "plateau"])
def test_find_peaks_against_the_reference_rule(case):
    """Without ties the port (and cim_tpu) mark the reference's peaks; on a
    plateau the reference marks its first position, cim_tpu and the port
    its last (ROADMAP queue 3)."""
    x = _peaks_case(case)
    got = _nhwc(tm.find_peaks(_nchw(x), 3, False))
    ref = _reference_peaks(x)
    if case == "random":
        np.testing.assert_array_equal(got, ref)
    else:
        assert got.sum() == ref.sum() if case == "plateau" else (got != ref).any()
        if case == "plateau":
            assert [tuple(p) for p in np.argwhere(ref[0, :, :, 0])] == [(0, 0), (3, 2)]


def test_find_peaks_even_median_is_the_midpoint():
    """The corner peak (2) is the lower middle value: the median filter of
    jnp's median (3.5) drops it, where torch.median's (2) would keep it."""
    x = _nchw(_peaks_case("even_median"))
    assert tm.find_peaks(x, 3, False)[0, 0, 0, 0]
    assert not tm.find_peaks(x, 3, True)[0, 0, 0, 0]
    assert torch.median(x.flatten()).item() == 2.0 and tm.median_peak_filter(x).item() == 3.5


def test_peak_stimulation_forward_backward():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    g = rng.randn(2, 4).astype(np.float32)

    def jloss(inp):
        _, agg = jm.peak_stimulation(inp, 3, True)
        return jnp.sum(agg * g), agg

    (_, jagg), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    pm, agg = tm.peak_stimulation(xt, 3, True)
    (agg * torch.from_numpy(g)).sum().backward()
    _close(agg.detach().numpy(), np.asarray(jagg))
    # the gradient is g on each peak, exactly (no 1/num_peaks factor)
    np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(jgrad))
    assert pm.dtype == torch.bool


_CONV_CASES = {
    "s1p1": dict(stride=1, padding=1, dilation=1, hw=(9, 9)),
    "s2p1_odd": dict(stride=2, padding=1, dilation=1, hw=(11, 9)),
    "s2p0_1x1": dict(stride=2, padding=0, dilation=1, hw=(9, 7), k=1),
    "s2p3_7x7": dict(stride=2, padding=3, dilation=1, hw=(13, 15), k=7),
    "s1p2_dil2": dict(stride=1, padding=2, dilation=2, hw=(10, 9)),
}


@pytest.mark.parametrize("case", list(_CONV_CASES))
def test_pr_conv_forward_backward(case):
    c = _CONV_CASES[case]
    k = c.get("k", 3)
    rng = np.random.RandomState(len(case))
    x = rng.randn(2, *c["hw"], 4).astype(np.float32)
    w = rng.randn(k, k, 4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    s, p, d = (c["stride"],) * 2, (c["padding"],) * 2, (c["dilation"],) * 2
    out = jm.pr_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s, p, d)
    gout = rng.rand(*out.shape).astype(np.float32)

    def jf(inp, wt, bt):
        return jnp.sum(jm.pr_conv(inp, wt, bt, s, p, d) * gout)

    jgx, jgw, jgb = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    tout = tm.pr_conv(xt, wt, bt, s, p, d)
    (tout * _nchw(gout)).sum().backward()
    _close(_nhwc(tout), np.asarray(out))
    _close(_nhwc(xt.grad), np.asarray(jgx))
    assert not wt.grad.any() and not bt.grad.any()
    assert not np.asarray(jgw).any() and not np.asarray(jgb).any()


def test_eb_linear_forward_backward():
    rng = np.random.RandomState(11)
    x = rng.randn(5, 7).astype(np.float32)
    w = rng.randn(7, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    g = rng.rand(5, 3).astype(np.float32)
    out = jm.eb_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jgx = jax.grad(lambda inp: jnp.sum(jm.eb_linear(inp, jnp.asarray(w), jnp.asarray(b)) * g))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    tout = tm.eb_linear(xt, wt, torch.from_numpy(b))
    (tout * torch.from_numpy(g)).sum().backward()
    _close(tout.detach().numpy(), np.asarray(out))
    _close(xt.grad.numpy(), np.asarray(jgx))
    assert not wt.grad.any()
