"""The port's fakequant projection (``kernels.ops.fakequant_project``) and
fakequant read (``kernels.xbar_vmm.fakequant_read``, the plain version of
its CUDA kernel) against the JAX package's jnp path and its interpret-mode
Pallas kernel (``repro.kernels.ops.fakequant_project``).

Parity classes:

  * float32 operands from a normal draw — within ``rtol = atol = 1e-5``:
    the products and the per-token ranges are float32 sums taken in other
    orders, and XLA contracts multiply-adds into FMAs where torch does
    not; an ADC code that sits at a rounding boundary may flip, which no
    case here hits;
  * the exact class — integer-valued operands with ``max|x| = in_levels``
    (DAC scale 1), small enough that every partial product and every sum
    of squares is an exact float32 integer, and N a power of two (so the
    reference's mean, a product with ``1/N``, is exact too): bit-equal
    to the jnp path, and for one row tile to the interpret-mode kernel.
    With several tiles the interpreted kernel's ``o += code * lsb`` is
    contracted into an FMA by XLA, so there it is held within 1e-5.

The inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adc import AdcConfig as JAdc
from repro.kernels.ops import fakequant_project as jax_fakequant
from repro_torch.core.adc import AdcConfig
from repro_torch.kernels import ops
from repro_torch.kernels import xbar_vmm as K
from repro_torch.models import layers

# lead, T, K, N, rows: one tile, several tiles, ragged T and K, lead dims
CASES = [((), 8, 16, 24, 16), ((), 8, 64, 24, 16), ((), 7, 40, 24, 16),
         ((2, 3), 5, 37, 20, 16), ((), 33, 100, 48, 32)]
EXACT_CASES = [((), 8, 16, 32, 16), ((), 8, 40, 64, 16),
               ((2, 3), 5, 37, 16, 16), ((), 33, 100, 128, 32)]


def _float_operands(lead, t, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, t, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _exact_operands(lead, t, k, n, seed=0):
    """Drives in [-2, 2] with one at 127 (the scale is then 1), weights in
    {-1, 0, 1} with three in four zero."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (*lead, t, k)).astype(np.float32)
    x.reshape(-1)[0] = 127.0
    w = (rng.integers(-1, 2, (k, n))
         * (rng.random((k, n)) < 0.25)).astype(np.float32)
    q = np.abs(x.reshape(-1, k)).astype(np.float64) @ np.abs(w)
    assert (q * q).sum(-1).max() < 2 ** 24
    return x, w


def _reference(x, w, rows, jimpl, **adc):
    return np.asarray(jax_fakequant(jnp.asarray(x), jnp.asarray(w),
                                    JAdc(**adc), rows, impl=jimpl))


def _port(x, w, rows, **adc):
    return ops.fakequant_project(torch.from_numpy(x), torch.from_numpy(w),
                                 AdcConfig(**adc), rows).numpy()


def _port_read(x, w, rows, **adc):
    """The kernel's plain version, on the (T, K) view of x."""
    y = K.fakequant_read(torch.from_numpy(x.reshape(-1, x.shape[-1])),
                         torch.from_numpy(w), AdcConfig(**adc), rows)
    return y.numpy().reshape(*x.shape[:-1], w.shape[1])


@pytest.mark.parametrize("jimpl", ["jnp", "interpret"])
@pytest.mark.parametrize("lead,t,k,n,rows", CASES)
def test_plain_fakequant_matches_reference(jimpl, lead, t, k, n, rows):
    x, w = _float_operands(lead, t, k, n)
    want = _reference(x, w, rows, jimpl)
    np.testing.assert_allclose(_port(x, w, rows), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_port_read(x, w, rows), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bits", [4, 2])
def test_plain_fakequant_low_bits(bits):
    x, w = _float_operands((), 9, 40, 24, seed=1)
    want = _reference(x, w, 16, "jnp", in_bits=bits, out_bits=bits)
    got = _port(x, w, 16, in_bits=bits, out_bits=bits)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead,t,k,n,rows", EXACT_CASES)
def test_exact_class_is_bit_equal(lead, t, k, n, rows):
    x, w = _exact_operands(lead, t, k, n)
    jnp_path = _reference(x, w, rows, "jnp")
    got, got_read = _port(x, w, rows), _port_read(x, w, rows)
    np.testing.assert_array_equal(got, jnp_path)
    np.testing.assert_array_equal(got_read, got)
    interp = _reference(x, w, rows, "interpret")
    if k <= rows:
        np.testing.assert_array_equal(got_read, interp)
    else:
        np.testing.assert_allclose(got_read, interp, rtol=1e-5, atol=1e-5)


def test_adc_fake_quant_alias_matches_reference():
    from repro.kernels.ops import _adc_fake_quant as jax_adc_fake_quant
    q = np.random.default_rng(2).standard_normal((6, 3, 40)).astype(
        np.float32)
    want = np.asarray(jax_adc_fake_quant(jnp.asarray(q), JAdc()))
    got = layers._adc_fake_quant(torch.from_numpy(q), AdcConfig()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert layers._adc_fake_quant is ops._adc_fake_quant


def test_dispatch_cpu_tensor_takes_plain_version():
    x, w = (torch.from_numpy(a) for a in _float_operands((), 8, 40, 24))
    before = dict(K.LAUNCHES)
    y_auto = ops.fakequant_project(x, w, AdcConfig(), 16)
    y_eager = ops.fakequant_project(x, w, AdcConfig(), 16, impl="eager")
    torch.testing.assert_close(y_auto, y_eager, rtol=0, atol=0)
    K.fakequant_read(x, w, AdcConfig(), 16)
    assert K.LAUNCHES == before


def test_cuda_impl_on_cpu_tensor_raises():
    """No fallback: asking for the kernel without CUDA tensors raises."""
    x, w = (torch.from_numpy(a) for a in _float_operands((), 8, 40, 24))
    with pytest.raises(ValueError, match="CUDA"):
        ops.fakequant_project(x, w, AdcConfig(), 16, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        K._fakequant_cuda(x, w, AdcConfig(), 16)
    with pytest.raises(ValueError, match="impl"):
        ops.fakequant_project(x, w, AdcConfig(), 16, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.fakequant_project(x, w, AdcConfig(), 16, impl="chain")


def test_autograd_on_the_kernel_path_raises(monkeypatch):
    """Under autograd the kernel path no longer raises: the read goes
    through ``ops.FakequantRead``, whose forward launches the kernel (here
    a counting stand-in that returns the plain version's values) and
    never the plain expression, and whose backward is the eager VJP.
    Without autograd the kernel is launched bare.  (On the CPU the kernel
    path is reached by resolving ``impl`` to ``"cuda"``.)"""
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, x: "cuda")
    x, w = (torch.from_numpy(a) for a in _float_operands((), 8, 40, 24))
    launched, eager = [], []
    plain_read = K.fakequant_read

    def fake_read(x2, w2, *args, **kw):
        launched.append(1)
        return plain_read(x2, w2, *args, **kw)
    monkeypatch.setattr(ops, "fakequant_read", fake_read)
    plain_eager = ops._fakequant_eager

    def counting_eager(*args, **kw):
        eager.append(1)
        return plain_eager(*args, **kw)
    monkeypatch.setattr(ops, "_fakequant_eager", counting_eager)
    for xg, wg in ((True, False), (False, True), (True, True)):
        xr, wr = x.clone().requires_grad_(xg), w.clone().requires_grad_(wg)
        y = ops.fakequant_project(xr, wr, AdcConfig(), 16)
        assert eager == [] and y.grad_fn is not None
        y.square().sum().backward()
        assert len(eager) == 1          # the backward's recomputation
        eager.clear()
        xe, we = x.clone().requires_grad_(xg), w.clone().requires_grad_(wg)
        plain_eager(xe, we, AdcConfig(), 16).square().sum().backward()
        for got, want in ((xr, xe), (wr, we)):
            assert (got.grad is None) == (want.grad is None)
            if want.grad is not None:
                torch.testing.assert_close(got.grad, want.grad, rtol=0,
                                           atol=0)
    with torch.no_grad():
        ops.fakequant_project(x.requires_grad_(), w, AdcConfig(), 16)
    assert launched == [1] * 4 and eager == []


def test_eager_path_is_differentiable_on_cpu():
    """QAT on the CPU trains through the plain path, as the reference's
    jnp path: the rounding passes no gradient, the range does."""
    x, w = (torch.from_numpy(a) for a in _float_operands((), 8, 40, 24))
    w = w.clone().requires_grad_()
    ops.fakequant_project(x, w, AdcConfig(), 16).sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


@pytest.mark.parametrize("lead,t,k,n,rows", EXACT_CASES[:2])
def test_stochastic_rounding_raises(lead, t, k, n, rows):
    """``stochastic_round=True`` as the reference runs it (the name is
    the refusal this test held before the port took the flag): the
    reference's fakequant projection passes no key, so it rounds half to
    even with the flag set; the port's projection and read are bit-equal
    to the reference's jnp path with the flag and to their own reads
    without it (exact class)."""
    x, w = _exact_operands(lead, t, k, n)
    want = _reference(x, w, rows, "jnp", stochastic_round=True)
    got = _port(x, w, rows, stochastic_round=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port(x, w, rows))
    np.testing.assert_array_equal(
        _port_read(x, w, rows, stochastic_round=True), got)


def test_fakequant_read_rejects_bad_shapes():
    with pytest.raises(ValueError, match="not"):
        K.fakequant_read(torch.ones((4, 8)), torch.ones((6, 3)),
                         AdcConfig(), 16)


def test_kernel_source_is_built_for_hopper():
    """The build line targets sm_90a and keeps IEEE division and sqrt; the
    source names the TPU kernel it replaces and uses no library GEMM."""
    from repro_torch.kernels import _nvcc
    assert "arch=compute_90a,code=sm_90a" in _nvcc.NVCC_FLAGS
    assert "--use_fast_math" not in _nvcc.NVCC_FLAGS
    src = K.FAKEQUANT_SOURCE.read_text()
    assert "xbar_vmm.py:247" in src and "_fakequant_kernel" in src
    assert "__fdiv_rn" in src and "__fsqrt_rn" in src
    assert "#include <cublas" not in src
    assert {"fakequant", "fakequant_epilogue"} <= set(K.LAUNCHES)


# --------------------------------------------------------------------------
# The lead-dim (expert-stack) read: x (E, T, K) through w (E, K, N)
# --------------------------------------------------------------------------

def _stack_operands(e, t, k, n, exact, seed=3):
    """E experts' operands; the float class with experts of very different
    magnitudes (1e-3 to 1e2) and one all-zero expert."""
    if exact:
        pairs = [_exact_operands((), t, k, n, seed + i) for i in range(e)]
        x, w = (np.stack(a) for a in zip(*pairs))
        x[1] = 0.0
        return x, w
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, t, k)).astype(np.float32)
    x *= np.float32([1e-3, 0.0, 1.0, 1e2])[:e, None, None]
    w = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _reference_vmap(x, w, rows, jimpl):
    """The reference's expert read: ``fakequant_project`` vmapped over the
    experts (``repro.models.layers.expert_project``)."""
    import jax
    return np.asarray(jax.vmap(lambda xe, we: jax_fakequant(
        xe, we, JAdc(), rows, impl=jimpl))(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("t,k,n,rows", [(8, 40, 16, 16), (5, 37, 32, 16)])
def test_lead_dim_read_matches_reference_vmap(t, k, n, rows, exact):
    """``fakequant_read`` and ``fakequant_project`` on an expert stack
    against the reference's vmap: one DAC scale per expert, the all-zero
    expert exactly 0; bit-equal in the exact class, 1e-5 of each expert's
    largest output otherwise; the plain lead-dim version equal to the
    per-expert loop of ``_fakequant_plain`` bit for bit."""
    x, w = _stack_operands(4, t, k, n, exact)
    want = _reference_vmap(x, w, rows, "jnp")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    read = K.fakequant_read(tx, tw, AdcConfig(), rows).numpy()
    proj = ops.fakequant_project(tx, tw, AdcConfig(), rows).numpy()
    sc = K.fakequant_scale(tx, 127)
    assert sc.shape == (4,) and float(sc[1]) == np.float32(1e-12 / 127)
    loop = np.stack([K._fakequant_plain(tx[i], tw[i], sc[i:i + 1],
                                        AdcConfig(), rows).numpy()
                     for i in range(4)])
    np.testing.assert_array_equal(read, loop)
    np.testing.assert_array_equal(
        K._fakequant_plain_lead(tx, tw, sc, AdcConfig(), rows).numpy(), loop)
    assert np.all(read[1] == 0) and np.all(proj[1] == 0)
    if exact:
        np.testing.assert_array_equal(read, want)
        np.testing.assert_array_equal(proj, want)
        for i in range(4):
            np.testing.assert_array_equal(K._fakequant_tc_plain(
                tx[i], tw[i], sc[i:i + 1], AdcConfig(), rows).numpy(),
                want[i])
        return
    scale = np.abs(want).max(axis=(1, 2), keepdims=True) + 1e-30
    for got in (read, proj):
        assert (np.abs(got - want) <= 1e-5 * scale).all()
    interp = _reference_vmap(x, w, rows, "interpret")
    assert (np.abs(read - interp) <= 1e-5 * scale).all()


def test_lead_dim_kernel_path_needs_the_card():
    """An expert stack on the CPU never reaches the kernel: the kernel's
    wrapper raises, the dispatch takes the plain version and counts no
    launch; mismatched lead dims raise."""
    x, w = (torch.from_numpy(a) for a in _stack_operands(4, 8, 40, 16,
                                                         False))
    with pytest.raises(ValueError, match="CUDA"):
        K._fakequant_cuda(x, w, AdcConfig(), 16)
    before = dict(K.LAUNCHES)
    K.fakequant_read(x, w, AdcConfig(), 16)
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="not"):
        K.fakequant_read(x, w[:3], AdcConfig(), 16)
    with pytest.raises(ValueError, match="match"):
        K._fakequant_cuda(x, w[:3], AdcConfig(), 16)


def test_lead_dim_read_under_autograd_is_the_eager_vjp():
    """The expert read's gradient (QAT on MoE) is the reference's: the
    eager expression per expert, ``jax.grad`` of its vmap, within 1e-5."""
    import jax
    x, w = _stack_operands(4, 8, 40, 16, False)
    dy = np.random.default_rng(4).standard_normal((4, 8, 16)).astype(
        np.float32)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jax.vmap(
        lambda xe, we: jax_fakequant(xe, we, JAdc(), 16))(a, b) * dy),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (ops.fakequant_project(tx, tw, AdcConfig(), 16)
     * torch.from_numpy(dy)).sum().backward()
    dx, dw = ops._fakequant_vjp(tx.detach(), tw.detach(),
                                torch.from_numpy(dy), AdcConfig(), 16)
    torch.testing.assert_close(tx.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(tw.grad, dw, rtol=0, atol=0)
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= \
            1e-5 * np.linalg.norm(want)
