"""The port's rank-k write (counter PRNG, device epilogue, plain version of
the update kernel, dispatch) against the JAX package.

Parity classes:

  * the PRNG's hash words (``_mix32``, ``_tile_seed``) — bit-equal: plain
    uint32 arithmetic, emulated in int64 by the port;
  * the Box–Muller normals — within 1e-6 (log, cos and sin of two libms);
  * an ideal device, no noise, operands on power-of-two grids — bit-equal:
    every product and sum of the outer product is exact;
  * the TaOx epilogue (exp, division, sqrt, the normals) — within 4
    float32 ulp of conductances in [0, 1] (2.4e-7 absolute).

The inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CrossbarConfig as JXbar
from repro.core import device as jdev
from repro.core.xbar_ops import outer_update as jax_outer_update
from repro.core.xbar_ops import quantize_update_operands as jax_quant_ops
from repro.kernels import xbar_update as JU
from repro_torch.core import CrossbarConfig, DeviceConfig, device as tdev
from repro_torch.core.xbar_ops import outer_update, quantize_update_operands
from repro_torch.kernels import xbar_update as U

ULP4 = 4 * 2.0 ** -24          # 4 float32 ulp of a conductance in [0.5, 1)
DEVICES = {
    "taox": dict(kind="taox"),
    "taox_asym": dict(kind="taox", nu_set=3.0, nu_reset=6.0, gain_set=1.2,
                      gain_reset=0.8),
    "taox_linear_set": dict(kind="taox", nu_set=0.0, nu_reset=5.0),
    "linearized": dict(kind="linearized"),
    "ideal": dict(kind="ideal", write_noise=0.0),
}


def _dev(name):
    return (jdev.DeviceConfig(**DEVICES[name]),
            DeviceConfig(**DEVICES[name]))


def _words(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n,
                                                dtype=np.uint64)


def test_mix32_hash_words_bit_equal():
    w = _words(4096)
    ref = np.asarray(JU._mix32(jnp.asarray(w.astype(np.uint32))))
    port = U._mix32(torch.from_numpy(w.astype(np.int64))).numpy()
    np.testing.assert_array_equal(port, ref.astype(np.int64))


def test_tile_seed_hash_words_bit_equal():
    seeds = _words(8, seed=1)
    lyr = np.arange(7, dtype=np.uint32)[:, None, None] + np.uint32(3)
    tk = np.arange(5, dtype=np.uint32)[None, :, None] + np.uint32(2 ** 31)
    tn = np.arange(9, dtype=np.uint32)[None, None, :]
    for s in seeds:
        ref = np.asarray(JU._tile_seed(jnp.uint32(s), jnp.asarray(lyr),
                                       jnp.asarray(tk), jnp.asarray(tn)))
        port = U._tile_seed(int(s), torch.from_numpy(lyr.astype(np.int64)),
                            torch.from_numpy(tk.astype(np.int64)),
                            torch.from_numpy(tn.astype(np.int64)))
        np.testing.assert_array_equal(port.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("tile", [(16, 16), (16, 15), (8, 32)])
def test_field_normals_close(tile):
    rows, cols = tile
    shape = (3, 40, 37)
    ref = np.asarray(JU.field_normals(
        jnp.uint32(0xDEADBEEF), shape, JXbar(rows=rows, cols=cols),
        tile_offsets=(0, 0, 0)))
    port = U.field_normals(0xDEADBEEF, shape,
                           CrossbarConfig(rows=rows, cols=cols))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)
    assert abs(float(port.std()) - 1.0) < 0.05


def test_field_normals_offsets_slice_the_larger_field():
    """A block of layers 2:4, row tiles 1:3 and column tiles 2:4 with
    ``tile_offsets`` gets that slice of the whole field bit for bit, and
    the reference's offset field within 1e-6."""
    cfg = CrossbarConfig(rows=16, cols=16)
    full = U.field_normals(1234, (4, 64, 64), cfg)
    part = U.field_normals(1234, (2, 32, 32), cfg, (2, 1, 2))
    assert torch.equal(part, full[2:4, 16:48, 32:64])
    ref = np.asarray(JU.field_normals(jnp.uint32(1234), (2, 32, 32),
                                      JXbar(rows=16, cols=16),
                                      tile_offsets=(2, 1, 2)))
    np.testing.assert_allclose(part.numpy(), ref, rtol=0, atol=1e-6)


def _g_and_request(seed=0, shape=(24, 20)):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    g.flat[:4] = [0.0, 1.0, 0.5, 0.999]
    dg = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    dg.flat[4:8] = [0.0, -0.0, 0.8, -0.8]          # zero and clipping cases
    noise = rng.standard_normal(shape).astype(np.float32)
    return g, dg, noise


@pytest.mark.parametrize("name", list(DEVICES))
def test_apply_update_matches_reference(name):
    """``core.device.apply_update``: the reference draws its field from a
    key; the port takes the same field as input."""
    jd, td = _dev(name)
    g, dg, _ = _g_and_request()
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jdev.apply_update(jnp.asarray(g), jnp.asarray(dg), jd,
                                       key))
    noise = np.array(jax.random.normal(key, g.shape, dtype=jnp.float32))
    port = tdev.apply_update(torch.from_numpy(g), torch.from_numpy(dg), td,
                             torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)


@pytest.mark.parametrize("name", list(DEVICES))
def test_pulse_epilogue_matches_reference(name):
    """``_pulse_epilogue`` on the same accumulators: the rails, the event
    counts (``pulse_dg`` is a power of two, so ``mag / pulse_dg`` is
    exact) and the device's response, within 4 float32 ulp."""
    jd, td = _dev(name)
    rng = np.random.default_rng(10)
    g, _, noise = _g_and_request(seed=10)
    acc = (rng.standard_normal(g.shape) * 0.05).astype(np.float32)
    a_abs = (np.abs(acc) + rng.uniform(0, 0.05, g.shape)).astype(np.float32)
    m = np.float32(-0.6)
    ref = np.asarray(JU._pulse_epilogue(
        jnp.asarray(g), jnp.asarray(acc), jnp.asarray(a_abs), jnp.asarray(m),
        jnp.asarray(noise), jd))
    port = U._pulse_epilogue(
        torch.from_numpy(g), torch.from_numpy(acc), torch.from_numpy(a_abs),
        torch.tensor(m), torch.from_numpy(noise), td).numpy()
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)
    assert np.abs(port - g).max() > 4 * td.pulse_dg


def test_pulse_update_dispatch_counts_and_source():
    """``cfg.update_mode="pulse_train"`` dispatches as the outer mode does:
    CPU tensors run the plain version and count no launch, the CUDA path
    refuses them; the kernel source exports the pulse launcher and rounds
    the counts half to even (``rintf``)."""
    g, x_q, d_q, scale = (torch.from_numpy(a) for a in
                          _update_operands(2, 5, 20, 12, False, seed=11))
    cfg = CrossbarConfig(rows=16, cols=16, update_mode="pulse_train")
    assert U.UPDATE_MODES == JU.UPDATE_MODES
    before = dict(U.LAUNCHES)
    out = U.xbar_outer_update(g, x_q, d_q, scale, cfg, seed=1)
    assert set(U.LAUNCHES) == {"outer_update", "pulse_update", "update_tc",
                               "update_prepare", "update_fp32"}
    assert U.LAUNCHES == before and out.shape == g.shape
    assert not torch.equal(out, U.xbar_outer_update(
        g, x_q, d_q, scale, cfg.replace(update_mode="outer"), seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        U.xbar_outer_update(g, x_q, d_q, scale, cfg, seed=1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        U._update_cuda(g, x_q, d_q, scale, None, 1, cfg, "kernel")
    src = U.SOURCE.read_text()
    assert "xbar_pulse_update" in src and "rintf(" in src
    assert "roundf" not in src


@pytest.mark.parametrize("name", list(DEVICES))
def test_device_epilogue_matches_reference(name):
    jd, td = _dev(name)
    g, dg, noise = _g_and_request(seed=1)
    ref = np.asarray(JU._device_epilogue(jnp.asarray(g), jnp.asarray(dg),
                                         jnp.asarray(noise), jd))
    port = U._device_epilogue(torch.from_numpy(g), torch.from_numpy(dg),
                              torch.from_numpy(noise), td).numpy()
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)


def test_quantize_update_operands_bit_equal():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    d = (rng.standard_normal((9, 24)) * 1e-3).astype(np.float32)
    jx, jd = jax_quant_ops(jnp.asarray(x), jnp.asarray(d), JXbar())
    tx, td = quantize_update_operands(torch.from_numpy(x),
                                      torch.from_numpy(d), CrossbarConfig())
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert len(np.unique(np.abs(td.numpy()))) <= 8     # 3 bits + sign


def test_outer_update_chain_matches_reference():
    """The unfused write chain (quantise, outer product, device model)."""
    rng = np.random.default_rng(3)
    g = rng.uniform(0.2, 0.8, (40, 24)).astype(np.float32)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    d = (rng.standard_normal((9, 24)) * 1e-2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jcfg, tcfg = JXbar(), CrossbarConfig()
    ref = np.asarray(jax_outer_update(jnp.asarray(g), jnp.asarray(x),
                                      jnp.asarray(d), 0.1, jnp.float32(1.7),
                                      jcfg, key))
    noise = np.array(jax.random.normal(key, g.shape, dtype=jnp.float32))
    port = outer_update(torch.from_numpy(g), torch.from_numpy(x),
                        torch.from_numpy(d), 0.1, torch.tensor(1.7), tcfg,
                        torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)


def _update_operands(lyr, t, k, n, pow2, seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (lyr, k, n)).astype(np.float32)
    xi = rng.integers(-127, 128, (lyr, t, k)).astype(np.float32)
    di = rng.integers(-7, 8, (lyr, t, n)).astype(np.float32)
    if pow2:   # max|x| = 127 * 2^-7, max|d| = 7 * 2^-12: exact products
        x_q, d_q = xi * 2.0 ** -7, di * 2.0 ** -12
        scale = np.full((lyr,), -2.0 ** -6, np.float32)
    else:
        x_q, d_q = xi * (2.6 / 127), di * (0.03 / 7)
        scale = -rng.uniform(0.05, 0.2, lyr)
    return (g, x_q.astype(np.float32), d_q.astype(np.float32),
            scale.astype(np.float32))


def _update_both(ops, tile, dev, noise_mode, jimpl, seed=None, noise=None):
    g, x_q, d_q, scale = ops
    jcfg = JXbar(rows=tile[0], cols=tile[1], device=dev[0])
    tcfg = CrossbarConfig(rows=tile[0], cols=tile[1], device=dev[1])
    ref = np.asarray(JU.xbar_outer_update(
        jnp.asarray(g), jnp.asarray(x_q), jnp.asarray(d_q),
        jnp.asarray(scale), jcfg, impl=jimpl, noise_mode=noise_mode,
        seed=None if seed is None else jnp.uint32(seed),
        noise=None if noise is None else jnp.asarray(noise)))
    port = U.xbar_outer_update(
        torch.from_numpy(g), torch.from_numpy(x_q), torch.from_numpy(d_q),
        torch.from_numpy(scale), tcfg, noise_mode=noise_mode, seed=seed,
        noise=None if noise is None else torch.from_numpy(noise))
    return ref, port.numpy()


@pytest.mark.parametrize("jimpl", ["fused", "interpret"])
@pytest.mark.parametrize("tile", [(16, 16), (16, 15)])
def test_update_plain_bitwise_ideal_pow2(jimpl, tile):
    ops = _update_operands(3, 9, 40, 37, pow2=True, seed=4)
    ref, port = _update_both(ops, tile, _dev("ideal"), "none", jimpl)
    np.testing.assert_array_equal(port, ref)
    assert np.abs(port - ops[0]).max() > 1e-5       # the write moved G


@pytest.mark.parametrize("jimpl", ["fused", "interpret"])
@pytest.mark.parametrize("tile", [(16, 16), (16, 15)])
def test_update_plain_taox_kernel_noise_close(jimpl, tile):
    ops = _update_operands(3, 9, 40, 37, pow2=False, seed=5)
    ref, port = _update_both(ops, tile, _dev("taox"), "kernel", jimpl,
                             seed=0x12345678)
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)
    # a wrong hash would move G by a write-noise sigma, far outside ULP4
    wrong, _ = _update_both(ops, tile, _dev("taox"), "kernel", jimpl,
                            seed=0x12345679)
    assert np.abs(port - wrong).max() > 1e3 * ULP4


def test_update_plain_taox_host_noise_close():
    ops = _update_operands(2, 9, 40, 37, pow2=False, seed=6)
    noise = np.random.default_rng(7).standard_normal(
        ops[0].shape).astype(np.float32)
    ref, port = _update_both(ops, (16, 16), _dev("taox"), "host", "fused",
                             noise=noise)
    np.testing.assert_allclose(port, ref, rtol=0, atol=ULP4)


def test_update_squeezes_a_single_matrix_and_counts_no_launch():
    g, x_q, d_q, scale = (torch.from_numpy(a)[0] for a in
                          _update_operands(1, 5, 20, 12, True, seed=8))
    before = dict(U.LAUNCHES)
    out = U.xbar_outer_update(g, x_q, d_q, scale, CrossbarConfig(
        rows=16, cols=16, device=_dev("ideal")[1]))
    assert out.shape == g.shape and U.LAUNCHES == before


def test_update_dispatch_and_argument_checks_raise():
    g, x_q, d_q, scale = (torch.from_numpy(a) for a in
                          _update_operands(1, 5, 20, 12, True, seed=9))
    cfg = CrossbarConfig(rows=16, cols=16)
    with pytest.raises(ValueError, match="CUDA"):
        U.xbar_outer_update(g, x_q, d_q, scale, cfg, seed=1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        U._update_cuda(g, x_q, d_q, scale, None, 1, cfg, "kernel")
    with pytest.raises(ValueError, match="impl"):
        U.xbar_outer_update(g, x_q, d_q, scale, cfg, seed=1, impl="pallas")
    with pytest.raises(ValueError, match="seed"):
        U.xbar_outer_update(g, x_q, d_q, scale, cfg)   # noisy, no seed
    with pytest.raises(ValueError, match="noise field"):
        U.xbar_outer_update(g, x_q, d_q, scale, cfg, noise_mode="host")
    with pytest.raises(ValueError, match="update_mode"):
        U.xbar_outer_update(g, x_q, d_q, scale,
                            cfg.replace(update_mode="outr"), seed=1)


def test_update_kernel_source_and_params():
    src = U.SOURCE.read_text()
    assert "_update_kernel" in src and "__fmul_rn" in src
    for intrinsic in ("__expf", "__logf", "__cosf", "__sinf"):
        assert intrinsic not in src
    p = U.device_params(DeviceConfig(), "kernel")
    e = np.exp(-5.0)
    mid = (np.exp(-2.5) - e) / (1.0 - e)
    assert (p.kind, p.noise_mode) == (1, 2)
    assert p.e == np.float32(e) and p.emid == np.float32((1.0 - e) * mid)
    assert p.sigma_scale == np.float32(0.3 / 256)
    assert U.device_params(DeviceConfig(write_noise=0.0),
                           "kernel").noise_mode == 0
