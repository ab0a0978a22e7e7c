"""The rest of the reference's public API in the port, each against the
JAX package on the same numpy inputs: stochastic rounding as the
reference runs it, ``conductance_to_weights``, ``tile_info``,
``with_tapes``, ``analog_project_batched``, the kernel-routed entry
points ``kernels.ops.vmm`` / ``mvm`` / ``outer_update``,
``ModelConfig.analog_training``, ``REPRO_SSM_CHUNK`` in the dry run, the
deprecated ``Engine`` aliases and the packages' exports.

Parity classes:

  * the quantisers with a uniform field (the reference's keyed rounding:
    floor, a comparison, an add) — bit-equal;
  * a read with ``stochastic_round`` set — bit-equal to the same read
    without it, in both packages (no library read passes a key);
  * reads with a fixed power-of-two ADC range — bit-equal (as
    ``tests/test_torch_xbar_vmm.py`` holds them);
  * ``outer_update`` — bit-equal on an ideal device with power-of-two
    operand grids; TaOx with noise within 4 float32 ulp of conductances
    in [0, 1] (``ULP4``, the write's class in
    ``tests/test_torch_xbar_update.py``), the host field the reference's
    ``jax.random.normal(key, g.shape)``, the kernel seed its
    ``jax.random.bits(key, (), uint32)``;
  * ``conductance_to_weights`` and ``tile_info`` — bit-equal / equal.
"""
import ast
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels as jkernels
from repro.configs import get_config as jax_config
from repro.core import adc as jadc
from repro.core import tiled_analog as JT
from repro.kernels import ops as JOPS
from repro.models import model as JM
from repro.serve import SamplingParams as JaxSampling
from repro.serve import make_engine as jax_engine
import repro_torch.core as tcore
import repro_torch.kernels as tkernels
from repro_torch.configs import get_config
from repro_torch.configs.base import AnalogMode
from repro_torch.convert import params_from_numpy
from repro_torch.core import adc as tadc
from repro_torch.core import crossbar as TC
from repro_torch.core import tiled_analog as TT
from repro_torch.core import xbar_ops
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import xbar_update as U
from repro_torch.kernels import xbar_vmm as K
from repro_torch.launch import dryrun as DR
from repro_torch.serve import SamplingParams, make_engine

ROOT = Path(__file__).resolve().parents[1]
ULP4 = 4 * 2.0 ** -24
POW2_ADC = dict(in_bits=8, out_bits=8, range_mode="fixed", sat_frac=0.03125)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _cfgs(tile=16, adc=None, **dev):
    adc = adc or {}
    jd = jcore.DeviceConfig(**dev) if dev else jcore.IDEAL
    td = tcore.DeviceConfig(**dev) if dev else tcore.IDEAL
    return (jcore.CrossbarConfig(rows=tile, cols=tile, device=jd,
                                 adc=jcore.AdcConfig(**adc)),
            tcore.CrossbarConfig(rows=tile, cols=tile, device=td,
                                 adc=tcore.AdcConfig(**adc)))


def _read_operands(k, n, b, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((*lead, k, n)) / np.sqrt(k)
    w_max = np.abs(w).max(axis=(-2, -1), keepdims=True)
    g = (0.5 + w * (0.5 / w_max)).astype(np.float32)
    ref = np.full(g.shape, 0.5, np.float32)
    ws = np.asarray(0.5 / w_max[..., 0, 0], np.float32)
    x = rng.standard_normal((*lead, b, k)).astype(np.float32)
    return x, g, ref, ws


# ------------------------------------------------- 1. stochastic rounding

@pytest.mark.parametrize("range_mode", ["fixed", "dynamic"])
def test_adc_quantize_keyed_rounding_bit_equal(range_mode):
    """``adc_quantize`` with ``u`` from the reference's key: bit-equal to
    the reference's keyed call (fixed range; the dynamic range's rms is
    a reduction in another order, so there the port takes the
    reference's ``sat``); without ``u`` it rounds half to even."""
    kw = dict(in_bits=8, out_bits=6, range_mode=range_mode, sat_frac=0.1,
              stochastic_round=True)
    jcfg, tcfg = jadc.AdcConfig(**kw), tadc.AdcConfig(**kw)
    q = (40 * np.random.default_rng(4).standard_normal((5, 32))).astype(
        np.float32)
    qj, satj = jadc.integrator_saturation(jnp.asarray(q), jcfg, n_rows=16)
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, q.shape, dtype=jnp.float32))
    want = np.asarray(jadc.adc_quantize(qj, satj, jcfg, key=key))
    got = tadc.adc_quantize(_t(np.asarray(qj)), _t(np.asarray(satj)), tcfg,
                            u=_t(u)).numpy()
    np.testing.assert_array_equal(got, want)
    plain = tadc.adc_quantize(_t(np.asarray(qj)), _t(np.asarray(satj)),
                              tcfg).numpy()
    np.testing.assert_array_equal(plain, np.asarray(
        jadc.adc_quantize(qj, satj, jcfg)))
    assert not np.array_equal(got, plain)
    # the flag off ignores the field, as the reference ignores its key
    off = tadc.AdcConfig(**{**kw, "stochastic_round": False})
    np.testing.assert_array_equal(tadc.adc_quantize(
        _t(np.asarray(qj)), _t(np.asarray(satj)), off, u=_t(u)).numpy(),
        plain)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("adc", [POW2_ADC, dict(range_mode="dynamic")],
                         ids=["pow2", "dynamic"])
def test_reads_with_stochastic_round_flag(transpose, adc):
    """The fused read, the chain read and ``kernels.ops`` with the flag:
    bit-equal to the same read without it; on the power-of-two class
    bit-equal to the reference's read with the flag."""
    x, g, ref, ws = _read_operands(40, 24, 6, lead=(2,), seed=1)
    if transpose:
        x = np.random.default_rng(2).standard_normal((2, 6, 24)).astype(
            np.float32)
    jcfg, tcfg = _cfgs(adc={**adc, "stochastic_round": True})
    _, off = _cfgs(adc=adc)
    args = (_t(x), _t(g), _t(ref), _t(ws))
    read = xbar_ops.mvm if transpose else xbar_ops.vmm
    on = read(*args, tcfg).numpy()
    np.testing.assert_array_equal(on, read(*args, off).numpy())
    np.testing.assert_array_equal(on, read(*args, tcfg, impl="chain")
                                  .numpy())
    op = OPS.mvm if transpose else OPS.vmm
    np.testing.assert_array_equal(op(*args, tcfg).numpy(), on)
    jread = jcore.mvm if transpose else jcore.vmm
    want = np.asarray(jread(*map(jnp.asarray, (x, g, ref, ws)), jcfg))
    if adc is POW2_ADC:
        np.testing.assert_array_equal(on, want)
    else:
        np.testing.assert_allclose(on, want, rtol=1e-5, atol=1e-5)


def test_fakequant_and_qat_projection_with_flag():
    """The fakequant read and the QAT projection (under autograd) with
    the flag: bit-equal to the same without it, values and gradients."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) / 6).astype(np.float32)
    outs = []
    for flag in (True, False):
        adc = tadc.AdcConfig(stochastic_round=flag)
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        y = OPS.fakequant_project(xt, wt, adc, 16)
        y.square().sum().backward()
        outs.append((y.detach(), xt.grad, wt.grad,
                     K.fakequant_read(_t(x), _t(w), adc, 16)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ------------------------------------------- 4. crossbar / tiled_analog

def test_conductance_to_weights_bit_equal():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((2, 20, 12)).astype(np.float32)
    jcfg, tcfg = _cfgs()
    jg, jws = jcore.weights_to_conductance(jnp.asarray(w[0]), jcfg)
    want = np.asarray(jcore.conductance_to_weights(jg, jws, jcfg))
    got = tcore.conductance_to_weights(_t(np.asarray(jg)),
                                       torch.tensor(float(jws)), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), w[0], rtol=1e-5, atol=1e-6)
    assert TC.conductance_to_weights is tcore.conductance_to_weights


@pytest.mark.parametrize("shape", [(64, 64), (100, 37), (3, 130, 16)])
def test_tile_info_equal(shape):
    jcfg, tcfg = _cfgs(tile=32)
    assert TT.tile_info({"g": torch.zeros(shape)}, tcfg) \
        == JT.tile_info({"g": jnp.zeros(shape)}, jcfg)


def test_with_tapes_shapes_match_reference():
    """Tape slots next to every container, of the reference's shapes
    (the port adds its code scales, ones), the default rows and
    ``tokens_for``'s."""
    tree = {"a": {"g": torch.zeros(3, 8, 5), "ref": torch.zeros(3, 8, 5),
                  "w_scale": torch.ones(3)},
            "b": {"g": torch.zeros(6, 4), "ref": torch.zeros(6, 4),
                  "w_scale": torch.ones(())}, "c": torch.zeros(2)}
    jtree = {k: ({n: jnp.zeros(v.shape) for n, v in d.items()}
                 if isinstance(d, dict) else jnp.zeros(d.shape))
             for k, d in tree.items()}
    for kw in (dict(), dict(tokens_for=lambda path, shape:
                            (2, 7) if path == ("b",) else 7)):
        got = TT.with_tapes(tree, 7, **kw)
        want = JT.with_tapes(jtree, 7, **kw)
        for name in ("a", "b"):
            for leaf in ("x_tape", "d_tape"):
                assert tuple(got[name][leaf].shape) \
                    == tuple(want[name][leaf].shape)
            lead = tuple(got[name]["x_tape"].shape[:-2])
            assert tuple(got[name]["x_tape_scale"].shape) == lead
        assert got["c"] is tree["c"] and got["a"]["g"] is tree["a"]["g"]


def test_analog_project_batched_reads_through_analog_project():
    """The batched projection is ``analog_project`` of the stack (one
    read path), bit for bit, with the reference's shape check; and on
    the power-of-two class bit-equal to the reference's."""
    x, g, ref, ws = _read_operands(40, 24, 6, lead=(3,), seed=8)
    jcfg, tcfg = _cfgs(adc=POW2_ADC)
    p = {"g": _t(g), "ref": _t(ref), "w_scale": _t(ws)}
    got = TT.analog_project_batched(p, _t(x), tcfg)
    assert torch.equal(got, TT.analog_project(p, _t(x), tcfg))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JT.analog_project_batched(
            jp, jnp.asarray(x), jcfg)))
    for bad in (x[:2], x[..., :39]):
        with pytest.raises(ValueError, match="does not match"):
            TT.analog_project_batched(p, _t(bad), tcfg)
        with pytest.raises(ValueError, match="does not match"):
            JT.analog_project_batched(jp, jnp.asarray(bad), jcfg)


# ----------------------------------------------------- 5. kernels.ops

@pytest.mark.parametrize("transpose", [False, True])
def test_ops_reads_match_reference(transpose):
    x, g, ref, ws = _read_operands(48, 40, 5, lead=(2,), seed=9)
    if transpose:
        x = np.random.default_rng(3).standard_normal((2, 5, 40)).astype(
            np.float32)
    jcfg, tcfg = _cfgs(adc=POW2_ADC)
    op, jop = (OPS.mvm, JOPS.mvm) if transpose else (OPS.vmm, JOPS.vmm)
    got = op(*map(_t, (x, g, ref, ws)), tcfg).numpy()
    want = np.asarray(jop(*map(jnp.asarray, (x, g, ref, ws)), jcfg,
                          impl="jnp"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        op(*map(_t, (x, g, ref, ws)), tcfg, impl="cuda")


def _update_inputs(lyr=2, t=9, k=40, n=37, pow2=False, seed=10):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (lyr, k, n)).astype(np.float32)
    if pow2:   # codes times powers of two: every product and sum exact
        x = (rng.integers(-127, 128, (lyr, t, k)) * 2.0 ** -7)
        d = (rng.integers(-7, 8, (lyr, t, n)) * 2.0 ** -12)
        x.reshape(-1)[0], d.reshape(-1)[0] = 127 * 2.0 ** -7, 7 * 2.0 ** -12
    else:
        x = rng.standard_normal((lyr, t, k))
        d = rng.standard_normal((lyr, t, n)) * 1e-2
    return g, x.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("mode", ["outer", "pulse_train"])
@pytest.mark.parametrize("noise_mode", ["host", "kernel"])
def test_ops_outer_update_matches_reference(mode, noise_mode):
    """TaOx with write noise: the reference's field or seed from its key,
    within ``ULP4``; the port's result is ``xbar_outer_update`` of the
    quantised operands (bit for bit)."""
    g, x, d = _update_inputs()
    jcfg, tcfg = _cfgs(kind="taox")
    jcfg, tcfg = jcfg.replace(update_mode=mode), \
        tcfg.replace(update_mode=mode)
    key = jax.random.PRNGKey(12)
    lr, ws = 0.1, np.float32(1.7)
    want = np.asarray(JOPS.outer_update(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(d), lr, jnp.asarray(ws),
        jcfg, key=key, noise_mode=noise_mode, impl="fused"))
    kw = dict(noise=_t(np.array(jax.random.normal(key, g.shape,
                                                  dtype=jnp.float32)))) \
        if noise_mode == "host" \
        else dict(seed=int(jax.random.bits(key, (), jnp.uint32)))
    got = OPS.outer_update(_t(g), _t(x), _t(d), lr, torch.tensor(ws), tcfg,
                           **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP4)
    x_q, d_q = xbar_ops.quantize_update_operands(_t(x), _t(d), tcfg)
    scale = torch.tensor(-lr, dtype=torch.float32) * torch.tensor(ws)
    direct = U.xbar_outer_update(_t(g), x_q, d_q, scale, tcfg, **kw)
    np.testing.assert_array_equal(got, direct.numpy())
    assert np.abs(got - g).max() > 1e-3          # the write moved G


@pytest.mark.parametrize("mode", ["outer", "pulse_train"])
def test_ops_outer_update_ideal_pow2_bit_equal(mode):
    """An ideal device on power-of-two grids (no noise: ``"none"``
    whatever mode is asked): bit-equal to the reference's."""
    g, x, d = _update_inputs(pow2=True, seed=13)
    jcfg, tcfg = _cfgs()
    jcfg, tcfg = jcfg.replace(update_mode=mode), \
        tcfg.replace(update_mode=mode)
    want = np.asarray(JOPS.outer_update(
        jnp.asarray(g), jnp.asarray(x), jnp.asarray(d), 8.0,
        jnp.float32(0.5), jcfg, impl="fused"))
    got = OPS.outer_update(_t(g), _t(x), _t(d), 8.0, 0.5, tcfg,
                           noise_mode="kernel").numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - g).max() > 1e-4


def test_ops_outer_update_noise_arguments():
    g, x, d = (_t(a) for a in _update_inputs(lyr=1, seed=14))
    _, tcfg = _cfgs(kind="taox")
    with pytest.raises(ValueError, match="noise field"):
        OPS.outer_update(g, x, d, 0.1, 1.0, tcfg)
    with pytest.raises(ValueError, match="noise field"):
        OPS.outer_update(g, x, d, 0.1, 1.0, tcfg, seed=1, noise_mode="host")
    with pytest.raises(ValueError, match="noise_mode"):
        OPS.outer_update(g, x, d, 0.1, 1.0, tcfg, seed=1, noise_mode="hots")
    with pytest.raises(ValueError, match="CUDA"):
        OPS.outer_update(g, x, d, 0.1, 1.0, tcfg, seed=1, impl="cuda")
    # a field and a seed: the field, as the reference's default mode
    z = torch.randn(g.shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(OPS.outer_update(g, x, d, 0.1, 1.0, tcfg, noise=z,
                                        seed=1),
                       OPS.outer_update(g, x, d, 0.1, 1.0, tcfg, noise=z))
    # the operands' scales ride along: the card's tensor-core instance
    before = dict(U.LAUNCHES)
    OPS.outer_update(g[0], x[0], d[0], 0.1, 1.0, tcfg, seed=3)
    assert U.LAUNCHES == before                  # the CPU launches nothing


# ------------------------------------------- 6-9. configs, dry run, serve

@pytest.mark.parametrize("mode", ["digital", "fakequant", "device"])
@pytest.mark.parametrize("arch", ["lm100m", "llama4-scout-17b-a16e",
                                  "mamba2-1.3b"])
def test_analog_training_property(arch, mode):
    kw = {"digital": {}, "fakequant": dict(analog=True,
                                           analog_mode="fakequant"),
          "device": dict(analog=True, analog_mode="device")}[mode]
    cfg = get_config(arch, smoke=True).replace(**kw)
    want = jax_config(arch, smoke=True).replace(**kw).analog_training
    assert cfg.analog_training is want
    assert want is (cfg.resolved_analog_mode is AnalogMode.DEVICE)


def test_sharding_has_one_analog_training_definition():
    src = (ROOT / "src/repro_torch/launch/sharding.py").read_text()
    assert "_analog_training" not in src and "cfg.analog_training" in src


def test_dryrun_follows_repro_ssm_chunk(monkeypatch):
    """An SSM cell's reckoned FLOPs and peak follow the SSD chunk length
    (the intra-chunk quadratic term grows with it), as the reference's
    dry run applies ``REPRO_SSM_CHUNK``."""
    recs = {}
    for chunk in (32, 64):
        monkeypatch.setenv("REPRO_SSM_CHUNK", str(chunk))
        recs[chunk] = DR.run_cell("mamba2-1.3b", "train_4k", "1x1",
                                  smoke=True)
        assert recs[chunk]["ok"], recs[chunk].get("error")
    assert recs[64]["trace"]["flops"] > recs[32]["trace"]["flops"]
    assert recs[64]["mem"]["temp_gb"] > recs[32]["mem"]["temp_gb"]
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    assert 'cfg.replace(ssm_chunk=int(os.environ["REPRO_SSM_CHUNK"]))' in src


def _engines():
    jcfg = jax_config("lm100m", smoke=True)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(max_len=32, prefill_chunk=4, n_slots=2)
    return (jax_engine(jcfg, jp, **kw),
            make_engine(get_config("lm100m", smoke=True), p, **kw))


def test_engine_deprecated_aliases():
    """Each alias warns with the reference's text and calls what the port
    already has; the tokens equal the reference's aliases'."""
    jeng, eng = _engines()
    prompts = [[3, 5, 7, 9], [2, 4]]
    texts = {}
    for e, sp in ((jeng, JaxSampling(max_new_tokens=3)),
                  (eng, SamplingParams(max_new_tokens=3))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            toks = e.generate_static(prompts, sp)
            cont = e.continuous(2)
        texts[e is eng] = ([str(r.message) for r in w],
                           [r.category for r in w], toks)
        assert cont is e._continuous(2)
    assert texts[True] == texts[False]
    assert texts[True][1] == [DeprecationWarning] * 2
    assert texts[True][2] == eng._generate_static(
        prompts, SamplingParams(max_new_tokens=3))


# ------------------------------------------------------------ 9. exports

def test_core_exports_cover_the_reference():
    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
    assert tcore.endurance.__name__ == "repro_torch.core.endurance"
    assert tcore.LutDevice is tcore.device.LutDevice


def test_kernels_exports():
    want = {"ops", "ref", "xbar_fused_read", "xbar_outer_update",
            "fakequant_read"}
    assert set(tkernels.__all__) == want
    assert tkernels.xbar_fused_read is K.xbar_fused_read
    assert tkernels.xbar_outer_update is U.xbar_outer_update
    assert tkernels.fakequant_read is K.fakequant_read
    # the reference's names, but its Pallas-only twins
    ported = {n.replace("_pallas", "") for n in jkernels.__all__
              if not n.endswith("_inline")}
    assert ported == want


def test_core_init_imports_in_any_order():
    """``kernels.xbar_vmm`` imports ``core.adc``, which runs
    ``core/__init__``, whose ``endurance`` imports the kernels: a
    kernel module imported first imports cleanly in a fresh interpreter
    (``tests/test_torch_imports.py`` imports every module in package
    order)."""
    import subprocess
    import sys
    code = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
            "import repro_torch.core as c; "
            "assert all(hasattr(c, n) for n in c.__all__)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code,
                          "repro_torch.kernels.xbar_vmm"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_core_all_is_parsed_from_the_reference_source():
    """``repro.core.__all__`` as its source lists it (53 names)."""
    tree = ast.parse((ROOT / "src/repro/core/__init__.py").read_text())
    names = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and n.targets[0].id == "__all__")
    assert names == list(jcore.__all__) and len(names) == 53
