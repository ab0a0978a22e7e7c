"""The port's copy of the energy/latency/area model (``repro_torch.hwmodel``)
against the JAX package's ``repro.hwmodel``, in one process.

The five plain-Python modules are copies, so every public function must
return the reference's value exactly (or raise the same exception) at
every I/O width from 1 to 8 bits; the tables and the §VII headline must
be equal; the published-number expectations of ``tests/test_hwmodel.py``
must hold for the copy (run here on the port's modules, case for case).
``arch_cost`` enumerates the projections from the port's own parameter
tree (``init_params`` on the meta device, where the reference uses
``jax.eval_shape``); its roll-up of lm100m at full size must equal the
reference's, float for float.
"""
import dataclasses
import importlib.util
import inspect
from pathlib import Path

import pytest

from repro.configs import get_config as jax_config
from repro.hwmodel import analog as J_analog
from repro.hwmodel import arch_cost as J_arch
from repro.hwmodel import compare as J_compare
from repro.hwmodel import digital_reram as J_dreram
from repro.hwmodel import params as J_params
from repro.hwmodel import sram as J_sram
from repro_torch.configs import get_config
from repro_torch.hwmodel import analog, arch_cost, compare, digital_reram
from repro_torch.hwmodel import params as T_params
from repro_torch.hwmodel import sram

MODULES = {"params": (J_params, T_params), "sram": (J_sram, sram),
           "digital_reram": (J_dreram, digital_reram),
           "analog": (J_analog, analog), "compare": (J_compare, compare)}


def _public_functions(mod):
    return sorted(name for name, f in inspect.getmembers(mod,
                                                         inspect.isfunction)
                  if not name.startswith("_") and f.__module__ == mod.__name__)


CASES = [(m, f) for m, (jm, _) in MODULES.items()
         for f in _public_functions(jm)]


def _outcome(fn, *args):
    try:
        return "value", fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception type is compared
        return "raises", type(e).__name__


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}.{f}" for m, f in CASES])
def test_every_public_function_equals_the_reference(module, name):
    jm, tm = MODULES[module]
    jf, tf = getattr(jm, name), getattr(tm, name)
    params = list(inspect.signature(jf).parameters)
    assert params == list(inspect.signature(tf).parameters)
    calls = [(b,) for b in range(1, 9)] if params[:1] == ["bits"] else [()]
    for args in calls:
        assert _outcome(tf, *args) == _outcome(jf, *args), (name, args)


def test_the_copy_covers_every_reference_function():
    for jm, tm in MODULES.values():
        assert set(_public_functions(jm)) <= set(_public_functions(tm))


def test_table_i_and_synthesized_values_are_equal():
    assert dataclasses.asdict(T_params.TABLE_I) == dataclasses.asdict(
        J_params.TABLE_I)
    for prop in ("cell_wire_len", "c_line", "r_line"):
        assert getattr(T_params.TABLE_I, prop) == getattr(J_params.TABLE_I,
                                                          prop)
    assert T_params.SYNTH == J_params.SYNTH


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_analog_core_bundle_equals_the_reference(bits):
    t, j = analog.AnalogCore(bits=bits), J_analog.AnalogCore(bits=bits)
    for prop in ("area", "latency", "energy", "macs"):
        assert getattr(t, prop) == getattr(j, prop)


def test_tables_and_headline_equal_the_reference():
    assert compare.tables() == {
        "area": J_compare.table_area(), "latency": J_compare.table_latency(),
        "energy": J_compare.table_energy(),
        "kernels": J_compare.table_kernels()}
    assert compare.headline() == J_compare.headline()


# --------------------------------------------------------------------------
# tests/test_hwmodel.py, case for case, on the port's modules
# --------------------------------------------------------------------------

def _expectations():
    """A private copy of ``tests/test_hwmodel.py`` whose model modules
    are the port's."""
    path = Path(__file__).resolve().parent / "test_hwmodel.py"
    spec = importlib.util.spec_from_file_location("_hwmodel_expectations",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.analog, mod.compare = analog, compare
    mod.digital_reram, mod.sram = digital_reram, sram
    mod.NJ, mod.NS, mod.UM = T_params.NJ, T_params.NS, T_params.UM
    mod.TABLE_I = T_params.TABLE_I
    return mod


EXPECT = _expectations()


def _expectation_cases():
    cases = []
    for name, fn in inspect.getmembers(EXPECT, inspect.isfunction):
        if not name.startswith("test_"):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            cases.append((name, {}))
            continue
        (argnames, values), = (m.args for m in marks)
        names = [a.strip() for a in argnames.split(",")]
        for vals in values:
            vals = vals if isinstance(vals, tuple) else (vals,)
            cases.append((name, dict(zip(names, vals))))
    return cases


EXPECT_CASES = _expectation_cases()


@pytest.mark.parametrize(
    "name,kwargs", EXPECT_CASES,
    ids=[f"{n}[{'-'.join(map(str, kw.values()))}]" if kw else n
         for n, kw in EXPECT_CASES])
def test_reference_expectations_hold_for_the_copy(name, kwargs):
    assert getattr(EXPECT, name).__globals__["analog"] is analog
    getattr(EXPECT, name)(**kwargs)


# --------------------------------------------------------------------------
# arch_cost: lm100m at full size
# --------------------------------------------------------------------------

DEVICE = dict(analog=True, analog_mode="device")


@pytest.mark.parametrize("mode", ["device", "digital"])
def test_model_projections_of_lm100m_equal_the_reference(mode):
    kw = DEVICE if mode == "device" else {}
    want = J_arch.model_projections(jax_config("lm100m").replace(**kw))
    got = arch_cost.model_projections(get_config("lm100m").replace(**kw))
    assert sorted(dataclasses.astuple(p) for p in got) == sorted(
        dataclasses.astuple(p) for p in want)
    assert len(got) == 4


@pytest.mark.parametrize("bits,ctx_len", [(8, 4096), (4, 256), (2, 2048)])
def test_analyze_arch_of_lm100m_equals_the_reference(bits, ctx_len):
    got = arch_cost.analyze_arch(get_config("lm100m").replace(**DEVICE),
                                 bits=bits, ctx_len=ctx_len)
    want = J_arch.analyze_arch(jax_config("lm100m").replace(**DEVICE),
                               bits=bits, ctx_len=ctx_len)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert arch_cost.serve_energy_per_token(
        get_config("lm100m").replace(**DEVICE), ctx_len, bits) == \
        J_arch.serve_energy_per_token(jax_config("lm100m").replace(**DEVICE),
                                      ctx_len, bits)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_train_step_cost_of_lm100m_equals_the_reference(n_shards):
    got = arch_cost.train_step_cost(get_config("lm100m").replace(**DEVICE),
                                    n_tokens=2048, ctx_len=256,
                                    n_shards=n_shards)
    want = J_arch.train_step_cost(jax_config("lm100m").replace(**DEVICE),
                                  n_tokens=2048, ctx_len=256,
                                  n_shards=n_shards)
    assert got == want


def test_analog_train_step_records_its_cost():
    """``AnalogTrainStep.cost`` after the first call is the reference's
    ``train_step_cost`` of the same step (lm100m smoke, 2 x 8 tokens)."""
    import numpy as np
    import torch

    from repro_torch.train import analog_lm as TA
    cfg = get_config("lm100m", smoke=True).replace(
        dtype="float32", analog_device="taox-nonoise", analog_rows=16,
        analog_cols=16, **DEVICE)
    step = TA.make_analog_sgd_step(cfg, lr=0.1)
    assert step.cost is None
    toks = torch.from_numpy(np.arange(16).reshape(2, 8) % cfg.vocab).long()
    step(TA.init_state(0, cfg, device="cpu"),
         {"tokens": toks, "labels": toks})
    jcfg = jax_config("lm100m", smoke=True).replace(
        dtype="float32", analog_device="taox-nonoise", analog_rows=16,
        analog_cols=16, **DEVICE)
    assert step.cost == J_arch.train_step_cost(jcfg, n_tokens=16, bits=8,
                                               ctx_len=8)
    assert step.cost["pj_per_mac"]["analog"] < \
        step.cost["pj_per_mac"]["sram"]


def test_non_dense_families_raise():
    """Every family's digital-core MACs per token equal the reference's:
    the VLM's and the audio model's (its encoder layers counted with the
    decoder's), MoE's."""
    for arch in ("llama-3.2-vision-90b", "whisper-medium",
                 "llama4-scout-17b-a16e"):
        for ctx_len in (16, 4096):
            assert arch_cost.digital_macs_per_token(
                get_config(arch), ctx_len) == \
                J_arch.digital_macs_per_token(jax_config(arch), ctx_len)
    whisper = get_config("whisper-medium")
    assert arch_cost.digital_macs_per_token(whisper, 16) == \
        (24 + 24) * 2 * 16 * 64 * 16


@pytest.mark.parametrize("mode", ["device", "digital"])
def test_llama4_scout_cost_equals_the_reference(mode):
    """The MoE family's roll-up at full size: each expert stack counted
    layers x experts arrays, active ``top_k / n_experts``; the
    projections, ``analyze_arch``, the energy per token and a training
    step's cost equal the reference's."""
    kw = DEVICE if mode == "device" else {}
    cfg = get_config("llama4-scout-17b-a16e").replace(**kw)
    jcfg = jax_config("llama4-scout-17b-a16e").replace(**kw)
    got = arch_cost.model_projections(cfg)
    assert sorted(dataclasses.astuple(p) for p in got) == sorted(
        dataclasses.astuple(p) for p in J_arch.model_projections(jcfg))
    experts = [p for p in got if "experts" in p.name]
    assert len(experts) == 3 and all(
        p.count == 48 * 16 and p.active == 1 / 16 for p in experts)
    assert dataclasses.asdict(arch_cost.analyze_arch(cfg)) == \
        dataclasses.asdict(J_arch.analyze_arch(jcfg))
    assert arch_cost.serve_energy_per_token(cfg) == \
        J_arch.serve_energy_per_token(jcfg)
    if mode == "device":
        assert arch_cost.train_step_cost(cfg, n_tokens=2048, ctx_len=256) \
            == J_arch.train_step_cost(jcfg, n_tokens=2048, ctx_len=256)


def test_moe_engine_energy_per_token_equals_the_reference():
    """``Engine.energy_per_token`` of a MoE engine (the llama4-scout smoke
    model from crossbars) is the reference's number."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine
    kw = dict(dtype="float32", analog=True, analog_mode="device",
              analog_device="taox-nonoise", analog_rows=16, analog_cols=16)
    cfg = get_config("llama4-scout-17b-a16e", smoke=True).replace(**kw)
    params = M.program_digital(M.init_params(cfg.digital(),
                                             torch.Generator(), "cpu"), cfg)
    engine = make_engine(cfg, params, backend="analog")
    jcfg = jax_config("llama4-scout-17b-a16e", smoke=True).replace(**kw)
    assert engine.energy_per_token() == J_arch.serve_energy_per_token(jcfg)
    assert engine.energy_per_token(256) == \
        J_arch.serve_energy_per_token(jcfg, ctx_len=256)


@pytest.mark.parametrize("mode", ["device", "digital"])
def test_deepseek_v2_lite_cost_equals_the_reference(mode):
    """MLA with 64 experts at top-6 (deepseek-v2-lite-16b at full size):
    ``analyze_arch``, the energy per token at two context lengths and,
    in device mode, a training step's cost equal the reference's."""
    kw = DEVICE if mode == "device" else {}
    cfg = get_config("deepseek-v2-lite-16b").replace(**kw)
    jcfg = jax_config("deepseek-v2-lite-16b").replace(**kw)
    assert dataclasses.asdict(arch_cost.analyze_arch(cfg)) == \
        dataclasses.asdict(J_arch.analyze_arch(jcfg))
    for ctx_len in (4096, 256):
        assert arch_cost.serve_energy_per_token(cfg, ctx_len=ctx_len) == \
            J_arch.serve_energy_per_token(jcfg, ctx_len=ctx_len)
    if mode == "device":
        assert arch_cost.train_step_cost(cfg, n_tokens=2048, ctx_len=256) \
            == J_arch.train_step_cost(jcfg, n_tokens=2048, ctx_len=256)


@pytest.mark.parametrize("mode", ["device", "digital"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_ssm_and_hybrid_cost_equals_the_reference(arch, mode):
    """The SSM and hybrid families at full size: the projections (the
    SSD's in/out projections per layer, the hybrid's shared block applied
    ``n_layers // attn_every`` times a token), ``analyze_arch``, the SSD
    scan's digital MACs, the energy per token at two context lengths
    and, in device mode, a training step's cost equal the reference's."""
    kw = DEVICE if mode == "device" else {}
    cfg = get_config(arch).replace(**kw)
    jcfg = jax_config(arch).replace(**kw)
    got = arch_cost.model_projections(cfg)
    assert sorted(dataclasses.astuple(p) for p in got) == sorted(
        dataclasses.astuple(p) for p in J_arch.model_projections(jcfg))
    assert len(got) == (2 if arch == "mamba2-1.3b" else 7)
    assert dataclasses.asdict(arch_cost.analyze_arch(cfg)) == \
        dataclasses.asdict(J_arch.analyze_arch(jcfg))
    for ctx_len in (4096, 256):
        assert arch_cost.digital_macs_per_token(cfg, ctx_len) == \
            J_arch.digital_macs_per_token(jcfg, ctx_len)
        assert arch_cost.serve_energy_per_token(cfg, ctx_len=ctx_len) == \
            J_arch.serve_energy_per_token(jcfg, ctx_len=ctx_len)
    if mode == "device":
        assert arch_cost.train_step_cost(cfg, n_tokens=2048, ctx_len=256) \
            == J_arch.train_step_cost(jcfg, n_tokens=2048, ctx_len=256)


@pytest.mark.parametrize("mode", ["device", "digital"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-medium"])
def test_cross_attention_cost_equals_the_reference(arch, mode):
    """The cross-attention families at full size: the projections (the
    VLM's 80 self and 20 cross layers, whisper's 24 encoder and 24
    decoder layers, the fused cross ``wqkv`` each), ``analyze_arch``, the
    energy per token at two context lengths and, in device mode, a
    training step's cost equal the reference's."""
    kw = DEVICE if mode == "device" else {}
    cfg = get_config(arch).replace(**kw)
    jcfg = jax_config(arch).replace(**kw)
    got = {p.name: dataclasses.astuple(p)
           for p in arch_cost.model_projections(cfg)}
    want = {p.name: dataclasses.astuple(p)
            for p in J_arch.model_projections(jcfg)}
    assert got == want
    if arch == "whisper-medium":
        assert len(got) == 10
        assert got["enc_layers/attn/wqkv"][1:] == (1024, 3072, 24, 1.0)
        assert got["dec_layers/xattn/wqkv"][1:] == (1024, 3072, 24, 1.0)
    else:
        assert len(got) == 8
        assert got["self_layers/attn/wqkv"][1:] == (8192, 10240, 80, 1.0)
        assert got["cross_layers/xattn/wqkv"][1:] == (8192, 10240, 20, 1.0)
    assert dataclasses.asdict(arch_cost.analyze_arch(cfg)) == \
        dataclasses.asdict(J_arch.analyze_arch(jcfg))
    for ctx_len in (4096, 256):
        assert arch_cost.serve_energy_per_token(cfg, ctx_len=ctx_len) == \
            J_arch.serve_energy_per_token(jcfg, ctx_len=ctx_len)
    if mode == "device":
        assert arch_cost.train_step_cost(cfg, n_tokens=2048, ctx_len=256) \
            == J_arch.train_step_cost(jcfg, n_tokens=2048, ctx_len=256)
