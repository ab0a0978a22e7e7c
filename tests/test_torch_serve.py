"""The port's serving slice against the JAX package, end to end, on the
lm100m smoke model.

The JAX package initialises and programs the model (``taox-nonoise``,
16x16 tiles so every read spans several tiles, 8-bit DAC/ADC, dynamic
ADC range); ``params_from_numpy`` carries the tree across, and both
packages run it on the CPU.

The fakequant model (``analog_mode="fakequant"``, 16-row tiles, 8-bit
DAC/ADC) serves the same digital weights through the fakequant
projection: on the CPU the port's plain path, against the reference's jnp
path and its interpret-mode Pallas kernel (``read_impl``).

Tolerances:
  * logits vs the reference evaluated op by op (``jax.disable_jit``):
    atol 1e-5 — the same float32 operations, summed in other orders (for
    the fakequant model no 8-bit ADC code of these inputs sits close
    enough to a rounding boundary to flip);
  * logits vs the reference's jitted forward: XLA compiles the scanned
    block into another float32 program, which on this model moves the
    analog logits by up to ~7e-2 from the reference's own op-by-op
    result (8-bit ADC codes flip with it).  The port must be no farther
    from the jitted reference than the reference's op-by-op result is;
  * greedy tokens: identical to the reference engines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serve import SamplingParams as JaxSampling
from repro.serve import make_engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as M
from repro_torch.serve import SamplingParams, make_engine, make_serve_state

DEVICE_MODE = dict(dtype="float32", analog=True, analog_mode="device",
                   analog_device="taox-nonoise", analog_rows=16,
                   analog_cols=16)
J_ACFG = jax_config("lm100m", smoke=True).replace(**DEVICE_MODE)
J_DCFG = jax_config("lm100m", smoke=True)          # bf16 digital serving
ACFG = get_config("lm100m", smoke=True).replace(**DEVICE_MODE)
DCFG = get_config("lm100m", smoke=True)
FAKEQUANT = dict(dtype="float32", analog=True, analog_mode="fakequant",
                 analog_rows=16)
J_FCFG = jax_config("lm100m", smoke=True).replace(**FAKEQUANT)
FCFG = get_config("lm100m", smoke=True).replace(**FAKEQUANT)

J_PARAMS = JM.init_params(jax.random.PRNGKey(0), J_ACFG.digital())
J_APARAMS = JM.program_digital(J_PARAMS, J_ACFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


PARAMS = params_from_numpy(_np(J_PARAMS), "cpu")
APARAMS = params_from_numpy(_np(J_APARAMS), "cpu")

_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, DCFG.vocab, (2, 8)).astype(np.int32)
PROMPTS = [[int(t) for t in _rng.integers(0, DCFG.vocab, n)]
           for n in (6, 3, 9)]
CASES = {"analog": (J_ACFG, J_APARAMS, ACFG, APARAMS),
         "digital": (J_DCFG, J_PARAMS, DCFG, PARAMS),
         "digital_f32": (J_ACFG.digital(), J_PARAMS, ACFG.digital(), PARAMS),
         "fakequant": (J_FCFG, J_PARAMS, FCFG, PARAMS)}


def _port_logits(params, cfg, tokens):
    with torch.no_grad():
        return M.forward(params, {"tokens": torch.from_numpy(tokens).long()},
                         cfg)[0].numpy()


NEXT = np.array([5, 7], np.int32)


@pytest.fixture(scope="module")
def op_by_op():
    """The reference's full-sequence logits of a prefill into a cache,
    then two decode steps appending to it.  The analog model runs op by
    op; the float32 digital model's compiled program already agrees with
    its op-by-op result to float32 rounding, so it runs as compiled."""
    out = {}
    for case in ("analog", "digital_f32", "fakequant"):
        jcfg, jp, _, _ = CASES[case]
        with jax.disable_jit(case != "digital_f32"):
            cache = JM.init_cache(jcfg, TOKENS.shape[0], 32)
            logits, caches, _, _ = JM.forward(
                jp, {"tokens": jnp.asarray(TOKENS)}, jcfg, caches=cache[0])
            steps, cache = [], (caches, None)
            for t in (NEXT, NEXT + 1):
                d, cache = JM.decode_step(jp, cache, jnp.asarray(t), jcfg)
                steps.append(np.asarray(d))
        out[case] = (np.asarray(logits), steps)
    return out


@pytest.mark.parametrize("case", ["analog", "digital_f32", "fakequant"])
def test_forward_logits_match_reference_op_by_op(case, op_by_op):
    _, _, cfg, p = CASES[case]
    np.testing.assert_allclose(_port_logits(p, cfg, TOKENS),
                               op_by_op[case][0], rtol=1e-5, atol=1e-5)


def test_forward_logits_vs_jitted_reference(op_by_op):
    jcfg, jp, cfg, p = CASES["analog"]
    jitted = np.asarray(JM.forward(jp, {"tokens": jnp.asarray(TOKENS)},
                                   jcfg)[0])
    spread = np.abs(op_by_op["analog"][0] - jitted).max()
    got = np.abs(_port_logits(p, cfg, TOKENS) - jitted).max()
    assert got <= spread + 1e-5, (got, spread)


def test_digital_bf16_logits_close():
    """bf16 activations round at other places in the two frameworks:
    within a few bf16 ulp of the logit scale."""
    jcfg, jp, cfg, p = CASES["digital"]
    want = np.asarray(JM.forward(jp, {"tokens": jnp.asarray(TOKENS)},
                                 jcfg)[0])
    np.testing.assert_allclose(_port_logits(p, cfg, TOKENS), want,
                               atol=0.05)


@pytest.mark.parametrize("case", ["analog", "digital_f32", "fakequant"])
def test_prefill_and_decode_match_reference_op_by_op(case, op_by_op):
    """The cached path: prefill, then decode steps appending to the cache
    at each row's length."""
    _, _, cfg, p = CASES[case]
    logits, steps = op_by_op[case]
    with torch.no_grad():
        last, cache = M.prefill(
            p, {"tokens": torch.from_numpy(TOKENS).long()}, cfg, max_len=32)
        got = []
        for t in (NEXT, NEXT + 1):
            d, cache = M.decode_step(p, cache, torch.from_numpy(t).long(),
                                     cfg)
            got.append(d.numpy())
    np.testing.assert_allclose(last.numpy(), logits[:, -1], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(steps, got):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    assert M.cache_lens(cache, cfg).tolist() == [10, 10]


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
@pytest.mark.parametrize("backend", ["analog", "digital"])
def test_greedy_tokens_match_reference_engines(backend, scheduler):
    """Two slots for three ragged prompts: a request queues, chunked
    prefill spans several chunks, slots are evicted and reused."""
    jcfg, jp, cfg, p = CASES[backend]
    kw = dict(backend=backend, scheduler=scheduler, max_len=32,
              prefill_chunk=4, n_slots=2)
    want = jax_engine(jcfg, jp, **kw).generate(
        PROMPTS, JaxSampling(max_new_tokens=6))
    got = make_engine(cfg, p, **kw).generate(
        PROMPTS, SamplingParams(max_new_tokens=6))
    assert got == want
    assert [len(o) for o in got] == [6, 6, 6]


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
@pytest.mark.parametrize("read_impl", ["auto", "interpret"])
def test_fakequant_greedy_tokens_match_reference_engines(read_impl,
                                                         scheduler):
    """The fakequant model served from its digital tree: the reference
    engine through its jnp path (``auto`` on the CPU) and through the
    interpret-mode Pallas kernel give the port's greedy tokens."""
    kw = dict(scheduler=scheduler, max_len=32, prefill_chunk=4, n_slots=2)
    want = jax_engine(J_FCFG, J_PARAMS, read_impl=read_impl, **kw).generate(
        PROMPTS, JaxSampling(max_new_tokens=6))
    eng = make_engine(FCFG, PARAMS, **kw)
    assert eng.backend == "digital"
    got = eng.generate(PROMPTS, SamplingParams(max_new_tokens=6))
    assert got == want
    assert [len(o) for o in got] == [6, 6, 6]


def test_fakequant_config_and_tree():
    """A fakequant config resolves like the reference's, initialises and
    converts to a digital ``{"w"}`` tree, and serves it on the digital
    backend."""
    from repro_torch.configs import AnalogMode
    assert FCFG.resolved_analog_mode is AnalogMode.FAKEQUANT
    assert get_config("lm100m").replace(analog=True).analog_mode == \
        "fakequant" == J_FCFG.analog_mode
    for field in ("analog_in_bits", "analog_out_bits", "analog_rows",
                  "analog_sat_sigmas"):
        assert getattr(FCFG, field) == getattr(J_FCFG, field)
    tree = M.init_params(FCFG, 0, device="cpu")
    wqkv = tree["layers"]["attn"]["wqkv"]
    assert set(wqkv) == {"w"} and wqkv["w"].shape == (2, 64, 192)
    assert make_serve_state(FCFG, PARAMS).backend == "digital"
    assert make_serve_state(FCFG, tree, backend="digital").backend == \
        "digital"
    with pytest.raises(ValueError, match="programmed"):
        make_serve_state(FCFG, PARAMS, backend="analog")


def test_fakequant_bf16_rounds_weights_first():
    """At bfloat16 the weights round to bfloat16 before the fake quant,
    and the projection returns bfloat16 (the reference's casts): exactly
    the float32 projection of the bfloat16-rounded operands, and within
    1e-2 of the reference (outputs of order 1, whose bfloat16 rounding is
    2^-8 relative and may go either way in the two frameworks)."""
    from repro.models.layers import project as jax_project
    from repro_torch.models.layers import project
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    jcfg, cfg = (c.replace(dtype="bfloat16") for c in (J_FCFG, FCFG))
    want = jax_project({"w": jnp.asarray(w)},
                       jnp.asarray(x, jnp.bfloat16), jcfg)
    got = project({"w": torch.from_numpy(w)},
                  torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels.ops import fakequant_project
    by_hand = fakequant_project(
        torch.from_numpy(x).to(torch.bfloat16).float(),
        torch.from_numpy(w).to(torch.bfloat16).float(), AdcConfig(),
        cfg.analog_rows).to(torch.bfloat16)
    torch.testing.assert_close(got, by_hand, rtol=0, atol=0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_continuous_engine_counts_model_calls():
    eng = make_engine(ACFG, APARAMS, max_len=32, prefill_chunk=4,
                      n_slots=2)
    eng.generate(PROMPTS, SamplingParams(max_new_tokens=6))
    m = eng.metrics
    # 9-token prompt: 3 chunks; 6- and 3-token prompts: 2 and 1
    assert m["prefill_chunks"] == 6
    assert m["admitted"] == m["evicted"] == 3


def test_program_digital_matches_reference():
    ported = M.program_digital(PARAMS, ACFG)
    want = params_from_numpy(_np(J_APARAMS), "cpu")
    for path in [("attn", "wqkv"), ("attn", "wo"), ("ffn", "w_upgate"),
                 ("ffn", "w_down")]:
        a, b = ported["layers"], want["layers"]
        for k in path:
            a, b = a[k], b[k]
        assert set(a) == {"g", "ref", "w_scale"}
        for leaf in ("g", "ref", "w_scale"):
            torch.testing.assert_close(a[leaf], b[leaf], rtol=1e-6,
                                       atol=1e-6)
    back = M.readout_digital(ported, ACFG)
    torch.testing.assert_close(back["layers"]["ffn"]["w_down"]["w"],
                               PARAMS["layers"]["ffn"]["w_down"]["w"],
                               rtol=1e-5, atol=1e-6)


def test_serve_state_validates_backend():
    assert make_serve_state(ACFG, APARAMS).backend == "analog"
    assert make_serve_state(DCFG, PARAMS).backend == "digital"
    with pytest.raises(ValueError, match="containers"):
        make_serve_state(DCFG, APARAMS, backend="digital")
    with pytest.raises(ValueError, match="programmed"):
        make_serve_state(ACFG, PARAMS, backend="analog")
    with pytest.raises(ValueError, match="device-mode"):
        make_serve_state(DCFG, APARAMS)
    st = make_serve_state(ACFG, APARAMS)
    assert make_serve_state(ACFG, st) is st
    with pytest.raises(ValueError):
        make_serve_state(ACFG, st, backend="digital")


def test_maintenance_is_not_ported_yet():
    """The maintenance runtime is ported: the analog engine has one and
    its calls work; a digital engine raises ``ValueError``, as the
    reference's does (``tests/test_torch_serve_analog.py`` holds the
    runtime against the reference)."""
    eng = make_engine(ACFG, params_from_numpy(_np(J_APARAMS), "cpu"),
                      max_len=32)
    assert eng.maintenance is not None
    eng.advance_clock(60.0)
    eng.start_recalibration()
    eng.run_maintenance()
    assert eng.maintenance.recal_pending == 0
    assert eng.maintenance.metrics["drift_applications"] == 1
    dig = make_engine(DCFG, PARAMS, max_len=32)
    assert dig.maintenance is None
    for call in (lambda: dig.advance_clock(60.0), dig.start_recalibration,
                 dig.run_maintenance):
        with pytest.raises(ValueError, match="analog"):
            call()


def test_params_from_numpy_keeps_structure():
    tree = _np(J_APARAMS)
    got = params_from_numpy(tree, "cpu")
    wqkv = got["layers"]["attn"]["wqkv"]
    assert wqkv["g"].shape == (2, 64, 192) and wqkv["w_scale"].shape == (2,)
    assert wqkv["g"].dtype == torch.float32
    np.testing.assert_array_equal(wqkv["g"].numpy(),
                                  tree["layers"]["attn"]["wqkv"]["g"])
    with pytest.raises(TypeError):
        params_from_numpy({"x": np.array(["a"])}, "cpu")


def test_temperature_sampling_is_seeded():
    """Temperature sampling draws from the engine's torch.Generator: the
    same seed replays the same tokens (not the reference's draws)."""
    eng = make_engine(ACFG, APARAMS, max_len=32, prefill_chunk=4, n_slots=2)
    sp = SamplingParams(temperature=1.0, max_new_tokens=6)
    a = eng.generate(PROMPTS, sp, seed=3)
    b = eng.generate(PROMPTS, sp, seed=3)
    assert a == b
    assert all(0 <= t < ACFG.vocab for o in a for t in o)
    assert a != eng.generate(PROMPTS, SamplingParams(max_new_tokens=6))


def test_greedy_takes_the_first_maximum():
    """Ties go to the lowest index, as jnp.argmax does."""
    from repro_torch.serve.engine import _sample
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    got = _sample(logits, torch.Generator(), np.zeros(2, np.float32))
    assert got.tolist() == [1, 0]
    want = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1))
    assert got.tolist() == want.tolist()
