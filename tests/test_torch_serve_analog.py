"""The port's analog serving lifetime against the JAX package: retention
physics (``core.endurance``), the maintenance runtime
(``serve.state.AnalogServeRuntime``: drift, read disturb, recalibration),
the engine's maintenance surface, checkpoints in both directions and the
endurance arithmetic.

The model is the lm100m smoke config on a nonoise device with 14-bit I/O
and 64x64 tiles, as ``tests/test_serve_analog.py`` runs it: there greedy
decode from the crossbars reproduces the digital tokens, so drift-induced
token flips and their repair are unambiguous.  The reference programs the
weights (``PRNGKey(0)``) and ``params_from_numpy`` carries them across;
every engine gets a fresh copy, because maintenance rewrites the
containers in place.

Tolerances:
  * drift factors and drifted conductances: 1e-6 relative (float32 pow
    in two libraries, within a few ulp);
  * the exponent fields (``cell_nu``) come from different PRNGs, so the
    comparisons with the reference feed the reference's fields into the
    port (``nu=``, or ``endurance.cell_nu`` replaced by a lookup of the
    reference's whole-container field);
  * recalibration pulses: 1e-5 relative (float32 sums in other orders);
  * tokens: identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import TAOX as J_TAOX
from repro.core import endurance as JE
from repro.hwmodel import arch_cost as J_arch
from repro.models import model as JM
from repro.serve import SamplingParams as JSampling
from repro.serve import make_engine as jax_engine
from repro.serve import state as JS
from repro.train import checkpoint as J_ckpt
from repro.train.analog_lm import init_state as j_init_state
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import TAOX
from repro_torch.core import endurance as E
from repro_torch.hwmodel import arch_cost
from repro_torch.hwmodel.params import TABLE_I
from repro_torch.serve import (SamplingParams, make_engine,
                               make_serve_state)
from repro_torch.serve import state as S
from repro_torch.train import checkpoint

MODE = dict(dtype="float32", analog=True, analog_mode="device",
            analog_device="taox-nonoise", analog_rows=64, analog_cols=64,
            analog_in_bits=14, analog_out_bits=14, analog_sat_sigmas=8.0)
J_ACFG = jax_config("lm100m", smoke=True).replace(**MODE)
ACFG = get_config("lm100m", smoke=True).replace(**MODE)
DCFG = ACFG.digital()

J_PARAMS = JM.init_params(jax.random.PRNGKey(0), J_ACFG.digital())
J_APARAMS = JM.program_digital(J_PARAMS, J_ACFG)

PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8]]
SP = SamplingParams(max_new_tokens=8)
DRIFT = E.RetentionSpec(nu=0.05, nu_sigma=0.5)
J_DRIFT = JE.RetentionSpec(nu=0.05, nu_sigma=0.5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _aparams():
    """A fresh port copy of the reference's programmed tree."""
    return params_from_numpy(_np(J_APARAMS), "cpu")


def _analog_engine(retention=None, n_slots=2):
    return make_engine(ACFG, _aparams(), max_len=64, n_slots=n_slots,
                       prefill_chunk=4, retention=retention)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def reference_tokens():
    return jax_engine(J_ACFG, J_APARAMS, max_len=64, n_slots=2,
                      prefill_chunk=4).generate(
        PROMPTS, JSampling(max_new_tokens=8))


# ------------------------------------------------------------- retention

@pytest.mark.parametrize("a0,a1", [(0.0, 60.0), (0.0, 86400.0),
                                   (3600.0, 3 * 86400.0), (-5.0, 10.0),
                                   (7200.0, 100.0)])
def test_drift_factor_matches_reference(a0, a1):
    """Scalar exponent and the reference's per-cell field, fed in."""
    spec, jspec = DRIFT, J_DRIFT
    np.testing.assert_allclose(
        E.drift_factor(a0, a1, spec).numpy(),
        np.asarray(JE.drift_factor(a0, a1, jspec)), rtol=1e-6)
    nu = np.array(JE.cell_nu(jspec, (8, 8), salt=17))
    np.testing.assert_allclose(
        E.drift_factor(a0, a1, spec, torch.from_numpy(nu)).numpy(),
        np.asarray(JE.drift_factor(a0, a1, jspec, jnp.asarray(nu))),
        rtol=1e-6)


def test_drift_factor_monotone_and_composable():
    ts = [0.0, 60.0, 3600.0, 86400.0, 7 * 86400.0]
    fs = [float(E.drift_factor(0.0, t, DRIFT)) for t in ts]
    assert fs[0] == 1.0
    assert all(a >= b for a, b in zip(fs, fs[1:]))
    assert all(0.0 < f <= 1.0 for f in fs)
    nu = E.cell_nu(DRIFT, (8, 8), salt=17)
    f_split = E.drift_factor(0.0, 3600.0, DRIFT, nu) \
        * E.drift_factor(3600.0, 86400.0, DRIFT, nu)
    f_span = E.drift_factor(0.0, 86400.0, DRIFT, nu)
    np.testing.assert_allclose(f_split.numpy(), f_span.numpy(), rtol=1e-6)


def test_cell_nu_is_a_fixed_device_property():
    """A pure function of (seed, salt, cell index): repeatable, salted,
    non-negative, any block equal to the same block of the whole field,
    and distributed as nu * max(0, 1 + nu_sigma z) with z standard
    normal."""
    a = E.cell_nu(DRIFT, (4, 4), salt=3)
    np.testing.assert_array_equal(a, E.cell_nu(DRIFT, (4, 4), salt=3))
    assert not torch.equal(a, E.cell_nu(DRIFT, (4, 4), salt=4))
    assert not torch.equal(a, E.cell_nu(dataclasses.replace(DRIFT, seed=1),
                                        (4, 4), salt=3))
    whole = E.cell_nu(DRIFT, (3, 5, 7), salt=11)
    assert float(whole.min()) >= 0.0
    for i in range(3):      # odd offsets split a Box-Muller pair
        np.testing.assert_array_equal(
            E.cell_nu(DRIFT, (5, 7), salt=11, offset=35 * i), whole[i])
    z = E.cell_normals(0, 0, 1 << 18)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01


def test_read_disturb_matches_reference():
    spec = E.RetentionSpec(nu=0.0, nu_sigma=0.0, read_disturb=1e-3)
    jspec = JE.RetentionSpec(nu=0.0, nu_sigma=0.0, read_disturb=1e-3)
    n = 137
    assert float(E.read_disturb_factor(n, spec)) \
        == pytest.approx((1.0 - 1e-3) ** n, rel=1e-6)
    g = np.random.default_rng(0).uniform(1.0, 2.0, (6, 6)).astype(np.float32)
    ref = np.full((6, 6), 1.5, np.float32)
    g2, r2 = E.apply_retention(torch.from_numpy(g), torch.from_numpy(ref),
                               0.0, 3600.0, n, spec, g_floor=0.5)
    jg2, jr2 = JE.apply_retention(jnp.asarray(g), jnp.asarray(ref), 0.0,
                                  3600.0, n, jspec, g_floor=0.5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg2), rtol=1e-6)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), rtol=1e-6)
    f = (1.0 - 1e-3) ** n
    np.testing.assert_allclose(g2.numpy(), 0.5 + (g - 0.5) * f, rtol=1e-5)


def test_dispersion_matches_reference_with_its_fields():
    """With the reference's exponent fields fed in, the port's drifted
    block equals the reference's; with a common exponent the differential
    only shrinks, with dispersion it spreads (the accuracy mechanism)."""
    g = np.random.default_rng(1).uniform(0.2, 0.9, (8, 8)).astype(np.float32)
    ref = np.full((8, 8), 0.5, np.float32)
    disp, jdisp = (E.RetentionSpec(nu=0.1, nu_sigma=0.5),
                   JE.RetentionSpec(nu=0.1, nu_sigma=0.5))
    nu = tuple(torch.from_numpy(np.asarray(JE.cell_nu(jdisp, (8, 8), s)))
               for s in (5, 5 ^ 0x5EED))
    g3, r3 = E.apply_retention(torch.from_numpy(g), torch.from_numpy(ref),
                               0.0, 86400.0, 3, disp, nu=nu)
    jg3, jr3 = JE.apply_retention(jnp.asarray(g), jnp.asarray(ref), 0.0,
                                  86400.0, 3, jdisp, salt=5)
    np.testing.assert_allclose(g3.numpy(), np.asarray(jg3), rtol=1e-6)
    np.testing.assert_allclose(r3.numpy(), np.asarray(jr3), rtol=1e-6)
    common = E.RetentionSpec(nu=0.1, nu_sigma=0.0)
    g2, r2 = E.apply_retention(torch.from_numpy(g), torch.from_numpy(ref),
                               0.0, 86400.0, 0, common)
    f = float(E.drift_factor(0.0, 86400.0, common))
    np.testing.assert_allclose((g2 - r2).numpy(), (g - ref) * f, rtol=1e-5)
    own = E.apply_retention(torch.full((8, 8), 2.0), torch.full((8, 8), 1.9),
                            0.0, 86400.0, 0, disp, salt=5)
    unif = E.apply_retention(torch.full((8, 8), 2.0),
                             torch.full((8, 8), 1.9), 0.0, 86400.0, 0, common)
    assert float((own[0] - own[1]).std()) \
        > 10 * float((unif[0] - unif[1]).std())


# --------------------------------------------------------------- runtime

def _reference_fields(monkeypatch, jspec, jparams):
    """Route the port's ``cell_nu`` to the reference's whole-container
    fields: a block at ``offset`` of a container with salt ``salt`` gets
    the same cells of the reference's field of that container."""
    import zlib
    fields = {}
    for p in JS.container_paths(jparams):
        salt = zlib.crc32("/".join(p).encode())
        cont = _get(jparams, p)
        for s, leaf in ((salt, "g"), (salt ^ 0x5EED, "ref")):
            fields[s] = np.asarray(JE.cell_nu(jspec, cont[leaf].shape, s))

    def cell_nu(spec, shape, salt=0, device=None, offset=0):
        n = int(np.prod(shape))
        flat = fields[salt].reshape(-1)[offset:offset + n]
        return torch.from_numpy(flat.reshape(shape).copy()).to(device)
    monkeypatch.setattr(E, "cell_nu", cell_nu)


@pytest.mark.parametrize("dispersed", [False, True])
def test_runtime_drift_and_recal_match_reference(dispersed, monkeypatch):
    """Two drift applications with reads between them, then a sweep: the
    port's in-place, block-by-block runtime against the reference's
    jitted tree update, container by container; the sweep restores
    ``g_target`` bit for bit and bills the reference's pulses."""
    kw = dict(nu=0.05, nu_sigma=0.5 if dispersed else 0.0,
              read_disturb=1e-4)
    spec, jspec = E.RetentionSpec(**kw), JE.RetentionSpec(**kw)
    if dispersed:
        _reference_fields(monkeypatch, jspec, J_APARAMS)
    jst = JS.make_serve_state(J_ACFG, J_APARAMS, retention=jspec)
    st = S.make_serve_state(ACFG, _aparams(), retention=spec)
    jrt, rt = JS.AnalogServeRuntime(jst, J_ACFG), S.AnalogServeRuntime(st,
                                                                     ACFG)
    for r in (jrt, rt):
        r.note_reads(5)
        r.advance_clock(86400.0)
        r.tick()
        r.note_reads(2)
        r.advance_clock(2 * 86400.0)
    assert rt.pending_drift_s == jrt.pending_drift_s == 2 * 86400.0
    jparams, params = jrt.tick(), rt.tick()
    assert st.paths == jst.paths and len(st.paths) == 4
    for p in st.paths:
        for leaf in ("g", "ref"):
            np.testing.assert_allclose(_get(params, p)[leaf].numpy(),
                                       np.asarray(_get(jparams, p)[leaf]),
                                       rtol=1e-6, err_msg=f"{p} {leaf}")
        assert st.age_s[p] == jst.age_s[p] == 3 * 86400.0
        assert st.reads[p] == jst.reads[p] == 7
        assert st.reads_unapplied[p] == jst.reads_unapplied[p] == 0
    assert rt.metrics == jrt.metrics
    for r in (jrt, rt):
        r.schedule_recalibration()
        while r.recal_pending:
            r.tick()
    for p in st.paths:
        for leaf in ("g", "ref"):
            assert torch.equal(_get(params, p)[leaf], st.g_target[p][leaf])
        assert st.pulses[p] == pytest.approx(jst.pulses[p], rel=1e-5)
        assert st.pulses[p] > 0 and st.age_s[p] == 0.0
    assert rt.metrics["recal_pulses"] == pytest.approx(
        jrt.metrics["recal_pulses"], rel=1e-5)


def test_block_drift_equals_whole_container_drift():
    """The runtime's block-by-block drift of a stacked (L, K, N)
    container equals one ``apply_retention`` of the whole container with
    the port's own fields, bit for bit."""
    import zlib
    st = S.make_serve_state(ACFG, _aparams(), retention=DRIFT)
    rt = S.AnalogServeRuntime(st, ACFG)
    path = ("layers", "ffn", "w_upgate")
    rt.drift_container(path, 0.0, 3 * 86400.0, 4)
    cont = st.g_target[path]
    want = E.apply_retention(cont["g"], cont["ref"], 0.0, 3 * 86400.0, 4,
                             DRIFT, salt=zlib.crc32("/".join(path).encode()))
    got = _get(st.params, path)
    assert torch.equal(got["g"], want[0]) and torch.equal(got["ref"], want[1])


def test_make_serve_state_infers_and_validates():
    aparams = _aparams()
    st = make_serve_state(ACFG, aparams)
    assert st.is_analog and len(st.paths) > 0
    assert set(st.g_target) == set(st.paths)
    jst = JS.make_serve_state(J_ACFG, J_APARAMS)
    for p in st.paths:
        for leaf in ("g", "ref"):
            np.testing.assert_array_equal(st.g_target[p][leaf].numpy(),
                                          np.asarray(jst.g_target[p][leaf]))
            assert st.g_target[p][leaf].data_ptr() \
                != _get(aparams, p)[leaf].data_ptr()
    assert isinstance(st.retention, E.RetentionSpec)
    with pytest.raises(ValueError):
        make_serve_state(DCFG, aparams)
    assert make_serve_state(ACFG, st) is st


# ------------------------------------------------------------ decode parity

def test_analog_nonoise_decode_matches_reference(reference_tokens):
    """Greedy decode from the crossbars: the reference engine's tokens,
    and every container read once per model call."""
    eng = _analog_engine()
    assert eng.generate(PROMPTS, SP) == reference_tokens
    m = eng.metrics
    expect = m["prefill_chunks"] + m["decode_steps"]
    assert expect > 0
    assert all(eng.state.reads[p] == expect for p in eng.state.paths)


def test_drift_degrades_and_recal_restores_parity(reference_tokens):
    """Multi-day drift flips greedy tokens; a recalibration sweep restores
    the reference's tokens exactly, resets the device age and bills the
    reprogramming pulses."""
    eng = _analog_engine(retention=DRIFT)
    base = eng.generate(PROMPTS, SP)
    assert base == reference_tokens
    eng.advance_clock(3 * 86400.0)
    degraded = eng.generate(PROMPTS, SP)
    assert degraded != base
    assert eng.maintenance.metrics["drift_applications"] == 1
    eng.start_recalibration()
    eng.run_maintenance()
    assert eng.maintenance.recal_pending == 0
    assert eng.generate(PROMPTS, SP) == base
    st = eng.state
    assert all(st.pulses[p] > 0 for p in st.paths)
    assert all(st.age_s[p] == 0.0 for p in st.paths)


def test_recal_drains_during_serving_without_stalling_decode():
    """A sweep scheduled while a request decodes drains one container per
    tick through the prefill lane; the request keeps decoding every tick
    and completes with its full token budget."""
    eng = _analog_engine(retention=DRIFT)
    core = eng.stream
    rid = eng.submit(PROMPTS[0], SamplingParams(max_new_tokens=24))
    while rid not in core.completed and not core.metrics["decode_steps"]:
        eng.step()
    eng.advance_clock(3 * 86400.0)
    eng.start_recalibration()
    n_paths = len(eng.state.paths)
    assert eng.maintenance.recal_pending == n_paths
    steps0 = core.metrics["decode_steps"]
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
    assert eng.maintenance.recal_pending == 0
    assert core.metrics["recal_ticks"] == n_paths
    assert core.metrics["decode_steps"] - steps0 == ticks
    assert len(core.completed[rid]) == 24
    assert eng.maintenance.metrics["recal_containers"] == n_paths


def test_scheduled_recal_fires_on_retention_interval():
    spec = dataclasses.replace(DRIFT, recal_interval_s=86400.0)
    eng = _analog_engine(retention=spec)
    eng.advance_clock(2 * 86400.0)
    assert eng.maintenance.metrics["recal_sweeps"] == 1
    assert eng.maintenance.recal_pending == len(eng.state.paths)


def test_static_scheduler_counts_reads_and_drains_drift():
    eng = make_engine(ACFG, _aparams(), scheduler="static", max_len=64,
                      retention=DRIFT)
    eng.advance_clock(60.0)
    out = eng.generate(PROMPTS, SamplingParams(max_new_tokens=3))
    assert len(out) == 2 and eng.maintenance.pending_drift_s == 0.0
    assert all(eng.state.reads[p] == 3 for p in eng.state.paths)


def test_maintenance_raises_on_a_digital_engine():
    eng = make_engine(DCFG, params_from_numpy(_np(J_PARAMS), "cpu"),
                      max_len=64)
    assert eng.maintenance is None
    for call in (lambda: eng.advance_clock(60.0), eng.start_recalibration,
                 eng.run_maintenance):
        with pytest.raises(ValueError, match="analog"):
            call()


# --------------------------------------------------------- checkpoint i/o

def test_to_serve_state_unwraps_train_state():
    from repro_torch.core.tiled_analog import make_tapes
    aparams = _aparams()
    wqkv = aparams["layers"]["attn"]["wqkv"]
    aparams["layers"]["attn"]["wqkv"] = {**wqkv, **make_tapes(wqkv, 4)}
    state = {"params": aparams, "step": torch.zeros((), dtype=torch.int32)}
    st = checkpoint.to_serve_state(state, ACFG)
    assert st.is_analog and len(st.paths) == 4
    assert "x_tape" not in st.params["layers"]["attn"]["wqkv"]
    assert checkpoint.to_serve_state(
        params_from_numpy(_np(J_PARAMS), "cpu"), DCFG).backend == "digital"


def test_from_checkpoint_serves_identically(tmp_path, reference_tokens):
    """Conductances written by the port's checkpointer restore into a
    ServeState whose engine emits the live tree's tokens; keep-N keeps
    the newest steps."""
    state = {"params": _aparams(), "step": torch.tensor(3, dtype=torch.int32)}
    for step in (1, 2, 3):
        checkpoint.save(tmp_path, state, step=step, keep_n=2)
    assert checkpoint.committed_steps(tmp_path) == [2, 3]
    assert checkpoint.latest_step(tmp_path) == 3
    st = checkpoint.from_checkpoint(tmp_path, ACFG, device="cpu")
    assert st.is_analog
    got = make_engine(ACFG, st, max_len=64, n_slots=2,
                      prefill_chunk=4).generate(PROMPTS, SP)
    assert got == reference_tokens


def test_reference_checkpoint_restores_into_the_port(tmp_path,
                                                     reference_tokens):
    """A checkpoint written by ``repro.train.checkpoint.save`` restores
    leaf for leaf into the port and serves the reference's tokens."""
    jstate = {"params": J_APARAMS, "step": jnp.int32(7)}
    J_ckpt.save(tmp_path, jstate, step=7)
    st = checkpoint.from_checkpoint(tmp_path, ACFG, device="cpu")
    for p in st.paths:
        for leaf in ("g", "ref", "w_scale"):
            np.testing.assert_array_equal(
                _get(st.params, p)[leaf].numpy(),
                np.asarray(_get(J_APARAMS, p)[leaf]))
    like = j_init_state(jax.random.PRNGKey(0), J_ACFG)
    restored = checkpoint.restore(tmp_path, params_from_numpy(_np(like),
                                                              "cpu"))
    assert int(restored["step"]) == 7
    got = make_engine(ACFG, st, max_len=64, n_slots=2,
                      prefill_chunk=4).generate(PROMPTS, SP)
    assert got == reference_tokens


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The reverse: the port's save, the reference's restore by its own
    template, every leaf equal; the layout files are the reference's."""
    state = {"params": _aparams(), "step": torch.tensor(5, dtype=torch.int32)}
    final = checkpoint.save(tmp_path, state, step=5)
    assert final.name == "step_00000005"
    assert (tmp_path / "step_00000005.COMMITTED").exists()
    assert (final / "meta.json").exists()
    like = jax.eval_shape(lambda: j_init_state(jax.random.PRNGKey(0),
                                               J_ACFG))
    got = J_ckpt.restore(tmp_path, like)
    assert int(got["step"]) == 5
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat) == 3 * 4 + 4 + 1  # 4 containers, embed, 3 norms, step
    for path, leaf in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        np.testing.assert_array_equal(np.asarray(leaf),
                                      _get(state, keys).numpy())


# ----------------------------------------------------------------- energy

@pytest.mark.parametrize("arch", ["gemma-2b", "stablelm-3b", "starcoder2-3b",
                                  "granite-20b", "lm100m"])
def test_energy_per_token_matches_reference(arch):
    want = J_arch.serve_energy_per_token(jax_config(arch))
    got = arch_cost.serve_energy_per_token(get_config(arch))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_engine_energy_per_token_matches_reference():
    jeng = jax_engine(J_ACFG, J_APARAMS, max_len=64)
    eng = _analog_engine()
    for ctx in (512, 4096):
        assert eng.energy_per_token(ctx) == pytest.approx(
            jeng.energy_per_token(ctx), rel=1e-12)


# -------------------------------------------------------------- endurance

def test_paper_endurance_numbers():
    assert E.pulses_required(E.EnduranceSpec(), worst_case=True) \
        == pytest.approx(8e14, rel=0.05)
    assert E.pulses_required(E.EnduranceSpec()) == pytest.approx(4e13,
                                                                 rel=0.05)
    for worst in (False, True):
        assert E.pulses_required(E.EnduranceSpec(), worst) \
            == JE.pulses_required(JE.EnduranceSpec(), worst)


def test_endurance_gap_matches_paper_conclusion():
    assert E.demonstrated_nudges(1e12) == 2e12
    assert E.endurance_margin(memory_cycles=1e12) < 1.0
    assert E.endurance_margin(memory_cycles=2.5e13) > 1.0
    assert E.endurance_margin(memory_cycles=3e12) \
        == JE.endurance_margin(memory_cycles=3e12)


def test_electromigration_limits():
    assert E.max_parallel_write_current(1000) == pytest.approx(33e-9,
                                                               rel=0.01)
    assert E.min_on_resistance(1000, v_write=1.1) == pytest.approx(33e6,
                                                                   rel=0.05)
    assert E.min_on_resistance(512) == JE.min_on_resistance(512)


def test_table_i_write_current_is_parallel_safe():
    assert E.check_write_current(TABLE_I.analog_write_i, n_rows=1)
    assert TABLE_I.analog_write_i * TABLE_I.rows < 33e-6
    assert not E.check_write_current(TABLE_I.binary_write_i, TABLE_I.rows)


def test_pulse_stats_match_reference():
    rng = np.random.default_rng(0)
    dg = (0.01 * rng.standard_normal((256, 256))).astype(np.float32)
    dg = np.where(rng.random(dg.shape) < 0.1, dg, 0.0).astype(np.float32)
    got = E.pulse_stats(torch.from_numpy(dg), TAOX)
    want = JE.pulse_stats(jnp.asarray(dg), J_TAOX)
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    assert 0.05 < float(got["duty"]) < 0.15
    assert float(got["mean_pulses_when_touched"]) > 1.0


def test_recalibration_pulses_match_reference():
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(0.2, 0.8, (64, 48)).astype(np.float32)
            for _ in range(2))
    assert float(E.recalibration_pulses(torch.from_numpy(a),
                                        torch.from_numpy(b), TAOX)) \
        == pytest.approx(float(JE.recalibration_pulses(
            jnp.asarray(a), jnp.asarray(b), J_TAOX)), rel=1e-5)
