"""The hybrid family (Zamba-2) in the port against the JAX package: the
zamba2-1.2b smoke config (4 layers, ``attn_every=2``) and, for the
model, the same config at 5 layers (two groups of two SSD layers, each
followed by the shared attention block, and one trailing layer), in
digital, fakequant and device mode; the shared K/V caches and the decode
positions they give; static serving; the shared block's tapes
(``tape_lead == (reps, T)``, one slot and one pair of code scales per
application); and one device-mode training step, its shared-block
containers each written once over their applications' collapsed rows.

Inputs as in ``tests/test_torch_ssm.py`` (whose helpers this file
uses): numpy from a seed, or the reference's draws at ``PRNGKey``s
carried across with ``convert.params_from_numpy``.  One module-scoped
fixture records the reference's op-by-op forward in each mode.

Tolerances:
  * digital logits, caches, states: 1e-5;
  * device mode: every read on the reference's own operands within 1e-6
    or a one-lsb-per-K-tile flip on under 1% of the elements, the logits
    within 1e-5 free-running and with the reference's reads replayed;
  * fakequant mode: the last layer's ``out_proj`` flips an 8-bit ADC code
    at this seed (its input differs from the reference's by 2e-6), so it
    is held read by read: every reference read within 1e-5 on its own
    operands, the logits within 1e-5 with the reference's reads
    replayed and within 1e-2 free-running;
  * the training step as ``tests/test_torch_ssm.py`` holds mamba2's, each
    application's tape slot against the reference's slot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import analog_registry as jreg
from repro.models import model as JM
from repro.serve import SamplingParams as JSP
from repro.serve import make_engine as j_make_engine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import analog_registry as treg
from repro_torch.core.tiled_analog import crossbar_from_model
from repro_torch.models import model as M
from repro_torch.serve import SamplingParams, make_engine
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.train import analog_lm as TA
from test_torch_ssm import (LR, MODES, TOKENS, TRAIN, _close, _get,
                            check_fq_reads_on_reference_operands,
                            check_reads_on_reference_operands, check_step,
                            check_write_on_reference_tapes, port_forward,
                            port_step_replayed, recording_port_tapes,
                            reference_forward, reference_step,
                            remat_replays, tapes_agree)

ARCH = "zamba2-1.2b"
#: Two groups of attn_every=2 SSD layers and one trailing layer.
N_LAYERS = 5
N_GROUPS = 2
MAX_LEN = 16
SHARED = (("shared_in",), ("shared_attn", "wqkv"), ("shared_attn", "wo"),
          ("shared_ffn", "w_upgate"), ("shared_ffn", "w_down"))
SSD = (("layers", "ssm", "in_proj"), ("layers", "ssm", "out_proj"))


def _cfgs(mode="digital", **kw):
    kw = {**MODES[mode], "n_layers": N_LAYERS, **kw}
    return jax_config(ARCH, True).replace(**kw), \
        get_config(ARCH, True).replace(**kw)


# ------------------------------------------------------------------ configs

def test_smoke_config_keeps_two_groups():
    """``make_smoke`` keeps 4 layers when ``attn_every`` is set, with
    ``attn_every=2`` and the SSM widths, as the reference's does."""
    got, want = get_config(ARCH, True), jax_config(ARCH, True)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.n_layers, got.attn_every, got.ssm_state, got.ssm_head_dim,
            got.ssm_chunk) == (4, 2, 16, 16, 16)
    assert got.sub_quadratic and not got.attention_free
    assert get_config("mamba2-1.3b").attention_free


@pytest.mark.parametrize("full", [False, True])
def test_tape_lead_gives_one_slot_per_application(full):
    """``tape_lead`` is (reps, T) for the shared block's containers and
    (T,) for the SSD stacks, as the reference's; ``tape_reps`` is
    ``n_layers // attn_every`` (6 at full depth)."""
    cfg = get_config(ARCH) if full else _cfgs()[1]
    jcfg = jax_config(ARCH) if full else _cfgs()[0]
    reps = 6 if full else N_GROUPS
    for path in SHARED + SSD:
        want = jreg.tape_lead(path, jcfg, 2048, (8, 256))
        assert treg.tape_lead(path, cfg, 2048, (8, 256)) == want
        assert want == ((reps, 2048) if path in SHARED else (2048,))
        assert treg.tape_reps(path, cfg) == (reps if path in SHARED else 1)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def reference():
    params = JM.init_params(jax.random.PRNGKey(0), _cfgs()[0])
    return {mode: reference_forward(_cfgs(mode)[0], params, mode)
            for mode in MODES}


def _reads_per_call(cfg):
    """Crossbar reads a model call makes: in_proj and out_proj a layer,
    the shared block's five containers once an application."""
    return 2 * cfg.n_layers + 5 * (cfg.n_layers // cfg.attn_every)


@pytest.mark.parametrize("mode", list(MODES))
def test_smoke_logits_match_reference(mode, reference, monkeypatch):
    """The 5-layer stack's logits in each mode: digital and device
    free-running within 1e-5; fakequant held read by read (module
    docstring) and free-running within 1e-2.  Every read on the reference's own operands."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    logits, mine = port_forward(run, cfg, monkeypatch)
    n = 0 if mode == "digital" else _reads_per_call(cfg)
    assert len(mine) == n
    assert _reads_per_call(cfg) == 2 * N_LAYERS + 5 * N_GROUPS
    assert len(run["reads"] if mode == "device" else run["fq_reads"]) \
        == (n if mode != "digital" else 0)
    if mode == "fakequant":
        check_fq_reads_on_reference_operands(run["fq_reads"], cfg)
        assert np.abs(logits - run["logits"]).max() < 1e-2
        return
    _close(logits, run["logits"])
    if mode == "device":
        check_reads_on_reference_operands(run["reads"],
                                          crossbar_from_model(cfg))


@pytest.mark.parametrize("mode", ["fakequant", "device"])
def test_smoke_logits_with_replayed_reads(mode, reference, monkeypatch):
    run = reference[mode]
    logits, _ = port_forward(run, _cfgs(mode)[1], monkeypatch,
                             replay="reads" if mode == "device"
                             else "fq_reads")
    _close(logits, run["logits"])


def test_params_from_numpy_carries_the_shared_block(reference):
    tp = params_from_numpy(reference["device"]["params"], "cpu")
    cfg = _cfgs("device")[1]
    d = cfg.d_model
    assert tp["shared_in"]["g"].shape == (2 * d, d)
    assert tp["shared_attn"]["wqkv"]["g"].shape == (d, 3 * 4 * 16)
    assert tp["shared_ffn"]["w_upgate"]["g"].shape == (d, 2 * cfg.d_ff)
    assert tp["layers"]["ssm"]["in_proj"]["g"].shape[0] == N_LAYERS
    assert set(treg.container_paths(tp)) == set(SHARED) | set(SSD)
    treg.validate_device_params(tp, cfg)


# ------------------------------------------------------------------ serving

def test_init_cache_matches_reference():
    """SSM states stacked (L, B, ...), the shared block's K/V caches
    stacked (n_groups, B, ...); batch axes as the reference's."""
    jcfg, cfg = _cfgs()
    got = M.init_cache(cfg, 3, MAX_LEN, "cpu")
    want = JM.init_cache(jcfg, 3, MAX_LEN)
    for g, w in zip(got, want):
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: tuple(v.shape) for k, v in w.items()}
    assert tuple(got[0]["h"].shape) == (N_LAYERS, 3, 8, 16, 16)
    assert tuple(got[1]["k"].shape) == (N_GROUPS, 3, MAX_LEN, 4, 16)
    axes = M.cache_batch_axes(cfg, MAX_LEN)
    j_axes = JM.cache_batch_axes(jcfg, MAX_LEN)
    assert axes == {**{(0, k): j_axes[0][k] for k in ("h", "conv")},
                    **{(1, k): j_axes[1][k] for k in ("k", "v", "len")}}


def test_prefill_and_decode_match_reference(reference):
    """``prefill`` then 3 decode steps fed the reference's greedy tokens:
    the logits, the decode positions (the shared caches' lengths), the
    final SSM states and the shared K/V caches within 1e-5."""
    jcfg, cfg = _cfgs()
    jp = reference["digital"]["params"]
    tp = params_from_numpy(jp, "cpu")
    j_pre = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, MAX_LEN))
    j_dec = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    lj, cj = j_pre(jp, jnp.asarray(TOKENS))
    with torch.no_grad():
        lt, ct = M.prefill(tp, {"tokens": torch.from_numpy(TOKENS).long()},
                           cfg, MAX_LEN)
        _close(lt.numpy(), np.array(lj))
        for i in range(3):
            lens = M.cache_lens(ct, cfg)
            np.testing.assert_array_equal(lens.numpy(),
                                          np.array(JM.cache_lens(cj, jcfg)))
            assert lens.tolist() == [TOKENS.shape[1] + i] * 2
            tok = jnp.argmax(lj, axis=-1)
            lj, cj = j_dec(jp, cj, tok)
            lt, ct = M.decode_step(tp, ct, torch.from_numpy(
                np.array(tok)).long(), cfg)
            _close(lt.numpy(), np.array(lj))
    for k in ("h", "conv"):
        _close(ct[0][k].numpy(), np.array(cj[0][k]))
    for k in ("k", "v"):
        _close(ct[1][k].numpy(), np.array(cj[1][k]))
    np.testing.assert_array_equal(ct[1]["len"].numpy(),
                                  np.array(cj[1]["len"]))


def test_static_engine_matches_reference(reference):
    jcfg, cfg = _cfgs()
    jp = reference["digital"]["params"]
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(0, cfg.vocab, n)))
               for n in (6, 3, 8)]
    eng = make_engine(cfg, params_from_numpy(jp, "cpu"), max_len=32)
    assert not eng.supports_continuous
    got = eng.generate(prompts, SamplingParams(max_new_tokens=4))
    want = j_make_engine(jcfg, jp, max_len=32).generate(
        prompts, JSP(max_new_tokens=4))
    assert got == want
    with pytest.raises(ValueError, match="static engine"):
        ContinuousEngine(cfg, eng.params)


# ------------------------------------------------------------------ training

@pytest.fixture(scope="module")
def hybrid_step():
    return reference_step(ARCH, n_layers=N_LAYERS)


def test_device_train_step_with_replayed_reads(hybrid_step, monkeypatch):
    """One device-mode step against the reference's, every read replaced
    by the reference's result for the same container and application:
    the shared block's containers are read twice forward and twice
    transposed a step, the SSD stacks once a layer (their forward reads
    once more under the port's remat; the shared block is not
    rematted)."""
    run = hybrid_step
    state, mets, _, used = port_step_replayed(run, monkeypatch)
    assert len(run["reads"]) == 2 * (2 * N_LAYERS + 5)
    assert sorted(len(v) for v in run["reads"].values()) == \
        [1] * (2 * 2 * N_LAYERS) + [N_GROUPS] * (2 * 5)
    # every recorded application replayed, once, or twice where rematted
    assert len(set(used)) == 2 * _reads_per_call(run["cfg"])
    assert sorted(used) == remat_replays(run["init"]["params"], ("layers",),
                                         set(used), key=lambda u: u[0])
    check_step(run, state, mets, 7)


def test_shared_block_tapes_one_slot_per_application(hybrid_step,
                                                     monkeypatch):
    """Each application of the shared block fills its own (T, K) / (T, N)
    slot and its own code scales; the slots differ, and each equals the
    reference's slot.  The SSD stacks' tapes agree as mamba2's do."""
    run = hybrid_step
    _, _, tapes, _ = port_step_replayed(run, monkeypatch)
    assert set(tapes) == set(run["tapes"]) == set(SHARED) | set(SSD)
    for path, (x_want, d_want) in run["tapes"].items():
        t = tapes[path]
        if path in SHARED:
            assert t["x_tape"].shape[:2] == (N_GROUPS, 16)
            assert t["x_tape_scale"].shape == (N_GROUPS,)
            assert not np.array_equal(t["x_tape"][0], t["x_tape"][1])
            assert t["d_tape_scale"][0] != t["d_tape_scale"][1]
            for r in range(N_GROUPS):
                tapes_agree(t["x_tape"][r], x_want[r], t["x_tape_scale"][r])
                tapes_agree(t["d_tape"][r], d_want[r], t["d_tape_scale"][r])
        else:
            tapes_agree(t["x_tape"], x_want, t["x_tape_scale"][:, None, None])
            tapes_agree(t["d_tape"], d_want, t["d_tape_scale"][:, None, None])


def test_shared_block_single_write_over_collapsed_tapes(hybrid_step,
                                                        monkeypatch):
    """Each shared container is written once, over its applications'
    (reps x T) rows as float operands without code scales (the FP32
    instance on the card), the SSD stacks with their scales; fed the
    reference's collapsed tapes, each write agrees with the reference's
    within 4 float32 ulp."""
    run = hybrid_step
    calls = []
    write = TA.xbar_outer_update

    def recorded(g, x_q, d_q, scale, cfg, **kw):
        calls.append((tuple(g.shape), tuple(x_q.shape),
                      kw.get("x_scale") is not None))
        return write(g, x_q, d_q, scale, cfg, **kw)
    monkeypatch.setattr(TA, "xbar_outer_update", recorded)
    port_step_replayed(run, monkeypatch)
    shared = [c for c in calls if len(c[0]) == 2]
    assert len(calls) == 7 and len(shared) == 5
    assert all(x[0] == N_GROUPS * 16 and not scaled
               for _, x, scaled in shared)
    assert all(scaled for g, _, scaled in calls if len(g) == 3)
    for path in SHARED + SSD:
        check_write_on_reference_tapes(run, path)
    # the collapsed rows are the two applications' slots, in order
    x_t = run["tapes"][("shared_in",)][0]
    g3, x3, *_ = treg.flatten_lead(
        treg.classify(("shared_in",)),
        torch.from_numpy(_get(run["init"]["params"], ("shared_in",))["g"]),
        torch.from_numpy(x_t), torch.from_numpy(
            run["tapes"][("shared_in",)][1]), 1.0)
    np.testing.assert_array_equal(x3.numpy(), x_t.reshape(-1, x_t.shape[-1]))
    assert tuple(g3.shape) == (2 * 64, 64)


def test_one_application_takes_the_tapes_as_its_slot(monkeypatch):
    """At 3 layers (one group of two SSD layers, one trailing layer) the
    shared block runs once a step: ``tape_lead`` is (T,) for it, the
    tapes are the slot (``tape_slot`` with one application), and each
    shared container is written once over its T rows with its code
    scales, as a container applied once, and moves.  The reference fails
    at this depth (it indexes the (T,) tapes by application), so there is
    no step of its to hold this one to."""
    cfg = get_config(ARCH, True).replace(**TRAIN, n_layers=3)
    assert all(treg.tape_lead(p, cfg, 16, (2, 8)) == (16,) for p in SHARED)
    calls, tapes = [], {}
    write = TA.xbar_outer_update

    def recorded(g, x_q, d_q, scale, cfg_, **kw):
        calls.append((tuple(g.shape), tuple(x_q.shape),
                      kw.get("x_scale") is not None))
        return write(g, x_q, d_q, scale, cfg_, **kw)
    monkeypatch.setattr(TA, "xbar_outer_update", recorded)
    state = TA.init_state(0, cfg, "cpu")
    init = {p: _get(state["params"], p)["g"].clone() for p in SHARED}
    with recording_port_tapes(tapes):
        new, mets = TA.make_analog_sgd_step(cfg, lr=LR)(
            state, {"tokens": torch.from_numpy(TOKENS).long(),
                    "labels": torch.from_numpy(TOKENS).long()}, 7)
    assert np.isfinite(float(mets["loss"]))
    assert len(calls) == 7 and all(scaled for *_, scaled in calls)
    for path in SHARED:
        t = tapes[path]
        k, n = init[path].shape
        assert t["x_tape"].shape == (16, k) and t["d_tape"].shape == (16, n)
        assert t["x_tape_scale"].shape == t["d_tape_scale"].shape == ()
        assert np.abs(t["d_tape"]).max() > 0
        assert (_get(new["params"], path)["g"] != init[path]).any()


def test_param_count_and_projections_match_reference():
    """Full-size counts: the shared block counted once in
    ``param_count`` and applied 6 times a token in the hwmodel
    inventory."""
    from repro.hwmodel import arch_cost as JC
    from repro_torch.hwmodel import arch_cost as TC
    for smoke in (False, True):
        assert get_config(ARCH, smoke).param_count() == \
            jax_config(ARCH, smoke).param_count()
    got = {p.name: dataclasses.astuple(p)
           for p in TC.model_projections(get_config(ARCH))}
    want = {p.name: dataclasses.astuple(p)
            for p in JC.model_projections(jax_config(ARCH))}
    assert got == want
    assert got["shared_in"][1:] == (4096, 2048, 1, 6.0)
    assert got["layers/ssm/in_proj"][1:] == (2048, 8384, 38, 1.0)
