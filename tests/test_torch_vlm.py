"""The VLM family (llama-3.2-vision style cross-attention) in the port
against the JAX package: the llama-3.2-vision-90b smoke config (4 layers,
``cross_attn_every=2``: two groups of a gated cross block and one self
block; 16 vision tokens) — ``layers.attention`` with ``x_kv`` (the fused
cross-attention, ONE ``wqkv`` read over both streams) in digital,
fakequant and device mode, ``cross_block``, the model in the three modes,
its caches, prefill and decode (every decode call re-reads the cross
``wqkv`` over the token and the whole stream), static serving with the
stream as ``extras``, the tapes' rows and one device-mode training step.

The reference initialises its gates at 0, where ``tanh(0)`` hides each
cross block's output and gives its containers zero cotangents, so the
numpy tree both packages receive carries non-zero gates (``GATES``).
Params come from the reference at ``PRNGKey(0)`` (programmed for device
mode) and cross with ``convert.params_from_numpy``; the vision tokens are
numpy normals from a seed.  One module-scoped fixture records the
reference's op-by-op forward in each mode with every read it made.

Tolerances:
  * outputs, caches and logits: 1e-5 (rtol and atol);
  * device reads on the reference's own operands within 1e-6 of their
    largest output, or a code flip within one lsb per K tile on under 1%
    of the elements; logits with the reference's reads replayed within
    1e-5; fakequant reads on their own operands within 1e-5;
  * the training step (the reference jitted, its forward and transpose
    reads replayed): as ``tests/test_torch_ssm.py`` holds mamba2's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.tiled_analog as TT
from repro.configs import get_config as jax_config
from repro.core import analog_registry as jreg
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JTF
from repro.serve import SamplingParams as JSP
from repro.serve import make_engine as j_make_engine
from repro.train import analog_lm as JA
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import analog_registry as treg
from repro_torch.core.tiled_analog import crossbar_from_model
from repro_torch.core.xbar_ops import vmm as torch_vmm
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models import transformer as TF
from repro_torch.serve import SamplingParams, make_engine
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.train import analog_lm as TA
from test_torch_ssm import (LR, MODES, TOKENS, TRAIN, _close, _env, _get,
                            _np, check_reads_on_reference_operands, check_step,
                            recording_jitted, recording_port_tapes,
                            recording_reference, recording_reference_tapes,
                            remat_replays, replaying, tapes_agree)

ARCH = "llama-3.2-vision-90b"
MAX_LEN = 16
#: The cross blocks' gates in the trees both packages receive.
GATES = {"gate_attn": 0.5, "gate_ffn": 0.75}
N_GROUPS = 2
#: Crossbar reads of one model call: a cross block's xattn wqkv and wo,
#: w_upgate and w_down, and a self block's four, per group.
READS_PER_CALL = 8 * N_GROUPS
CROSS = (("cross_layers", "xattn", "wqkv"), ("cross_layers", "xattn", "wo"),
         ("cross_layers", "ffn", "w_upgate"),
         ("cross_layers", "ffn", "w_down"))
SELF = (("self_layers", "attn", "wqkv"), ("self_layers", "attn", "wo"),
        ("self_layers", "ffn", "w_upgate"), ("self_layers", "ffn", "w_down"))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


VISION = _x((2, 16, 64), 7)
X_Q = _x((2, 8, 64), 1, 0.5)


def _cfgs(mode="digital", **kw):
    kw = {**MODES[mode], **kw}
    return jax_config(ARCH, True).replace(**kw), \
        get_config(ARCH, True).replace(**kw)


def with_gates(tree):
    """``tree`` (numpy) with every cross block's gates set to ``GATES``."""
    tree = dict(tree)
    cross = dict(tree["cross_layers"])
    for k, v in GATES.items():
        cross[k] = np.full_like(cross[k], v)
    tree["cross_layers"] = cross
    return tree


# ------------------------------------------------------ shared machinery
# (tests/test_torch_audio.py uses these with the audio frames)

def reference_forward(jcfg, params, mode, batch):
    """The reference's op-by-op logits of ``batch`` (numpy) on the numpy
    tree ``params`` (programmed for device mode) and the reads they
    made."""
    tree = jax.tree.map(jnp.asarray, params)
    if mode == "device":
        tree = JM.program_digital(tree, jcfg)
    reads, fq_reads = [], []
    with _env("REPRO_REMAT", "none"), recording_reference(reads, fq_reads), \
            jax.disable_jit():
        logits = JM.forward(tree, jax.tree.map(jnp.asarray, batch), jcfg)[0]
    return {"params": _np(tree), "logits": np.array(logits),
            "reads": reads, "fq_reads": fq_reads}


def torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device).long()
            if v.dtype.kind == "i" else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


def port_reads(monkeypatch, run=None, replay=None):
    """The port's crossbar and fakequant reads recorded (their results);
    with ``replay`` (``"reads"`` or ``"fq_reads"``) each returns the
    reference's result of the same position instead.  Crossbar reads
    also record their operand rows and conductances."""
    mine, rows = [], []

    def recorded(x, g, ref, ws, xcfg, **kw):
        y = torch_vmm(x, g, ref, ws, xcfg, **kw)
        mine.append(y.numpy().copy())
        rows.append((x.reshape(-1, x.shape[-1]).shape[0], g))
        if replay == "reads":
            return torch.from_numpy(run["reads"][len(mine) - 1][4])
        return y

    fq = TL.fakequant_project

    def recorded_fq(x, w, *args, **kw):
        y = fq(x, w, *args, **kw)
        mine.append(y.numpy().copy())
        if replay == "fq_reads":
            return torch.from_numpy(
                run["fq_reads"][len(mine) - 1][2]).reshape(y.shape)
        return y
    monkeypatch.setattr(TT, "vmm", recorded)
    monkeypatch.setattr(TL, "fakequant_project", recorded_fq)
    return mine, rows


def port_forward(run, cfg, batch, monkeypatch, replay=None):
    mine, rows = port_reads(monkeypatch, run, replay)
    with torch.no_grad():
        logits = M.forward(params_from_numpy(run["params"], "cpu"),
                           torch_batch(batch), cfg)[0].numpy()
    return logits, mine, rows


def fq_one_lsb_per_tile(x, w, cfg):
    """Per token of a fakequant read, the sum over its row tiles of one
    output-ADC lsb (the token's own range): what one code flip per tile
    can move an output by."""
    from repro_torch.core.adc import AdcConfig, quantize_dequantize
    from repro_torch.kernels.ops import _adc_lsb
    adc = AdcConfig(in_bits=cfg.analog_in_bits,
                    out_bits=cfg.analog_out_bits)
    rows, (k, n) = cfg.analog_rows, w.shape
    pad = (-k) % rows
    xq = torch.nn.functional.pad(quantize_dequantize(x, adc), (0, pad))
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
    q = torch.einsum("...tk,tkn->...tn",
                     xq.reshape(*x.shape[:-1], -1, rows),
                     wp.reshape(-1, rows, n))
    return _adc_lsb(q, adc)[1].sum(-2).numpy()


def check_fq_reads_with_flips(fq_reads, cfg):
    """Each reference fakequant read, fed to the port's on its own
    operands: within 1e-5, or a code flip within one lsb per row tile on
    under 1% of the elements (the two packages' tile sums are float32
    sums taken in another order)."""
    flips = 0
    for i, (x, w, out) in enumerate(fq_reads):
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        with torch.no_grad():
            y = TL.project({"w": wt}, xt, cfg).numpy()
        err = np.abs(y - out.reshape(y.shape))
        off = err > 1e-5 * (1 + np.abs(y))
        if off.any():
            flips += 1
            bound = fq_one_lsb_per_tile(xt, wt, cfg)
            assert (err <= bound + 1e-5 * (1 + np.abs(y))).all(), i
            assert off.mean() < 0.01, i
    return flips


def check_mode(run, cfg, mode, logits, mine, n_reads):
    """The port's free-running logits against the reference's (1e-5),
    ``n_reads`` reads a call in the analog modes, each reference read on
    its own operands.  Where a fakequant read flips a code on the
    reference's own operands, the flip cascades: each later read takes
    its range over other values (whisper's smoke logits end 0.068 off
    the reference's, as far as its own quantisation moves them, 0.063).
    The free-running logits are then held within twice the quantisation's
    own move of the reference's, and at least half that move off the
    digital model's, so that a port without the quantisation fails;
    ``test_smoke_logits_with_replayed_reads`` holds them to 1e-5."""
    assert len(mine) == (0 if mode == "digital" else n_reads)
    assert len(run["reads"]) == (n_reads if mode == "device" else 0)
    assert len(run["fq_reads"]) == (n_reads if mode == "fakequant" else 0)
    if mode == "device":
        check_reads_on_reference_operands(run["reads"],
                                          crossbar_from_model(cfg))
    if mode == "fakequant" and check_fq_reads_with_flips(run["fq_reads"],
                                                         cfg):
        own = np.abs(run["logits"] - run["digital_logits"]).max()
        assert np.abs(logits - run["logits"]).max() < 2 * own
        assert np.abs(logits - run["digital_logits"]).max() > own / 2
        return
    _close(logits, run["logits"])


def reference_step(jcfg, cfg, init, batch):
    """The reference's jitted device-mode step from the numpy state
    ``init`` on ``batch`` (numpy): its new state, loss, seed_base, every
    read's (x, y) by container and the tapes each write used."""
    state = jax.tree.map(jnp.asarray, init)
    ks = jax.random.split(jax.random.PRNGKey(1))[1]
    results, tapes = {}, {}
    with _env("REPRO_REMAT", "none"), recording_jitted(results), \
            recording_reference_tapes(tapes):
        new, mets = JA.make_analog_sgd_step(jcfg, lr=LR)(
            state, jax.tree.map(jnp.asarray, batch), ks)
        jax.block_until_ready(new)
    return {"cfg": cfg, "init": init, "new": _np(new), "batch": batch,
            "loss": float(mets["loss"]),
            "seed_base": int(jax.random.bits(ks, (), jnp.uint32)),
            "reads": results, "tapes": tapes}


def port_step_replayed(run, monkeypatch):
    """The port's step on the reference's init state, batch and
    seed_base, every read replaced by the reference's; returns (state,
    metrics, tapes, replays used)."""
    used, tapes = [], {}
    replaying(monkeypatch, run["reads"], used)
    with recording_port_tapes(tapes):
        state, mets = TA.make_analog_sgd_step(run["cfg"], lr=LR)(
            params_from_numpy(run["init"], "cpu"),
            torch_batch(run["batch"]), run["seed_base"])
    return state, mets, tapes, used


def check_tapes(run, tapes, rows_of):
    """Every container's tapes against the reference's (``tapes_agree``),
    each with the rows ``rows_of(path)`` a layer."""
    assert set(tapes) == set(run["tapes"])
    for path, (x_want, d_want) in run["tapes"].items():
        t = tapes[path]
        lead = t["x_tape_scale"].shape
        assert t["x_tape"].shape[len(lead)] == rows_of(path), path
        s = t["x_tape_scale"].reshape(*lead, 1, 1)
        tapes_agree(t["x_tape"], x_want, s)
        tapes_agree(t["d_tape"], d_want, t["d_tape_scale"].reshape(
            *lead, 1, 1))


def train_batch(vocab, b, s):
    x, y = jsyn.batch_tokens(jsyn.make_token_stream(4096, vocab), b, s, 0)
    return {"tokens": x, "labels": y}


# ------------------------------------------------------------------ configs

def test_config_fields_and_smoke_match_reference():
    """Full and smoke fields as the reference's; the smoke keeps 4 layers
    (two groups of ``cross_attn_every=2``) and 16 vision tokens."""
    for smoke in (False, True):
        got, want = get_config(ARCH, smoke), jax_config(ARCH, smoke)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    got = get_config(ARCH, True)
    assert (got.n_layers, got.cross_attn_every, got.n_vision_tokens) == \
        (4, 2, 16)
    full = get_config(ARCH)
    assert (full.n_layers, full.cross_attn_every, full.n_vision_tokens,
            full.has_encoder) == (100, 5, 1024, False)


# ------------------------------------------------------------ the stack

@pytest.fixture(scope="module")
def reference():
    """Per mode: the reference's smoke tree at PRNGKey(0) with non-zero
    gates, its op-by-op logits and reads; the fused cross-attention of
    cross block 0 on ``X_Q`` and ``VISION`` with its reads; in digital
    mode ``cross_block`` on the same inputs."""
    params = with_gates(_np(JM.init_params(jax.random.PRNGKey(0),
                                           _cfgs()[0])))
    batch = {"tokens": TOKENS, "vision": VISION}
    out = {}
    for mode in MODES:
        jcfg = _cfgs(mode)[0]
        run = reference_forward(jcfg, params, mode, batch)
        run["digital_logits"] = out["digital"]["logits"] if out else None
        tree = jax.tree.map(lambda a: jnp.asarray(a[0]),
                            run["params"]["cross_layers"])
        reads, fq_reads = [], []
        with recording_reference(reads, fq_reads), jax.disable_jit():
            y, _ = JL.attention(tree["xattn"], jnp.asarray(X_Q), jcfg,
                                causal=False, x_kv=jnp.asarray(VISION),
                                use_rope=False)
            run["xattn"] = (np.array(y), reads, fq_reads)
            if mode == "digital":
                run["cross_block"] = np.array(JTF.cross_block(
                    tree, jnp.asarray(X_Q), jnp.asarray(VISION), jcfg))
        out[mode] = run
    return out


def _port_cross0(run):
    return TF.tree_index(params_from_numpy(run["params"], "cpu")
                         ["cross_layers"], 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_cross_attention_matches_reference(mode, reference, monkeypatch):
    """``attention`` with ``x_kv`` (no rope, no causal mask) on cross
    block 0: within 1e-5 of the reference's; in the analog modes ONE
    ``wqkv`` read over B x (8 + 16) rows (both streams) and one ``wo``
    read over B x 8, each reference read on its own operands."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    p = _port_cross0(run)["xattn"]
    mine, rows = port_reads(monkeypatch)
    with torch.no_grad():
        y, cache = TL.attention(p, torch.from_numpy(X_Q), cfg, causal=False,
                                x_kv=torch.from_numpy(VISION),
                                use_rope=False)
    assert cache is None
    want, reads, fq_reads = run["xattn"]
    _close(y.numpy(), want)
    assert len(mine) == (0 if mode == "digital" else 2)
    if mode == "device":
        assert [r for r, _ in rows] == [2 * (8 + 16), 2 * 8]
        assert [r[0].shape[0] for r in reads] == [2 * (8 + 16), 2 * 8]
        check_reads_on_reference_operands(reads, crossbar_from_model(cfg))
    if mode == "fakequant":
        assert [r[0].shape[:2] for r in fq_reads] == [(2, 24), (2, 8)]
        check_fq_reads_with_flips(fq_reads, cfg)


def test_cross_attention_with_a_cache_leaves_it_alone(reference):
    """A cache given with ``x_kv`` is neither read nor written, and no
    cache comes back (the reference returns none either)."""
    cfg = _cfgs()[1]
    p = _port_cross0(reference["digital"])["xattn"]
    cache = TL.make_cache(cfg, 2, MAX_LEN)
    with torch.no_grad():
        y, new = TL.attention(p, torch.from_numpy(X_Q), cfg, causal=False,
                              x_kv=torch.from_numpy(VISION), use_rope=False,
                              cache=cache)
    assert new is None and not any(v.any() for v in cache.values())
    _close(y.numpy(), reference["digital"]["xattn"][0])


def test_cross_block_matches_reference(reference):
    cfg = _cfgs()[1]
    with torch.no_grad():
        y = TF.cross_block(_port_cross0(reference["digital"]),
                           torch.from_numpy(X_Q), torch.from_numpy(VISION),
                           cfg)
    _close(y.numpy(), reference["digital"]["cross_block"])


@pytest.mark.parametrize("mode", list(MODES))
def test_smoke_logits_match_reference(mode, reference, monkeypatch):
    """The smoke model's logits in each mode, free-running, within 1e-5;
    16 reads a call in the analog modes, each cross ``wqkv`` read over
    B x (S + 16) rows."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    logits, mine, rows = port_forward(
        run, cfg, {"tokens": TOKENS, "vision": VISION}, monkeypatch)
    check_mode(run, cfg, mode, logits, mine, READS_PER_CALL)
    if mode == "device":
        counts = sorted(r for r, _ in rows)
        assert counts == [2 * 8] * (READS_PER_CALL - N_GROUPS) \
            + [2 * (8 + 16)] * N_GROUPS


@pytest.mark.parametrize("mode", ["fakequant", "device"])
def test_smoke_logits_with_replayed_reads(mode, reference, monkeypatch):
    run = reference[mode]
    logits, _, _ = port_forward(
        run, _cfgs(mode)[1], {"tokens": TOKENS, "vision": VISION},
        monkeypatch, replay="reads" if mode == "device" else "fq_reads")
    _close(logits, run["logits"])


def test_non_zero_gates_change_the_logits(reference):
    """With the reference's own zero gates the cross blocks add nothing:
    the logits differ from the gated tree's and do not depend on the
    vision tokens."""
    cfg = _cfgs()[1]
    zero = params_from_numpy(reference["digital"]["params"], "cpu")
    for k in GATES:
        zero["cross_layers"][k].zero_()
    with torch.no_grad():
        a = M.forward(zero, torch_batch({"tokens": TOKENS,
                                         "vision": VISION}), cfg)[0]
        b = M.forward(zero, torch_batch({"tokens": TOKENS,
                                         "vision": 2 * VISION}), cfg)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert np.abs(a.numpy() - reference["digital"]["logits"]).max() > 1e-3


def test_params_from_numpy_carries_the_vlm_tree(reference):
    tp = params_from_numpy(reference["device"]["params"], "cpu")
    cfg = _cfgs("device")[1]
    assert set(tp) == {"embed", "self_layers", "cross_layers", "final_ln",
                       "lm_head"}
    assert tp["self_layers"]["attn"]["wqkv"]["g"].shape == (2, 64, 3 * 64)
    assert tp["cross_layers"]["xattn"]["wqkv"]["g"].shape == (2, 64, 3 * 64)
    assert tp["cross_layers"]["gate_attn"].shape == (N_GROUPS,)
    assert set(treg.container_paths(tp)) == set(CROSS) | set(SELF)
    treg.validate_device_params(tp, cfg)
    digital = params_from_numpy(reference["digital"]["params"], "cpu")
    ported = M.program_digital(digital, cfg)
    for path in CROSS + SELF:
        for leaf in ("g", "ref", "w_scale"):
            torch.testing.assert_close(_get(ported, path)[leaf],
                                       _get(tp, path)[leaf], rtol=1e-6,
                                       atol=1e-6)
    assert torch.equal(ported["cross_layers"]["gate_ffn"],
                       digital["cross_layers"]["gate_ffn"])


# ------------------------------------------------------------------ serving

def test_init_cache_and_lens_match_reference():
    """Self caches stacked (n_groups, g - 1, B, ...), batch axes and
    ``cache_lens`` as the reference's."""
    jcfg, cfg = _cfgs()
    got = M.init_cache(cfg, 3, MAX_LEN, "cpu")
    want = JM.init_cache(jcfg, 3, MAX_LEN)
    assert got[1] is None and want[1] is None
    assert {k: tuple(v.shape) for k, v in got[0].items()} == \
        {k: tuple(v.shape) for k, v in want[0].items()} == {
            "k": (2, 1, 3, MAX_LEN, 4, 16), "v": (2, 1, 3, MAX_LEN, 4, 16),
            "len": (2, 1, 3)}
    axes = M.cache_batch_axes(cfg, MAX_LEN)
    j_axes = JM.cache_batch_axes(jcfg, MAX_LEN)
    assert axes == {(0, k): j_axes[0][k] for k in ("k", "v", "len")}
    got[0]["len"].fill_(5)
    assert M.cache_lens(got, cfg).tolist() == [5] * 3
    np.testing.assert_array_equal(
        M.cache_lens(got, cfg).numpy(),
        np.array(JM.cache_lens(jax.tree.map(
            lambda a: jnp.asarray(a.numpy()), got), jcfg)))


def test_prefill_and_decode_match_reference(reference, monkeypatch):
    """``prefill`` with the vision tokens, then 3 decode steps (the
    stream as ``batch_extras``) fed the reference's greedy tokens: the
    logits, the positions and the self caches within 1e-5.  In device
    mode each decode call re-reads both cross ``wqkv``s over B x (1 +
    16) rows."""
    jcfg, cfg = _cfgs()
    jp = reference["digital"]["params"]
    tp = params_from_numpy(jp, "cpu")
    vis, tvis = {"vision": jnp.asarray(VISION)}, \
        {"vision": torch.from_numpy(VISION)}
    j_pre = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t, **vis}, jcfg,
                                            MAX_LEN))
    j_dec = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg, vis))
    lj, cj = j_pre(jp, jnp.asarray(TOKENS))
    with torch.no_grad():
        lt, ct = M.prefill(tp, {"tokens": torch.from_numpy(TOKENS).long(),
                                **tvis}, cfg, MAX_LEN)
        _close(lt.numpy(), np.array(lj))
        for i in range(3):
            assert M.cache_lens(ct, cfg).tolist() == [8 + i] * 2
            tok = jnp.argmax(lj, axis=-1)
            lj, cj = j_dec(jp, cj, tok)
            lt, ct = M.decode_step(tp, ct, torch.from_numpy(
                np.array(tok)).long(), cfg, tvis)
            _close(lt.numpy(), np.array(lj))
    for k in ("k", "v"):
        _close(ct[0][k].numpy(), np.array(cj[0][k]))
    np.testing.assert_array_equal(ct[0]["len"].numpy(),
                                  np.array(cj[0]["len"]))
    dcfg = _cfgs("device")[1]
    dp = params_from_numpy(reference["device"]["params"], "cpu")
    with torch.no_grad():
        _, cache = M.prefill(dp, {"tokens": torch.from_numpy(TOKENS).long(),
                                  **tvis}, dcfg, MAX_LEN)
        _, rows = port_reads(monkeypatch)
        M.decode_step(dp, cache, torch.zeros(2, dtype=torch.long), dcfg,
                      tvis)
    assert sorted(r for r, _ in rows) == [2] * (READS_PER_CALL - N_GROUPS) \
        + [2 * (1 + 16)] * N_GROUPS


def test_static_engine_with_extras_matches_reference(reference):
    """Ragged prompts and the vision tokens as ``extras``: greedy tokens
    equal the reference engine's; an engine with extras, and the
    continuous scheduler for the family, are refused."""
    jcfg, cfg = _cfgs()
    jp = reference["digital"]["params"]
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(0, cfg.vocab, n)))
               for n in (6, 3)]
    eng = make_engine(cfg, params_from_numpy(jp, "cpu"), max_len=32,
                      extras={"vision": torch.from_numpy(VISION)})
    assert not eng.supports_continuous
    got = eng.generate(prompts, SamplingParams(max_new_tokens=4))
    want = j_make_engine(jcfg, jp, max_len=32,
                         extras={"vision": jnp.asarray(VISION)}).generate(
        prompts, JSP(max_new_tokens=4))
    assert got == want
    with pytest.raises(ValueError, match="static engine"):
        ContinuousEngine(cfg, eng.params)
    dense = get_config("lm100m", smoke=True)
    with_extras = make_engine(dense, M.init_params(dense, 0, "cpu"),
                              extras={"vision": torch.zeros(1)})
    assert not with_extras.supports_continuous


# ------------------------------------------------------------------ tapes

@pytest.mark.parametrize("full", [False, True])
def test_tape_lead_and_operand_rows_match_reference(full):
    """Every container's operand rows and tape slots as the reference's:
    the cross ``wqkv`` b x (s + n_vision_tokens) rows, everything else
    the b x s tokens."""
    cfg = get_config(ARCH, not full)
    jcfg = jax_config(ARCH, not full)
    b, s = 2, (128 if full else 8)
    for path in CROSS + SELF:
        want = b * (s + cfg.n_vision_tokens) if path == CROSS[0] else b * s
        assert treg.operand_rows(path, cfg, b * s, (b, s)) == \
            jreg.operand_rows(path, jcfg, b * s, (b, s)) == want
        assert treg.tape_lead(path, cfg, b * s, (b, s)) == \
            jreg.tape_lead(path, jcfg, b * s, (b, s)) == (want,)
    # without the batch shape the stream counts one sequence, as there
    assert treg.operand_rows(CROSS[0], cfg, 16) == \
        jreg.operand_rows(CROSS[0], jcfg, 16) == 16 + cfg.n_vision_tokens


# ------------------------------------------------------------------ training

@pytest.fixture(scope="module")
def vlm_step():
    jcfg, cfg = _cfgs(**TRAIN)
    init = _np(JA.init_state(jax.random.PRNGKey(0), jcfg))
    init["params"] = with_gates(init["params"])
    return reference_step(jcfg, cfg, init,
                          {**train_batch(cfg.vocab, 2, 8),
                           "vision": VISION})


def test_device_train_step_with_replayed_reads(vlm_step, monkeypatch):
    """One device-mode step against the reference's, every forward and
    transpose read replaced by the reference's result for the same
    container: 8 containers read once each way a layer (the self blocks'
    forward reads once more under the port's remat, not the cross
    blocks'), conductances within 1e-6, ``ref`` and ``w_scale``
    bit-equal, the loss within 1e-5, the gates' SGD moves within 1e-4 of
    theirs."""
    run = vlm_step
    state, mets, _, used = port_step_replayed(run, monkeypatch)
    assert len(run["reads"]) == 2 * READS_PER_CALL
    assert all(len(v) == 1 for v in run["reads"].values())
    assert sorted(k for k, _ in used) == remat_replays(
        run["init"]["params"], ("self_layers",), run["reads"])
    check_step(run, state, mets, 8)
    g0 = run["init"]["params"]["cross_layers"]["gate_attn"]
    assert np.abs(state["params"]["cross_layers"]["gate_attn"].numpy()
                  - g0).max() > 0


def test_device_train_step_tapes(vlm_step, monkeypatch):
    """Each cross ``wqkv`` deposits exactly one tape a layer of 2 x (8 +
    16) rows (tokens and vision rows in one block), every other
    container 2 x 8; every tape agrees with the reference's."""
    run = vlm_step
    _, _, tapes, _ = port_step_replayed(run, monkeypatch)
    assert set(tapes) == set(CROSS) | set(SELF)
    assert tapes[CROSS[0]]["x_tape"].shape == (N_GROUPS, 2 * (8 + 16), 64)
    check_tapes(run, tapes,
                lambda p: 2 * (8 + 16) if p == CROSS[0] else 2 * 8)


# ------------------------------------------------------------------ CLI

def test_serve_cli_runs_the_smoke_model_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", ARCH, "--smoke", "--backend", "analog",
                       "--analog-tile", "16", "--device", "cpu",
                       "--batch", "2", "--max-new", "3"])
    assert [len(o) for o in outs] == [3, 3]
    text = capsys.readouterr().out
    assert "analog/static" in text and "energy/token" in text
