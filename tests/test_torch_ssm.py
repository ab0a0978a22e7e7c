"""The SSM family (Mamba-2 SSD) in the port against the JAX package: the
chunked scan ``models.ssm._ssd_chunked`` (the reference test's three
(s, chunk) cases and an initial state), the causal conv with and
without a state, ``ssm_apply`` (full sequence, prefill then decode, a
50-step decode), the mamba2-1.3b smoke stack (2 layers) in digital,
fakequant and device mode, its states cache, prefill and decode, static
serving, and one device-mode training step (the tapes of every
container, and the write fed the reference's tapes).

Inputs are made with numpy from a seed, or drawn by the reference at
``PRNGKey``s and carried across with ``convert.params_from_numpy``.
One module-scoped fixture records the reference's op-by-op forward in
each mode, with every device read (operands and result) and every
fakequant read.

Tolerances:
  * the scan, the conv, the layer, the logits, the states and the
    caches: 1e-5 (rtol and atol; float32 sums taken in another order);
  * device-mode reads on the reference's own operands within 1e-6 of
    their largest output, or a code flip within one lsb per K tile on
    under 1% of the elements; logits with the reference's reads replayed
    within 1e-5; fakequant reads on the reference's operands within
    1e-5;
  * the training step with the reference's forward and transpose reads
    replayed (the reference jitted): the loss within 1e-5, every tape
    within 1e-5 of its largest value but for one-code flips on under 1%
    of the rows, conductances within 1e-6, ``ref`` and ``w_scale``
    bit-equal, each digital leaf's update within 1e-4 of its move; the
    port's write fed the reference's tapes within 4 float32 ulp of the
    reference's conductances.
"""
import contextlib
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.tiled_analog as JT
import repro_torch.core.tiled_analog as TT
from repro.configs import get_config as jax_config
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serve import make_engine as j_make_engine
from repro.train import analog_lm as JA
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import analog_registry as treg
from repro_torch.core.tiled_analog import crossbar_from_model
from repro_torch.core.xbar_ops import vmm as torch_vmm
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TF
from repro_torch.serve import SamplingParams, make_engine
from repro_torch.train import analog_lm as TA
from test_torch_forward_flips import _one_lsb_per_k_tile

ARCH = "mamba2-1.3b"
F32 = dict(dtype="float32")
MODES = {
    "digital": F32,
    "fakequant": dict(F32, analog=True, analog_mode="fakequant",
                      analog_rows=16),
    "device": dict(F32, analog=True, analog_mode="device",
                   analog_device="taox-nonoise", analog_rows=16,
                   analog_cols=16),
}
TRAIN = dict(F32, analog=True, analog_mode="device", analog_device="taox",
             analog_rows=16, analog_cols=16)
LR = 0.1
ULP4 = 4 * 2.0 ** -24
MAX_LEN = 16

_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 256, (2, 8)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _cfgs(mode="digital", arch=ARCH, **kw):
    kw = {**MODES[mode], **kw}
    return jax_config(arch, True).replace(**kw), \
        get_config(arch, True).replace(**kw)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@contextlib.contextmanager
def _env(name, value):
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


@contextlib.contextmanager
def recording_reference(reads, fq_reads):
    """Record the reference's forward reads op by op: crossbar reads as
    ``(x, g, ref, w_scale, y)``, fakequant reads as ``(x, w, y)``."""
    vmm_any, fq = JT._vmm_any, JL.fakequant_project

    def recorded(x, g, ref, ws, cfg, meta=None):
        y = vmm_any(x, g, ref, ws, cfg, meta)
        reads.append(tuple(np.array(a) for a in (x, g, ref, ws, y)))
        return y

    def recorded_fq(x, w, *args, **kw):
        y = fq(x, w, *args, **kw)
        fq_reads.append(tuple(np.array(a) for a in (x, w, y)))
        return y
    JT._vmm_any, JL.fakequant_project = recorded, recorded_fq
    try:
        yield
    finally:
        JT._vmm_any, JL.fakequant_project = vmm_any, fq


def reference_forward(jcfg, params, mode):
    """The reference's op-by-op logits of ``TOKENS`` and the reads they
    made (``REPRO_REMAT=none`` keeps its layer scans concrete)."""
    tree = JM.program_digital(params, jcfg) if mode == "device" else params
    reads, fq_reads = [], []
    with _env("REPRO_REMAT", "none"), recording_reference(reads, fq_reads), \
            jax.disable_jit():
        logits = JM.forward(tree, {"tokens": jnp.asarray(TOKENS)}, jcfg)[0]
    return {"params": _np(tree), "logits": np.array(logits),
            "reads": reads, "fq_reads": fq_reads}


def port_forward(run, cfg, monkeypatch, replay=None):
    """The port's logits of ``TOKENS`` on the reference's tree, its
    crossbar reads recorded; with ``replay`` (``"reads"`` or
    ``"fq_reads"``) each read returns the reference's result instead."""
    mine = []

    def recorded(x, g, ref, ws, xcfg, **kw):
        y = torch_vmm(x, g, ref, ws, xcfg, **kw)
        mine.append(y.numpy().copy())
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
    with torch.no_grad():
        logits = M.forward(params_from_numpy(run["params"], "cpu"),
                           {"tokens": torch.from_numpy(TOKENS).long()},
                           cfg)[0].numpy()
    return logits, mine


def check_reads_on_reference_operands(reads, xcfg):
    """Each reference crossbar read, fed to the port on its own operands:
    within 1e-6 of its largest output, or a code flip within one lsb per
    K tile on under 1% of the elements."""
    for i, (x, g, ref, ws, out) in enumerate(reads):
        ops = [torch.from_numpy(a) for a in (x, g, ref, ws)]
        err = np.abs(torch_vmm(*ops, xcfg).numpy() - out)
        off = err > 1e-6 * np.abs(out).max()
        if off.any():
            assert (err <= _one_lsb_per_k_tile(*ops, xcfg) + 1e-6).all(), i
            assert off.mean() < 0.01, i


def check_fq_reads_on_reference_operands(fq_reads, cfg):
    """Each reference fakequant read, fed to the port's on its own
    operands: within 1e-5."""
    for x, w, out in fq_reads:
        with torch.no_grad():
            y = TL.project({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                           cfg).numpy()
        _close(y, out.reshape(y.shape))


# ----------------------------------------------------------- the scan

def _ssd_inputs(s, seed, h0):
    """The reference test's shapes: B 2, H 4, P 8, G 1, N 16."""
    r = np.random.default_rng(seed)
    b, h, p, g, n = 2, 4, 8, 1, 16
    f = np.float32
    dt_raw = r.standard_normal((b, s, h)).astype(f)
    out = {"xh": r.standard_normal((b, s, h, p)).astype(f),
           "dt": np.logaddexp(dt_raw, 0).astype(f),
           "a_log": (0.5 * r.standard_normal(h)).astype(f),
           "bmat": (0.3 * r.standard_normal((b, s, g, n))).astype(f),
           "cmat": (0.3 * r.standard_normal((b, s, g, n))).astype(f)}
    if h0:
        out["h0"] = (0.2 * r.standard_normal((b, h, n, p))).astype(f)
    return out


@pytest.mark.parametrize("s,chunk,h0", [(16, 4, False), (32, 8, False),
                                        (24, 24, False), (16, 4, True)])
def test_ssd_chunked_matches_reference(s, chunk, h0):
    a = _ssd_inputs(s, s + chunk, h0)
    order = ("xh", "dt", "a_log", "bmat", "cmat")
    y_j, h_j = JS._ssd_chunked(*(jnp.asarray(a[k]) for k in order), chunk,
                               h0=jnp.asarray(a["h0"]) if h0 else None)
    y_t, h_t = TS._ssd_chunked(*(torch.from_numpy(a[k]) for k in order),
                               chunk,
                               h0=torch.from_numpy(a["h0"]) if h0 else None)
    _close(y_t.numpy(), np.array(y_j))
    _close(h_t.numpy(), np.array(h_j))


def test_ssd_chunked_backward_is_finite():
    """The -inf mask sits before the exp: the scan's gradient has no
    ``inf * 0`` and matches the reference's."""
    a = _ssd_inputs(16, 5, False)
    order = ("xh", "dt", "a_log", "bmat", "cmat")

    def j_loss(*args):
        y, h = JS._ssd_chunked(*args, 8)
        return jnp.sum(y ** 2) + jnp.sum(h ** 2)
    want = jax.grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a[k]) for k in order))
    ts = [torch.from_numpy(a[k]).requires_grad_(True) for k in order]
    y, h = TS._ssd_chunked(*ts, 8)
    (torch.sum(y ** 2) + torch.sum(h ** 2)).backward()
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        _close(t.grad.numpy(), np.array(w), tol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 6, 12)).astype(np.float32)
    w = (0.1 * r.standard_normal((4, 12))).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    st = r.standard_normal((2, 3, 12)).astype(np.float32) if with_state \
        else None
    y_j, s_j = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               state=None if st is None else jnp.asarray(st))
    y_t, s_t = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               state=None if st is None
                               else torch.from_numpy(st))
    _close(y_t.numpy(), np.array(y_j), tol=1e-6)
    np.testing.assert_array_equal(s_t.numpy(), np.array(s_j))


# ----------------------------------------------------------- the layer

@pytest.fixture(scope="module")
def layer():
    """One SSD layer of the smoke config (float32, digital) at
    PRNGKey(2), both packages' parameters."""
    jcfg, cfg = _cfgs()
    p = _np(JS.ssm_init(jax.random.PRNGKey(2), jcfg))
    return jcfg, cfg, p, params_from_numpy(p, "cpu")


def _state_close(got, want):
    for k in ("h", "conv"):
        _close(got[k].numpy(), np.array(want[k]))


def test_ssm_apply_full_sequence_matches_reference(layer):
    jcfg, cfg, jp, tp = layer
    x = (0.5 * np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model))).astype(np.float32)
    y_j, s_j = JS.ssm_apply(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y_t, s_t = TS.ssm_apply(tp, torch.from_numpy(x), cfg)
    _close(y_t.numpy(), np.array(y_j))
    _state_close(s_t, s_j)


def test_ssm_apply_prefill_then_decode_matches_reference(layer):
    """A 11-token prefill from a zero state (padded to the 16-token
    chunk), then one decode step: outputs and states."""
    jcfg, cfg, jp, tp = layer
    x = (0.5 * np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model))).astype(np.float32)
    js = JS.make_ssm_state(jcfg, 2)
    ts = TS.make_ssm_state(cfg, 2)
    for sl in (slice(0, 11), slice(11, 12)):
        y_j, js = JS.ssm_apply(jp, jnp.asarray(x[:, sl]), jcfg, state=js)
        with torch.no_grad():
            y_t, ts = TS.ssm_apply(tp, torch.from_numpy(x[:, sl]), cfg,
                                   state=ts)
        _close(y_t.numpy(), np.array(y_j))
        _state_close(ts, js)


def test_ssm_apply_fifty_decode_steps_match_reference(layer):
    jcfg, cfg, jp, tp = layer
    x = np.full((1, 1, cfg.d_model), 0.5, np.float32)
    js, ts = JS.make_ssm_state(jcfg, 1), TS.make_ssm_state(cfg, 1)
    step = jax.jit(lambda s: JS.ssm_apply(jp, jnp.asarray(x), jcfg,
                                          state=s))
    with torch.no_grad():
        for _ in range(50):
            y_j, js = step(js)
            y_t, ts = TS.ssm_apply(tp, torch.from_numpy(x), cfg, state=ts)
    _close(y_t.numpy(), np.array(y_j))
    _state_close(ts, js)
    assert torch.isfinite(ts["h"]).all() and ts["h"].abs().max() < 1e3


def test_ssm_init_shapes_match_reference(layer):
    """The port's own initialiser lays the layer out as the reference's
    (a torch.Generator's draws, not the reference's)."""
    jcfg, cfg, jp, _ = layer
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = TS.ssm_init(gen, cfg)
    assert {p: tuple(v.shape) for p, v in _leaves(mine)} == \
        {p: tuple(np.shape(v)) for p, v in _leaves(jp)}
    _close(mine["a_log"].numpy(), jp["a_log"], tol=1e-6)
    dt = torch.nn.functional.softplus(mine["dt_bias"])
    assert (dt >= 1e-3 * (1 - 1e-5)).all() and (dt <= 1e-1 * (1 + 1e-5)).all()


# ----------------------------------------------------------- the stack

@pytest.fixture(scope="module")
def reference():
    """Per mode: the reference's smoke tree at PRNGKey(0), its op-by-op
    logits and every read of that forward."""
    params = JM.init_params(jax.random.PRNGKey(0), _cfgs()[0])
    return {mode: reference_forward(_cfgs(mode)[0], params, mode)
            for mode in MODES}


@pytest.mark.parametrize("mode", list(MODES))
def test_smoke_logits_match_reference(mode, reference, monkeypatch):
    """The smoke stack's logits in each mode, free-running, within 1e-5
    (no read flips a code at this seed); device mode reads in_proj and
    out_proj once a layer, each read on the reference's own operands
    within the registry's class; fakequant reads likewise within 1e-5."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    logits, mine = port_forward(run, cfg, monkeypatch)
    n = {"digital": 0, "fakequant": 2 * cfg.n_layers,
         "device": 2 * cfg.n_layers}[mode]
    assert len(mine) == n
    assert len(run["reads"]) == (n if mode == "device" else 0)
    assert len(run["fq_reads"]) == (n if mode == "fakequant" else 0)
    _close(logits, run["logits"])
    if mode == "device":
        check_reads_on_reference_operands(run["reads"],
                                          crossbar_from_model(cfg))
    if mode == "fakequant":
        check_fq_reads_on_reference_operands(run["fq_reads"], cfg)


@pytest.mark.parametrize("mode", ["fakequant", "device"])
def test_smoke_logits_with_replayed_reads(mode, reference, monkeypatch):
    run = reference[mode]
    logits, _ = port_forward(run, _cfgs(mode)[1], monkeypatch,
                             replay="reads" if mode == "device"
                             else "fq_reads")
    _close(logits, run["logits"])


def test_params_from_numpy_carries_the_ssm_tree(reference):
    tp = params_from_numpy(reference["device"]["params"], "cpu")
    ssm = tp["layers"]["ssm"]
    cfg = _cfgs("device")[1]
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    assert set(ssm) == {"in_proj", "conv_w", "conv_b", "a_log", "d_skip",
                        "dt_bias", "norm", "out_proj"}
    assert ssm["in_proj"]["g"].shape == (2, 64, 2 * d_in + 2 * 16 + h)
    assert ssm["out_proj"]["g"].shape == (2, d_in, 64)
    assert ssm["conv_w"].shape == (2, cfg.ssm_conv, d_in + 2 * 16)
    treg.validate_device_params(tp, cfg)
    digital = params_from_numpy(reference["digital"]["params"], "cpu")
    back = M.readout_digital(M.program_digital(digital, cfg), cfg)
    torch.testing.assert_close(back["layers"]["ssm"]["in_proj"]["w"],
                               digital["layers"]["ssm"]["in_proj"]["w"],
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- serving

def test_init_cache_matches_reference():
    jcfg, cfg = _cfgs()
    got = M.init_cache(cfg, 3, MAX_LEN, "cpu")
    want = JM.init_cache(jcfg, 3, MAX_LEN)
    assert got[1] is None and want[1] is None
    assert {k: tuple(v.shape) for k, v in got[0].items()} == \
        {k: tuple(v.shape) for k, v in want[0].items()} == {
            "h": (2, 3, 8, 16, 16), "conv": (2, 3, 3, 128 + 32)}
    axes = M.cache_batch_axes(cfg, MAX_LEN)
    j_axes = JM.cache_batch_axes(jcfg, MAX_LEN)
    assert axes == {(0, k): j_axes[0][k] for k in ("h", "conv")}
    assert M.cache_lens(got, cfg) is None
    with pytest.raises(ValueError, match="no positional cache"):
        M.prefill_chunk(M.init_params(cfg, 0, "cpu"), got,
                        torch.zeros((3, 4), dtype=torch.long), cfg)


def test_prefill_and_decode_match_reference(reference):
    """``prefill`` then 3 decode steps fed the reference's greedy tokens:
    logits and the final states within 1e-5."""
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
        for _ in range(3):
            tok = jnp.argmax(lj, axis=-1)
            lj, cj = j_dec(jp, cj, tok)
            lt, ct = M.decode_step(tp, ct, torch.from_numpy(
                np.array(tok)).long(), cfg)
            _close(lt.numpy(), np.array(lj))
    for k in ("h", "conv"):
        _close(ct[0][k].numpy(), np.array(cj[0][k]))


def test_static_engine_matches_reference(reference):
    """Ragged prompts (left-padded with 0, the pads run through the
    recurrence) served greedily by the static scheduler: the port's
    tokens equal the reference engine's; the continuous scheduler is not
    offered."""
    jcfg, cfg = _cfgs()
    jp = reference["digital"]["params"]
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(0, cfg.vocab, n)))
               for n in (5, 9, 3)]
    sp = SamplingParams(max_new_tokens=5)
    eng = make_engine(cfg, params_from_numpy(jp, "cpu"), max_len=32)
    assert not eng.supports_continuous
    with pytest.raises(ValueError, match="continuous scheduler"):
        eng.stream
    got = eng.generate(prompts, sp)
    from repro.serve import SamplingParams as JSP
    want = j_make_engine(jcfg, jp, max_len=32).generate(
        prompts, JSP(max_new_tokens=5))
    assert got == want


# ----------------------------------------------------------- training

def _g_key(kind, g):
    return kind, hashlib.sha1(np.ascontiguousarray(g).tobytes()).hexdigest()


@contextlib.contextmanager
def recording_jitted(results):
    """Record every forward and transpose read a jitted reference step
    makes (a host callback from inside the compiled step): per
    ``(direction, conductance bytes)`` key, the list of ``(x, y)`` of the
    container's applications."""
    vmm_any, mvm_any = JT._vmm_any, JT._mvm_any

    def recorded(kind, read):
        def store(x, g, y):
            x, y = np.array(x), np.array(y)
            got = results.setdefault(_g_key(kind, np.asarray(g)), [])
            if not any(np.array_equal(x, a) and np.array_equal(y, b)
                       for a, b in got):
                got.append((x, y))

        def f(x, g, ref, ws, cfg, meta=None):
            y = read(x, g, ref, ws, cfg, meta)
            jax.debug.callback(store, x, g, y)
            return y
        return f
    JT._vmm_any, JT._mvm_any = recorded("vmm", vmm_any), \
        recorded("mvm", mvm_any)
    try:
        yield
    finally:
        JT._vmm_any, JT._mvm_any = vmm_any, mvm_any


def replaying(monkeypatch, results, used):
    """The port's reads replaced by the reference's result for the same
    container and, where it was applied several times, the application
    whose operands lie nearest the port's."""
    def replay(kind):
        def read(x, g, ref, ws, xcfg, **_):
            key = _g_key(kind, g.numpy())
            xs = x.numpy().reshape(-1, x.shape[-1])
            best = min(results[key], key=lambda r: np.abs(
                r[0].reshape(xs.shape) - xs).max())
            used.append((key, id(best)))
            return torch.from_numpy(best[1]).reshape(*x.shape[:-1], -1)
        return read
    monkeypatch.setattr(TT, "vmm", replay("vmm"))
    monkeypatch.setattr(TT, "mvm", replay("mvm"))


@contextlib.contextmanager
def recording_reference_tapes(tapes):
    """The tapes each container's write of a jitted reference step
    consumed, by path: ``(x_tape, d_tape)``."""
    update = JA.AnalogTrainStep._update_container

    def recorded(self, p, t, key, seed_base, path, rail):
        def store(x, d):
            tapes[path] = (np.array(x), np.array(d))
        jax.debug.callback(store, t["x_tape"], t["d_tape"])
        return update(self, p, t, key, seed_base, path, rail)
    JA.AnalogTrainStep._update_container = recorded
    try:
        yield
    finally:
        JA.AnalogTrainStep._update_container = update


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def remat_replays(init_params, stacks, keys, key=lambda k: k):
    """The replays a port step makes of the recorded reads ``keys`` (each
    ``(direction, conductance bytes)`` key, or an entry whose ``key`` is
    one, once per recorded application), sorted: each once, and under the
    port's per-layer remat (``models.transformer.remat_policy``, ``full``
    by default) the forward reads of the containers in the layer stacks
    ``stacks`` once more, by the backward's recompute of their blocks."""
    again = set()
    if TF.remat_policy() != "none":
        for path, g in _leaves(init_params):
            if path[0] in stacks and path[-1] == "g":
                again |= {_g_key("vmm", gi) for gi in g}
    keys = list(keys)
    return sorted(keys + [k for k in keys if key(k) in again])


def reference_step(arch, n_layers=None):
    """The reference's jitted device-mode step on the smoke config (TaOx,
    lr 0.1, 2 x 8 tokens): its init state, new state, loss, seed_base,
    every read's (x, y) by container and the tapes each write used."""
    kw = dict(TRAIN) if n_layers is None else dict(TRAIN, n_layers=n_layers)
    jcfg, cfg = _cfgs(arch=arch, **kw)
    state = JA.init_state(jax.random.PRNGKey(0), jcfg)
    init = _np(state)     # the jitted step donates the state's buffers
    ks = jax.random.split(jax.random.PRNGKey(1))[1]
    x, y = jsyn.batch_tokens(jsyn.make_token_stream(4096, cfg.vocab), 2, 8,
                             0)
    results, tapes = {}, {}
    with _env("REPRO_REMAT", "none"), recording_jitted(results), \
            recording_reference_tapes(tapes):
        new, mets = JA.make_analog_sgd_step(jcfg, lr=LR)(
            state, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}, ks)
        jax.block_until_ready(new)
    return {"cfg": cfg, "init": init, "new": _np(new),
            "loss": float(mets["loss"]), "x": x, "y": y,
            "seed_base": int(jax.random.bits(ks, (), jnp.uint32)),
            "reads": results, "tapes": tapes}


@contextlib.contextmanager
def recording_port_tapes(tapes):
    update = TA.AnalogTrainStep._update_container

    def recorded(self, p, t, seed_base, path, rail):
        tapes[path] = {k: v.numpy().copy() for k, v in t.items()}
        return update(self, p, t, seed_base, path, rail)
    TA.AnalogTrainStep._update_container = recorded
    try:
        yield
    finally:
        TA.AnalogTrainStep._update_container = update


def port_step_replayed(run, monkeypatch):
    """The port's step on the reference's init state and seed_base, every
    read replaced by the reference's; returns (state, metrics, tapes,
    replays used)."""
    used, tapes = [], {}
    replaying(monkeypatch, run["reads"], used)
    with recording_port_tapes(tapes):
        state, mets = TA.make_analog_sgd_step(run["cfg"], lr=LR)(
            params_from_numpy(run["init"], "cpu"),
            {"tokens": torch.from_numpy(run["x"]).long(),
             "labels": torch.from_numpy(run["y"]).long()},
            run["seed_base"])
    return state, mets, tapes, used


def tapes_agree(got, want, scale):
    """A tape against the reference's: within 1e-5 of its largest value,
    but for rows whose codes flipped by one step of their scale (the two
    packages' activations differ by float32 ulps), under 1% of the
    rows."""
    assert got.shape == want.shape
    err = np.abs(got - want)
    off = err > 1e-5 * max(np.abs(want).max(), 1e-30)
    if off.any():
        assert (err <= np.broadcast_to(scale, err.shape) * (1 + 1e-5)
                + 1e-7).all()
        assert off.any(axis=-1).mean() < 0.01


def check_step(run, state, mets, n_containers):
    """The port's step against the reference's: the loss within 1e-5,
    conductances within 1e-6 (moved), ``ref`` and ``w_scale`` bit-equal,
    each digital leaf's update within 1e-4 of its move."""
    assert abs(float(mets["loss"]) - run["loss"]) <= 1e-5
    seen = 0
    for path, want in _leaves(run["new"]["params"]):
        mine = _get(state["params"], path).numpy()
        g0 = _get(run["init"]["params"], path)
        if path[-1] in ("ref", "w_scale"):
            np.testing.assert_array_equal(mine, want)
        elif path[-1] == "g":
            seen += 1
            np.testing.assert_allclose(mine, want, rtol=0, atol=1e-6)
            assert np.abs(mine - g0).max() > 1e-3, path
        else:
            err = np.linalg.norm(mine - want) / max(
                np.linalg.norm(want - g0), 1e-30)
            assert err <= 1e-4, (path, err)
    assert seen == n_containers


def check_write_on_reference_tapes(run, path):
    """The port's write of the container at ``path`` fed the reference's
    tapes (float operands, so the FP32 class): within 4 float32 ulp of
    the reference's new conductances."""
    step = TA.make_analog_sgd_step(run["cfg"], lr=LR)
    p = params_from_numpy(_get(run["init"]["params"], path), "cpu")
    x_t, d_t = run["tapes"][path]
    tapes = {"x_tape": torch.from_numpy(x_t),
             "d_tape": torch.from_numpy(d_t)}
    with torch.no_grad():
        new = step._update_container(p, tapes, run["seed_base"], path, [])
    np.testing.assert_allclose(new["g"].numpy(),
                               _get(run["new"]["params"], path)["g"],
                               rtol=0, atol=ULP4)


@pytest.fixture(scope="module")
def ssm_step():
    return reference_step(ARCH)


def test_device_train_step_with_replayed_reads(ssm_step, monkeypatch):
    """One device-mode step against the reference's, every forward and
    transpose read of the port replaced by the reference's result for
    the same container (2 + 2 a layer; the forward reads once more under
    the port's remat)."""
    run = ssm_step
    cfg = run["cfg"]
    state, mets, _, used = port_step_replayed(run, monkeypatch)
    assert len(run["reads"]) == 2 * 2 * cfg.n_layers
    assert all(len(v) == 1 for v in run["reads"].values())
    assert sorted(k for k, _ in used) == remat_replays(
        run["init"]["params"], ("layers",), run["reads"])
    check_step(run, state, mets, 2)


def test_device_train_step_tapes_and_write(ssm_step, monkeypatch):
    """Each container's tapes (L, T, K) / (L, T, N) and code scales (L,)
    against the reference's tapes; each container's write fed the
    reference's tapes against the reference's conductances."""
    run = ssm_step
    cfg = run["cfg"]
    _, _, tapes, _ = port_step_replayed(run, monkeypatch)
    assert set(tapes) == set(run["tapes"]) == {
        ("layers", "ssm", "in_proj"), ("layers", "ssm", "out_proj")}
    for path, (x_want, d_want) in run["tapes"].items():
        t = tapes[path]
        lead = (cfg.n_layers,)
        assert t["x_tape_scale"].shape == t["d_tape_scale"].shape == lead
        assert x_want.shape[:2] == (cfg.n_layers, 16)
        tapes_agree(t["x_tape"], x_want, t["x_tape_scale"][:, None, None])
        tapes_agree(t["d_tape"], d_want, t["d_tape_scale"][:, None, None])
        check_write_on_reference_tapes(run, path)


# ----------------------------------------------------------- CLI

def test_serve_cli_runs_the_smoke_model_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", ARCH, "--smoke", "--backend", "analog",
                       "--analog-tile", "16", "--device", "cpu",
                       "--batch", "2", "--max-new", "3"])
    assert [len(o) for o in outs] == [3, 3]
    text = capsys.readouterr().out
    assert "analog/static" in text and "energy/token" in text
