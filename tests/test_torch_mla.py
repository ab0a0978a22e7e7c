"""MLA (DeepSeek-V2 multi-head latent attention) and deepseek-v2-lite-16b
in the port against the JAX package: ``layers.mla_attention`` in digital,
fakequant and device mode (no cache, a fresh prefill into a cache, a
one-token append and a chunked-prefill append at a fixed ``max_len``),
the absorbed decode (``REPRO_MLA_ABSORB``), the smoke model (64 experts
-> 8, top-2, and top-6 of 8) in the three modes, its latent cache and
the continuous engine, one device-mode training step, and
``ModelConfig.param_count``.

The reference initialises the smoke model at ``PRNGKey(0)`` (and
programs it for device mode); ``params_from_numpy`` carries the tree
across.  One module-scoped fixture records the reference's op-by-op
forwards and every device read (operands and result); the digital and
fakequant model forwards run jitted (they read nothing, and at this seed
the jitted forward flips no code).

Tolerances:
  * outputs, caches and logits: 1e-5 (rtol and atol; float32 products
    taken in another order);
  * each device read within 1e-6 of its largest output on the
    reference's own operands, except code flips within one lsb per K
    tile (``_one_lsb_per_k_tile``) on under 1% of the elements; logits
    with the reference's reads replayed within 1e-5;
  * the training step (the reference jitted) with its forward and
    transpose reads replayed: every conductance within 1e-6, ``ref`` and ``w_scale``
    bit-equal, the loss within 1e-5, every digital leaf's update within
    1e-4 of its move (2-norm).
"""
import contextlib
import dataclasses
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
from repro.configs.registry import ARCHS as J_ARCHS
from repro.data import synthetic as jsyn
from repro.hwmodel import arch_cost as JC
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import analog_lm as JA
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import analog_registry as treg
from repro_torch.core.tiled_analog import crossbar_from_model
from repro_torch.core.xbar_ops import vmm as torch_vmm
from repro_torch.hwmodel import arch_cost as TC
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.serve import SamplingParams, make_engine
from repro_torch.train import analog_lm as TA
from test_torch_forward_flips import _one_lsb_per_k_tile
from test_torch_ssm import remat_replays

ARCH = "deepseek-v2-lite-16b"
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
TOP_K = (2, 6)
LR = 0.1
MAX_LEN = 16
#: Crossbar reads of one MLA MoE layer: wq, wkv_a, wkv_b, wo, the shared
#: experts' w_upgate and w_down, the three expert stacks.
LAYER_READS = 9
ATTN_CASES = ("no_cache", "prefill", "append_one", "append_chunk")

_rng = np.random.default_rng(0)
TOKENS = _rng.integers(0, 256, (2, 8)).astype(np.int32)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


#: attention inputs: the prompt, one decode token, a 4-token chunk
X_PROMPT, X_ONE, X_CHUNK = _x((2, 8, 64), 1), _x((2, 1, 64), 2), \
    _x((2, 4, 64), 3)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _cfgs(mode="digital", **kw):
    kw = {**MODES[mode], **kw}
    return jax_config(ARCH, True).replace(**kw), \
        get_config(ARCH, True).replace(**kw)


@contextlib.contextmanager
def _env(name, value):
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


@contextlib.contextmanager
def _recording(reads):
    """Record the reference's forward reads, op by op, as numpy tuples
    ``(x, g, ref, w_scale, y)``."""
    vmm_any = JT._vmm_any

    def recorded(x, g, ref, ws, cfg, meta=None):
        y = vmm_any(x, g, ref, ws, cfg, meta)
        reads.append(tuple(np.array(a) for a in (x, g, ref, ws, y)))
        return y
    JT._vmm_any = recorded
    try:
        yield
    finally:
        JT._vmm_any = vmm_any


def _g_key(kind, g):
    """A read's key: its direction and its conductances' bytes (each
    container is read once forward and once transposed in a step)."""
    return kind, hashlib.sha1(np.ascontiguousarray(g).tobytes()).hexdigest()


@contextlib.contextmanager
def _recording_jitted(results):
    """Record, by :func:`_g_key`, the result of every forward and
    transpose read a jitted reference step makes (a host callback from
    inside the compiled step)."""
    vmm_any, mvm_any = JT._vmm_any, JT._mvm_any

    def recorded(kind, read):
        def store(g, y):
            results[_g_key(kind, np.asarray(g))] = np.array(y)

        def f(x, g, ref, ws, cfg, meta=None):
            y = read(x, g, ref, ws, cfg, meta)
            jax.debug.callback(store, g, y)
            return y
        return f
    JT._vmm_any, JT._mvm_any = recorded("vmm", vmm_any), \
        recorded("mvm", mvm_any)
    try:
        yield
    finally:
        JT._vmm_any, JT._mvm_any = vmm_any, mvm_any


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"]["attn"])


def _port_layer0(tree):
    return {k: {leaf: v[0] for leaf, v in proj.items()}
            for k, proj in tree["layers"]["attn"].items()}


def _j_attention_cases(p, jcfg):
    """The reference's ``mla_attention`` on the four cache cases: outputs
    and the caches they leave."""
    out = {}
    y, _ = JL.mla_attention(p, jnp.asarray(X_PROMPT), jcfg)
    out["no_cache"] = (y, None)
    y, c1 = JL.mla_attention(p, jnp.asarray(X_PROMPT), jcfg,
                             cache=JL.make_mla_cache(jcfg, 2, MAX_LEN))
    out["prefill"] = (y, c1)
    out["append_one"] = JL.mla_attention(
        p, jnp.asarray(X_ONE), jcfg, positions=c1["len"][:, None], cache=c1)
    out["append_chunk"] = JL.mla_attention(
        p, jnp.asarray(X_CHUNK), jcfg,
        positions=c1["len"][:, None] + jnp.arange(4)[None, :], cache=c1)
    return out


def _j_attention_jitted(p, jcfg):
    """:func:`_j_attention_cases` jitted (a fresh trace, so it reads
    ``REPRO_MLA_ABSORB`` as set now)."""
    return jax.jit(lambda q: _j_attention_cases(q, jcfg))(p)


@pytest.fixture(scope="module")
def reference():
    """Per mode: the reference's smoke tree at PRNGKey(0), its attention
    cases on layer 0 (each with the device reads it made), the absorbed
    decode (digital and fakequant) and the model's logits at top-2 and
    top-6, with every device read of the top-2 forward."""
    out = {}
    params = JM.init_params(jax.random.PRNGKey(0), _cfgs()[0])
    for mode in MODES:
        jcfg = _cfgs(mode)[0]
        tree = JM.program_digital(params, jcfg) if mode == "device" \
            else params
        run = {"params": _np(tree), "reads": {}}
        p0 = _layer0(tree)
        with _env("REPRO_MLA_ABSORB", None), _env("REPRO_REMAT", "none"):
            reads = []
            if mode == "device":
                with _recording(reads), jax.disable_jit():
                    run["attention"] = _np(_j_attention_cases(p0, jcfg))
            else:
                run["attention"] = _np(_j_attention_jitted(p0, jcfg))
                with _env("REPRO_MLA_ABSORB", "1"):
                    run["absorbed"] = _np(_j_attention_jitted(p0, jcfg))
            run["attention_reads"] = reads
            for top_k in TOP_K:
                kcfg = jcfg.replace(top_k=top_k)
                reads = []
                ctx = jax.disable_jit() if mode == "device" \
                    else contextlib.nullcontext()
                with _recording(reads), ctx:
                    logits = JM.forward(
                        tree, {"tokens": jnp.asarray(TOKENS)}, kcfg)[0]
                run[f"logits_top{top_k}"] = np.array(logits)
                run["reads"][top_k] = reads
        out[mode] = run
    return out


def _t_attention_cases(p, cfg):
    """The port's ``mla_attention`` on the four cache cases (the caches
    are updated in place, so each append starts from a copy of the
    prefilled one)."""
    out = {}
    t = torch.from_numpy
    with torch.no_grad():
        y, _ = TL.mla_attention(p, t(X_PROMPT), cfg)
        out["no_cache"] = (y.numpy(), None)
        y, c1 = TL.mla_attention(p, t(X_PROMPT), cfg,
                                 cache=TL.make_mla_cache(cfg, 2, MAX_LEN))
        out["prefill"] = (y.numpy(), {k: v.numpy().copy()
                                      for k, v in c1.items()})
        for case, x in (("append_one", X_ONE), ("append_chunk", X_CHUNK)):
            c = {k: v.clone() for k, v in c1.items()}
            pos = c["len"][:, None].long() + torch.arange(x.shape[1])
            y, c = TL.mla_attention(p, t(x), cfg, positions=pos, cache=c)
            out[case] = (y.numpy(), {k: v.numpy() for k, v in c.items()})
    return out


def _recording_port(monkeypatch, replay=None):
    """Record the port's forward reads; with ``replay``, each read returns
    the given result instead."""
    mine = []

    def recorded(x, g, ref, ws, xcfg, **kw):
        y = torch_vmm(x, g, ref, ws, xcfg, **kw)
        mine.append(y.numpy().copy())
        return torch.from_numpy(replay[len(mine) - 1]) if replay else y
    monkeypatch.setattr(TT, "vmm", recorded)
    return mine


def _check_reads_on_reference_operands(reads, xcfg):
    """Each reference read, fed to the port on its own operands: within
    1e-6 of its largest output, or a code flip within one lsb per K tile
    on under 1% of the elements."""
    for i, (x, g, ref, ws, out) in enumerate(reads):
        ops = [torch.from_numpy(a) for a in (x, g, ref, ws)]
        err = np.abs(torch_vmm(*ops, xcfg).numpy() - out)
        off = err > 1e-6 * np.abs(out).max()
        if off.any():
            assert (err <= _one_lsb_per_k_tile(*ops, xcfg) + 1e-6).all(), i
            assert off.mean() < 0.01, i


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ configs

def test_mla_config_fields_and_smoke_match_reference():
    for smoke in (False, True):
        got, want = get_config(ARCH, smoke), jax_config(ARCH, smoke)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    smoke = get_config(ARCH, True)
    assert (smoke.use_mla, smoke.kv_lora_rank, smoke.qk_rope_dim,
            smoke.qk_nope_dim, smoke.v_head_dim) == (True, 32, 8, 16, 16)
    assert ARCH in ARCHS
    full = get_config(ARCH)
    assert treg.expert_capacity(4, full) == 8
    assert treg.expert_capacity(8 * 256, full) == 240


@pytest.mark.parametrize("active_only", [False, True])
def test_param_count_matches_reference(active_only):
    """``param_count`` of every config, full and smoke, equals the
    reference's (the port carries the whole registry)."""
    for arch in ARCHS:
        for smoke in (False, True):
            assert get_config(arch, smoke).param_count(active_only) == \
                jax_config(arch, smoke).param_count(active_only), arch
    full = get_config(ARCH)
    assert full.param_count(active_only) == \
        (2663120896 if active_only else 16210198528)
    assert sorted(ARCHS) == sorted(J_ARCHS)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("mode", list(MODES))
def test_mla_attention_matches_reference(mode, case, reference,
                                         monkeypatch):
    """``mla_attention`` on layer 0's weights, each cache case, against
    the reference's: the output and the cache within 1e-5; in device mode
    every read agrees on the reference's own operands, and in append mode
    ``wkv_b`` reads all B x max_len rows of the cache."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    p = _port_layer0(params_from_numpy(run["params"], "cpu"))
    mine = _recording_port(monkeypatch)
    with _env("REPRO_MLA_ABSORB", None):
        got = _t_attention_cases(p, cfg)
    y, cache = got[case]
    want_y, want_cache = run["attention"][case]
    _close(y, want_y)
    if want_cache is not None:
        for key in ("c_kv", "k_rope"):
            _close(cache[key], want_cache[key])
        np.testing.assert_array_equal(cache["len"], want_cache["len"])
    if mode == "device":
        reads = run["attention_reads"]
        assert len(mine) == len(reads) == 4 * len(ATTN_CASES)
        # wkv_b is each case's third read: B x S rows of the latent
        rows = [r[0].shape[0] for r in reads[2::4]]
        assert rows == [2 * 8, 2 * 8, 2 * MAX_LEN, 2 * MAX_LEN]
        _check_reads_on_reference_operands(reads, crossbar_from_model(cfg))


@pytest.mark.parametrize("mode", ["digital", "fakequant", "device"])
def test_absorbed_decode_matches_reference(mode, reference, monkeypatch):
    """``REPRO_MLA_ABSORB`` set: in digital and fakequant mode the
    one-token append runs in the latent space, reading ``wkv_b``'s
    weights directly, within 1e-5 of the reference's absorbed decode (in
    fakequant mode it differs from the expanded decode, which reads
    ``wkv_b`` through the fakequant read); the other cases are unchanged.
    In device mode ``wkv_b`` has no ``"w"`` leaf and the variable changes
    nothing."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    p = _port_layer0(params_from_numpy(run["params"], "cpu"))
    monkeypatch.setenv("REPRO_MLA_ABSORB", "1")
    got = _t_attention_cases(p, cfg)
    want = run["attention"] if mode == "device" else run["absorbed"]
    for case in ATTN_CASES:
        _close(got[case][0], want[case][0])
    if mode == "fakequant":
        expanded = run["attention"]["append_one"][0]
        assert np.abs(got["append_one"][0] - expanded).max() > 1e-4


# ------------------------------------------------------------------ model

def _port_logits(run, cfg, monkeypatch, replay=None):
    mine = _recording_port(monkeypatch, replay)
    with torch.no_grad():
        logits = M.forward(params_from_numpy(run["params"], "cpu"),
                           {"tokens": torch.from_numpy(TOKENS).long()},
                           cfg)[0].numpy()
    return logits, mine


@pytest.mark.parametrize("top_k", TOP_K)
@pytest.mark.parametrize("mode", list(MODES))
def test_smoke_logits_match_reference(mode, top_k, reference, monkeypatch):
    """The deepseek smoke model's logits (8 experts, top-2 and top-6) in
    each mode against the reference's, within 1e-5; device mode reads 9
    containers a layer and each read agrees on the reference's own
    operands."""
    run = reference[mode]
    cfg = _cfgs(mode, top_k=top_k)[1]
    logits, mine = _port_logits(run, cfg, monkeypatch)
    reads = run["reads"][top_k]
    assert len(mine) == len(reads) \
        == (LAYER_READS * cfg.n_layers if mode == "device" else 0)
    _close(logits, run[f"logits_top{top_k}"])
    if mode == "device":
        _check_reads_on_reference_operands(reads, crossbar_from_model(cfg))


def test_smoke_device_logits_with_replayed_reads(reference, monkeypatch):
    run = reference["device"]
    cfg = _cfgs("device")[1]
    replay = [r[4] for r in run["reads"][2]]
    logits, _ = _port_logits(run, cfg, monkeypatch, replay=replay)
    _close(logits, run["logits_top2"])


def test_params_from_numpy_carries_the_mla_tree(reference):
    """The programmed MLA tree crosses leaf for leaf; the port programs
    the digital tree onto the same containers (1e-6) and reads it back;
    ``kv_norm`` stays digital."""
    tree = reference["device"]["params"]
    tp = params_from_numpy(tree, "cpu")
    attn = tp["layers"]["attn"]
    assert set(attn) == {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert attn["wkv_b"]["g"].shape == (2, 32, 4 * (16 + 16))
    assert attn["wkv_a"]["g"].shape == (2, 64, 32 + 8)
    assert set(attn["kv_norm"]) == {"scale"}
    for key in ("wq", "wkv_a", "wkv_b", "wo"):
        for leaf in ("g", "ref", "w_scale"):
            np.testing.assert_array_equal(
                attn[key][leaf].numpy(), tree["layers"]["attn"][key][leaf])
    cfg = _cfgs("device")[1]
    digital = params_from_numpy(reference["digital"]["params"], "cpu")
    ported = M.program_digital(digital, cfg)["layers"]["attn"]
    for key in ("wq", "wkv_a", "wkv_b", "wo"):
        for leaf in ("g", "ref", "w_scale"):
            torch.testing.assert_close(ported[key][leaf], attn[key][leaf],
                                       rtol=1e-6, atol=1e-6)
    back = M.readout_digital(tp, cfg)["layers"]["attn"]
    assert set(back["wkv_b"]) == {"w"}
    torch.testing.assert_close(back["wkv_b"]["w"],
                               digital["layers"]["attn"]["wkv_b"]["w"],
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ serving

def test_init_cache_and_batch_axes_match_reference():
    jcfg, cfg = _cfgs()
    got = M.init_cache(cfg, 3, MAX_LEN, "cpu")
    want = JM.init_cache(jcfg, 3, MAX_LEN)
    assert got[1] is None and want[1] is None
    assert {k: tuple(v.shape) for k, v in got[0].items()} == \
        {k: tuple(v.shape) for k, v in want[0].items()} == {
            "c_kv": (2, 3, MAX_LEN, 32), "k_rope": (2, 3, MAX_LEN, 8),
            "len": (2, 3)}
    assert {k: v.dtype for k, v in got[0].items()} == {
        "c_kv": torch.float32, "k_rope": torch.float32, "len": torch.int32}
    axes = M.cache_batch_axes(cfg, MAX_LEN)
    j_axes = JM.cache_batch_axes(jcfg, MAX_LEN)
    assert axes == {(0, k): j_axes[0][k] for k in ("c_kv", "k_rope", "len")}
    # a row inserted at slot 1, then reset
    big = M.init_cache(cfg, 3, MAX_LEN, "cpu")
    row = M.init_cache(cfg, 1, MAX_LEN, "cpu")
    for v in row[0].values():
        v.fill_(7)
    M.cache_insert(big, row, 1, axes)
    assert all(bool((v[:, 1] == 7).all()) and not v[:, [0, 2]].any()
               for v in big[0].values())
    M.cache_reset_row(big, 1, axes)
    assert not any(v.any() for v in big[0].values())


def test_continuous_engine_matches_static_decode():
    """Greedy tokens of the continuous engine (4 slots, prefill chunk 4,
    ragged prompts, so padded final chunks) equal the port's static
    prefill + decode of each prompt alone (digital, float32)."""
    _, cfg = _cfgs()
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(0, cfg.vocab, n)) for n in (5, 7, 9, 3)]
    eng = make_engine(cfg, params, n_slots=4, prefill_chunk=4,
                      max_len=32)
    got = eng.generate(prompts, SamplingParams(max_new_tokens=6))
    want = []
    with torch.no_grad():
        for prompt in prompts:
            logits, cache = M.prefill(
                params, {"tokens": torch.tensor([prompt])}, cfg, 32)
            toks = [int(logits.argmax(-1))]
            for _ in range(5):
                logits, cache = M.decode_step(
                    params, cache, torch.tensor([toks[-1]]), cfg)
                toks.append(int(logits.argmax(-1)))
            want.append(toks)
    assert got == want
    assert eng.stream.metrics["prefill_chunks"] == 2 + 2 + 3 + 1


# ----------------------------------------------------------------- training

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


def test_device_train_step_with_replayed_reads(monkeypatch):
    """One device-mode step (TaOx, lr 0.1, 2 x 8 tokens, capacity 8)
    against the reference's step with its seed_base, every forward and
    transpose read of the port replaced by the reference's result for the
    same container (9 + 9 a layer, the forward reads once more under the
    port's remat): conductances within 1e-6, ``ref`` and
    ``w_scale`` bit-equal, the loss within 1e-5, each digital leaf's
    update within 1e-4 of its move.  With the reads replayed the port
    follows the reference's codes, so the reference runs jitted."""
    jcfg, cfg = _cfgs(**TRAIN)
    state = JA.init_state(jax.random.PRNGKey(0), jcfg)
    init = _np(state)
    ks = jax.random.split(jax.random.PRNGKey(1))[1]
    x, y = jsyn.batch_tokens(jsyn.make_token_stream(4096, cfg.vocab), 2, 8,
                             0)
    results = {}
    with _env("REPRO_REMAT", "none"), _recording_jitted(results):
        new, mets = JA.make_analog_sgd_step(jcfg, lr=LR)(
            state, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}, ks)
        jax.block_until_ready(new)
    assert len(results) == 2 * LAYER_READS * cfg.n_layers
    used = []

    def replay(kind):
        def read(x_, g, ref, ws, xcfg, **_):
            key = _g_key(kind, g.numpy())
            used.append(key)
            return torch.from_numpy(results[key])
        return read
    monkeypatch.setattr(TT, "vmm", replay("vmm"))
    monkeypatch.setattr(TT, "mvm", replay("mvm"))
    got_state, got = TA.make_analog_sgd_step(cfg, lr=LR)(
        params_from_numpy(init, "cpu"),
        {"tokens": torch.from_numpy(x).long(),
         "labels": torch.from_numpy(y).long()},
        int(jax.random.bits(ks, (), jnp.uint32)))
    assert sorted(used) == remat_replays(init["params"], ("layers",), results)
    assert abs(float(got["loss"]) - float(mets["loss"])) <= 1e-5
    n_containers = 0
    for path, want in _leaves(_np(new["params"])):
        mine = _get(got_state["params"], path).numpy()
        g0 = _get(init["params"], path)
        if path[-1] in ("ref", "w_scale"):
            np.testing.assert_array_equal(mine, want)
        elif path[-1] == "g":
            n_containers += 1
            np.testing.assert_allclose(mine, want, rtol=0, atol=1e-6)
            assert np.abs(mine - g0).max() > 1e-3, path
        else:
            err = np.linalg.norm(mine - want) / max(
                np.linalg.norm(want - g0), 1e-30)
            assert err <= 1e-4, (path, err)
    assert n_containers == LAYER_READS


# ------------------------------------------------------------------ hwmodel

def test_mla_model_projections_match_reference():
    """The hwmodel inventory of deepseek-v2-lite-16b at full size: the MLA
    projections and the 64-expert stacks (active 6 / 64)."""
    got = {p.name: dataclasses.astuple(p)
           for p in TC.model_projections(get_config(ARCH))}
    want = {p.name: dataclasses.astuple(p)
            for p in JC.model_projections(jax_config(ARCH))}
    assert got == want
    assert got["layers/attn/wkv_b"][1:3] == (512, 16 * 256)
    assert got["layers/moe/experts/w_up"][3:] == (27 * 64, 6 / 64)
