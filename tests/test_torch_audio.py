"""The audio encoder-decoder family (whisper) in the port against the JAX
package: the whisper-medium smoke config (2 encoder + 2 decoder layers,
32 frames, GELU, not gated) — the encoder's non-causal, rope-free
attention in digital, fakequant and device mode, ``audio_encode``, the
cached decoder (``prefill`` fills each layer's cross keys and values
through ONE read of the fused ``wqkv`` over the tokens and the encoder
output; decode steps read them from the cache and no encoder
container), the model in the three modes, its caches, static serving
with the frames as ``extras``, the tapes' rows (the encoder's the
frames, the cross ``wqkv``'s both streams) and one device-mode training
step.

Inputs and machinery as in ``tests/test_torch_vlm.py``: params from the
reference at ``PRNGKey(0)`` carried across with
``convert.params_from_numpy``, the frames numpy normals from a seed, one
module-scoped fixture with the reference's op-by-op forward per mode.

Tolerances: as ``tests/test_torch_vlm.py`` (outputs, caches and logits
1e-5; device reads on the reference's own operands within 1e-6 or a
one-lsb-per-K-tile flip on under 1% of the elements; the training step
as mamba2's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import analog_registry as jreg
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
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models import transformer as TF
from repro_torch.serve import SamplingParams, make_engine
from repro_torch.serve.engine import ContinuousEngine
from test_torch_ssm import (MODES, TOKENS, TRAIN, _close, _get, _np,
                            check_reads_on_reference_operands, check_step,
                            recording_reference, remat_replays)
from test_torch_vlm import (check_fq_reads_with_flips, check_mode,
                            check_tapes, port_forward, port_reads,
                            port_step_replayed, reference_forward,
                            reference_step, train_batch)

ARCH = "whisper-medium"
MAX_LEN = 16
N_FRAMES = 32
ENC = (("enc_layers", "attn", "wqkv"), ("enc_layers", "attn", "wo"),
       ("enc_layers", "ffn", "w_up"), ("enc_layers", "ffn", "w_down"))
DEC = (("dec_layers", "attn", "wqkv"), ("dec_layers", "attn", "wo"),
       ("dec_layers", "xattn", "wqkv"), ("dec_layers", "xattn", "wo"),
       ("dec_layers", "ffn", "w_up"), ("dec_layers", "ffn", "w_down"))
XQKV = DEC[2]
#: Crossbar reads of a model call with the encoder (4 a layer there, 6 a
#: decoder layer) and of a decode step (the decoder's only).
READS_PER_CALL = 4 * 2 + 6 * 2
DECODE_READS = 6 * 2

AUDIO = np.random.default_rng(8).standard_normal((2, N_FRAMES, 64)) \
    .astype(np.float32)


def _cfgs(mode="digital", **kw):
    kw = {**MODES[mode], **kw}
    return jax_config(ARCH, True).replace(**kw), \
        get_config(ARCH, True).replace(**kw)


def _batch():
    return {"tokens": TOKENS, "audio": AUDIO}


def _rows_of(path, b=2, s=8):
    """Operand rows of one application at the smoke config's (b, s)."""
    if path[0] == "enc_layers":
        return b * N_FRAMES
    return b * s + b * N_FRAMES if path == XQKV else b * s


# ------------------------------------------------------------------ configs

def test_config_fields_and_smoke_match_reference():
    """Full and smoke fields as the reference's; the smoke keeps 2
    encoder layers and 32 frames."""
    for smoke in (False, True):
        got, want = get_config(ARCH, smoke), jax_config(ARCH, smoke)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    got = get_config(ARCH, True)
    assert (got.n_layers, got.n_encoder_layers, got.n_audio_frames,
            got.has_encoder) == (2, 2, N_FRAMES, True)
    full = get_config(ARCH)
    assert (full.n_layers, full.n_encoder_layers, full.n_audio_frames,
            full.vocab) == (24, 24, 1500, 51872)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def reference():
    """Per mode: the reference's smoke tree at PRNGKey(0), its op-by-op
    logits of ``TOKENS`` with ``AUDIO`` and every read; encoder layer 0's
    attention on the frames (non-causal, rope-free) with its reads; in
    digital mode ``audio_encode``."""
    params = _np(JM.init_params(jax.random.PRNGKey(0), _cfgs()[0]))
    out = {}
    for mode in MODES:
        jcfg = _cfgs(mode)[0]
        run = reference_forward(jcfg, params, mode, _batch())
        run["digital_logits"] = out["digital"]["logits"] if out else None
        tree = jax.tree.map(jnp.asarray, run["params"])
        attn0 = jax.tree.map(lambda a: a[0], tree["enc_layers"]["attn"])
        reads, fq_reads = [], []
        with recording_reference(reads, fq_reads), jax.disable_jit():
            y, _ = JL.attention(attn0, jnp.asarray(AUDIO), jcfg,
                                causal=False, use_rope=False)
        run["enc_attention"] = (np.array(y), reads, fq_reads)
        if mode == "digital":
            run["encode"] = np.array(jax.jit(
                lambda p, f: JTF.audio_encode(p, f, jcfg))(
                    tree, jnp.asarray(AUDIO)))
        out[mode] = run
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_attention_matches_reference(mode, reference, monkeypatch):
    """Encoder layer 0's self-attention over the frames, without a causal
    mask or rope: within 1e-5; in the analog modes one ``wqkv`` and one
    ``wo`` read over B x 32 rows, each reference read on its own
    operands."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    p = TF.tree_index(params_from_numpy(run["params"], "cpu")
                      ["enc_layers"], 0)["attn"]
    mine, rows = port_reads(monkeypatch)
    with torch.no_grad():
        y, _ = TL.attention(p, torch.from_numpy(AUDIO), cfg, causal=False,
                            use_rope=False)
    want, reads, fq_reads = run["enc_attention"]
    _close(y.numpy(), want)
    assert len(mine) == (0 if mode == "digital" else 2)
    if mode == "device":
        assert [r for r, _ in rows] == [2 * N_FRAMES] * 2
        check_reads_on_reference_operands(reads, crossbar_from_model(cfg))
    if mode == "fakequant":
        check_fq_reads_with_flips(fq_reads, cfg)
    with torch.no_grad():
        causal, _ = TL.attention(p, torch.from_numpy(AUDIO), cfg)
    assert np.abs(causal.numpy() - want).max() > 1e-3


def test_audio_encode_matches_reference(reference):
    """``enc_pos`` added to the frames, the encoder stack, ``enc_ln``."""
    cfg = _cfgs()[1]
    with torch.no_grad():
        enc = TF.audio_encode(params_from_numpy(
            reference["digital"]["params"], "cpu"),
            torch.from_numpy(AUDIO), cfg)
    assert enc.shape == (2, N_FRAMES, 64)
    _close(enc.numpy(), reference["digital"]["encode"])


@pytest.mark.parametrize("mode", list(MODES))
def test_smoke_logits_match_reference(mode, reference, monkeypatch):
    """The smoke model's logits of ``TOKENS`` with the frames in each
    mode, free-running, within 1e-5: 20 reads a call in the analog
    modes, the encoder's over B x 32 rows, each cross ``wqkv``'s over B
    x (8 + 32)."""
    run = reference[mode]
    cfg = _cfgs(mode)[1]
    logits, mine, rows = port_forward(run, cfg, _batch(), monkeypatch)
    check_mode(run, cfg, mode, logits, mine, READS_PER_CALL)
    if mode == "device":
        assert sorted(r for r, _ in rows) == sorted(
            [2 * N_FRAMES] * 8 + [2 * (8 + N_FRAMES)] * 2 + [2 * 8] * 10)


@pytest.mark.parametrize("mode", ["fakequant", "device"])
def test_smoke_logits_with_replayed_reads(mode, reference, monkeypatch):
    run = reference[mode]
    logits, _, _ = port_forward(
        run, _cfgs(mode)[1], _batch(), monkeypatch,
        replay="reads" if mode == "device" else "fq_reads")
    _close(logits, run["logits"])


def test_params_from_numpy_carries_the_audio_tree(reference):
    """The programmed tree crosses leaf for leaf; ``enc_pos`` stays on the
    digital core; the port programs the digital tree onto the same
    containers."""
    tp = params_from_numpy(reference["device"]["params"], "cpu")
    cfg = _cfgs("device")[1]
    assert set(tp) == {"embed", "enc_pos", "enc_layers", "enc_ln",
                       "dec_layers", "final_ln", "lm_head"}
    assert tp["enc_pos"].shape == (N_FRAMES, 64)
    assert set(tp["dec_layers"]) == {"ln1", "attn", "lnx", "xattn", "ln2",
                                     "ffn"}
    assert tp["dec_layers"]["xattn"]["wqkv"]["g"].shape == (2, 64, 3 * 64)
    assert set(treg.container_paths(tp)) == set(ENC) | set(DEC)
    treg.validate_device_params(tp, cfg)
    digital = params_from_numpy(reference["digital"]["params"], "cpu")
    ported = M.program_digital(digital, cfg)
    assert torch.equal(ported["enc_pos"], digital["enc_pos"])
    for path in ENC + DEC:
        for leaf in ("g", "ref", "w_scale"):
            torch.testing.assert_close(_get(ported, path)[leaf],
                                       _get(tp, path)[leaf], rtol=1e-6,
                                       atol=1e-6)


# ------------------------------------------------------------------ serving

def test_init_cache_and_lens_match_reference():
    """``{"self": K/V, "ck", "cv"}`` stacked (L, B, ...), the cross K/V
    over the frames; batch axes and ``cache_lens`` as the reference's."""
    jcfg, cfg = _cfgs()
    got = M.init_cache(cfg, 3, MAX_LEN, "cpu")
    want = JM.init_cache(jcfg, 3, MAX_LEN)
    assert got[1] is None and want[1] is None

    def shapes(c):
        return {"ck": tuple(c["ck"].shape), "cv": tuple(c["cv"].shape),
                **{k: tuple(v.shape) for k, v in c["self"].items()}}
    assert shapes(got[0]) == shapes(want[0]) == {
        "ck": (2, 3, N_FRAMES, 4, 16), "cv": (2, 3, N_FRAMES, 4, 16),
        "k": (2, 3, MAX_LEN, 4, 16), "v": (2, 3, MAX_LEN, 4, 16),
        "len": (2, 3)}
    axes = M.cache_batch_axes(cfg, MAX_LEN)
    j_axes = JM.cache_batch_axes(jcfg, MAX_LEN)
    assert axes == {(0, "ck"): j_axes[0]["ck"], (0, "cv"): j_axes[0]["cv"],
                    **{(0, "self", k): j_axes[0]["self"][k]
                       for k in ("k", "v", "len")}}
    got[0]["self"]["len"].fill_(6)
    assert M.cache_lens(got, cfg).tolist() == [6] * 3


def test_prefill_and_decode_match_reference(reference, monkeypatch):
    """``prefill`` with the frames, then 3 decode steps fed the
    reference's greedy tokens: the logits, the self caches and the cross
    ``ck`` / ``cv`` within 1e-5.  A decode step does not run the encoder:
    in device mode it reads the decoder's 12 containers over B rows, the
    cross ``wqkv`` included, and no encoder container."""
    jcfg, cfg = _cfgs()
    jp = reference["digital"]["params"]
    tp = params_from_numpy(jp, "cpu")
    ex, tex = {"audio": jnp.asarray(AUDIO)}, \
        {"audio": torch.from_numpy(AUDIO)}
    j_pre = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t, **ex}, jcfg,
                                            MAX_LEN))
    j_dec = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg, ex))
    lj, cj = j_pre(jp, jnp.asarray(TOKENS))
    encodes = []
    encode = TF.audio_encode
    monkeypatch.setattr(TF, "audio_encode",
                        lambda *a: encodes.append(1) or encode(*a))
    with torch.no_grad():
        lt, ct = M.prefill(tp, {"tokens": torch.from_numpy(TOKENS).long(),
                                **tex}, cfg, MAX_LEN)
        _close(lt.numpy(), np.array(lj))
        for k in ("ck", "cv"):
            _close(ct[0][k].numpy(), np.array(cj[0][k]))
        assert ct[0]["ck"].abs().max() > 0
        for i in range(3):
            assert M.cache_lens(ct, cfg).tolist() == [8 + i] * 2
            tok = jnp.argmax(lj, axis=-1)
            lj, cj = j_dec(jp, cj, tok)
            lt, ct = M.decode_step(tp, ct, torch.from_numpy(
                np.array(tok)).long(), cfg, tex)
            _close(lt.numpy(), np.array(lj))
    assert len(encodes) == 1
    for k in ("ck", "cv"):
        _close(ct[0][k].numpy(), np.array(cj[0][k]))
    for k in ("k", "v", "len"):
        _close(ct[0]["self"][k].numpy(), np.array(cj[0]["self"][k]))
    dcfg = _cfgs("device")[1]
    dp = params_from_numpy(reference["device"]["params"], "cpu")
    with torch.no_grad():
        _, cache = M.prefill(dp, {"tokens": torch.from_numpy(TOKENS).long(),
                                  **tex}, dcfg, MAX_LEN)
        _, rows = port_reads(monkeypatch)
        M.decode_step(dp, cache, torch.zeros(2, dtype=torch.long), dcfg,
                      tex)
    enc_g = [_get(dp, p)["g"][i] for p in ENC for i in range(2)]
    assert [r for r, _ in rows] == [2] * DECODE_READS
    assert not any(torch.equal(g, e) for _, g in rows for e in enc_g)


def test_static_engine_with_extras_matches_reference(reference):
    """Ragged prompts with the frames as ``extras``: greedy tokens equal
    the reference engine's (static scheduler)."""
    jcfg, cfg = _cfgs()
    jp = reference["digital"]["params"]
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(0, cfg.vocab, n)))
               for n in (4, 7)]
    eng = make_engine(cfg, params_from_numpy(jp, "cpu"), max_len=32,
                      extras={"audio": torch.from_numpy(AUDIO)})
    assert not eng.supports_continuous
    got = eng.generate(prompts, SamplingParams(max_new_tokens=4))
    want = j_make_engine(jcfg, jp, max_len=32,
                         extras={"audio": jnp.asarray(AUDIO)}).generate(
        prompts, JSP(max_new_tokens=4))
    assert got == want
    with pytest.raises(ValueError, match="static engine"):
        ContinuousEngine(cfg, eng.params)


# ------------------------------------------------------------------ tapes

@pytest.mark.parametrize("full", [False, True])
def test_tape_lead_and_operand_rows_match_reference(full):
    """Every container's operand rows and tape slots as the reference's:
    the encoder's b x n_audio_frames (4 x 1500 = 6000 at full size), the
    cross ``wqkv``'s b x s + b x n_audio_frames, the rest b x s."""
    cfg = get_config(ARCH, not full)
    jcfg = jax_config(ARCH, not full)
    b, s = (4, 128) if full else (2, 8)
    frames = cfg.n_audio_frames
    for path in ENC + DEC:
        want = b * frames if path[0] == "enc_layers" else \
            b * s + b * frames if path == XQKV else b * s
        assert treg.operand_rows(path, cfg, b * s, (b, s)) == \
            jreg.operand_rows(path, jcfg, b * s, (b, s)) == want
        assert treg.tape_lead(path, cfg, b * s, (b, s)) == \
            jreg.tape_lead(path, jcfg, b * s, (b, s)) == (want,)
    if full:
        assert treg.operand_rows(ENC[0], cfg, 512, (4, 128)) == 6000
        assert treg.operand_rows(XQKV, cfg, 512, (4, 128)) == 6512


# ------------------------------------------------------------------ training

@pytest.fixture(scope="module")
def audio_step():
    jcfg, cfg = _cfgs(**TRAIN)
    init = _np(JA.init_state(jax.random.PRNGKey(0), jcfg))
    return reference_step(jcfg, cfg, init,
                          {**train_batch(cfg.vocab, 2, 8), "audio": AUDIO})


def test_device_train_step_with_replayed_reads(audio_step, monkeypatch):
    """One device-mode step against the reference's, every forward and
    transpose read replaced by the reference's result for the same
    container (10 containers, each read once each way a layer, forward
    once more under the port's remat): conductances within 1e-6, ``ref``
    and ``w_scale`` bit-equal, the loss within 1e-5, ``enc_pos`` and the
    other digital leaves within 1e-4 of their moves."""
    run = audio_step
    state, mets, _, used = port_step_replayed(run, monkeypatch)
    assert len(run["reads"]) == 2 * READS_PER_CALL
    assert all(len(v) == 1 for v in run["reads"].values())
    assert sorted(k for k, _ in used) == remat_replays(
        run["init"]["params"], ("enc_layers", "dec_layers"), run["reads"])
    check_step(run, state, mets, 10)
    assert np.abs(state["params"]["enc_pos"].numpy()
                  - run["init"]["params"]["enc_pos"]).max() > 0


def test_device_train_step_tapes(audio_step, monkeypatch):
    """The encoder's tapes take B x 32 frame rows a layer, each cross
    ``wqkv`` exactly one tape a layer of B x 8 + B x 32 rows, the rest B
    x 8; every tape agrees with the reference's."""
    run = audio_step
    _, _, tapes, _ = port_step_replayed(run, monkeypatch)
    assert set(tapes) == set(ENC) | set(DEC)
    assert tapes[XQKV]["x_tape"].shape == (2, 2 * (8 + N_FRAMES), 64)
    assert tapes[ENC[2]]["d_tape"].shape == (2, 2 * N_FRAMES, 128)
    check_tapes(run, tapes, _rows_of)


# ------------------------------------------------------------------ CLI

def test_serve_cli_runs_the_smoke_model_on_the_cpu(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", ARCH, "--smoke", "--backend", "analog",
                       "--analog-tile", "16", "--device", "cpu",
                       "--batch", "2", "--max-new", "3"])
    assert [len(o) for o in outs] == [3, 3]
    text = capsys.readouterr().out
    assert "analog/static" in text and "energy/token" in text
