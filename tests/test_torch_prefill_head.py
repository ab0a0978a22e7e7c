"""The prefill head: ``models.model.prefill`` applies the final norm and
the head to the last position alone (B rows, not B x S), against the
reference's ``prefill``, which forms every position's logits and keeps
the last.  The head and its norm act per position, so the logits are the
same function: held in the forward's class
(``tests/test_torch_serve.py``: 1e-5, the reference op by op where the
model is analog, jitted where it is float32 digital).  ``prefill_chunk``
still returns the whole chunk's logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import transformer as TF

MODES = {
    "digital_f32": dict(dtype="float32"),
    "device": dict(dtype="float32", analog=True, analog_mode="device",
                   analog_device="taox-nonoise", analog_rows=16,
                   analog_cols=16),
    "fakequant": dict(dtype="float32", analog=True,
                      analog_mode="fakequant", analog_rows=16),
}
CASES = [("lm100m", "digital_f32"), ("lm100m", "device"),
         ("lm100m", "fakequant"), ("deepseek-v2-lite-16b", "digital_f32"),
         ("zamba2-1.2b", "digital_f32"),
         ("llama-3.2-vision-90b", "digital_f32"),
         ("whisper-medium", "digital_f32")]
MAX_LEN = 16


def _inputs(cfg):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    stream = {"vlm": ("vision", cfg.n_vision_tokens),
              "audio": ("audio", cfg.n_audio_frames)}.get(cfg.family)
    if stream is not None:
        out[stream[0]] = rng.standard_normal(
            (2, stream[1], cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch,mode", CASES,
                         ids=[f"{a}-{m}" for a, m in CASES])
def test_prefill_logits_match_reference(arch, mode, monkeypatch):
    jcfg = jax_config(arch, True).replace(**MODES[mode])
    cfg = get_config(arch, smoke=True).replace(**MODES[mode])
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg.digital())
    if mode == "device":
        jp = JM.program_digital(jp, jcfg)
    batch = _inputs(cfg)
    with jax.disable_jit(mode != "digital_f32"):
        want, _ = JM.prefill(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jcfg, MAX_LEN)
    want = np.asarray(want)
    heads = []
    logits = TF._logits

    def head(p, x, cfg_, last_only=False):
        out = logits(p, x, cfg_, last_only)
        heads.append(tuple(out.shape))
        return out
    monkeypatch.setattr(TF, "_logits", head)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        got, _ = M.prefill(params, {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, cfg, MAX_LEN)
    # one head row a sequence
    assert heads == [(2, 1, cfg.vocab)]
    assert got.shape == want.shape == (2, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_prefill_chunk_keeps_the_chunks_logits():
    """A chunk appended to a prefilled cache returns (B, S, V), every
    position's logits, and its last row is the next prefill's row."""
    cfg = get_config("lm100m", smoke=True).replace(dtype="float32")
    params = M.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(_inputs(cfg)["tokens"]).long()
    with torch.no_grad():
        first, cache = M.prefill(params, {"tokens": toks[:, :4]}, cfg,
                                 MAX_LEN)
        chunk, _ = M.prefill_chunk(params, cache, toks[:, 4:], cfg)
        whole, _ = M.prefill(params, {"tokens": toks}, cfg, MAX_LEN)
    assert chunk.shape == (2, 4, cfg.vocab)
    np.testing.assert_allclose(chunk[:, -1].numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert first.shape == (2, cfg.vocab)
