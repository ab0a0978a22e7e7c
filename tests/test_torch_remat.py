"""Per-layer remat in the port (``models.transformer._remat``, the
reference's ``REPRO_REMAT``: ``full`` by default, ``dots``, ``none``).

  * the policy parse against the reference's ``_remat`` (its jaxpr: a
    ``remat`` with no policy, with the dots policy, or none at all);
  * one device-mode step (TaOx, 16x16 tiles, lr 0.1, 2 x 8 tokens, one
    ``seed_base``) of every family's smoke config under ``full`` and
    ``dots``, bit-equal to the step under ``none``: every conductance,
    digital leaf and tape, the loss and the rail fraction; the forward
    read of every container in the reference's rematted stacks made once
    more (the backward's recompute), every other read as often as under
    ``none`` (the VLM's cross blocks and the hybrid's shared block are
    not rematted, as in the reference).  lm100m with periodic carry too:
    its reads recompute ``effective_g``;
  * the sharded step on two gloo ranks under ``full`` bit-equal to its
    step under ``none``, the forward reads' ordered gathers replayed;
  * on the meta tracer (``launch.dryrun.reckon``) the peak falls and the
    FLOPs rise, ``dots`` between ``none`` and ``full``;
  * serving under ``no_grad`` dispatches the same ops under every policy;
  * the reference's numeric step, jitted under a policy, against the
    port's under the same policy (``tests/test_torch_pulse_carry.py``'s
    numeric class: 1e-5 relative on the loss and gradient norm, each leaf
    within rtol 1e-5 / atol 1e-6).
"""
import collections
import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro_torch.core.tiled_analog as TT
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import transformer as JTF
from repro.train import optimizer as JO
from repro.train import train_loop as JL
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.analog_registry import container_paths
from repro_torch.launch import dryrun as DR
from repro_torch.launch.trace_analysis import tracing
from repro_torch.models import model as M
from repro_torch.models import transformer as TF
from repro_torch.train import analog_lm as TA
from repro_torch.train import optimizer as TO
from repro_torch.train import train_loop as TL

DEVICE_MODE = dict(dtype="float32", analog=True, analog_mode="device",
                   analog_device="taox", analog_rows=16, analog_cols=16)
#: family -> (arch, config overrides, the stacks the reference remats)
FAMILIES = {
    "dense": ("lm100m", {}, ("layers",)),
    "dense-carry": ("lm100m", dict(analog_carry=True, carry_period=1),
                    ("layers",)),
    "moe": ("llama4-scout-17b-a16e", {}, ("layers",)),
    "mla": ("deepseek-v2-lite-16b", {}, ("layers",)),
    "ssm": ("mamba2-1.3b", {}, ("layers",)),
    "hybrid": ("zamba2-1.2b", {}, ("layers",)),
    "vlm": ("llama-3.2-vision-90b", {}, ("self_layers",)),
    "audio": ("whisper-medium", {}, ("enc_layers", "dec_layers")),
}
SEED_BASE = 1234


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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _batch(cfg, b=2, s=8):
    rng = np.random.default_rng(0)
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).long()
           for k in ("tokens", "labels")}
    stream = {"vlm": ("vision", cfg.n_vision_tokens),
              "audio": ("audio", cfg.n_audio_frames)}.get(cfg.family)
    if stream is not None:
        out[stream[0]] = torch.from_numpy(rng.standard_normal(
            (b, stream[1], cfg.d_model)).astype(np.float32))
    return out


# ------------------------------------------------------------ the policy

def _reference_policy():
    """What the reference's ``_remat`` makes of ``REPRO_REMAT``: its
    jaxpr holds a remat with no policy (``full``), one with a policy
    (``dots``), or none."""
    jaxpr = jax.make_jaxpr(JTF._remat(lambda x: jnp.sin(x) @ x))(
        jnp.ones((2, 2)))
    remats = [e for e in jaxpr.jaxpr.eqns if "remat" in e.primitive.name]
    if not remats:
        return "none"
    return "full" if remats[0].params["policy"] is None else "dots"


@pytest.mark.parametrize("value", [None, "full", "dots", "none", "",
                                   "DOTS", "bogus"])
def test_policy_parse_matches_reference(value):
    with _env("REPRO_REMAT", value):
        assert TF.remat_policy() == _reference_policy()


# ------------------------------------------------- one step per family

@functools.lru_cache(maxsize=None)
def _step(family, policy):
    """One device-mode step under ``policy``: the new state's leaves, the
    metrics, the tapes each write consumed, and the (container path,
    layer) of every forward and transpose read, by the ``ref`` view it
    read (never recomputed, unlike ``effective_g`` under carry)."""
    arch, extra, _ = FAMILIES[family]
    cfg = get_config(arch, smoke=True).replace(**DEVICE_MODE, **extra)
    state = TA.init_state(0, cfg, device="cpu")
    where = {}
    for path in container_paths(state["params"]):
        ref = state["params"]
        for k in path:
            ref = ref[k]
        ref = ref["ref"]
        if ref.ndim == 2:     # applied whole (the hybrid's shared block)
            where[ref.data_ptr()] = (path, None)
        else:
            for i in range(ref.shape[0]):
                where[ref[i].data_ptr()] = (path, i)
    reads = {"vmm": [], "mvm": []}
    tapes = {}
    real = {kind: getattr(TT, kind) for kind in reads}
    update = TA.AnalogTrainStep._update_container

    def recording(kind):
        def read(x, g, ref, *args, **kw):
            reads[kind].append(where[ref.data_ptr()])
            return real[kind](x, g, ref, *args, **kw)
        return read

    def recorded(self, p, t, seed_base, path, rail):
        tapes[path] = {k: v.clone() for k, v in t.items()}
        return update(self, p, t, seed_base, path, rail)

    TT.vmm, TT.mvm = recording("vmm"), recording("mvm")
    TA.AnalogTrainStep._update_container = recorded
    try:
        with _env("REPRO_REMAT", policy):
            new, mets = TA.make_analog_sgd_step(cfg, lr=0.1)(
                state, _batch(cfg), SEED_BASE)
    finally:
        TT.vmm, TT.mvm = real["vmm"], real["mvm"]
        TA.AnalogTrainStep._update_container = update
    return (dict(_leaves(new)), {k: float(v) for k, v in mets.items()},
            tapes, reads)


def _bit_equal(got, want):
    assert set(got) == set(want)
    bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
    assert not bad, bad


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_bit_equal_to_no_remat(family, policy):
    state, mets, tapes, reads = _step(family, policy)
    state0, mets0, tapes0, reads0 = _step(family, "none")
    assert mets == mets0
    _bit_equal(state, state0)
    assert set(tapes) == set(tapes0)
    for path, t in tapes.items():
        _bit_equal(t, tapes0[path])
    # one transpose read a container application, as without remat: each
    # tape slot written once, by the original node's backward
    assert collections.Counter(reads["mvm"]) == \
        collections.Counter(reads0["mvm"])
    # the forward read of every container in a rematted stack once more,
    # nothing else
    stacks = FAMILIES[family][2]
    again = collections.Counter(reads["vmm"]) \
        - collections.Counter(reads0["vmm"])
    want = collections.Counter(r for r in reads0["vmm"]
                               if r[0][0] in stacks)
    assert again == want and sum(want.values()) > 0
    assert len(reads["vmm"]) == len(reads0["vmm"]) + sum(want.values())


# -------------------------------------------------- the sharded step

def _sharded_rank(rank, world, rdv, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.core import shardctx
    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", f"file://{rdv}", rank, world)
    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    shardctx.set_shard_context(mesh, None)
    cfg = get_config("lm100m", smoke=True).replace(**DEVICE_MODE)
    result = {}
    for policy in ("none", "full"):
        step = TA.make_analog_sgd_step(cfg, lr=0.1, mesh=mesh)
        state = step.shard_state(TA.init_state(0, cfg, device="cpu"))
        before = shardctx.GATHERED["gathers"]
        with _env("REPRO_REMAT", policy):
            new, mets = step(state, _batch(cfg), SEED_BASE)
        result[policy] = (
            {"/".join(k): v.clone() for k, v in
             _leaves(step.unshard_state(new))},
            float(mets["loss"]), shardctx.GATHERED["gathers"] - before)
    # the gathers of the forward reads alone, as the recompute replays them
    before = shardctx.GATHERED["gathers"]
    with torch.no_grad():
        M.loss_fn(step._map_containers(state["params"], step._annotate),
                  _batch(cfg), cfg)
    result["forward_gathers"] = shardctx.GATHERED["gathers"] - before
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


def test_sharded_step_replays_its_gathers_bit_equal(tmp_path):
    """lm100m's step on a 1x2 mesh of gloo ranks (shard-local reads):
    under ``full`` bit-equal to the same sharded step under ``none``; the
    ranks' ordered gathers grow by exactly the forward reads' gathers,
    replayed by the backward's recompute in the same order on every
    rank."""
    out = tmp_path / "result.pt"
    mp.spawn(_sharded_rank, args=(2, str(tmp_path / "rdv"), str(out)),
             nprocs=2)
    res = torch.load(out, weights_only=False)
    (full, loss_full, g_full), (none, loss_none, g_none) = \
        res["full"], res["none"]
    assert loss_full == loss_none
    _bit_equal(full, none)
    assert res["forward_gathers"] > 0
    assert g_full == g_none + res["forward_gathers"]


# ------------------------------------------------------- the meta tracer

def test_remat_lowers_the_reckoned_peak_and_adds_flops():
    """The dry run's numeric step (adamw) of lm100m's smoke config at 6
    layers over 4 x 256 tokens, on meta tensors: the peak falls from
    ``none`` to ``dots`` to ``full``, and the FLOPs rise (the recomputed
    forward; ``dots`` keeps the matmuls' outputs).  A dry-run cell
    records the policy it ran under."""
    cfg = get_config("lm100m", smoke=True).replace(n_layers=6)
    shape = ShapeSpec("remat_4x256", "train", 256, 4)
    got = {}
    for policy in ("none", "dots", "full"):
        with _env("REPRO_REMAT", policy):
            got[policy] = DR.reckon(cfg, shape, DR.make_mesh("1x1"))["trace"]
            rec = DR.run_cell("lm100m", "decode_32k", "1x1", smoke=True)
        assert rec["ok"] and rec["remat"] == policy
    peak = {p: t["peak_bytes"] for p, t in got.items()}
    flops = {p: t["flops"] for p, t in got.items()}
    assert peak["full"] <= peak["dots"] <= peak["none"], peak
    assert peak["full"] < peak["none"], peak
    assert flops["none"] < flops["dots"] < flops["full"], flops


# ----------------------------------------------------------- serving

@pytest.mark.parametrize("policy", ["full", "dots"])
def test_serving_dispatches_the_same_ops(policy):
    """A prefill and a decode step of lm100m's smoke model from crossbars
    (taox-nonoise) under ``no_grad``: the same aten ops, op for op
    counted, under ``policy`` as under ``none``, and the same logits."""
    cfg = get_config("lm100m", smoke=True).replace(
        **DEVICE_MODE).replace(analog_device="taox-nonoise")
    params = M.program_digital(M.init_params(cfg.digital(), 0, "cpu"), cfg)
    tokens = _batch(cfg)["tokens"]

    def serve():
        with torch.no_grad(), tracing() as trace:
            logits, cache = M.prefill(params, {"tokens": tokens}, cfg, 16)
            step, _ = M.decode_step(params, cache, tokens[:, -1], cfg)
        return trace.ops, torch.cat([logits, step])
    with _env("REPRO_REMAT", "none"):
        ops0, logits0 = serve()
    with _env("REPRO_REMAT", policy):
        ops, logits = serve()
    assert ops == ops0 and sum(ops.values()) > 0
    assert torch.equal(logits, logits0)


# --------------------------------------- the reference's numeric step

@pytest.mark.parametrize("policy", ["full", "dots"])
def test_numeric_step_matches_reference_under_policy(policy):
    """One ``make_train_step(sgd(0.1))`` step of lm100m's digital smoke
    model (float32) from the reference's init: the reference jitted under
    ``REPRO_REMAT=policy``, the port under the same policy."""
    jcfg = jax_config("lm100m", True).replace(dtype="float32")
    cfg = get_config("lm100m", smoke=True).replace(dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    opt_j = JO.sgd(0.1)
    state_j = {"params": params, "opt": opt_j.init(params),
               "step": jnp.zeros((), jnp.int32), "err_fb": ()}
    state_t = params_from_numpy(jax.tree.map(np.array, state_j), "cpu")
    batch = _batch(cfg)
    with _env("REPRO_REMAT", policy):
        new_j, mets_j = jax.jit(JL.make_train_step(jcfg, opt_j))(
            state_j, {k: jnp.asarray(v.numpy().astype(np.int32))
                      for k, v in batch.items()})
        new_t, mets_t = TL.make_train_step(cfg, TO.sgd(0.1))(state_t, batch)
    for k in ("loss", "grad_norm"):
        want = float(mets_j[k])
        assert abs(float(mets_t[k]) - want) <= 1e-5 * abs(want) + 1e-6, k
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.array, new_j["params"]))[0]
    for path, want in ref:
        leaf = new_t["params"]
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    assert len(ref) == len(TO.tree_leaves(new_t["params"]))
