"""``REPRO_SEQ_SHARD`` (sequence parallelism of the numeric step) across
every family's plan, without processes: ``launch.sharding.NumericParallel``
on one rank's view of a layout, and the cross-attention's fused read on
the ranks of a 1x4 layout emulated in one process
(``launch.mesh.emulate_layout``).

  * ``plan()["seq"]`` is on under the flag on 2x2 and 1x4 for the smoke
    configs of every family (lm100m, llama4-scout, deepseek-v2-lite,
    mamba2, zamba2, whisper-medium, llama-3.2-vision-90b), off on 4x1 and
    2x1 and off without the flag;
  * every leaf of those trees that ``model`` does not split has a rule in
    ``launch.sharding.SEQ_GRAD`` (summed over ``model`` or not), every
    rule names a leaf of some tree that ``model`` does not split or of
    the MoE's shared experts (which may fall off the plan), and a leaf
    without one raises;
  * the cross-attention's fused ``wqkv`` read under sequence parallelism
    (the VLM's smoke config, digital): its input on every rank is
    ``[x_whole, stream]`` bit for bit, and the gradients of this rank's
    chunk and of the stream (whole on every rank) are the one-device
    read's within 1e-6 relative, the stream's cotangent summed over
    ``model`` once;
  * a MoE config whose shared experts fall off the plan keeps ``seq``
    on, and its digital step on an emulated 1x4 layout is the
    one-device step's within 1e-5 relative.
"""
import contextlib
import os

import pytest
import torch

FAMILIES = ("lm100m", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
            "mamba2-1.3b", "zamba2-1.2b", "whisper-medium",
            "llama-3.2-vision-90b")
IDS = ("dense", "llama4", "deepseek", "mamba2", "zamba2", "whisper", "vlm")


@contextlib.contextmanager
def _seq_flag():
    os.environ["REPRO_SEQ_SHARD"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_SEQ_SHARD")


def _cfg(arch):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(dtype="float32")


def _numeric(arch, shape, coords=None):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import NumericParallel
    coords = coords or (0,) * len(shape)
    return NumericParallel(_cfg(arch), Mesh(shape, ("data", "model"),
                                            coords=coords))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", FAMILIES, ids=IDS)
def test_seq_plan_per_family(arch):
    with _seq_flag():
        for shape in ((2, 2), (1, 4)):
            assert _numeric(arch, shape).plan()["seq"], (arch, shape)
        for shape in ((4, 1), (2, 1)):
            assert not _numeric(arch, shape).plan()["seq"], (arch, shape)
    assert not _numeric(arch, (1, 4)).plan()["seq"]


@pytest.mark.parametrize("arch", FAMILIES, ids=IDS)
def test_seq_grad_rule_for_every_leaf(arch):
    """Every leaf not split over ``model`` on 1x4 is in ``SEQ_GRAD``;
    every leaf split over ``model`` is one the plan keeps split."""
    with _seq_flag():
        npar = _numeric(arch, (1, 4), (0, 1))
    kinds = set()
    for path, _ in _leaves(npar.like):
        axes = npar.leaf_axes(_get(npar.specs, path))
        kinds.add(npar.seq_grad(path, axes))
    assert "chunk" in kinds and "split" in kinds, kinds


def test_seq_grad_table_has_no_stray_rule():
    """Every rule of ``SEQ_GRAD`` names a leaf of some family's tree that
    ``model`` does not split, or one of the MoE's shared experts (whole
    where they fall off the plan); the MoE router and the SSD layer's
    replicated leaves act on the whole sequence, the norms on chunks."""
    from repro_torch.launch import sharding as S_
    seen = set()
    with _seq_flag():
        for arch in FAMILIES:
            npar = _numeric(arch, (1, 4), (0, 1))
            for path, _ in _leaves(npar.like):
                axes = npar.leaf_axes(_get(npar.specs, path))
                key = S_.block_path(path)
                if "model" not in axes or key[:2] == ("moe", "shared"):
                    seen.add(key)
    assert set(S_.SEQ_GRAD) == seen, set(S_.SEQ_GRAD) ^ seen
    assert {v for k, v in S_.SEQ_GRAD.items()
            if k[:2] == ("moe", "shared")} == {"whole"}
    assert S_.SEQ_GRAD[("moe", "router", "w")] == "whole"
    assert S_.SEQ_GRAD[("ssm", "norm", "scale")] == "whole"
    assert S_.SEQ_GRAD[("ln1", "scale")] == "chunk"


def test_seq_grad_missing_leaf_raises(monkeypatch):
    from repro_torch.launch import sharding as S_
    table = dict(S_.SEQ_GRAD)
    del table[("moe", "router", "w")]
    monkeypatch.setattr(S_, "SEQ_GRAD", table)
    with _seq_flag():
        npar = _numeric("llama4-scout-17b-a16e", (1, 4), (0, 1))
    with pytest.raises(KeyError):
        npar.seq_grad(("layers", "moe", "router", "w"), ())


def test_cross_read_input_is_whole_sequence_then_stream(monkeypatch):
    """The cross-attention's fused read on the 4 ``model`` ranks of a 1x4
    layout under sequence parallelism: each rank reads ``[x_whole,
    stream]`` (its chunk's sequence gathered before the stream joins
    it), and the gradients of its chunk and of the stream are the
    one-device read's."""
    from repro_torch.core import shardctx
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.launch.sharding import NumericParallel
    from repro_torch.models import layers as L
    cfg = _cfg("llama-3.2-vision-90b")
    hd, d = cfg.resolved_head_dim, cfg.d_model
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    width = (h + 2 * kvh) * hd
    gen = torch.Generator().manual_seed(30)
    b, s, n_kv = 2, 8, cfg.n_vision_tokens
    w = torch.randn(d, width, generator=gen) / d ** 0.5
    x = torch.randn(b, s, d, generator=gen)
    kv = torch.randn(b, n_kv, d, generator=gen)
    dq = torch.randn(b, s, h, hd, generator=gen)
    dk = torch.randn(b, n_kv, kvh, hd, generator=gen)
    dv = torch.randn(b, n_kv, kvh, hd, generator=gen)
    xg, kvg = x.clone().requires_grad_(), kv.clone().requires_grad_()
    q, k, v = L.fused_qkv({"wqkv": {"w": w}}, xg, cfg, False, kvg)
    ((q * dq).sum() + (k * dk).sum() + (v * dv).sum()).backward()

    def rank(mesh):
        with _seq_flag():
            npar = NumericParallel(cfg, mesh)
        m, r = mesh.shape["model"], mesh.coords["model"]
        c = s // m
        cols = S_.part_columns(S_.fused_parts(("wqkv",), width, cfg, m),
                               m, r)
        npar.sp_on = True
        with shardctx.numeric_parallel(npar):
            xr = x[:, r * c:(r + 1) * c].clone().requires_grad_()
            kvr = kv.clone().requires_grad_()
            qr, kr, vr = L.fused_qkv({"wqkv": {"w": w[:, cols]}}, xr, cfg,
                                     True, kvr)
            hq, hk = h // m, kvh // m
            loss = (qr * dq[:, :, r * hq:(r + 1) * hq]).sum() \
                + (kr * dk[:, :, r * hk:(r + 1) * hk]).sum() \
                + (vr * dv[:, :, r * hk:(r + 1) * hk]).sum()
            loss.backward()
        return xr.grad, kvr.grad

    seen = {}
    read = L.project

    def project(p, xin, cfg, tp=None):     # each rank's read input
        rank_of = shardctx.numeric_context().mesh.rank
        seen.setdefault(rank_of, []).append(xin.detach().clone())
        return read(p, xin, cfg, tp)
    monkeypatch.setattr(L, "project", project)

    def rel(a, b_):
        return float((a - b_).norm() / b_.norm())
    for r, (gx, gkv) in enumerate(
            emulate_layout((1, 4), ("data", "model"), rank)):
        c = s // 4
        assert len(seen[r]) == 1
        assert torch.equal(seen[r][0], torch.cat([x, kv], dim=1))
        assert rel(gx, xg.grad[:, r * c:(r + 1) * c]) <= 1e-6
        assert rel(gkv, kvg.grad) <= 1e-6


def test_moe_seq_with_shared_experts_off_the_plan():
    """deepseek-v2-lite's smoke config with shared experts 134 wide, which
    do not divide over 4 ranks (``ffn`` off: the shared FFN gathered
    whole), as deepseek-v2-lite's full-width QAT step on 1x4 has
    ``ffn_row`` off: the shared experts run inside the MoE layer on the
    gathered sequence, so ``seq`` stays on, and one digital step on an
    emulated 1x4 layout is the one-device step's (loss and grad norm
    within 1e-5 relative)."""
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.models import model as M
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = _cfg("deepseek-v2-lite-16b").replace(d_ff_expert=67)
    gen = torch.Generator().manual_seed(31)
    x = torch.randint(0, cfg.vocab, (2, 17), generator=gen)
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}

    def state():
        params = M.init_params(cfg, 5, "cpu")
        opt = adamw(1e-3)
        return opt, {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32),
                     "err_fb": ()}
    opt, st = state()
    _, one = TL.make_train_step(cfg, opt)(st, batch)

    def rank(mesh):
        opt, st = state()
        with _seq_flag():
            step = TL.make_train_step(cfg, opt, mesh=mesh)
        _, m = step(TL.shard_state(st, cfg, mesh), batch)
        return (float(m["loss"]), float(m["grad_norm"]),
                step.numeric.plan(), step.numeric.sp_on)
    for loss, norm, plan, sp in emulate_layout((1, 4), ("data", "model"),
                                               rank):
        assert plan["seq"] and sp and not plan["ffn"], plan
        assert abs(loss - float(one["loss"])) <= 1e-5 * float(one["loss"])
        assert abs(norm - float(one["grad_norm"])) \
            <= 1e-5 * float(one["grad_norm"])
