"""FSDP and tensor parallelism of the numeric step, and the analog step's
``exact=False``, on gloo CPU ranks against the reference and against the
port's one-device step.

One job of 4 ranks runs every check of the 2x2, 1x4 and 4x1 layouts in
turn, one of 2 ranks those of 1x2 and one of 8 ranks those of 2x4, the
three at once (and two more spawns run the CLI); the ranks rendezvous
through a file under ``tmp_path``, run one thread each and import no
JAX.  The model is lm100m's smoke config (float32; the QAT runs at
16-row tiles, 64-wide heads and d_ff 256, so that ``wo`` and ``w_down``
split at whole tiles and every rank's columns at whole 64-column range
blocks), and for multi-query attention gemma-2b's (one kv head).
Tolerances:

  * digital, on 2x2, 1x4 and 4x1, against the reference's jitted
    one-device step (``repro.train.train_loop.make_train_step`` with
    ``adamw``, the same numpy parameters through ``repro_torch.convert``):
    the loss (the mean over the data ranks) and ``grad_norm`` of each of 2
    steps within 1e-5 relative; the parameters after them within 1e-5
    relative plus 1e-6, except elements whose gradient lies within
    float32 rounding of 0, where adamw's ``m / sqrt(v)`` is a ratio of
    rounding errors and may move by up to ``2 lr`` a step: those are
    counted (at most 1e-3 of the elements) and bounded by ``4 lr``;
  * gemma-2b digital on 1x2 and 1x4 (each ``model`` rank its slice of
    k's and v's columns, gathered whole after the read, their gradient
    summed over ``model`` and scattered back to the columns) against the
    reference's jitted one-device step: the class above;
  * QAT (the fakequant read), on 2x2, 1x4 and 4x1 (the column splits'
    range partials gathered, the row splits' tiles gathered, so every
    read's codes are one device's; 4x1 splits nothing over ``model`` and
    shares each read's DAC scale over the data ranks), against the
    port's 1x1 QAT
    step (itself held to the reference's op-by-op step by
    ``tests/test_torch_qat.py``; the reference's jitted QAT forward flips
    ADC codes against its own op-by-op one, ROADMAP §3): loss and
    ``grad_norm`` within 1e-5 relative, the parameters within the class
    above; every rank's split read against the reference's read of the
    same operands (``repro.kernels.ops.fakequant_project``): within one
    lsb per row tile, off (beyond 1e-5 relative) at under 1% of the
    outputs; one read of a
    column-split leaf against the whole read: the range formed from the
    gathered 64-column range partials within 2 ulp of the whole read's
    (the plain versions sum in other orders; on the card the kernels' is
    the whole read's bit for bit), each output within
    one lsb per row
    tile and off (beyond 1e-5 relative) at under 1% of the outputs; the
    split reads' ``dx`` (summed over the ranks) and ``dw`` against
    ``torch.autograd`` of the whole eager expression within 1e-5
    relative, column and row splits (a missing ``dL/dlsb`` or scale
    gradient sum is off by tens of percent); a read whose DAC scale is
    shared over data ranks that hold the same tokens (the max tied on
    every rank): ``dx`` and ``dw`` within 1e-5 relative of the whole
    eager expression's over all their tokens (the scale's gradient
    shared among the tied elements, as the reference's ``max`` shares
    it; given whole to each rank it is off by the ranks' count);
  * ``REPRO_SEQ_SHARD`` on 2x2 and 1x4: the digital class above, and
    with QAT the QAT class;
  * ``REPRO_EMBED_BF16`` (bfloat16 activations): the loss of the
    tensor-parallel forward bit-equal to the flag unset;
  * each rank holds the policy's block of every leaf of ``params``, ``m``,
    ``v`` and ``err_fb``, shapes exactly;
  * ``AnalogTrainStep(exact=False)`` on 2x2 and 2x4 against
    ``exact=True``: every shard-local read within ``(tiles - 1) * 2^-23 *
    sum |partial| * |x_scale / w_scale| + 2^-23 |exact|`` an element of
    the exact read (two float sums of the same tiles' partials in two
    orders, each within ``(tiles - 1) u sum |partial|`` of the exact sum,
    ``u = 2^-24``, and the rescale's rounding);
    one noisy TaOx step's conductances equal except cells whose write saw
    a flipped operand code (under 1e-3 of the cells), the digital leaves
    within 1e-5;
  * the CLI: a 2x2 run with ``--grad-compress`` checkpointed at step 2
    and resumed on 1x1 and on 4x1: the same batches bit for bit, and the
    uninterrupted run's losses within 1e-5 relative.
"""
import json
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

LR = 1e-3
STEPS = 2
B, S = 4, 16
DIG = dict(dtype="float32")
# 64-wide heads and ff slices: a column-split fakequant read's range
# partials come in whole 64-column blocks on every layout
QAT = dict(dtype="float32", analog=True, analog_mode="fakequant",
           analog_rows=16, head_dim=64, d_ff=256)
DEVICE = dict(dtype="float32", analog=True, analog_mode="device",
              analog_device="taox", analog_rows=16, analog_cols=16)
JOBS = {(2, 2): ("digital", "qat", "sp", "qat_sp", "bf16", "reads", "ties",
                 "inexact"),
        (1, 4): ("digital", "qat", "sp", "qat_sp", "reads", "mqa"),
        (4, 1): ("digital", "qat", "ties"),
        (1, 2): ("mqa",),
        (2, 4): ("inexact",)}
#: gemma-2b's smoke config: 4 query heads over one kv head (MQA), so on
#: ``model`` ranks each holds a slice of k's and v's columns
MQA = "gemma-2b"


def _cfg(extra, arch="lm100m"):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(**extra)


def _batches(vocab):
    rng = np.random.default_rng(7)
    x = rng.integers(0, vocab, (STEPS, B, S)).astype(np.int32)
    return x, np.roll(x, -1, axis=2)


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


# ------------------------------------------------------------- the ranks

def _numeric_run(extra, params_np, mesh, n_steps=STEPS, env=None,
                 arch="lm100m"):
    """``n_steps`` adamw steps of the FSDP / TP step from whole numpy
    parameters: the global losses and grad norms, the whole parameters
    after them, the plan, and whether every held leaf had its policy
    block's shape."""
    import os

    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch import sharding as S_
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    if env:
        os.environ[env] = "1"
    try:
        cfg = _cfg(extra, arch)
        opt = adamw(LR)
        params = params_from_numpy(params_np, "cpu")
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32), "err_fb": ()}
        st = TL.shard_state(state, cfg, mesh)
        step = TL.make_train_step(cfg, opt, mesh=mesh)
        policy = S_.params_shardings(params, cfg, mesh)
        held = all(
            tuple(_get(tree, p).shape) == tuple(
                len(range(*sl.indices(d))) for d, sl in zip(
                    w.shape, S_.block_slices(w.shape, _get(policy, p),
                                             mesh)))
            for tree in (st["params"], st["opt"]["m"], st["opt"]["v"])
            for p, w in _leaves(params))
        # the port's own blocks: a fused leaf cut per part
        held_port = all(
            tuple(_get(tree, p).shape) == tuple(S_.leaf_block(
                w, p, _get(policy, p), cfg, mesh).shape)
            for tree in (st["params"], st["opt"]["m"], st["opt"]["v"])
            for p, w in _leaves(params))
        x, y = _batches(cfg.vocab)
        d, n = mesh.coords["data"], mesh.shape["data"]
        losses, norms = [], []
        sp = False
        for i in range(n_steps):
            rows = slice(d * B // n, (d + 1) * B // n)
            st, m = step(st, {"tokens": torch.from_numpy(x[i, rows]).long(),
                              "labels": torch.from_numpy(y[i, rows]).long()})
            sp = sp or step.numeric.sp_on
            loss = mesh.all_reduce(m["loss"].reshape(1), "data") / n
            losses.append(float(loss))
            norms.append(float(m["grad_norm"]))
        whole = TL.unshard_state(st, cfg, mesh)
        npar = step.numeric
        plan = {k: getattr(npar, k) for k in ("attn", "attn_row", "ffn",
                                              "ffn_row", "vocab")}
        return {"losses": losses, "norms": norms, "plan": plan, "sp": sp,
                "params": params_to_numpy(whole["params"]), "held": held,
                "held_port": held_port,
                "gathers": npar.counts["layer_gathers"]}
    finally:
        if env:
            os.environ.pop(env)


def _bf16_check(params_np, mesh):
    """The tensor-parallel loss with and without ``REPRO_EMBED_BF16``."""
    import os

    from repro_torch.convert import params_from_numpy
    from repro_torch.core import shardctx
    from repro_torch.launch.sharding import NumericParallel
    from repro_torch.models import model as M
    from repro_torch.train import train_loop as TL
    cfg = _cfg({})
    npar = NumericParallel(cfg, mesh)
    params = TL.shard_state({"params": params_from_numpy(params_np, "cpu"),
                             "opt": (), "step": torch.zeros(()),
                             "err_fb": ()}, cfg, mesh)["params"]
    x, y = _batches(cfg.vocab)
    batch = {"tokens": torch.from_numpy(x[0]).long(),
             "labels": torch.from_numpy(y[0]).long()}
    out = []
    for flag in (False, True):
        if flag:
            os.environ["REPRO_EMBED_BF16"] = "1"
        try:
            with torch.no_grad(), shardctx.numeric_parallel(npar):
                out.append(M.loss_fn(params, batch, cfg)[0])
        finally:
            os.environ.pop("REPRO_EMBED_BF16", None)
    return {"equal": bool(torch.equal(*out)), "vocab": npar.vocab}


def x_q_tiles(x, sc, adc, rows, k):
    """The DAC codes times the scale, (tiles, T, rows)."""
    lv = float(adc.in_levels)
    xq = torch.clamp(torch.round(x / sc), -lv, lv) * sc
    xq = torch.nn.functional.pad(xq, (0, (-k) % rows))
    return xq.reshape(xq.shape[0], -1, rows).transpose(0, 1)


def w_tiles(w, rows, k):
    wp = torch.nn.functional.pad(w, (0, 0, 0, (-k) % rows))
    return wp.reshape(-1, rows, wp.shape[1])


def _read_checks(mesh):
    """A column-split and a row-split fakequant read of this rank's part
    against the whole read and the whole eager expression's gradient."""
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import xbar_vmm as K
    adc, rows, n_m = AdcConfig(), 16, mesh.shape["model"]
    r = mesh.coords["model"]
    gen = torch.Generator().manual_seed(5)
    t, k, n = 64, 64, 256
    x = torch.randn(t, k, generator=gen)
    w = torch.randn(k, n, generator=gen) / 8.0
    dy = torch.randn(t, n, generator=gen)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx_e, dw_e = torch.autograd.grad(ops._fakequant_eager(xg, wg, adc, rows),
                                     [xg, wg], dy)
    y_w = K.fakequant_read(x, w, adc, rows)
    sc = K.fakequant_scale(x, adc.in_levels)
    ssq_w = (x_q_tiles(x, sc, adc, rows, k) @ w_tiles(w, rows, k)) \
        .square().sum(-1).transpose(0, 1)   # (T, tiles), as one device
    lsb_sum = (adc.sat_sigmas * torch.sqrt(ssq_w / n + 1e-12)
               / adc.out_levels).sum(dim=1, keepdim=True)
    out = {}
    # column split: this rank's columns
    c = n // n_m
    cols = slice(r * c, (r + 1) * c)
    y_c, full = K.fakequant_split_read(
        x, w[:, cols], adc, rows,
        lambda s: mesh.all_gather(s, "model", s.ndim - 1), n)
    tot = full.sum(dim=-1)

    def lsb(ssq):     # the ADC's range, as the read forms it
        return adc.sat_sigmas * torch.sqrt(ssq / n + 1e-12) / adc.out_levels
    out["range_ulps"] = float(((lsb(tot) - lsb(ssq_w)).abs()
                               / torch.from_numpy(np.spacing(
                                   lsb(ssq_w).numpy()))).max())
    out["y_col"], out["cols"] = y_c, (r * c, (r + 1) * c)
    dev = (y_c - y_w[:, cols]).abs()
    out["col_lsb"] = bool((dev <= lsb_sum * 1.0001 + 1e-6).all())
    out["col_off"] = float((dev > 1e-5 * y_w[:, cols].abs() + 1e-6)
                           .float().mean())
    xr, wr = x.clone().requires_grad_(), w[:, cols].clone().requires_grad_()
    yr = ops.FakequantSplitRead.apply(xr, wr, adc, rows, mesh, ("model",),
                                      (), n, None)
    yr.backward(dy[:, cols])
    dx = mesh.all_reduce(xr.grad, "model")

    def rel(a, b):    # dx is 0 but at the drive's max (the DAC scale)
        return float((a - b).norm() / (b.norm() + 1e-30))
    out["col_dx"], out["col_dw"] = rel(dx, dx_e), rel(wr.grad, dw_e[:, cols])
    # row split: this rank's row tiles
    kk = k // n_m
    rws = slice(r * kk, (r + 1) * kk)
    xr = x[:, rws].clone().requires_grad_()
    wr = w[rws].clone().requires_grad_()
    yr = ops.FakequantSplitRead.apply(xr, wr, adc, rows, mesh, (),
                                      ("model",), n, None, ("model",))
    out["row_y"] = float((yr.detach() - y_w).abs().max())
    yr.backward(dy)
    out["row_dx"], out["row_dw"] = rel(xr.grad, dx_e[:, rws]), \
        rel(wr.grad, dw_e[rws])
    return out


def _tie_checks(mesh):
    """A fakequant read whose DAC scale is shared over the data ranks,
    every data rank holding the same tokens (so the drive's max ties
    across them, as identical sequences make it in real text): ``dx`` and
    ``dw`` against ``torch.autograd`` of the whole eager expression over
    the data ranks' tokens together."""
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import ops
    adc, rows, n_d = AdcConfig(), 16, mesh.shape["data"]
    gen = torch.Generator().manual_seed(9)
    t, k, n = 16, 64, 128
    x = torch.randn(t, k, generator=gen)
    w = torch.randn(k, n, generator=gen) / 8.0
    dy = torch.randn(n_d, t, n, generator=gen)
    xg = x.repeat(n_d, 1).requires_grad_()
    wg = w.clone().requires_grad_()
    dx_e, dw_e = torch.autograd.grad(
        ops._fakequant_eager(xg, wg, adc, rows), [xg, wg], dy.reshape(-1, n))
    d = mesh.coords["data"]
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    yr = ops.FakequantSplitRead.apply(xr, wr, adc, rows, mesh, (),
                                      ("data",), n, None, ())
    yr.backward(dy[d])
    dw = mesh.all_reduce(wr.grad, "data")

    def rel(a, b):
        return float((a - b).norm() / (b.norm() + 1e-30))
    return {"dx": rel(xr.grad, dx_e[d * t:(d + 1) * t]), "dw": rel(dw, dw_e),
            "dx_nonzero": bool(dx_e.abs().max() > 0)}


def _inexact_checks(mesh):
    """exact=False against exact=True: shard-local reads (the bound) and
    one noisy step's conductances."""
    from repro_torch.core import shardctx
    from repro_torch.core.adc import AdcConfig
    from repro_torch.core.crossbar import CrossbarConfig
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.launch import sharding as S_
    from repro_torch.train import analog_lm as TA
    shardctx.set_shard_context(mesh, None)
    xcfg = CrossbarConfig(rows=16, cols=16, adc=AdcConfig())
    reads = []
    for i, (k, n, b, spec) in enumerate([
            (64, 192, 64, (("data",), ("model",))),
            (128, 64, 4, (("data",), ("model",))),
            (64, 64, 4, (("model",), ("data",)))]):
        gen = torch.Generator().manual_seed(i)
        g = torch.rand(k, n, generator=gen)
        ref = torch.rand(k, n, generator=gen)
        ws = torch.tensor(2.5)
        blk = S_.block_slices(g.shape, spec, mesh)
        meta = S_.shard_meta(g.shape, spec, mesh)
        import dataclasses
        loose = dataclasses.replace(meta, exact=False)
        for tr in (False, True):
            x = torch.randn(b, n if tr else k, generator=gen)
            exact = K.xbar_fused_read(x, g, ref, ws, xcfg, transpose=tr)
            y = K.manual_collective_read(x, g[blk], ref[blk], ws, xcfg,
                                         loose, transpose=tr)
            x3 = x[None]
            sc = K.read_scales(x3, ws.reshape(1), xcfg.adc.in_levels)
            part = K._read_plain(x3, g[None], ref[None], sc, xcfg, tr,
                                 partials=True)
            bound = (part.shape[1] - 1) * 2.0 ** -23 \
                * part.abs().sum(1)[0] * sc[0, 1].abs() \
                + 2.0 ** -23 * exact.abs()
            reads.append(bool(((y - exact).abs() <= bound).all()))
    cfg = _cfg(DEVICE)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))).long()
             for k in ("tokens", "labels")}
    runs = {}
    for exact in (True, False):
        step = TA.make_analog_sgd_step(cfg, lr=0.05, mesh=mesh, exact=exact)
        state = step.shard_state(TA.init_state(0, cfg, device="cpu"))
        state, m = step(state, batch, 1000)
        runs[exact] = (step.unshard_state(state)["params"], float(m["loss"]))
    diff = cells = 0
    digital = 0.0
    for path, a in _leaves(runs[True][0]):
        b = _get(runs[False][0], path)
        if path[-1] in ("g", "ref", "g_carry"):
            diff += int((a != b).sum())
            cells += a.numel()
        else:
            digital = max(digital, float(((a - b).abs()
                                          / (a.abs() + 1e-6)).max()))
    return {"reads": reads, "diff": diff, "cells": cells,
            "digital": digital, "loss": (runs[True][1], runs[False][1])}


def _rank(rank, world, rdv, inp, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", f"file://{rdv}", rank, world)
    data = torch.load(inp, weights_only=False)
    res = {}
    for shape in (s for s in JOBS if s[0] * s[1] == world):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        res[shape] = got = {}
        for job in JOBS[shape]:
            if job == "digital":
                got[job] = _numeric_run(DIG, data["params"], mesh)
            elif job == "qat":
                got[job] = _numeric_run(QAT, data["params_qat"], mesh, 1)
            elif job == "sp":
                got[job] = _numeric_run(DIG, data["params"], mesh,
                                        env="REPRO_SEQ_SHARD")
            elif job == "qat_sp":
                got[job] = _numeric_run(QAT, data["params_qat"], mesh, 1,
                                        env="REPRO_SEQ_SHARD")
            elif job == "bf16":
                got[job] = _bf16_check(data["params"], mesh)
            elif job == "reads":
                got[job] = _read_checks(mesh)
            elif job == "inexact":
                got[job] = _inexact_checks(mesh)
            elif job == "ties":
                got[job] = _tie_checks(mesh)
            elif job == "mqa":
                got[job] = _numeric_run(DIG, data["params_mqa"], mesh,
                                        arch=MQA)
    torch.save(res, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ the one device

def _initial_params(extra, arch="lm100m"):
    """The reference's initial parameters (``PRNGKey(0)``) as numpy; both
    packages take them."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    cfg = jax_config(arch, smoke=True).replace(**extra)
    params = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _reference_runs(params, arch="lm100m"):
    """The reference's jitted digital steps from ``params``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.train import optimizer as JO
    from repro.train import train_loop as JL
    x, y = _batches(_cfg(DIG).vocab)

    def run(extra, n):
        cfg = jax_config(arch, smoke=True).replace(**extra)
        jparams = jax.tree.map(jnp.asarray, params)
        opt = JO.adamw(LR)
        state = {"params": jparams, "opt": opt.init(jparams),
                 "step": jnp.zeros((), jnp.int32), "err_fb": ()}
        step = jax.jit(JL.make_train_step(cfg, opt))
        losses, norms = [], []
        for i in range(n):
            state, m = step(state, {"tokens": jnp.asarray(x[i]),
                                    "labels": jnp.asarray(y[i])})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return {"losses": losses, "norms": norms,
                "params": jax.tree.map(np.asarray, state["params"])}
    return run(DIG, STEPS)


def _port_one_device(extra, params_np, n):
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = _cfg(extra)
    opt = adamw(LR)
    params = params_from_numpy(params_np, "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32), "err_fb": ()}
    step = TL.make_train_step(cfg, opt)
    x, y = _batches(cfg.vocab)
    losses, norms = [], []
    for i in range(n):
        state, m = step(state, {"tokens": torch.from_numpy(x[i]).long(),
                                "labels": torch.from_numpy(y[i]).long()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": params_to_numpy(state["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's ranks, the reference and the port's one device."""
    tmp = tmp_path_factory.mktemp("tp")
    params, params_qat = _initial_params(DIG), _initial_params(QAT)
    params_mqa = _initial_params(DIG, MQA)
    dig = _reference_runs(params)
    mqa = _reference_runs(params_mqa, MQA)
    inp = tmp / "inputs.pt"
    torch.save({"params": params, "params_qat": params_qat,
                "params_mqa": params_mqa}, inp)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one_qat = _port_one_device(QAT, params_qat, 1)
    finally:
        torch.set_num_threads(threads)
    out = {}
    worlds = (2, 4, 8)   # one job a world size, its layouts in turn
    jobs = [mp.start_processes(
        _rank, args=(world, str(tmp / f"rdv-{world}"), str(inp),
                     str(tmp / f"res-{world}")),
        nprocs=world, join=False, start_method="spawn") for world in worlds]
    for job in jobs:
        while not job.join():
            pass
    for world in worlds:
        ranks = [torch.load(f"{tmp / f'res-{world}'}.{r}", weights_only=False)
                 for r in range(world)]
        for shape in ranks[0]:
            out[shape] = [r[shape] for r in ranks]
    return {"ref_dig": dig, "ref_mqa": mqa, "one_qat": one_qat,
            "ranks": out}


def _close_params(got, want, lr, n_steps):
    """The parameter class of the module docstring; returns the count of
    elements off."""
    off = total = 0
    for path, w in _leaves(want):
        g = np.asarray(_get(got, path))
        bad = np.abs(g - w) > 1e-5 * np.abs(w) + 1e-6
        assert np.all(np.abs(g - w)[bad] <= 2 * n_steps * lr * 1.01), path
        off += int(bad.sum())
        total += w.size
    assert off <= 1e-3 * total, (off, total)
    return off


def _close(a, b, rel=1e-5):
    return all(abs(x - y) <= rel * abs(y) + 1e-7 for x, y in zip(a, b))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "1x4", "4x1"])
def test_digital_step_matches_reference(runs, shape):
    ref = runs["ref_dig"]
    for r in runs["ranks"][shape]:
        got = r["digital"]
        assert got["held"]
        assert _close(got["losses"], ref["losses"]), got["losses"]
        assert _close(got["norms"], ref["norms"]), got["norms"]
        _close_params(got["params"], ref["params"], LR, STEPS)
        # a layer gathered once a block (and again by its rematted
        # backward under REPRO_REMAT=full)
        assert got["gathers"] >= STEPS * 2


def test_tensor_parallel_plan_on_model_ranks(runs):
    """lm100m's dense blocks, embedding and head split over ``model`` on
    2x2 and 1x4; nothing on 4x1 (FSDP alone)."""
    for shape, want in (((2, 2), True), ((1, 4), True), ((4, 1), False)):
        plan = runs["ranks"][shape][0]["digital"]["plan"]
        assert set(plan.values()) == {want}, (shape, plan)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_mqa_step_matches_reference(runs, shape):
    """gemma-2b's smoke config (one kv head) tensor-parallel: each
    ``model`` rank holds the policy's even block of ``wqkv`` (its q heads'
    columns and its slice of k's and v's, gathered whole after the read),
    the k and v gradient summed over ``model`` and scattered back to the
    columns, each column counted once in ``grad_norm`` (the clip scales
    every update by it)."""
    ref = runs["ref_mqa"]
    for r in runs["ranks"][shape]:
        got = r["mqa"]
        assert got["held_port"] and got["plan"]["attn"], got["plan"]
        assert got["held"]
        assert _close(got["losses"], ref["losses"]), got["losses"]
        assert _close(got["norms"], ref["norms"]), (got["norms"],
                                                    ref["norms"])
        _close_params(got["params"], ref["params"], LR, STEPS)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "1x4", "4x1"])
def test_qat_step_matches_one_device(runs, shape):
    one = runs["one_qat"]
    for r in runs["ranks"][shape]:
        got = r["qat"]
        assert got["held"]
        assert all(got["plan"].values()) == (shape[1] > 1), got["plan"]
        assert _close(got["losses"], one["losses"]), got["losses"]
        assert _close(got["norms"], one["norms"]), got["norms"]
        _close_params(got["params"], one["params"], LR, 1)


def _reference_read():
    """The reference's fakequant read of ``_read_checks``' operands, and
    the lsb sum of each token's row tiles."""
    import jax.numpy as jnp

    from repro.core.adc import AdcConfig as JAdc
    from repro.kernels.ops import fakequant_project as jax_fakequant
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(64, 64, generator=gen)
    w = torch.randn(64, 256, generator=gen) / 8.0
    y = jax_fakequant(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                      JAdc(), 16)
    adc = _adc()
    sc = torch.clamp(x.abs().amax(), min=1e-12) / adc.in_levels
    q = torch.stack([x_q_tiles(x, sc, adc, 16, 64)[i]
                     @ w_tiles(w, 16, 64)[i] for i in range(4)], dim=1)
    lsb = adc.sat_sigmas * torch.sqrt(q.square().mean(-1) + 1e-12) \
        / adc.out_levels
    return torch.from_numpy(np.asarray(y)), lsb.sum(1, keepdim=True)


def _adc():
    from repro_torch.core.adc import AdcConfig
    return AdcConfig()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_split_reads_range_and_gradient(runs, shape):
    y_ref, lsb = _reference_read()
    for r in runs["ranks"][shape]:
        got = r["reads"]
        lo, hi = got["cols"]
        dev = (got["y_col"] - y_ref[:, lo:hi]).abs()
        assert bool((dev <= 1.0001 * lsb + 1e-6).all())
        assert float((dev > 1e-5 * y_ref[:, lo:hi].abs() + 1e-6)
                     .float().mean()) < 0.01
        assert got["range_ulps"] <= 2, got
        assert got["col_lsb"] and got["col_off"] < 0.01, got
        assert got["row_y"] <= 1e-4, got
        for k in ("col_dx", "col_dw", "row_dx", "row_dw"):
            assert got[k] <= 1e-5, (k, got)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_shared_scale_gradient_splits_ties_across_data_ranks(runs, shape):
    """The data ranks hold the same tokens: the drive's max ties on every
    rank, and the scale's gradient is shared among all tied elements, as
    the reference's ``max`` over its one global batch shares it."""
    for r in runs["ranks"][shape]:
        got = r["ties"]
        assert got["dx_nonzero"]
        assert got["dx"] <= 1e-5 and got["dw"] <= 1e-5, got


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_sequence_sharding_matches_reference(runs, shape):
    ref = runs["ref_dig"]
    for r in runs["ranks"][shape]:
        got = r["sp"]
        assert got["sp"], "REPRO_SEQ_SHARD did not split the sequence"
        assert _close(got["losses"], ref["losses"]), got["losses"]
        assert _close(got["norms"], ref["norms"]), got["norms"]
        _close_params(got["params"], ref["params"], LR, STEPS)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_qat_sequence_sharding_matches_one_device(runs, shape):
    """QAT under ``REPRO_SEQ_SHARD``: a row split's whole output cut to
    this rank's tokens (its gradient gathered back), the QAT class."""
    one = runs["one_qat"]
    for r in runs["ranks"][shape]:
        got = r["qat_sp"]
        assert got["sp"], "REPRO_SEQ_SHARD did not split the sequence"
        assert _close(got["losses"], one["losses"]), got["losses"]
        assert _close(got["norms"], one["norms"]), got["norms"]
        _close_params(got["params"], one["params"], LR, 1)


def test_embed_bf16_is_bit_equal(runs):
    for r in runs["ranks"][(2, 2)]:
        assert r["bf16"]["vocab"] and r["bf16"]["equal"]


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_inexact_step_within_reassociation(runs, shape):
    for r in runs["ranks"][shape]:
        got = r["inexact"]
        assert all(got["reads"]), got["reads"]
        assert got["diff"] <= 1e-3 * got["cells"], (got["diff"],
                                                    got["cells"])
        assert got["digital"] <= 1e-5
        a, b = got["loss"]
        assert abs(a - b) <= 1e-5 * abs(a)


# ------------------------------------------------------------------ the CLI

CLI = ["--arch", "lm100m", "--smoke", "--device", "cpu", "--seq-len", "16",
       "--global-batch", "4", "--log-every", "100", "--lr", "1e-3",
       "--dtype", "float32", "--grad-compress"]


def _cli_rank(rank, world, rdv, argv):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch import train
    train.main(argv, init_method=f"file://{rdv}", rank=rank,
               world_size=world)
    dist.destroy_process_group()


def _metrics(path):
    return [json.loads(line) for line in open(path)]


def test_cli_2x2_resumes_on_1x1_and_4x1(tmp_path):
    """4 steps on 2x2, checkpointed every 2; its step-2 checkpoint resumed
    for steps 3-4 on 1x1 (in this process) and on 4x1."""
    from repro_torch.core.shardctx import clear_shard_context
    from repro_torch.launch import train
    ckpt = tmp_path / "ckpt"
    whole = tmp_path / "whole.jsonl"
    mp.spawn(_cli_rank, args=(4, str(tmp_path / "rdv-a"), CLI + [
        "--steps", "4", "--mesh", "2x2", "--ckpt-dir", str(ckpt),
        "--ckpt-every", "2", "--metrics-out", str(whole)]), nprocs=4)
    a = _metrics(whole)
    assert [m["step"] for m in a] == [1, 2, 3, 4]
    for name in ("one", "four"):
        d = tmp_path / f"ckpt-{name}"
        d.mkdir()
        shutil.copytree(ckpt / "step_00000002", d / "step_00000002")
        (d / "step_00000002.COMMITTED").write_text("ok")
    one = tmp_path / "one.jsonl"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(CLI + ["--steps", "4", "--mesh", "1x1", "--ckpt-dir",
                          str(tmp_path / "ckpt-one"), "--metrics-out",
                          str(one)])
    finally:
        torch.set_num_threads(threads)
        clear_shard_context()
    four = tmp_path / "four.jsonl"
    mp.spawn(_cli_rank, args=(4, str(tmp_path / "rdv-b"), CLI + [
        "--steps", "4", "--mesh", "4x1", "--ckpt-dir",
        str(tmp_path / "ckpt-four"), "--metrics-out", str(four)]), nprocs=4)
    for path in (one, four):
        got = _metrics(path)
        assert [m["step"] for m in got] == [3, 4]
        for x, y in zip(a[2:], got):
            assert x["batch"] == y["batch"]
            assert abs(x["loss"] - y["loss"]) <= 1e-5 * abs(x["loss"])
