"""FSDP, tensor and expert parallelism of the MoE family's numeric step on
gloo CPU ranks, against the reference's jitted one-device step and the
port's one-device QAT step.

One job of 4 ranks runs every check of the 2x2, 1x4 and 4x1 layouts in
turn and one of 2 ranks those of 2x1, the two at once; the ranks
rendezvous through a file under ``tmp_path``, run one thread each and
import no JAX.  The models are llama4-scout's smoke config (GQA, 8
experts top-1, one shared expert) and deepseek-v2-lite's (MLA, 8
experts top-2, two shared), in float32, at ``capacity_factor`` 0.5, at
which the one-device dispatch drops pairs (asserted).  Tolerances:

  * digital, on 2x1, 2x2, 1x4 and 4x1, against the reference's jitted
    one-device step over the same global batch
    (``repro.train.train_loop.make_train_step`` with ``adamw``, the same
    numpy parameters through ``repro_torch.convert``): the loss (the mean
    over the data ranks) and ``grad_norm`` of each of 2 steps within 1e-5
    relative; the parameters after them within 1e-5 relative plus 1e-6,
    except elements whose gradient lies within float32 rounding of 0
    (adamw's ``m / sqrt(v)`` a ratio of rounding errors), counted (at most
    1e-3 of the elements) and bounded by ``4 lr``;
  * the dropped pairs of the one-device forward equal to the sum over
    the data ranks' (one global dispatch);
  * QAT (the fakequant read) on 2x2, 1x4 and 4x1 against the port's 1x1
    QAT step (itself held to the reference by ``tests/test_torch_moe.py``
    and ``tests/test_torch_mla.py``), at 16-row tiles and smoke widths
    whose per-rank columns are whole 64-column range blocks and whose row
    splits are whole tiles (MLA heads of 48 + 16 query and 48 + 16 key /
    value dims, experts 128 or 256 wide): llama4-scout's loss and
    ``grad_norm`` within 1e-5 relative and its parameters within the
    class above.  deepseek-v2-lite's split reads on ``model`` ranks flip
    ADC codes on the CPU: their plain versions form the range from the
    ranks' 64-column partials, the one-device eager read from one mean
    over the row, the two lsbs an ulp apart; layer 0's reads agree within
    3e-7, and a code of a layer-1 read flips.  QAT's gradient flows only
    through the ranges, so one flip moves every gradient by about 1e-3
    relative.  Its class: the loss and ``grad_norm`` within 1e-4
    relative, every parameter within ``2 lr`` of the one-device step's
    (adamw's bound for one step) and off the 1e-5 class at under 5% of
    the elements.  On the card the split forms are the whole read's bit
    for bit (``chip_smoke.py`` phase 28(a));
  * a data rank's expert-stack read with each expert's DAC scale the max
    over the data ranks (``kernels.ops.fakequant_expert_project``): its
    rows bit-equal to the whole buffer's read; its ``dx`` and ``dw``
    (summed over the data ranks) against ``torch.autograd`` of the whole
    eager expression within 1e-5 relative, with an expert's max tied
    across the data ranks (the scale's gradient shared among the tied
    elements of every rank);
  * the aux loss's gradient (``metrics["aux"]`` alone, through the data
    ranks' blocks and ``NumericParallel.reduce_grads``) against
    ``jax.grad`` of the reference's aux over the global batch: every
    leaf within 1e-5 relative in norm (a per-rank mean, or the gradient
    of a sum with an identity backward, is off by the data ranks' count);
  * each rank holds the policy's block of every leaf of ``params``, ``m``
    and ``v``, shapes exactly, and the plan's flags are as the layout
    allows (``ep``, ``mla`` or ``attn``, ``attn_row``, ``ffn``,
    ``ffn_row``, ``vocab`` on ``model`` ranks, none on 4x1 and 2x1);
  * the CLI: a deepseek-v2-lite smoke run on 2x2 checkpointed at step 2
    and resumed on 1x1: the same batches bit for bit and the
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
ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-lite-16b")
DIG = dict(dtype="float32", capacity_factor=0.5)
#: QAT widths: every rank's columns whole 64-column blocks and every row
#: split whole 16-row tiles on 2x2 and 1x4
QAT = {"llama4-scout-17b-a16e": dict(
           DIG, analog=True, analog_mode="fakequant", analog_rows=16,
           head_dim=64, d_ff_expert=256),
       "deepseek-v2-lite-16b": dict(
           DIG, analog=True, analog_mode="fakequant", analog_rows=16,
           qk_nope_dim=48, qk_rope_dim=16, v_head_dim=16,
           d_ff_expert=128)}
JOBS = {(2, 2): ("digital", "qat", "reads", "aux"),
        (1, 4): ("digital", "qat"),
        (4, 1): ("digital", "qat", "reads", "aux"),
        (2, 1): ("digital", "aux")}


def _cfg(arch, extra):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(**extra)


def _batches(vocab):
    rng = np.random.default_rng(11)
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


def _rows(mesh):
    d, n = mesh.coords["data"], mesh.shape["data"]
    return slice(d * B // n, (d + 1) * B // n)


# ------------------------------------------------------------- the ranks

def _dropped(params, cfg, tokens, npar=None):
    """The pairs the forward drops at capacity (no gradient: a rematted
    layer's backward would replay the dispatch)."""
    from repro_torch.core import shardctx
    from repro_torch.models import model as M
    from repro_torch.models import moe
    moe.DROPPED["pairs"] = 0
    with torch.no_grad(), shardctx.numeric_parallel(npar):
        M.loss_fn(params, {"tokens": tokens, "labels": tokens}, cfg)
    return int(moe.DROPPED["pairs"])


def _numeric_run(arch, extra, params_np, mesh, n_steps):
    """``n_steps`` adamw steps of the FSDP / TP / EP step from whole numpy
    parameters: the global losses and grad norms, the whole parameters
    after them, the plan, the held blocks and the dropped pairs."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch import sharding as S_
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = _cfg(arch, extra)
    opt = adamw(LR)
    params = params_from_numpy(params_np, "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32), "err_fb": ()}
    st = TL.shard_state(state, cfg, mesh)
    step = TL.make_train_step(cfg, opt, mesh=mesh)
    policy = S_.params_shardings(params, cfg, mesh)
    held = all(
        tuple(_get(tree, p).shape) == tuple(S_.leaf_block(
            w, p, _get(policy, p), cfg, mesh).shape)
        == tuple(len(range(*sl.indices(d))) for d, sl in zip(
            w.shape, S_.block_slices(w.shape, _get(policy, p), mesh)))
        for tree in (st["params"], st["opt"]["m"], st["opt"]["v"])
        for p, w in _leaves(params))
    x, y = _batches(cfg.vocab)
    rows = _rows(mesh)
    dropped = _dropped(st["params"], cfg, torch.from_numpy(x[0, rows]).long(),
                       step.numeric)
    losses, norms = [], []
    for i in range(n_steps):
        st, m = step(st, {"tokens": torch.from_numpy(x[i, rows]).long(),
                          "labels": torch.from_numpy(y[i, rows]).long()})
        loss = mesh.all_reduce(m["loss"].reshape(1), "data") \
            / mesh.shape["data"]
        losses.append(float(loss))
        norms.append(float(m["grad_norm"]))
    whole = TL.unshard_state(st, cfg, mesh)
    return {"losses": losses, "norms": norms, "plan": step.numeric.plan(),
            "params": params_to_numpy(whole["params"]), "held": held,
            "dropped": dropped}


def _aux_grads(arch, params_np, mesh):
    """The gradient of ``metrics["aux"]`` alone, data-parallel mean over
    the blocks (``reduce_grads``), unsharded whole."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core import shardctx
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.sharding import NumericParallel
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_map
    cfg = _cfg(arch, DIG)
    npar = NumericParallel(cfg, mesh)
    whole = params_from_numpy(params_np, "cpu")
    blocks = S_.shard_tree(whole, npar.specs, cfg, mesh)
    blocks = tree_map(lambda p: p.detach().requires_grad_(True), blocks)
    x, y = _batches(cfg.vocab)
    rows = _rows(mesh)
    with shardctx.numeric_parallel(npar):
        _, mets = M.loss_fn(blocks, {
            "tokens": torch.from_numpy(x[0, rows]).long(),
            "labels": torch.from_numpy(y[0, rows]).long()}, cfg)
        mets["aux"].backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), blocks)
    grads = npar.reduce_grads(grads)
    return params_to_numpy(S_.unshard_tree(grads, npar.specs, npar.like,
                                           cfg, mesh))


def _expert_read_checks(mesh):
    """A data rank's rows of an expert-stack read whose DAC scales are
    shared over the data ranks, against the whole buffer's read and the
    whole eager expression's gradient; expert 0's max tied across the
    data ranks."""
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import xbar_vmm as K
    adc, rows, n_d = AdcConfig(), 16, mesh.shape["data"]
    d = mesh.coords["data"]
    gen = torch.Generator().manual_seed(3)
    e, t, k, n = 4, 8, 64, 64
    x = torch.randn(e, n_d * t, k, generator=gen)
    for r in range(n_d):    # expert 0's max on every data rank's rows
        x[0, r * t + 1, 5] = 9.0
    w = torch.randn(e, k, n, generator=gen) / 8.0
    dy = torch.randn(e, n_d * t, n, generator=gen)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx_e, dw_e = torch.autograd.grad(ops._fakequant_eager(xg, wg, adc, rows),
                                     [xg, wg], dy)
    y_w = K.fakequant_read(x, w, adc, rows)
    mine = slice(d * t, (d + 1) * t)
    xr = x[:, mine].clone().requires_grad_()
    wr = w.clone().requires_grad_()
    yr = ops.fakequant_expert_project(xr, wr, adc, rows, mesh, ("data",),
                                      n_d * t)
    yr.backward(dy[:, mine])
    dw = mesh.all_reduce(wr.grad, "data")

    def rel(a, b):
        return float((a - b).norm() / (b.norm() + 1e-30))
    return {"equal": bool(torch.equal(yr.detach(), y_w[:, mine])),
            "dx": rel(xr.grad, dx_e[:, mine]), "dw": rel(dw, dw_e),
            "tie_grad": float(dx_e[0, d * t + 1, 5]),
            "tie_grad_rank": float(xr.grad[0, 1, 5])}


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
            for arch in ARCHS:
                if job == "digital":
                    got[job, arch] = _numeric_run(
                        arch, DIG, data["params"][arch], mesh, STEPS)
                elif job == "qat":
                    got[job, arch] = _numeric_run(
                        arch, QAT[arch], data["params_qat"][arch], mesh, 1)
                elif job == "aux":
                    got[job, arch] = _aux_grads(arch, data["params"][arch],
                                                mesh)
            if job == "reads":
                got[job] = _expert_read_checks(mesh)
    torch.save(res, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ the one device

def _initial_params(arch, extra):
    """The reference's initial parameters (``PRNGKey(0)``) as numpy; both
    packages take them."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    cfg = jax_config(arch, smoke=True).replace(**extra)
    params = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _reference(arch, params):
    """The reference's jitted digital steps from ``params`` over the
    global batches, and ``jax.grad`` of its aux loss on the first."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    from repro.train import optimizer as JO
    from repro.train import train_loop as JL
    cfg = jax_config(arch, smoke=True).replace(**DIG)
    x, y = _batches(cfg.vocab)
    jparams = jax.tree.map(jnp.asarray, params)
    opt = JO.adamw(LR)
    state = {"params": jparams, "opt": opt.init(jparams),
             "step": jnp.zeros((), jnp.int32), "err_fb": ()}
    step = jax.jit(JL.make_train_step(cfg, opt))
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(x[i]),
                                "labels": jnp.asarray(y[i])})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    batch = {"tokens": jnp.asarray(x[0]), "labels": jnp.asarray(y[0])}
    aux = jax.jit(jax.grad(lambda p: JM.loss_fn(p, batch, cfg)[1]["aux"]))(
        jparams)
    return {"losses": losses, "norms": norms,
            "params": jax.tree.map(np.asarray, state["params"]),
            "aux_grads": jax.tree.map(np.asarray, aux)}


def _port_one_device(arch, extra, params_np, n):
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = _cfg(arch, extra)
    opt = adamw(LR)
    params = params_from_numpy(params_np, "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32), "err_fb": ()}
    step = TL.make_train_step(cfg, opt)
    x, y = _batches(cfg.vocab)
    dropped = _dropped(params, cfg, torch.from_numpy(x[0]).long())
    losses, norms = [], []
    for i in range(n):
        state, m = step(state, {"tokens": torch.from_numpy(x[i]).long(),
                                "labels": torch.from_numpy(y[i]).long()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms, "dropped": dropped,
            "params": params_to_numpy(state["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's ranks, the reference and the port's one device."""
    tmp = tmp_path_factory.mktemp("moe_tp")
    params = {a: _initial_params(a, DIG) for a in ARCHS}
    params_qat = {a: _initial_params(a, QAT[a]) for a in ARCHS}
    inp = tmp / "inputs.pt"
    torch.save({"params": params, "params_qat": params_qat}, inp)
    worlds = (2, 4)   # one job a world size, its layouts in turn
    jobs = [mp.start_processes(
        _rank, args=(world, str(tmp / f"rdv-{world}"), str(inp),
                     str(tmp / f"res-{world}")),
        nprocs=world, join=False, start_method="spawn") for world in worlds]
    ref = {a: _reference(a, params[a]) for a in ARCHS}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {a: _port_one_device(a, DIG, params[a], 1) for a in ARCHS}
        one_qat = {a: _port_one_device(a, QAT[a], params_qat[a], 1)
                   for a in ARCHS}
    finally:
        torch.set_num_threads(threads)
    for job in jobs:
        while not job.join():
            pass
    out = {}
    for world in worlds:
        ranks = [torch.load(f"{tmp / f'res-{world}'}.{r}", weights_only=False)
                 for r in range(world)]
        for shape in ranks[0]:
            out[shape] = [r[shape] for r in ranks]
    return {"ref": ref, "one": one, "one_qat": one_qat, "ranks": out}


def _close_params(got, want, lr, n_steps, share=1e-3):
    """The parameter class of the module docstring (at most ``share`` of
    the elements off); returns the count of elements off."""
    off = total = 0
    for path, w in _leaves(want):
        g = np.asarray(_get(got, path))
        bad = np.abs(g - w) > 1e-5 * np.abs(w) + 1e-6
        assert np.all(np.abs(g - w)[bad] <= 2 * n_steps * lr * 1.01), path
        off += int(bad.sum())
        total += w.size
    assert off <= share * total, (off, total)
    return off


def _close(a, b, rel=1e-5):
    return all(abs(x - y) <= rel * abs(y) + 1e-7 for x, y in zip(a, b))


#: the QAT class of each model: the loss and grad norm's relative bound
#: and the share of parameters that may lie off the 1e-5 class (see the
#: module docstring)
QAT_CLASS = {"llama4-scout-17b-a16e": (1e-5, 1e-3),
             "deepseek-v2-lite-16b": (1e-4, 5e-2)}
LAYOUTS = [(2, 1), (2, 2), (1, 4), (4, 1)]
LAYOUT_IDS = ["2x1", "2x2", "1x4", "4x1"]


@pytest.mark.parametrize("arch", ARCHS, ids=["llama4", "deepseek"])
@pytest.mark.parametrize("shape", LAYOUTS, ids=LAYOUT_IDS)
def test_moe_digital_step_matches_reference(runs, shape, arch):
    """One global dispatch over the data ranks (global capacity, pairs
    dropped in the global order, the aux's global means), and on
    ``model`` ranks the experts over ``model`` and the attention, shared
    experts and vocab split: the reference's step over the global
    batch."""
    ref = runs["ref"][arch]
    one = runs["one"][arch]
    assert one["dropped"] > 0, "the one-device dispatch drops no pair"
    per = runs["ranks"][shape]
    assert sum(r["digital", arch]["dropped"] for r in per) \
        == one["dropped"] * shape[1], [r["digital", arch]["dropped"]
                                       for r in per]
    for r in per:
        got = r["digital", arch]
        assert got["held"]
        assert _close(got["losses"], ref["losses"]), (got["losses"],
                                                      ref["losses"])
        assert _close(got["norms"], ref["norms"]), (got["norms"],
                                                    ref["norms"])
        _close_params(got["params"], ref["params"], LR, STEPS)


@pytest.mark.parametrize("arch", ARCHS, ids=["llama4", "deepseek"])
def test_moe_plan_on_model_ranks(runs, arch):
    """``ep`` and the attention (GQA's ``attn`` or MLA's ``mla``), the
    shared experts' FFN and the vocab split on 2x2 and 1x4; nothing on
    4x1 and 2x1 (FSDP alone); ``seq`` never (the dense family's)."""
    attn = "mla" if arch.startswith("deepseek") else "attn"
    on = {"ep", attn, "attn_row", "ffn", "ffn_row", "vocab"}
    for shape in LAYOUTS:
        for job in ("digital", "qat") if shape != (2, 1) else ("digital",):
            plan = runs["ranks"][shape][0][job, arch]["plan"]
            want = on if shape[1] > 1 else set()
            assert {k for k, v in plan.items() if v} == want, (shape, job,
                                                               plan)


@pytest.mark.parametrize("arch", ARCHS, ids=["llama4", "deepseek"])
@pytest.mark.parametrize("shape", LAYOUTS[1:], ids=LAYOUT_IDS[1:])
def test_moe_qat_step_matches_one_device(runs, shape, arch):
    one = runs["one_qat"][arch]
    for r in runs["ranks"][shape]:
        got = r["qat", arch]
        assert got["held"]
        rel, share = QAT_CLASS[arch]
        assert _close(got["losses"], one["losses"], rel), (got["losses"],
                                                           one["losses"])
        assert _close(got["norms"], one["norms"], rel), (got["norms"],
                                                         one["norms"])
        _close_params(got["params"], one["params"], LR, 1, share)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_expert_read_shares_scale_over_data_ranks(runs, shape):
    """A data rank's rows of an expert-stack read: bit-equal to the whole
    buffer's read (each expert's scale the max over the data ranks); the
    gradient the whole expression's, expert 0's tied max sharing the
    scale's gradient across the data ranks."""
    for r in runs["ranks"][shape]:
        got = r["reads"]
        assert got["equal"]
        assert got["dx"] <= 1e-5 and got["dw"] <= 1e-5, got
        assert got["tie_grad"] != 0.0
        assert abs(got["tie_grad_rank"] - got["tie_grad"]) \
            <= 1e-6 * abs(got["tie_grad"]), got


@pytest.mark.parametrize("arch", ARCHS, ids=["llama4", "deepseek"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 1)],
                         ids=["2x1", "2x2", "4x1"])
def test_aux_gradient_matches_reference(runs, shape, arch):
    want = runs["ref"][arch]["aux_grads"]
    for r in runs["ranks"][shape]:
        got = r["aux", arch]
        for path, w in _leaves(want):
            g = np.asarray(_get(got, path))
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert err <= 1e-5 or np.linalg.norm(w) < 1e-12, (path, err)


# ------------------------------------------------------------------ the CLI

CLI = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--device", "cpu",
       "--seq-len", "16", "--global-batch", "4", "--log-every", "100",
       "--lr", "1e-3", "--dtype", "float32"]


def _cli_rank(rank, world, rdv, argv):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch import train
    train.main(argv, init_method=f"file://{rdv}", rank=rank,
               world_size=world)
    dist.destroy_process_group()


def _metrics(path):
    return [json.loads(line) for line in open(path)]


def test_cli_moe_2x2_resumes_on_1x1(tmp_path):
    """deepseek-v2-lite's smoke config: 4 steps on 2x2 (MLA by heads,
    experts over ``model``), checkpointed every 2; its step-2 checkpoint
    resumed for steps 3-4 on 1x1 (in this process)."""
    from repro_torch.core.shardctx import clear_shard_context
    from repro_torch.launch import train
    ckpt = tmp_path / "ckpt"
    whole = tmp_path / "whole.jsonl"
    mp.spawn(_cli_rank, args=(4, str(tmp_path / "rdv"), CLI + [
        "--steps", "4", "--mesh", "2x2", "--ckpt-dir", str(ckpt),
        "--ckpt-every", "2", "--metrics-out", str(whole)]), nprocs=4)
    a = _metrics(whole)
    assert [m["step"] for m in a] == [1, 2, 3, 4]
    d = tmp_path / "ckpt-one"
    d.mkdir()
    shutil.copytree(ckpt / "step_00000002", d / "step_00000002")
    (d / "step_00000002.COMMITTED").write_text("ok")
    one = tmp_path / "one.jsonl"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(CLI + ["--steps", "4", "--mesh", "1x1", "--ckpt-dir",
                          str(d), "--metrics-out", str(one)])
    finally:
        torch.set_num_threads(threads)
        clear_shard_context()
    got = _metrics(one)
    assert [m["step"] for m in got] == [3, 4]
    for x, y in zip(a[2:], got):
        assert x["batch"] == y["batch"]
        assert abs(x["loss"] - y["loss"]) <= 1e-5 * abs(x["loss"])
