"""Tensor parallelism of the SSM, hybrid and cross-attention families'
numeric step on gloo CPU ranks, against the reference's jitted one-device
step, ``jax.grad`` and the port's one-device QAT step.

One job of 4 ranks runs every check of the 2x2, 1x4 and 4x1 layouts in
turn and one of 2 ranks those of 2x1, the two at once; the ranks
rendezvous through a file under ``tmp_path``, run one thread each and
import no JAX.  The models are the smoke configs of mamba2-1.3b (the
SSD layer split by heads), zamba2-1.2b (its SSD layers and the shared
attention block on the dense plan), whisper-medium (the encoder and the
decoder, its cross-attention's fused ``wqkv`` read once over the tokens
and the frames) and llama-3.2-vision-90b (self and cross blocks), in
float32, the cross gates set non-zero in the numpy tree both packages
get (the reference's start at 0).  Tolerances:

  * digital, on 2x1, 2x2, 1x4 and 4x1, against the reference's jitted
    one-device step over the same global batch
    (``repro.train.train_loop.make_train_step`` with ``adamw``, the same
    numpy parameters through ``repro_torch.convert``): the loss (the mean
    over the data ranks) and ``grad_norm`` of each of 2 steps within 1e-5
    relative; the parameters after them within 1e-5 relative plus 1e-6,
    except elements whose gradient lies within float32 rounding of 0
    (adamw's ``m / sqrt(v)`` a ratio of rounding errors), counted (at most
    1e-3 of the elements) and bounded by ``4 lr``;
  * QAT (the fakequant read, 16-row tiles) on 2x2, 1x4 and 4x1 against
    the port's 1x1 QAT step (itself held to the reference by
    ``tests/test_torch_ssm.py``, ``test_torch_hybrid.py``,
    ``test_torch_audio.py`` and ``test_torch_vlm.py``): the loss and
    ``grad_norm`` within 1e-5 relative, the parameters within the class
    above.  The widths make every rank's columns whole 64-column range
    blocks and every row split whole 16-row tiles on 2x2 and 1x4: the SSD
    layers at ``d_model`` 128, ``ssm_head_dim`` 4 and ``ssm_state`` 64 (64
    heads; ``in_proj`` 256 + 256 + 64 + 64 + 64 = 704 columns, a rank's
    64 + 64 of z and x beside B, C and dt whole; ``out_proj`` 64 rows a
    rank on 1x4), the attention at ``head_dim`` 64 and ``d_ff`` 256.  Both
    steps take the card's route, the read under
    ``kernels.ops.FakequantRead`` (``resolve_impl`` answering ``cuda``),
    its CPU plain version forming the per-token range from the 64-column
    partials in order, as the kernel does: the whole read's plain version
    sums q² over the row in one reduction and a split read's from the
    ranks' partials, two orders whose lsbs lie an ulp apart, and QAT's
    gradient, which flows only through the ranges, turns the code flips
    they cause into sign flips of adamw's step (on mamba2, 6e-4 of the
    parameters; on zamba2 7.6%).  On the card the kernel's split forms
    are the whole read's bit for bit (``chip_smoke.py`` phase 29);
  * the SSD layer's gradients (mamba2, digital, 2x2 and 1x4: the loss's
    gradient through the ranks' blocks, ``NumericParallel.reduce_grads``
    and unsharded) against ``jax.grad`` of the reference's loss over the
    global batch: every leaf within 1e-5 relative in norm, among them
    ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``, the norm's
    scale and ``in_proj``'s columns that every rank holds whole (B, C, dt),
    checked apart; and in mamba2's QAT forward on the card's route (every
    read one device's), the gated norm's output of each layer on every
    ``model`` rank bit-equal to the one-device forward's (a digital
    row-split ``out_proj`` sums the ranks' partial products, so only the
    first layer's input would be one device's there);
  * a column split of a leaf with parts whole on every rank (``in_proj``'s
    B, C, dt) read on 1x4: ``dx`` and ``dw`` (each rank's whole parts'
    cotangent its share of the whole, as the SSD scan gives it) against
    ``torch.autograd`` of the whole eager expression within 1e-5 relative
    (each rank's range gradient through a whole part counted once);
  * each rank holds the policy's block of every leaf of ``params``, ``m``
    and ``v``, ``in_proj`` cut by parts (its whole parts on every rank);
    the plan's flags are as the layout allows (``ssm`` for mamba2 and
    zamba2, ``attn``, ``attn_row``, ``ffn``, ``ffn_row`` for zamba2's
    shared block and the other two's blocks, ``vocab`` for all four on
    ``model`` ranks; none on 4x1 and 2x1);
  * the CLI: a zamba2 smoke run on 2x2 checkpointed at step 2 and resumed
    on 1x1: the same batches bit for bit and the uninterrupted run's
    losses within 1e-5 relative.
"""
import contextlib
import json
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

LR = 1e-3
STEPS = 2
B, S = 4, 16
ARCHS = ("mamba2-1.3b", "zamba2-1.2b", "whisper-medium",
         "llama-3.2-vision-90b")
IDS = ("mamba2", "zamba2", "whisper", "vlm")
SSM_ARCH = "mamba2-1.3b"
#: The cross blocks' gates in the trees both packages receive.
GATES = {"gate_attn": 0.5, "gate_ffn": 0.75}
DIG = dict(dtype="float32")
_Q = dict(DIG, analog=True, analog_mode="fakequant", analog_rows=16)
_SSD = dict(d_model=128, ssm_head_dim=4, ssm_state=64)
_ATT = dict(head_dim=64, d_ff=256)
#: QAT widths (module docstring)
QAT = {"mamba2-1.3b": dict(_Q, **_SSD),
       "zamba2-1.2b": dict(_Q, **_SSD, **_ATT),
       "whisper-medium": dict(_Q, **_ATT),
       "llama-3.2-vision-90b": dict(_Q, **_ATT)}
JOBS = {(2, 2): ("digital", "qat", "grads"),
        (1, 4): ("digital", "qat", "grads", "read"),
        (4, 1): ("digital", "qat"),
        (2, 1): ("digital",)}


def _cfg(arch, extra):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(**extra)


def _stream(cfg):
    """The cross-attention families' second stream's key and width."""
    if cfg.family == "vlm":
        return "vision", cfg.n_vision_tokens
    if cfg.family == "audio":
        return "audio", cfg.n_audio_frames
    return None, 0


def _batches(cfg):
    """``STEPS`` global batches (numpy): tokens, labels and the stub
    frontend's stream."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, cfg.vocab, (STEPS, B, S + 1)).astype(np.int32)
    out = {"tokens": x[..., :-1], "labels": x[..., 1:]}
    key, n = _stream(cfg)
    if key:
        out[key] = rng.standard_normal(
            (STEPS, B, n, cfg.d_model)).astype(np.float32)
    return out


def _batch(batches, i, rows=slice(None)):
    """Step ``i``'s batch as torch tensors, its ``rows``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[i, rows])).long()
            if k in ("tokens", "labels")
            else torch.from_numpy(np.ascontiguousarray(v[i, rows]))
            for k, v in batches.items()}


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


@contextlib.contextmanager
def card_route():
    """The fakequant reads on the card's route on the CPU: every read
    through ``kernels.ops.FakequantRead`` (forward the read's plain
    version, backward the eager expression's VJP), the whole read's
    plain version forming its range from the 64-column partials in
    order, as the kernel and the split read's plain halves do."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import xbar_vmm as K
    saved = ops.resolve_impl, K._fakequant_plain

    def blocked(x, w, sc, adc, rows):
        return K._fakequant_plain_finish(
            *K._fakequant_plain_head(x, w, sc, adc, rows), w.shape[1], adc)
    ops.resolve_impl = lambda impl, x: "cuda"
    K._fakequant_plain = blocked
    try:
        yield
    finally:
        ops.resolve_impl, K._fakequant_plain = saved


# ------------------------------------------------------------- the ranks

def _held_shape(w, path, spec, cfg, mesh):
    """The policy's block shape of the whole leaf ``w``, a fused leaf's
    last dim cut by parts (its whole parts on every ``model`` rank)."""
    from repro_torch.launch import sharding as S_
    shape = [len(range(*sl.indices(d)))
             for d, sl in zip(w.shape, S_.block_slices(w.shape, spec, mesh))]
    parts = S_._model_parts(path, tuple(w.shape), spec, cfg, mesh)
    if parts is not None:
        shape[-1] = len(S_.part_columns(parts, mesh.shape["model"],
                                        mesh.coords["model"]))
    return tuple(shape)


def _numeric_run(arch, extra, params_np, mesh, n_steps):
    """``n_steps`` adamw steps of the FSDP / TP step from whole numpy
    parameters: the global losses and grad norms, the whole parameters
    after them, the plan and whether the held blocks are the policy's."""
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
    held = all(tuple(_get(tree, p).shape)
               == _held_shape(w, p, _get(policy, p), cfg, mesh)
               for tree in (st["params"], st["opt"]["m"], st["opt"]["v"])
               for p, w in _leaves(params))
    batches = _batches(cfg)
    losses, norms = [], []
    for i in range(n_steps):
        st, m = step(st, _batch(batches, i, _rows(mesh)))
        loss = mesh.all_reduce(m["loss"].reshape(1), "data") \
            / mesh.shape["data"]
        losses.append(float(loss))
        norms.append(float(m["grad_norm"]))
    whole = TL.unshard_state(st, cfg, mesh)
    return {"losses": losses, "norms": norms, "plan": step.numeric.plan(),
            "params": params_to_numpy(whole["params"]), "held": held,
            "counts": dict(step.numeric.counts)}


@contextlib.contextmanager
def _norm_outputs(out):
    """Record the SSD layer's gated-norm outputs into ``out``."""
    from repro_torch.models import ssm
    saved = ssm.rmsnorm

    def norm(p, y, eps):
        r = saved(p, y, eps)
        out.append(r.detach().clone())
        return r
    ssm.rmsnorm = norm
    try:
        yield
    finally:
        ssm.rmsnorm = saved


def _ssm_grads(params_np, mesh):
    """mamba2's loss gradient on this rank's rows through its blocks,
    data-parallel mean (``reduce_grads``), unsharded whole."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.core import shardctx
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.sharding import NumericParallel
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_map
    cfg = _cfg(SSM_ARCH, DIG)
    npar = NumericParallel(cfg, mesh)
    blocks = S_.shard_tree(params_from_numpy(params_np, "cpu"), npar.specs,
                           cfg, mesh)
    blocks = tree_map(lambda p: p.detach().requires_grad_(True), blocks)
    batch = _batch(_batches(cfg), 0, _rows(mesh))
    with shardctx.numeric_parallel(npar):
        M.loss_fn(blocks, batch, cfg)[0].backward()
    grads = npar.reduce_grads(tree_map(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        blocks))
    return {"grads": params_to_numpy(S_.unshard_tree(grads, npar.specs,
                                                     npar.like, cfg, mesh))}


def _ssm_norms(params_np, mesh):
    """The gated norm's outputs of mamba2's QAT forward (the card's
    route: every read one device's, the row-split ``out_proj`` too) split
    over the mesh (this rank's rows; each read's DAC scale the max over
    the data ranks) and, at those rows, on one device over the global
    batch."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import shardctx
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.sharding import NumericParallel
    from repro_torch.models import model as M
    cfg = _cfg(SSM_ARCH, QAT[SSM_ARCH])
    npar = NumericParallel(cfg, mesh)
    whole = params_from_numpy(params_np, "cpu")
    blocks = S_.shard_tree(whole, npar.specs, cfg, mesh)
    batches = _batches(cfg)
    split, one = [], []
    with torch.no_grad(), card_route():
        with _norm_outputs(one):
            M.loss_fn(whole, _batch(batches, 0), cfg)
        with shardctx.numeric_parallel(npar), _norm_outputs(split):
            M.loss_fn(blocks, _batch(batches, 0, _rows(mesh)), cfg)
    return {"split": split, "one": [t[_rows(mesh)] for t in one]}


def _whole_part_read(mesh):
    """A column split of ``in_proj`` at the QAT widths on this rank (B, C
    and dt whole on every rank, their cotangent this rank's share of the
    whole): ``dx`` (summed over ``model``) and ``dw`` (its whole parts
    summed over ``model`` as ``copy_to`` does) against ``torch.autograd``
    of the whole eager expression."""
    from repro_torch.core import shardctx
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as S_
    cfg = _cfg(SSM_ARCH, QAT[SSM_ARCH])
    adc = AdcConfig(in_bits=cfg.analog_in_bits, out_bits=cfg.analog_out_bits)
    m, r = mesh.shape["model"], mesh.coords["model"]
    d_in, h, gn = S_.ssm_dims(cfg)
    width = 2 * d_in + 2 * gn + h
    parts = S_.fused_parts(("in_proj",), width, cfg, m)
    cols = S_.part_columns(parts, m, r)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(64, cfg.d_model, generator=gen)
    w = torch.randn(cfg.d_model, width, generator=gen) / 12.0
    dy = torch.randn(64, width, generator=gen)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    dx_e, dw_e = torch.autograd.grad(ops._fakequant_eager(xg, wg, adc, 16),
                                     [xg, wg], dy)
    # a whole part's cotangent split among the ranks (each rank's heads'
    # share of it), the split parts' each on its own rank
    share = torch.cat([torch.full((w_ // m if sp else w_,),
                                  1.0 if sp else (r + 1.0) / (m * (m + 1) / 2))
                       for w_, sp in parts])
    xr = x.clone().requires_grad_()
    wr = w[:, cols].clone().requires_grad_()
    y = ops.fakequant_split_project(
        shardctx.copy_to(xr, mesh, ("model",)), wr, adc, 16, mesh,
        ("model",), (), width, S_.range_blocks(parts, m))
    y.backward(dy[:, cols] * share)
    whole = ~torch.cat([torch.full((w_ // m if sp else w_,), sp)
                        for w_, sp in parts])
    # copy_to's sum over model of the whole parts' weight gradient
    dw_whole = mesh.all_reduce(wr.grad[:, whole].contiguous(), "model")

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    return {"dx": rel(xr.grad, dx_e),
            "dw_whole": rel(dw_whole, dw_e[:, cols[whole]]),
            "dw_split": rel(wr.grad[:, ~whole], dw_e[:, cols[~whole]])}


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
            if job == "grads":
                got[job] = _ssm_grads(data["params"][SSM_ARCH], mesh)
                got["norms"] = _ssm_norms(data["params_qat"][SSM_ARCH],
                                          mesh)
            elif job == "read":
                got[job] = _whole_part_read(mesh)
            for arch in ARCHS if job in ("digital", "qat") else ():
                if job == "digital":
                    got[job, arch] = _numeric_run(
                        arch, DIG, data["params"][arch], mesh, STEPS)
                else:
                    with card_route():
                        got[job, arch] = _numeric_run(
                            arch, QAT[arch], data["params_qat"][arch], mesh,
                            1)
    torch.save(res, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------ the one device

def _with_gates(tree):
    """``tree`` (numpy) with every cross block's gates set to ``GATES``."""
    if "cross_layers" not in tree:
        return tree
    tree = dict(tree)
    cross = dict(tree["cross_layers"])
    for k, v in GATES.items():
        cross[k] = np.full_like(cross[k], v)
    tree["cross_layers"] = cross
    return tree


def _initial_params(arch, extra):
    """The reference's initial parameters (``PRNGKey(0)``) as numpy, the
    cross gates set; both packages take them."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    cfg = jax_config(arch, smoke=True).replace(**extra)
    params = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(0))
    return _with_gates(jax.tree.map(np.asarray, params))


def _reference(arch, params):
    """The reference's jitted digital steps from ``params`` over the
    global batches; for the SSM config also ``jax.grad`` of its loss on
    the first."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    from repro.train import optimizer as JO
    from repro.train import train_loop as JL
    cfg = jax_config(arch, smoke=True).replace(**DIG)
    batches = _batches(cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    opt = JO.adamw(LR)
    state = {"params": jparams, "opt": opt.init(jparams),
             "step": jnp.zeros((), jnp.int32), "err_fb": ()}
    step = jax.jit(JL.make_train_step(cfg, opt))
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v[i])
                                for k, v in batches.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "norms": norms,
           "params": jax.tree.map(np.asarray, state["params"])}
    if arch == SSM_ARCH:
        batch = {k: jnp.asarray(v[0]) for k, v in batches.items()}
        grads = jax.jit(jax.grad(lambda p: JM.loss_fn(p, batch, cfg)[0]))(
            jparams)
        out["grads"] = jax.tree.map(np.asarray, grads)
    return out


def _port_one_device(arch, extra, params_np, n):
    """The port's 1x1 steps (QAT on the card's route)."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.train import train_loop as TL
    from repro_torch.train.optimizer import adamw
    cfg = _cfg(arch, extra)
    opt = adamw(LR)
    params = params_from_numpy(params_np, "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32), "err_fb": ()}
    step = TL.make_train_step(cfg, opt)
    batches = _batches(cfg)
    losses, grad_norms = [], []
    route = card_route() if cfg.analog else contextlib.nullcontext()
    with route:
        for i in range(n):
            state, m = step(state, _batch(batches, i))
            losses.append(float(m["loss"]))
            grad_norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": grad_norms,
            "params": params_to_numpy(state["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's ranks, the reference and the port's one device."""
    tmp = tmp_path_factory.mktemp("family_tp")
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
    return {"ref": ref, "one_qat": one_qat, "ranks": out}


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


LAYOUTS = [(2, 1), (2, 2), (1, 4), (4, 1)]
LAYOUT_IDS = ["2x1", "2x2", "1x4", "4x1"]


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
@pytest.mark.parametrize("shape", LAYOUTS, ids=LAYOUT_IDS)
def test_family_digital_step_matches_reference(runs, shape, arch):
    """On ``model`` ranks the SSD layers split by heads, the attention and
    FFN blocks (the shared block's, the encoder's and decoder's, the
    VLM's self and cross blocks) column- and row-parallel, the vocab
    split: the reference's step over the global batch."""
    ref = runs["ref"][arch]
    for r in runs["ranks"][shape]:
        got = r["digital", arch]
        assert got["held"]
        assert _close(got["losses"], ref["losses"]), (got["losses"],
                                                      ref["losses"])
        assert _close(got["norms"], ref["norms"]), (got["norms"],
                                                    ref["norms"])
        _close_params(got["params"], ref["params"], LR, STEPS)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
@pytest.mark.parametrize("shape", LAYOUTS[1:], ids=LAYOUT_IDS[1:])
def test_family_qat_step_matches_one_device(runs, shape, arch):
    one = runs["one_qat"][arch]
    for r in runs["ranks"][shape]:
        got = r["qat", arch]
        assert got["held"]
        assert _close(got["losses"], one["losses"]), (got["losses"],
                                                      one["losses"])
        assert _close(got["norms"], one["norms"]), (got["norms"],
                                                    one["norms"])
        _close_params(got["params"], one["params"], LR, 1)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_family_plan_on_model_ranks(runs, arch):
    """``ssm`` for the SSD layers, the dense plan for every attention and
    FFN block, ``vocab`` for all four on 2x2 and 1x4 (digital and QAT);
    nothing on 4x1 and 2x1; the SSD norm's gather counted where ``ssm``
    is on."""
    cfg = _cfg(arch, DIG)
    on = {"vocab"}
    if cfg.ssm_state:
        on.add("ssm")
    if cfg.n_heads:
        on |= {"attn", "attn_row", "ffn", "ffn_row"}
    for shape in LAYOUTS:
        for job in ("digital", "qat") if shape != (2, 1) else ("digital",):
            got = runs["ranks"][shape][0][job, arch]
            want = on if shape[1] > 1 else set()
            assert {k for k, v in got["plan"].items() if v} == want, (
                shape, job, got["plan"])
            assert (got["counts"]["norm_gather_bytes"] > 0) \
                == ("ssm" in want), (shape, job, got["counts"])


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_family_leaves_kept_split(arch):
    """On 1x4 no projection of the SSD layers, the shared block, the
    encoder, the decoder or the VLM's blocks is gathered whole over
    ``model`` before its layer runs: each keeps the dim its plan splits
    (``NumericParallel.kept``); on 4x1 none does."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import NumericParallel
    cfg = _cfg(arch, DIG)
    npar = NumericParallel(cfg, Mesh((1, 4), ("data", "model"),
                                     coords=(0, 1)))
    cols = {"wqkv", "w_upgate", "w_up", "in_proj"}
    rows = {"wo", "w_down", "out_proj"}
    paths = [p for p, _ in _leaves(npar.like)
             if len(p) >= 2 and p[-2] in cols | rows and p[-1] == "w"
             and p[0] != "lm_head"]
    assert paths
    for p in paths:
        assert npar.kept(p) == (-1 if p[-2] in cols else -2), p
    far = NumericParallel(cfg, Mesh((4, 1), ("data", "model"),
                                    coords=(1, 0)))
    assert all(far.kept(p) is None for p in paths)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_ssm_gradients_match_jax_grad(runs, shape):
    """Every leaf's gradient within 1e-5 relative in norm of ``jax.grad``:
    the replicated leaves a rank uses in part (``conv_w``, ``conv_b``,
    ``a_log``, ``dt_bias``, ``d_skip``: sliced after a ``copy_to``), the
    norm's scale, and ``in_proj``'s columns every rank holds whole (their
    gradient summed over ``model`` by a ``copy_to``), checked apart."""
    from repro_torch.launch import sharding as S_
    want = runs["ref"][SSM_ARCH]["grads"]
    cfg = _cfg(SSM_ARCH, DIG)
    d_in, h, gn = S_.ssm_dims(cfg)
    whole = slice(2 * d_in, None)          # B, C and dt
    for r in runs["ranks"][shape]:
        got = r["grads"]["grads"]
        for path, w in _leaves(want):
            g = np.asarray(_get(got, path))
            err = np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30)
            assert err <= 1e-5, (path, err)
        g = _get(got, ("layers", "ssm", "in_proj", "w"))[..., whole]
        w = want["layers"]["ssm"]["in_proj"]["w"][..., whole]
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
    for k in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm"):
        assert all(np.linalg.norm(v) > 0 for _, v in
                   _leaves(want["layers"]["ssm"][k])), k


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_ssm_gated_norm_is_one_devices(runs, shape):
    """The gated norm over the whole ``d_in`` runs whole on every rank
    after its input is gathered: in mamba2's QAT forward on the card's
    route (every read one device's, ``out_proj``'s row split too), each
    layer's norm output on every ``model`` rank bit-equal to the
    one-device forward's on the rank's rows (an all-reduce of the ranks'
    partial sums of squares would move every token's scale by ulps)."""
    for r in runs["ranks"][shape]:
        norms, one = r["norms"]["split"], r["norms"]["one"]
        assert len(norms) == len(one) > 0
        for a, b in zip(norms, one):
            assert torch.equal(a, b)


def test_whole_part_read_gradient(runs):
    """``in_proj``'s split read with B, C and dt whole on every rank of
    1x4: the whole expression's ``dx`` and ``dw``, each rank's range
    gradient through a whole part counted once."""
    for r in runs["ranks"][(1, 4)]:
        got = r["read"]
        assert got["dx"] <= 1e-5 and got["dw_whole"] <= 1e-5 \
            and got["dw_split"] <= 1e-5, got


# ------------------------------------------------------------------ the CLI

CLI = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
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


def test_cli_hybrid_2x2_resumes_on_1x1(tmp_path):
    """zamba2's smoke config: 4 steps on 2x2 (the SSD layers by heads, the
    shared block on the dense plan), checkpointed every 2; its step-2
    checkpoint resumed for steps 3-4 on 1x1 (in this process)."""
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
