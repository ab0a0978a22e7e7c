"""Serving under the sharding policy (``models.model.prefill`` /
``decode_step`` with ``mesh=``, ``launch.sharding.ServeParallel``) on
gloo CPU ranks, against the reference's ``prefill`` / ``decode_step`` and
against the port's one-device serving.

One job of 4 ranks serves every case on the 2x2, 1x4 and 4x1 layouts in
turn; the ranks rendezvous through a file under ``tmp_path``, run one
thread each and import no JAX.  The models are the smoke configs of
lm100m (4 kv heads: the cache split by heads), gemma-2b (one kv head:
the cache split along the sequence on 2 and 4 ``model`` ranks),
starcoder2-3b (2 kv heads: by heads on 2, along the sequence on 4),
mamba2-1.3b (the SSD state by heads, the conv state by the rank's
channels) and zamba2-1.2b (its SSD layers and its shared block's caches
by heads), in float32, digital and fakequant (16-row tiles; the widths
of ``tests/test_torch_tensor_parallel.py`` and
``test_torch_family_parallel.py``, and gemma-2b at head_dim 256, so
that every rank's columns are whole 64-column range blocks and every
row split whole tiles).  Each case is a prefill of 8 x 8 tokens into a
32-slot cache and three decode steps of given tokens, each rank serving
its rows of the batch (2 a data rank on 4x1).  The fakequant reads take
the card's route (``tests/test_torch_family_parallel.card_route``: the
whole read's plain version forms its range from the 64-column partials,
as the kernel and the split reads do).  Tolerances:

  * digital: every rank's last-token logits of the prefill and of each
    decode step against the reference's jitted ``prefill`` /
    ``decode_step`` (the same numpy weights, the reference's
    ``init_params`` at ``PRNGKey(0)``, through ``repro_torch.convert``;
    the float32 digital program agrees with its op-by-op result to
    float32 rounding, ``tests/test_torch_serve.py``): rtol = atol = 1e-5;
  * fakequant: lm100m (by kv heads), gemma-2b (one kv head: along the
    sequence on 1x4 and 2x2) and mamba2-1.3b (the SSD state by heads)
    against the reference's ``prefill`` / ``decode_step`` evaluated op by
    op (``jax.disable_jit``: its jitted fakequant serving flips ADC codes
    against its own op-by-op one) on the same weights, read by read as
    ``tests/test_torch_forward_flips.py`` holds a forward: each rank's
    every read, on its own operand, against the reference's read (its
    rows, its columns), then the reference's result put in its place.
    The read class: within one ADC lsb per row tile (the sum over the
    read's row tiles of each token's lsb) and moved by an ADC code (more
    than half a row tile's mean lsb) at under ``MOVED`` = 2% of the
    read's outputs over the ranks.  Free-running, the two packages' float32
    sums differ by an ulp here and there, and an 8-bit code at a rounding
    boundary flips and carries through the layers (the port's one-device
    serving of these weights is itself hundredths off the op-by-op
    logits);
    read by read the port's one device moves under 1% of any read's
    outputs, while a DAC scale taken over two of the batch's rows alone
    moves about half of most reads' outputs
    (``test_read_class_catches_a_dac_scale_over_a_ranks_rows``).  The
    logits with the reads replayed: rtol = atol = 1e-5 and the same
    greedy tokens.  zamba2's smoke stack (no trailing layers) cannot run
    op by op (a zero-length scan), and starcoder2-3b's cases are those of
    lm100m and gemma-2b, so their fakequant layouts are held to the
    port's one-device serving alone (which ``tests/test_torch_hybrid.py``
    and ``test_torch_registry.py`` hold to the reference);
  * against the port's one-device serving of the same weights (digital
    and fakequant): rtol = atol = 1e-5 and the same greedy token a row a
    step.  Bit-equality is
    not reached on the CPU: a digital row-parallel read (``wo``,
    ``w_down``, ``out_proj``) sums the ranks' partial products over
    ``model``, and the decode attention's batched products (the
    flash-decoding partials' einsums) round otherwise at another count
    of rows, heads or slots (MKL picks other kernels; so does a read of
    one row).  The sequence split's combine itself is the one device's
    bit for bit: fed the one-device decode's own chunk partials, each
    rank's in turn, it gives the one-device decode's output;
  * each rank's held bytes of the parameters and the cache equal
    ``launch.dryrun.reckon``'s for its coordinates, and those the
    policy's (``launch.sharding.params_shardings`` / ``cache_shardings``)
    for the dense family; the SSM and hybrid families hold beyond the
    policy exactly ``in_proj``'s B, C and dt columns and the conv state's
    B and C channels, whole on every ``model`` rank (one group);
  * a sequence split whose slots are not whole flash-decoding chunks
    raises, and so does a chunked prefill against a sequence-split cache;
    against a cache split by kv heads a chunked prefill runs on the
    rank's heads, as one device's within 1e-5.
"""
import contextlib
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ARCHS = ("lm100m", "gemma-2b", "starcoder2-3b", "mamba2-1.3b",
         "zamba2-1.2b")
MODES = ("digital", "fakequant")
LAYOUTS = ((2, 2), (1, 4), (4, 1))
B, S, MAX_LEN, STEPS = 8, 8, 32, 3
DIG = dict(dtype="float32")
_Q = dict(DIG, analog=True, analog_mode="fakequant", analog_rows=16)
_SSD = dict(d_model=128, ssm_head_dim=4, ssm_state=64)
#: fakequant widths (module docstring)
QAT = {"lm100m": dict(_Q, head_dim=64, d_ff=256),
       "gemma-2b": dict(_Q, head_dim=256, d_ff=256),
       "starcoder2-3b": dict(_Q, head_dim=128, d_ff=256),
       "mamba2-1.3b": dict(_Q, **_SSD),
       "zamba2-1.2b": dict(_Q, **_SSD, head_dim=64, d_ff=256)}
CASES = [(a, m) for a in ARCHS for m in MODES]
#: the fakequant cases held to the reference's op-by-op serving: one
#: of each cache split (zamba2's smoke stack cannot run op by op)
OP_BY_OP = ("lm100m", "gemma-2b", "mamba2-1.3b")
#: the read class's share of a read's outputs moved by an ADC code
#: (module docstring)
MOVED = 0.02
CASE_IDS = [f"{a}-{m}" for a, m in CASES]
LAYOUT_IDS = ["2x2", "1x4", "4x1"]


def _extra(arch, mode):
    return DIG if mode == "digital" else QAT[arch]


def _cfg(arch, mode):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(**_extra(arch, mode))


def _inputs(vocab):
    rng = np.random.default_rng(32)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (STEPS, B)).astype(np.int32))


def _rows(mesh):
    d, n = mesh.coords["data"], mesh.shape["data"]
    return slice(d * B // n, (d + 1) * B // n)


@contextlib.contextmanager
def _route(mode):
    """The fakequant reads on the card's route (module docstring)."""
    if mode == "digital":
        yield
        return
    from test_torch_family_parallel import card_route
    with card_route():
        yield


def _serve(cfg, params, tokens, steps, mesh=None, rows=slice(None)):
    """Prefill and the decode steps: the last-token logits of each, (1 +
    STEPS, rows, V), and the cache."""
    from repro_torch.models import model as M
    with torch.no_grad():
        lg, cache = M.prefill(params, {"tokens": torch.from_numpy(
            tokens[rows]).long()}, cfg, MAX_LEN, mesh=mesh)
        out = [lg.numpy()]
        for t in steps:
            lg, cache = M.decode_step(params, cache, torch.from_numpy(
                t[rows]).long(), cfg, mesh=mesh)
            out.append(lg.numpy())
    return np.stack(out), cache


# ------------------------------------------------------------- the ranks

def _rank_case(cfg, mode, params_np, mesh):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import sharding as S_
    from repro_torch.models import model as M
    npar = S_.serve_parallel(cfg, mesh)
    blocks = npar.shard_params(params_from_numpy(params_np, "cpu"))
    tokens, steps = _inputs(cfg.vocab)
    with _route(mode):
        logits, cache = _serve(cfg, blocks, tokens, steps, mesh,
                               _rows(mesh))
    whole = M.init_params(cfg, None, "meta")
    wcache = M.cache_specs(cfg, B, MAX_LEN)
    dry = DR.DryMesh(tuple(mesh.shape.values()), mesh.axis_names,
                     coords=tuple(mesh.coords.values()))
    cell = ShapeSpec("decode_smoke", "decode", MAX_LEN, B)
    return {"logits": logits, "plan": npar.plan(),
            "dryrun": DR.reckon(cfg, cell, dry)["mem"],
            "coords": dict(mesh.coords),
            "held": {"params": DR.tree_bytes(blocks),
                     "cache": DR.tree_bytes(cache)},
            "excess": {**DR.leaf_excess(blocks, whole, npar.specs, mesh,
                                        "params"),
                       **DR.leaf_excess(cache, wcache, S_.cache_shardings(
                           wcache, cfg, mesh), mesh, "cache")}}


@contextlib.contextmanager
def _replaying(reads, rows):
    """Every fakequant read of this rank held against the reference's read
    ``reads[i]`` (its rows of the batch ``rows``, its columns found by
    the weight's columns), then the reference's result returned in its
    place: yields the list of each read's ``(largest |difference| over
    the one-lsb-per-row-tile bound, outputs moved by an ADC code (by more
    than half a row tile's mean lsb), outputs)``."""
    from repro_torch.models import layers as L
    got = []
    inner = {n: getattr(L, n) for n in ("fakequant_project",
                                        "fakequant_split_project")}

    def hook(name):
        def read(x, w, *a, **k):
            y = inner[name](x, w, *a, **k)
            ref = reads[len(got)]
            rw = ref["w"]
            want = ref["out"][rows]
            if w.shape[-1] != rw.shape[-1]:     # a column split: its columns
                at = {c.tobytes(): j for j, c in enumerate(rw.T)}
                cols = [at[c.tobytes()] for c in w.numpy().T]
                want = want[..., cols]
            want = torch.from_numpy(np.array(want)).reshape(y.shape)
            lsb = torch.from_numpy(np.array(ref["lsb"][rows])).reshape(
                *y.shape[:-1], 1)
            dev = (y - want).abs()
            got.append((float((dev / (lsb + 1e-6)).max()),
                        int((dev > 0.5 * lsb / ref["tiles"]).sum()),
                        dev.numel()))
            return want.to(y.dtype)
        return read
    for n in inner:
        setattr(L, n, hook(n))
    try:
        yield got
    finally:
        for n, f in inner.items():
            setattr(L, n, f)


def _rank_replayed(arch, params_np, reads, mesh):
    """The fakequant serving of ``arch`` on this rank with the
    reference's reads replayed (:func:`_replaying`)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import sharding as S_
    cfg = _cfg(arch, "fakequant")
    blocks = S_.serve_parallel(cfg, mesh).shard_params(
        params_from_numpy(params_np, "cpu"))
    tokens, steps = _inputs(cfg.vocab)
    with _route("fakequant"), _replaying(reads, _rows(mesh)) as got:
        logits, _ = _serve(cfg, blocks, tokens, steps, mesh, _rows(mesh))
    return {"logits": logits, "reads": got, "n_reads": len(reads)}


def _rank(rank, world, rdv, inp, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", f"file://{rdv}", rank, world)
    data = torch.load(inp, weights_only=False)
    res = {}
    meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
              for shape in LAYOUTS}
    for shape, mesh in meshes.items():
        for arch, mode in CASES:
            res[shape, arch, mode] = _rank_case(
                _cfg(arch, mode), mode, data[arch, mode], mesh)
    reads = Path(f"{inp}.reads")
    for _ in range(6000):       # the parent's op-by-op reference runs
        if reads.exists():
            break
        time.sleep(0.1)
    reads = torch.load(reads, weights_only=False)
    for shape, mesh in meshes.items():
        for arch in OP_BY_OP:
            res[shape, arch, "replayed"] = _rank_replayed(
                arch, data[arch, "fakequant"], reads[arch], mesh)
    torch.save(res, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------ the reference and one device

def _reference(arch, tokens, steps):
    """The reference's initial weights (numpy, ``PRNGKey(0)``) and its
    jitted digital prefill and decode logits."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    jcfg = jax_config(arch, smoke=True).replace(**DIG)
    params = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    jp = jax.tree.map(jnp.asarray, params)
    prefill = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                              MAX_LEN))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    lg, cache = prefill(jp, jnp.asarray(tokens))
    out = [np.asarray(lg)]
    for t in steps:
        lg, cache = decode(jp, cache, jnp.asarray(t))
        out.append(np.asarray(lg))
    return params, np.stack(out)


def _lsb_per_row_tile(x, w, adc, rows):
    """Per token of a fakequant read of ``x`` (..., K) through ``w`` (K,
    N), the sum over its row tiles of one ADC lsb: what one code flip a
    tile can move an output by (``tests/test_torch_tensor_parallel``)."""
    x2 = x.reshape(-1, x.shape[-1]).astype(np.float64)
    lv = float(adc.in_levels)
    sc = max(np.abs(x2).max(), 1e-12) / lv
    xq = np.clip(np.round(x2 / sc), -lv, lv) * sc
    k, pad = w.shape[0], (-w.shape[0]) % rows
    xt = np.pad(xq, ((0, 0), (0, pad))).reshape(len(x2), -1, rows)
    wt = np.pad(w.astype(np.float64), ((0, pad), (0, 0))).reshape(
        -1, rows, w.shape[1])
    q = np.einsum("btr,trn->btn", xt, wt)
    lsb = adc.sat_sigmas * np.sqrt(np.square(q).mean(-1) + 1e-12) \
        / adc.out_levels
    return lsb.sum(1).reshape(x.shape[:-1]).astype(np.float32)


def _reference_op_by_op(arch, params, tokens, steps):
    """The reference's fakequant prefill and decode logits evaluated op
    by op (``jax.disable_jit``; its jnp read on the CPU), and each of its
    fakequant reads: the weight, the result and the one-lsb-per-row-tile
    bound of each token.  ``REPRO_REMAT=none`` keeps the layer scan's
    reads concrete (``tests/test_torch_forward_flips.py``); it changes no
    value."""
    import jax
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    jcfg = jax_config(arch, smoke=True).replace(**QAT[arch])
    jp = jax.tree.map(jnp.asarray, params)
    reads, inner = [], JL.fakequant_project

    def recorded(x, w, adc, rows, **kw):
        out = inner(x, w, adc, rows, **kw)
        x, w = np.asarray(x), np.asarray(w)
        reads.append({"w": w, "out": np.asarray(out),
                      "lsb": _lsb_per_row_tile(x, w, adc, rows),
                      "tiles": -(-w.shape[0] // rows)})
        return out
    prev = os.environ.get("REPRO_REMAT")
    os.environ["REPRO_REMAT"] = "none"
    JL.fakequant_project = recorded
    try:
        with jax.disable_jit():
            lg, cache = JM.prefill(jp, {"tokens": jnp.asarray(tokens)},
                                   jcfg, MAX_LEN)
            out = [np.asarray(lg)]
            for t in steps:
                lg, cache = JM.decode_step(jp, cache, jnp.asarray(t), jcfg)
                out.append(np.asarray(lg))
    finally:
        JL.fakequant_project = inner
        if prev is None:
            os.environ.pop("REPRO_REMAT")
        else:
            os.environ["REPRO_REMAT"] = prev
    return np.stack(out), reads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference, the port's one device and every layout's ranks;
    the one-device runs and the reference's op-by-op ones while the
    ranks serve (the ranks wait for the latter's reads to replay them)."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import model as M
    tmp = tmp_path_factory.mktemp("serve")
    params, ref = {}, {}
    for arch, mode in CASES:
        cfg = _cfg(arch, mode)
        tokens, steps = _inputs(cfg.vocab)
        if mode == "digital":
            params[arch, mode], ref[arch, mode] = _reference(arch, tokens,
                                                             steps)
        else:
            params[arch, mode] = params_to_numpy(M.init_params(cfg, 32,
                                                               "cpu"))
    inp = tmp / "inputs.pt"
    torch.save(params, inp)
    job = mp.start_processes(_rank, args=(4, str(tmp / "rdv"), str(inp),
                                          str(tmp / "res")),
                             nprocs=4, join=False, start_method="spawn")
    try:
        reads, one = {}, {}
        for arch in OP_BY_OP:
            cfg = _cfg(arch, "fakequant")
            ref[arch, "fakequant"], reads[arch] = _reference_op_by_op(
                arch, params[arch, "fakequant"], *_inputs(cfg.vocab))
        torch.save(reads, tmp / "reads.pt")
        os.replace(tmp / "reads.pt", f"{inp}.reads")
        for arch, mode in CASES:
            cfg = _cfg(arch, mode)
            tokens, steps = _inputs(cfg.vocab)
            with _route(mode):
                one[arch, mode] = _serve(cfg, params_from_numpy(
                    params[arch, mode], "cpu"), tokens, steps)[0]
        while not job.join():
            pass
    finally:
        for p in job.processes:
            p.kill()
    ranks = [torch.load(f"{tmp / 'res'}.{r}", weights_only=False)
             for r in range(4)]
    return {"ref": ref, "one": one, "ranks": ranks, "reads": reads,
            "params": params}


def _rank_rows(r, shape):
    d = r["coords"]["data"]
    return slice(d * B // shape[0], (d + 1) * B // shape[0])


@pytest.mark.parametrize("shape", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_digital_serving_matches_reference(runs, arch, shape):
    want = runs["ref"][arch, "digital"]
    for ranks in runs["ranks"]:
        r = ranks[shape, arch, "digital"]
        np.testing.assert_allclose(r["logits"],
                                   want[:, _rank_rows(r, shape)],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", LAYOUTS, ids=LAYOUT_IDS)
def _reads_within_class(got):
    """Each read of ``got`` (a list over ranks of :func:`_replaying`'s
    lists) within one ADC lsb per row tile of the reference's, and moved
    by an ADC code at under MOVED of its outputs over the ranks."""
    for i, per in enumerate(zip(*got)):
        worst = max(p[0] for p in per)
        moved = sum(p[1] for p in per) / sum(p[2] for p in per)
        if worst > 1.0001 or moved >= MOVED:
            return i, worst, moved
    return None


@pytest.mark.parametrize("shape", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("arch", OP_BY_OP)
def test_fakequant_serving_matches_reference_op_by_op(runs, arch, shape):
    """The fakequant layouts against the reference's op-by-op serving of
    the same weights, read by read and with its reads replayed (module
    docstring): every read of the ranks (the column splits' gathered
    range partials, the row splits' gathered tiles, k and v cut by
    columns, the DAC scale shared over the data ranks, at prefill and at
    decode rows) in the read class; the logits, with the reference's
    read results in the reads' place, within rtol = atol = 1e-5 and the
    same greedy tokens."""
    want = runs["ref"][arch, "fakequant"]
    got = [ranks[shape, arch, "replayed"] for ranks in runs["ranks"]]
    for r in got:
        assert len(r["reads"]) == r["n_reads"] == len(runs["reads"][arch])
    assert _reads_within_class([r["reads"] for r in got]) is None
    for ranks, r in zip(runs["ranks"], got):
        rows = want[:, _rank_rows(ranks[shape, arch, "fakequant"], shape)]
        np.testing.assert_allclose(r["logits"], rows, rtol=1e-5, atol=1e-5)
        assert np.array_equal(r["logits"].argmax(-1), rows.argmax(-1))


@pytest.mark.parametrize("arch", ["lm100m", "gemma-2b"])
def test_read_class_catches_a_dac_scale_over_a_ranks_rows(runs, arch):
    """The read class's power: one device serving two of the batch's rows
    alone, each read's DAC scale taken over those rows (what a data rank
    whose scale is not the max over the data ranks would take), is out of
    it; the same device serving every row is in it."""
    from repro_torch.convert import params_from_numpy
    cfg = _cfg(arch, "fakequant")
    tokens, steps = _inputs(cfg.vocab)
    params = params_from_numpy(runs["params"][arch, "fakequant"], "cpu")
    reads = runs["reads"][arch]
    for rows, sound in ((slice(None), True), (slice(0, 2), False)):
        with _route("fakequant"), _replaying(reads, rows) as got:
            _serve(cfg, params, tokens, steps, rows=rows)
        assert (_reads_within_class([got]) is None) == sound, rows


@pytest.mark.parametrize("shape", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("arch,mode", CASES, ids=CASE_IDS)
def test_serving_matches_one_device(runs, arch, mode, shape):
    one = runs["one"][arch, mode]
    for ranks in runs["ranks"]:
        r = ranks[shape, arch, mode]
        want = one[:, _rank_rows(r, shape)]
        np.testing.assert_allclose(r["logits"], want, rtol=1e-5, atol=1e-5)
        assert np.array_equal(r["logits"].argmax(-1), want.argmax(-1))


def _ssd_whole_parts(cfg, shape):
    """The bytes of ``in_proj``'s B, C and dt columns and of the conv
    state's B and C channels a ``model`` rank holds beyond the policy's
    even split (one group: both whole on every rank)."""
    from repro_torch.launch.sharding import ssm_dims
    m, dp = shape[1], shape[0]
    _, h, gn = ssm_dims(cfg)
    if m == 1:
        return {}
    rows = cfg.d_model // dp if cfg.d_model % dp == 0 else cfg.d_model
    share = (m - 1) / m
    return {"params/layers/ssm/in_proj/w":
            round(cfg.n_layers * rows * (2 * gn + h) * share) * 4,
            "cache/0/conv":
            round(cfg.n_layers * (B // dp) * (cfg.ssm_conv - 1) * 2 * gn
                  * share) * 4}


@pytest.mark.parametrize("shape", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("arch,mode", CASES, ids=CASE_IDS)
def test_held_bytes_are_the_dry_runs(runs, arch, mode, shape):
    """Each rank's held bytes against ``launch.dryrun.reckon`` of a
    ``B`` x ``MAX_LEN`` decode cell on a dry mesh at its coordinates
    (reckoned in the rank's process)."""
    cfg = _cfg(arch, mode)
    for ranks in runs["ranks"]:
        r = ranks[shape, arch, mode]
        mem = r["dryrun"]
        assert r["held"]["params"] / 1e9 == mem["params_gb"]
        assert r["held"]["cache"] / 1e9 == mem["cache_gb"]
        want = {} if cfg.family == "dense" else _ssd_whole_parts(cfg, shape)
        assert r["excess"] == want
        assert {k: round(v * 1e9) for k, v in
                mem["replicated_by_port_leaves"].items()} == want
        if cfg.family == "dense":
            assert mem["replicated_by_port_gb"] == 0.0


def test_plan_on_model_ranks(runs):
    for ranks in runs["ranks"]:
        for (shape, arch, mode), r in ranks.items():
            if mode == "replayed":
                continue
            on = {k for k, v in r["plan"].items() if v}
            if shape[1] == 1:
                assert not on, (shape, arch, mode, on)
                continue
            want = {"vocab"}
            if arch in ("mamba2-1.3b", "zamba2-1.2b"):
                want.add("ssm")
            if arch != "mamba2-1.3b":
                want |= {"attn", "attn_row", "ffn", "ffn_row"}
            assert on == want, (shape, arch, mode, on)


def test_sequence_split_combines_in_chunk_order():
    """Fed the one-device decode's own chunk partials, each rank's in
    turn, the sequence split's gather and combine give the one-device
    decode attention bit for bit; the partials a rank forms over its own
    slots are those within float32 rounding."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.models import layers as L
    cfg = get_config("gemma-2b", smoke=True).replace(**DIG)
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 16, generator=gen)
    k, v = (torch.randn(2, 64, 1, 16, generator=gen) for _ in range(2))
    kv_len = torch.tensor([37, 64])
    want = L._decode_sdpa(q, k, v, kv_len)
    whole = L._decode_partials(q, k, v, kv_len)
    own = L._decode_partials

    for m in (2, 4):
        c, s = L.DECODE_KV_CHUNKS // m, 64 // m

        def rank(mesh):
            npar = S_.ServeParallel(cfg, mesh)
            r = mesh.coords["model"]
            sl = slice(r * s, (r + 1) * s)
            mine = own(q, k[:, sl], v[:, sl], kv_len, c, r * s)
            for a, b in zip(mine, whole):
                torch.testing.assert_close(a, b[:, r * c:(r + 1) * c],
                                           rtol=1e-6, atol=1e-6)
            L._decode_partials = lambda *a: tuple(
                t[:, r * c:(r + 1) * c] for t in whole)
            try:
                with S_.shardctx.numeric_parallel(npar):
                    return L._decode_sdpa_split(q, k[:, sl], v[:, sl],
                                                kv_len, npar)
            finally:
                L._decode_partials = own
        for got in emulate_layout((1, m), ("data", "model"), rank):
            assert torch.equal(got, want)


@pytest.mark.parametrize("shape,max_len", [((1, 4), 40), ((1, 3), 48)],
                         ids=["slots", "ranks"])
def test_sequence_split_must_be_whole_chunks(shape, max_len):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.models import model as M
    cfg = get_config("gemma-2b", smoke=True).replace(
        **DIG, n_heads=shape[1] * 2)
    params = M.init_params(cfg, 0, "cpu")
    tokens = torch.zeros((2, 4), dtype=torch.long)

    def rank(mesh):
        from repro_torch.launch import sharding as S_
        blocks = S_.serve_parallel(cfg, mesh).shard_params(params)
        with torch.no_grad():
            M.prefill(blocks, {"tokens": tokens}, cfg, max_len, mesh=mesh)
    with pytest.raises(ValueError, match="whole chunks"):
        emulate_layout(shape, ("data", "model"), rank)


def test_chunked_prefill_against_a_sequence_split_raises():
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.models import model as M
    cfg = get_config("gemma-2b", smoke=True).replace(**DIG)
    params = M.init_params(cfg, 0, "cpu")

    def rank(mesh):
        blocks = S_.serve_parallel(cfg, mesh).shard_params(params)
        with torch.no_grad():
            _, cache = M.prefill(blocks, {"tokens": torch.zeros(
                (2, 4), dtype=torch.long)}, cfg, 32, mesh=mesh)
            M.prefill_chunk(blocks, cache, torch.zeros((2, 3),
                                                       dtype=torch.long),
                            cfg, mesh=mesh)
    with pytest.raises(ValueError, match="chunked prefill"):
        emulate_layout((1, 2), ("data", "model"), rank)


def test_chunked_prefill_against_a_head_split_cache():
    """``prefill_chunk`` against a cache split by kv heads (lm100m on an
    emulated 1x2 layout): a prefill of 4 tokens, a chunk of 3 and a
    decode step, each rank on its heads, against the one-device serving
    at rtol = atol = 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.models import model as M
    cfg = get_config("lm100m", smoke=True).replace(**DIG)
    params = M.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(7)
    first, chunk, step = (torch.from_numpy(rng.integers(
        0, cfg.vocab, shape)).long() for shape in ((2, 4), (2, 3), (2,)))

    def serve(p, mesh=None):
        with torch.no_grad():
            lg, cache = M.prefill(p, {"tokens": first}, cfg, 32, mesh=mesh)
            out, cache = M.prefill_chunk(p, cache, chunk, cfg, mesh=mesh)
            lg, cache = M.decode_step(p, cache, step, cfg, mesh=mesh)
        return out, lg, cache[0]["k"].shape
    want = serve(params)

    def rank(mesh):
        return serve(S_.serve_parallel(cfg, mesh).shard_params(params),
                     mesh)
    for out, lg, shape in emulate_layout((1, 2), ("data", "model"), rank):
        torch.testing.assert_close(out, want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lg, want[1], rtol=1e-5, atol=1e-5)
        assert shape[3] == want[2][3] // 2


def test_whole_kv_heads_attend_as_one_device_under_the_attn_plan():
    """starcoder2-3b's 2 kv heads over 4 ``model`` ranks (smoke: 4 q
    heads, one a rank): under the ``attn`` plan k and v are whole on
    every rank and each rank's q heads attend to their own kv head, so
    the forward's loss is the one device's (the prefill of the serving
    tests takes the same path)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.models import model as M
    cfg = get_config("starcoder2-3b", smoke=True).replace(**DIG)
    params = M.init_params(cfg, 0, "cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 9))).long()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with torch.no_grad():
        want = M.loss_fn(params, batch, cfg)[0]

    def rank(mesh):
        npar = S_.NumericParallel(cfg, mesh)
        assert npar.attn and not npar.kv_split
        blocks = S_.shard_tree(params, npar.specs, cfg, mesh)
        with torch.no_grad(), S_.shardctx.numeric_parallel(npar):
            return M.loss_fn(blocks, batch, cfg)[0]
    for got in emulate_layout((1, 4), ("data", "model"), rank):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_moe_and_cross_attention_families_are_not_served_sharded():
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulated_mesh
    mesh = emulated_mesh((1, 2), ("data", "model"))
    for arch in ("llama4-scout-17b-a16e", "whisper-medium"):
        with pytest.raises(NotImplementedError, match="families"):
            S_.ServeParallel(get_config(arch, smoke=True), mesh)


@pytest.mark.parametrize("arch", ["lm100m", "gemma-2b"])
def test_cache_split_without_the_attention_plan(arch):
    """At the smoke widths a fakequant rank's ``wqkv`` columns are no
    whole 64-column range blocks, so the plan reads ``wqkv`` and ``wo``
    whole (``attn`` off); the cache keeps its split all the same (lm100m
    by kv heads, gemma-2b along the sequence), held to the one-device
    serving on an emulated 1x2 layout at rtol = atol = 1e-5 (in one
    process, the ranks in turn)."""
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulate_layout
    from repro_torch.models import model as M
    cfg = _cfg(arch, "digital").replace(**_Q)
    params = M.init_params(cfg, 0, "cpu")
    tokens, steps = _inputs(cfg.vocab)
    with _route("fakequant"):
        one, _ = _serve(cfg, params, tokens, steps)

        def rank(mesh):
            npar = S_.serve_parallel(cfg, mesh)
            assert not npar.attn and npar.ffn
            got, cache = _serve(cfg, npar.shard_params(params), tokens,
                                steps, mesh)
            return got, cache[0]["k"].shape
        for got, shape in emulate_layout((1, 2), ("data", "model"), rank):
            np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)
            assert shape[2:4] == ((MAX_LEN, 2) if arch == "lm100m"
                                  else (MAX_LEN // 2, 1))


def test_ssd_state_split_needs_the_ssm_plan():
    from repro_torch.launch import sharding as S_
    from repro_torch.launch.mesh import emulated_mesh
    cfg = _cfg("mamba2-1.3b", "digital").replace(**_Q)
    with pytest.raises(ValueError, match="ssm split is off"):
        S_.ServeParallel(cfg, emulated_mesh((1, 2), ("data", "model")))
