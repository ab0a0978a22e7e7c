"""The sharding policy, the shard context, the data pipeline, int8
gradient compression and the write at tile offsets in the port, against
the JAX package (no process group: the policy is a function of shapes).

Parity classes:

  * every spec of ``launch.sharding`` — equal to the reference's
    ``PartitionSpec`` entry for entry, for every leaf of every registry
    smoke config, on fake 2x2, 2x4 and 4x4 meshes (the reference test's
    ``FakeMesh`` idiom), with and without ``REPRO_FLAT_DP``;
  * ``TokenPipeline`` batches — bit-equal (integer tokens), including
    shards and an elastic re-shard;
  * ``compress_decompress`` and its error feedback — within 1 float32
    ulp of each value (a division and a rounding per element);
  * ``xbar_outer_update(tile_offsets=...)`` — bit-equal on an ideal
    power-of-two grid (every product and sum exact), within 4 float32
    ulp with TaOx and the counter PRNG (the normals' libm), as the
    write's own tests hold it; a block written at its offsets is
    bit-equal to its slice of the whole write, in both update modes and
    in the tensor-core instance's plain twin.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import CrossbarConfig as JXbar
from repro.core import device as jdev
from repro.data import pipeline as JP
from repro.kernels import xbar_update as JU
from repro.launch import sharding as JS
from repro.models import model as JM
from repro.train import compress as JC
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core import CrossbarConfig, DeviceConfig, shardctx
from repro_torch.data import pipeline as TP
from repro_torch.kernels import xbar_update as U
from repro_torch.launch import mesh as TM
from repro_torch.launch import pipeline as TPipe
from repro_torch.launch import sharding as TS
from repro_torch.train import compress as TC

DEVICE_MODE = dict(dtype="float32", analog=True, analog_mode="device",
                   analog_device="taox", analog_rows=16, analog_cols=16)
ULP4 = 4 * 2.0 ** -24


class FakeMesh:
    """A mesh the reference's policy functions accept: axis sizes and
    names, no devices."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


def _norm(spec):
    """A reference PartitionSpec as the port's spec: per dim ``None`` or a
    tuple of axis names."""
    return tuple(None if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)) for e in spec)


def _port_spec(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


_ABSTRACT = {}


def _abstract(arch, device):
    """The reference's parameter shapes of a smoke config (no values)."""
    key = (arch, device)
    if key not in _ABSTRACT:
        cfg = jax_config(arch, smoke=True)
        if device:
            cfg = cfg.replace(**DEVICE_MODE)
        _ABSTRACT[key] = (cfg, jax.eval_shape(
            lambda: JM.init_params(jax.random.PRNGKey(0), cfg)))
    return _ABSTRACT[key]


def _leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", "")))
                     for k in path)
        out.append((path, keys, leaf))
    return out


MESHES = [(2, 2), (2, 4), (4, 4)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_container_and_param_specs_match_reference(arch):
    """``analog_container_pspec`` / ``analog_update_specs`` of every
    container leaf and ``param_pspec`` of every leaf (device and digital
    trees) equal the reference's, on every mesh, with and without
    ``REPRO_FLAT_DP``."""
    n_containers = 0
    for flat in (False, True):
        if flat:
            os.environ["REPRO_FLAT_DP"] = "1"
        try:
            for shape in MESHES:
                mesh = FakeMesh(shape)
                for device in (True, False):
                    jcfg, tree = _abstract(arch, device)
                    cfg = get_config(arch, smoke=True)
                    if device:
                        cfg = cfg.replace(**DEVICE_MODE)
                    for path, keys, leaf in _leaves(tree):
                        want = _norm(JS.param_pspec(path, leaf, jcfg, mesh))
                        got = TS.param_pspec(keys, leaf.shape, cfg, mesh)
                        assert _port_spec(got, leaf.ndim) == \
                            _port_spec(want, leaf.ndim), (keys, shape)
                        if device and keys[-1] == "g":
                            n_containers += 1
                            cpath = keys[:-1]
                            want_u = JS.analog_update_specs(
                                cpath, leaf.shape, jcfg, mesh)
                            got_u = TS.analog_update_specs(
                                cpath, leaf.shape, cfg, mesh)
                            assert set(got_u) == set(want_u)
                            for k in want_u:
                                assert got_u[k] == _norm(want_u[k]), \
                                    (keys, k, shape)
        finally:
            os.environ.pop("REPRO_FLAT_DP", None)
    assert n_containers > 0


@pytest.mark.parametrize("shape", MESHES)
def test_analog_params_shardings_match_reference_lm100m(shape):
    """The sharded analog step's whole-tree policy: containers by tiles,
    digital leaves replicated, as the reference's
    ``analog_params_shardings`` (its specs read off one leaf at a time)."""
    jcfg, tree = _abstract("lm100m", True)
    cfg = get_config("lm100m", smoke=True).replace(**DEVICE_MODE)
    mesh = FakeMesh(shape)
    got = TS.analog_params_shardings(
        jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), tree),
        cfg, mesh)
    sharded = 0
    for path, keys, leaf in _leaves(tree):
        spec = got
        for k in keys:
            spec = spec[k]
        if keys[-1] in ("g", "ref", "w_scale", "g_carry"):
            want = _norm(JS.analog_container_pspec(keys, leaf.shape, jcfg,
                                                   mesh, keys[-1]))
            sharded += any(spec)
        else:
            want = (None,) * leaf.ndim
        assert spec == want, keys
    assert sharded >= 4


def _abstract_mesh(shape):
    try:
        return jax.sharding.AbstractMesh(shape, ("data", "model"))
    except TypeError:       # the older signature: (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(("data", "model"),
                                                   shape)))


def _spec_leaves(tree):
    """A reference tree of NamedShardings as the port's spec leaves."""
    return [_norm(ns.spec) for ns in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


def _port_leaves(tree, ref_tree):
    """The port's spec tree, leaf for leaf in the reference's order
    (sorted dict keys), padded to each leaf's rank."""
    ndims = [leaf.ndim for leaf in jax.tree.leaves(ref_tree)]
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif t is None:            # an empty subtree (no shared caches)
            return
        elif isinstance(t, tuple) and t and isinstance(t[0], dict):
            for v in t:            # a tuple of subtrees
                walk(v)
        else:                      # a spec
            out.append(t)
    walk(tree)
    return [_port_spec(sp, nd) for sp, nd in zip(out, ndims)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tree_batch_and_cache_shardings_match_reference(arch):
    """``params_shardings``, ``batch_shardings`` and ``cache_shardings``
    over whole trees (the reference's on an abstract 2x4 mesh)."""
    jcfg, tree = _abstract(arch, False)
    cfg = get_config(arch, smoke=True)
    mesh = FakeMesh((2, 4))
    amesh = _abstract_mesh((2, 4))
    want = _spec_leaves(JS.params_shardings(tree, jcfg, amesh))
    assert _port_leaves(TS.params_shardings(tree, cfg, mesh), tree) \
        == [_port_spec(w, leaf.ndim)
            for w, leaf in zip(want, jax.tree.leaves(tree))]
    batch = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
             "labels": jax.ShapeDtypeStruct((6, 16), jnp.int32)}
    assert TS.batch_shardings(batch, mesh) == {
        k: _norm(v.spec) for k, v in JS.batch_shardings(batch,
                                                        amesh).items()}
    cache = jax.eval_shape(lambda: JM.init_cache(jcfg, 8, 16))
    want = _spec_leaves(JS.cache_shardings(cache, jcfg, amesh))
    got = _port_leaves(TS.cache_shardings(cache, cfg, mesh), cache)
    assert got == [_port_spec(w, leaf.ndim)
                   for w, leaf in zip(want, jax.tree.leaves(cache))]
    assert TS.replicated(mesh) == ()


def test_block_slices_shard_and_emulated_combine_round_trip():
    """Every rank's block of a 2x4 layout, reassembled with the pure
    ordered combine in flat shard order, is the whole tensor."""
    x = torch.arange(2 * 32 * 64, dtype=torch.float32).reshape(2, 32, 64)
    spec = (None, ("data",), ("model",))
    layout = TM.emulated_mesh((2, 4), ("data", "model"))
    blocks = {}
    for coords in TM.layout_coords(layout):
        m = TM.emulated_mesh((2, 4), ("data", "model"), coords)
        blocks[coords] = TS.shard_block(x, spec, m)
        assert blocks[coords].shape == (2, 16, 16)
    rows = [shardctx.combine_blocks([blocks[(i, j)] for j in range(4)], 2)
            for i in range(2)]
    assert torch.equal(shardctx.combine_blocks(rows, 1), x)
    # flat index over two axes: row-major, major axis first
    m = TM.emulated_mesh((2, 4), ("data", "model"), (1, 2))
    assert shardctx.flat_index(m.shape, m.coords, ("data", "model")) == 6
    assert TS.block_slices((8, 16), ((("data", "model")), None), m)[0] \
        == slice(6, 7)


def test_emulated_layout_gathers_in_order_and_fails_whole():
    """``emulate_layout`` runs a function as every rank of a layout: the
    ordered combine on its ranks (``combine_partials_exact`` through
    ``Mesh.gather_blocks``) is ``combine_blocks`` of the ranks' blocks in
    flat shard order, on either axis and on both; a rank that raises, or
    ranks that exchange unevenly, fail the whole run."""
    x = torch.arange(2 * 32 * 64, dtype=torch.float32).reshape(2, 32, 64)
    spec = (None, ("data",), ("model",))

    def rank(m):
        blk = TS.shard_block(x, spec, m)
        return (shardctx.combine_partials_exact(blk, ("model",), 2, m),
                TS.unshard(blk, spec, m),
                shardctx.combine_partials_exact(blk[:, :1, :1],
                                                ("data", "model"), 0, m))

    layout = TM.emulated_mesh((2, 4), ("data", "model"))
    got = TM.emulate_layout((2, 4), ("data", "model"), rank)
    blocks = [TS.shard_block(x, spec, TM.emulated_mesh(
        (2, 4), ("data", "model"), c)) for c in TM.layout_coords(layout)]
    for r, (row, whole, flat) in enumerate(got):
        assert torch.equal(row, shardctx.combine_blocks(
            blocks[r // 4 * 4:r // 4 * 4 + 4], 2))
        assert torch.equal(whole, x)
        assert torch.equal(flat, shardctx.combine_blocks(
            [b[:, :1, :1] for b in blocks], 0))

    def failing(m):
        if m.rank == 3:
            raise ValueError("rank 3 fails")
        return shardctx.combine_partials_exact(torch.ones(1), ("model",), 0,
                                               m)
    with pytest.raises(ValueError, match="rank 3 fails"):
        TM.emulate_layout((2, 4), ("data", "model"), failing)

    def uneven(m):
        if m.rank:
            return shardctx.combine_partials_exact(torch.ones(1), ("data",),
                                                   0, m)
        return None
    with pytest.raises(RuntimeError, match="unevenly"):
        TM.emulate_layout((2, 1), ("data", "model"), uneven)


def test_mesh_helpers():
    mesh = TM.make_mesh((1, 1), ("data", "model"), "cpu")
    assert mesh.size == 1 and mesh.coords == {"data": 0, "model": 0}
    assert TM.dp_axes(mesh) == ("data",)
    os.environ["REPRO_FLAT_DP"] = "1"
    try:
        assert TM.dp_axes(mesh) == ("data", "model")
    finally:
        os.environ.pop("REPRO_FLAT_DP")
    with pytest.raises(ValueError, match="torch.distributed"):
        TM.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="256 ranks"):
        TM.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="process group"):
        mesh.group("data")
    assert TPipe.bubble_fraction(4, 8) == 3 / 11
    meta = shardctx.ShardMeta(shape=(2, 8, 64, 64), row=("data",),
                              lead=((), ("model",)),
                              axis_sizes=(("data", 2), ("model", 4)),
                              coords=(("data", 1), ("model", 3)))
    assert meta.sharded and meta.view(3) == (8, 64, 64)
    assert meta.lead_names(1) == (("model",),)
    assert meta.lead_names(3) == ((), (), ("model",))
    assert shardctx.shard_index(meta, ("model",)) == 3


# ------------------------------------------------------------ data, compress

def test_token_pipeline_batches_bit_equal_and_elastic():
    kw = dict(vocab=256, seq_len=16, global_batch=8, seed=3,
              chunk_tokens=4096)
    jcfg, tcfg = JP.PipelineConfig(**kw), TP.PipelineConfig(**kw)
    whole = TP.TokenPipeline(tcfg)
    for step in (0, 1, 5, 40):          # 40 crosses into another chunk
        want = JP.TokenPipeline(jcfg).batch_at(step)
        got = whole.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == np.int32
        for n in (2, 4):                 # any shard layout: the same rows
            parts = [TP.TokenPipeline(tcfg, shard_id=i, num_shards=n)
                     .batch_at(step) for i in range(n)]
            np.testing.assert_array_equal(
                np.concatenate([p["tokens"] for p in parts]),
                want["tokens"])
    # iterate, save, restore on another layout: the same batches follow
    it = TP.TokenPipeline(tcfg, shard_id=1, num_shards=2)
    next(it), next(it)
    again = TP.TokenPipeline.restore(tcfg, it.state(), shard_id=0,
                                     num_shards=4)
    np.testing.assert_array_equal(
        next(again)["tokens"], whole.batch_at(2)["tokens"][:2])
    with pytest.raises(ValueError, match="seed"):
        TP.TokenPipeline.restore(TP.PipelineConfig(**{**kw, "seed": 4}),
                                 it.state())


def test_compress_decompress_and_error_feedback_within_one_ulp():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((7, 5)).astype(np.float32),
             "b": {"c": (rng.standard_normal(64) * 1e-3).astype(np.float32),
                   "z": np.zeros((3,), np.float32)}}
    jg = jax.tree.map(jnp.asarray, grads)
    tg = {"a": torch.from_numpy(grads["a"]),
          "b": {k: torch.from_numpy(v) for k, v in grads["b"].items()}}
    je, te = JC.init_error_feedback(jg), TC.init_error_feedback(tg)
    for _ in range(3):                   # the residual carries over
        jg2, je = JC.compress_decompress(jg, je)
        tg2, te = TC.compress_decompress(tg, te)
        for want, got in ((jg2, tg2), (je, te)):
            for w, g in zip(jax.tree.leaves(want),
                            [got["a"], got["b"]["c"], got["b"]["z"]]):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0,
                    atol=float(np.abs(w).max()) * 2.0 ** -23 + 1e-30)
    assert TC.compression_ratio(tg) == pytest.approx(
        JC.compression_ratio(jg), rel=1e-12)
    assert torch.all(te["b"]["z"] == 0)


# ------------------------------------------------------- writes at offsets

def _operands(lyr, t, k, n, pow2, seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (lyr, k, n)).astype(np.float32)
    xi = rng.integers(-127, 128, (lyr, t, k)).astype(np.float32)
    di = rng.integers(-7, 8, (lyr, t, n)).astype(np.float32)
    if pow2:
        return (g, xi * 2.0 ** -7, di * 2.0 ** -12,
                np.full((lyr,), -2.0 ** -6, np.float32), xi, di)
    return (g, (xi * (2.6 / 127)).astype(np.float32),
            (di * (0.03 / 7)).astype(np.float32),
            -rng.uniform(0.05, 0.2, lyr).astype(np.float32), xi, di)


DEVICES = {"ideal": dict(kind="ideal", write_noise=0.0),
           "taox": dict(kind="taox")}


@pytest.mark.parametrize("mode", ["outer", "pulse_train"])
@pytest.mark.parametrize("dev", ["ideal", "taox"])
def test_write_at_offsets_matches_reference(dev, mode):
    g, x_q, d_q, scale, _, _ = _operands(2, 9, 32, 48, dev == "ideal", 4)
    if mode == "pulse_train" and dev == "ideal":   # several pulses, exact
        scale = scale * np.float32(2.0 ** 10)
    offs = (3, 5, 9)
    jcfg = JXbar(rows=16, cols=16, device=jdev.DeviceConfig(**DEVICES[dev]),
                 update_mode=mode)
    tcfg = CrossbarConfig(rows=16, cols=16,
                          device=DeviceConfig(**DEVICES[dev]),
                          update_mode=mode)
    noise_mode = "none" if dev == "ideal" else "kernel"
    seed = None if dev == "ideal" else 0x1234567

    def ref(o):
        return np.asarray(JU.xbar_outer_update(
            jnp.asarray(g), jnp.asarray(x_q), jnp.asarray(d_q),
            jnp.asarray(scale), jcfg, impl="fused", noise_mode=noise_mode,
            seed=None if seed is None else jnp.uint32(seed),
            tile_offsets=o))

    def port(o):
        return U.xbar_outer_update(
            torch.from_numpy(g), torch.from_numpy(x_q), torch.from_numpy(d_q),
            torch.from_numpy(scale), tcfg, noise_mode=noise_mode, seed=seed,
            tile_offsets=o).numpy()
    want, got = ref(offs), port(offs)
    if dev == "ideal":
        np.testing.assert_array_equal(got, want)
        assert np.abs(got - g).max() > 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ULP4)
        # the offsets move the noise streams by far more than the class
        assert np.abs(got - port((0, 0, 0))).max() > 1e3 * ULP4


@pytest.mark.parametrize("mode", ["outer", "pulse_train"])
def test_block_write_at_offsets_is_the_slice_of_the_whole_write(mode):
    """The sharded step's invariant: a block of layers 1:3, row tiles
    2:4 and col tiles 1:3, written alone at those offsets with the whole
    container's code scales, is bit-equal to the block of the whole write
    (TaOx, counter PRNG) in the plain version and in the tensor-core
    instance's plain twin."""
    g, x_q, d_q, scale, xi, di = _operands(4, 24, 64, 64, False, 5)
    cfg = CrossbarConfig(rows=16, cols=16, device=DeviceConfig(kind="taox"),
                         update_mode=mode)
    t = [torch.from_numpy(a) for a in (g, x_q, d_q, scale)]
    xs = torch.full((4,), 2.6 / 127, dtype=torch.float32)
    ds = torch.full((4,), 0.03 / 7, dtype=torch.float32)
    seed = 77
    whole = U.xbar_outer_update(*t, cfg, seed=seed)
    twin = U._update_tc_plain(*t, None, seed, cfg, "kernel", xs, ds)
    lb, kr, nc = slice(1, 3), slice(32, 64), slice(16, 48)
    blk = (t[0][lb, kr, nc].contiguous(), t[1][lb][..., kr].contiguous(),
           t[2][lb][..., nc].contiguous(), t[3][lb])
    got = U.xbar_outer_update(*blk, cfg, seed=seed, tile_offsets=(1, 2, 1))
    assert torch.equal(got, whole[lb, kr, nc])
    got_tc = U._update_tc_plain(*blk, None, seed, cfg, "kernel", xs[lb],
                                ds[lb], (1, 2, 1))
    assert torch.equal(got_tc, twin[lb, kr, nc])
    unshifted = U.xbar_outer_update(*blk, cfg, seed=seed)
    assert not torch.equal(unshifted, got)


@pytest.mark.parametrize("shape", [(2, 64, 64, 256), (3, 4, 128, 64),
                                   (2, 33, 96, 48)])
@pytest.mark.parametrize("transpose", [False, True])
def test_read_partials_form_plain_twin(shape, transpose):
    """The plain version of the reads' partials form: (L, tR, B, O) tile
    partials, unscaled, whose tile-order sum (``_reduce_tiles_plain``, the
    kernel ``reduce_tiles_kernel``'s adds) is the whole plain read bit
    for bit (the whole read sums its tiles in the same order); so is a
    one-tile read's."""
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import xbar_vmm as K
    lyr, b, k, n = shape
    gen = torch.Generator().manual_seed(sum(shape))
    cfg = CrossbarConfig(rows=16, cols=16, adc=AdcConfig())
    x = torch.randn(lyr, b, n if transpose else k, generator=gen)
    g, ref = torch.rand(2, lyr, k, n, generator=gen)
    sc = K.read_scales(x, 1.0 + torch.rand(lyr, generator=gen), 127)
    whole = K._read_plain(x, g, ref, sc, cfg, transpose)
    parts = K._read_plain(x, g, ref, sc, cfg, transpose, partials=True)
    red = n if transpose else k
    assert parts.shape == (lyr, -(-red // 16), b, k if transpose else n)
    assert torch.equal(K._reduce_tiles_plain(parts, sc), whole)
    one = K._read_plain(x[..., :16], g[:, :16] if not transpose
                        else g[..., :16], ref[:, :16] if not transpose
                        else ref[..., :16], sc, cfg, transpose,
                        partials=True)
    assert one.shape[1] == 1
    assert torch.equal(K._reduce_tiles_plain(one, sc), K._read_plain(
        x[..., :16], g[:, :16] if not transpose else g[..., :16],
        ref[:, :16] if not transpose else ref[..., :16], sc, cfg,
        transpose))
