"""The sharded analog training step on gloo CPU ranks: bit-identical to
the port's own single-device step (the reference's contract).

One ``torch.multiprocessing.spawn`` per mesh shape (2x2, 2x4) runs every
check of that shape: after 2 noisy TaOx steps the sharded
``AnalogTrainStep``'s conductances (gathered from the ranks' blocks),
digital leaves, loss and ``g_rail_frac`` are bit-equal to the unsharded
step's, for smoke lm100m with shard-local and gathered reads, smoke
llama4-scout-17b-a16e with its expert stacks split over ``model``
(expert parallelism), lm100m with periodic carry and with pulse-train
writes, zamba2-1.2b (the hybrid's shared block, written once over its
applications' rows) and deepseek-v2-lite-16b (MLA and 64 experts); and
the shard-local read
(``kernels.xbar_vmm.manual_collective_read``) of single containers,
forward and transpose, with and without an expert dim, is bit-equal to
the whole read.  The unsharded step is held to the reference by
``tests/test_torch_train.py`` and the family tests.  The ranks rendezvous
through a file under ``tmp_path``, run one thread each and import no
JAX.
"""
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

DEVICE_MODE = dict(dtype="float32", analog=True, analog_mode="device",
                   analog_device="taox", analog_rows=16, analog_cols=16)
LR = 0.05
SEED_BASES = (1000, 1001)
RUNS = {
    "lm100m-local": ("lm100m", {}, "local"),
    "lm100m-gather": ("lm100m", {}, "gather"),
    "scout-ep": ("llama4-scout-17b-a16e", {}, "local"),
    "lm100m-carry": ("lm100m", dict(analog_carry=True, carry_period=1,
                                    analog_carry_base=4.0), "local"),
    "lm100m-pulse": ("lm100m", dict(analog_update_mode="pulse_train"),
                     "local"),
    "zamba2-hybrid": ("zamba2-1.2b", {}, "local"),
    "deepseek-mla": ("deepseek-v2-lite-16b", {}, "local"),
}
# (K, N, lead, B, spec of g) of the single-container read checks
READS = [
    (64, 192, (), 64, (("data",), ("model",))),
    (64, 64, (), 4, (("model",), ("data",))),
    (128, 64, (), 4, (("data",), ("model",))),
    (64, 128, (), 64, (None, ("model",))),
    (64, 128, (), 64, (("data",), None)),
    (64, 48, (8,), 16, (("model",), ("data",), None)),
]


def _cfg(arch, extra):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(**DEVICE_MODE, **extra)


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))).long()
            for k in ("tokens", "labels")}


def _initial_state(cfg):
    """``init_state(0)`` with the first three rows of the first container
    (of every matrix of its stack; its carry array under periodic carry)
    pinned at the window's top rail, so the rail fraction counts cells on
    some ranks only."""
    from repro_torch.core.analog_registry import container_paths
    from repro_torch.core.tiled_analog import crossbar_from_model
    from repro_torch.train import analog_lm as TA
    state = TA.init_state(0, cfg, device="cpu")
    p = state["params"]
    for k in container_paths(p)[0]:
        p = p[k]
    # the array the writes land on, whose rails the step counts
    p["g_carry" if "g_carry" in p else "g"][..., :3, :] = \
        crossbar_from_model(cfg).device.gmax
    return state


def _train(arch, extra, read_mode, mesh=None):
    from repro_torch.core import shardctx
    from repro_torch.train import analog_lm as TA
    cfg = _cfg(arch, extra)
    gathered = shardctx.GATHERED["bytes"]
    step = TA.make_analog_sgd_step(cfg, lr=LR, mesh=mesh,
                                   read_mode=read_mode)
    state = step.shard_state(_initial_state(cfg))
    metrics = []
    for seed_base in SEED_BASES:
        state, m = step(state, _batch(cfg), seed_base)
        metrics.append((float(m["loss"]), float(m["g_rail_frac"])))
    sharded = sum(1 for spec, _ in (step._cspecs or {}).values()
                  if any(spec["g"]))
    # bytes this rank received in the steps' ordered gathers
    gathered = shardctx.GATHERED["bytes"] - gathered
    return (step.unshard_state(state)["params"], metrics,
            (sharded, gathered))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def _read_checks(mesh):
    """Each READS case: the shard-local read of this rank's blocks against
    the whole read, both directions; returns (case, direction, equal)."""
    from repro_torch.core.adc import AdcConfig
    from repro_torch.core.crossbar import CrossbarConfig
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.launch import sharding as S
    cfg = CrossbarConfig(rows=16, cols=16, adc=AdcConfig())
    out = []
    for i, (k, n, lead, b, spec) in enumerate(READS):
        gen = torch.Generator().manual_seed(i)
        g = torch.rand(*lead, k, n, generator=gen)
        ref = torch.rand(*lead, k, n, generator=gen)
        ws = 2.0 + torch.rand(lead, generator=gen)
        blk = S.block_slices(g.shape, spec, mesh)
        meta = S.shard_meta(g.shape, spec, mesh)
        ws_blk = ws[blk[:len(lead)]] if lead else ws
        for tr in (False, True):
            x = torch.randn(*lead, b, n if tr else k, generator=gen)
            whole = K.xbar_fused_read(x, g, ref, ws, cfg, transpose=tr)
            y = K.manual_collective_read(x, g[blk], ref[blk], ws_blk, cfg,
                                         meta, transpose=tr)
            out.append((i, tr, bool(torch.equal(y, whole))))
    return out


@pytest.mark.parametrize("layout", [(2, 2), (2, 4)])
@pytest.mark.parametrize("case", range(len(READS)))
def test_emulated_layout_shard_local_reads_bit_equal(layout, case):
    """The shard-local read as ``chip_smoke.py`` phase 24(b) runs it on
    the card: every rank of the layout emulated in one process
    (``launch.mesh.emulate_layout``) runs ``manual_collective_read`` on
    its block, forward and transpose; each rank's result is bit-equal to
    the whole read."""
    from repro_torch.core.adc import AdcConfig
    from repro_torch.core.crossbar import CrossbarConfig
    from repro_torch.kernels import xbar_vmm as K
    from repro_torch.launch import mesh as TM
    from repro_torch.launch import sharding as S
    k, n, lead, b, spec = READS[case]
    cfg = CrossbarConfig(rows=16, cols=16, adc=AdcConfig())
    gen = torch.Generator().manual_seed(100 + case)
    g = torch.rand(*lead, k, n, generator=gen)
    ref = torch.rand(*lead, k, n, generator=gen)
    ws = 2.0 + torch.rand(lead, generator=gen)
    for tr in (False, True):
        x = torch.randn(*lead, b, n if tr else k, generator=gen)
        whole = K.xbar_fused_read(x, g, ref, ws, cfg, transpose=tr)

        def rank_read(m):
            blk = S.block_slices(g.shape, spec, m)
            return K.manual_collective_read(
                x, g[blk], ref[blk], ws[blk[:len(lead)]] if lead else ws,
                cfg, S.shard_meta(g.shape, spec, m), transpose=tr, mesh=m)
        ys = TM.emulate_layout(layout, ("data", "model"), rank_read)
        assert len(ys) == layout[0] * layout[1]
        assert all(torch.equal(y, whole) for y in ys), (case, tr)


def _rank(rank, world, shape, rdv, out):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.core import shardctx
    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", f"file://{rdv}", rank, world)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    shardctx.set_shard_context(mesh, None)
    result = {"reads": _read_checks(mesh), "runs": {}}
    for name, (arch, extra, mode) in RUNS.items():
        params, metrics, sharded = _train(arch, extra, mode, mesh)
        result["runs"][name] = ({k: v.numpy() for k, v in
                                 _flat(params).items()}, metrics, sharded)
    if rank == 0:
        torch.save(result, out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def unsharded():
    """The single-device runs, on one thread as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: _train(arch, extra, mode)
                for name, (arch, extra, mode) in RUNS.items()}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_sharded_step_bit_identical_to_one_device(shape, unsharded,
                                                   tmp_path):
    world = shape[0] * shape[1]
    out = tmp_path / "result.pt"
    mp.spawn(_rank, args=(world, shape, str(tmp_path / "rdv"), str(out)),
             nprocs=world)
    result = torch.load(out, weights_only=False)
    bad_reads = [r for r in result["reads"] if not r[2]]
    assert not bad_reads, bad_reads
    for name, (params, metrics, (sharded, gathered)) in \
            result["runs"].items():
        want, want_metrics, _ = unsharded[name]
        # the runs really were sharded: every container of the smoke
        # models splits on these meshes, and the steps exchanged blocks
        assert sharded >= 4 and gathered > 0, (name, sharded, gathered)
        assert metrics == want_metrics, name
        assert any(m[1] > 0 for m in metrics), name   # rails counted
        flat = _flat(want)
        assert set(params) == set(flat), name
        bad = [k for k, v in flat.items()
               if not np.array_equal(params[k], v.numpy())]
        assert not bad, (name, bad)
