"""The port's multi-process pieces on gloo CPU ranks: the GPipe schedule
(``launch.pipeline``), the training CLI (``launch.train``) data-parallel
and resumed on another mesh, and the ordered combine on ranks
(``core.shardctx.combine_partials_exact``).

Tolerances:
  * ``pipeline_apply`` against the stages run in sequence: outputs
    within 1e-6 (the same float32 operations; the hand-overs move bits),
    every stage's parameter gradients within 1e-5 relative (summed over
    the microbatches, not over the batch at once);
  * the CLI on a 2x1 mesh against 1x1, in float32: the loss of each of 3
    steps within 1e-5 relative (the data ranks' gradients meet in an
    ``all_reduce``, whose float sums are not the one-device batch's);
  * an elastic restart (a 2x1 checkpoint resumed on 1x2): the same
    batches, bit for bit, and the uninterrupted 2x1 run's losses within
    1e-5 relative (1x2 computes the whole batch on each rank);
  * the combine on ranks: bit-equal to the pure ``combine_blocks``.

The ranks rendezvous through a file under ``tmp_path``, run one thread
each and import no JAX.
"""
import json

import pytest
import torch
import torch.multiprocessing as mp

D_MODEL = 8


def _init(rank, world, rdv):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", f"file://{rdv}", rank, world)


def _stage_params(s):
    gen = torch.Generator().manual_seed(3)
    return {"w": torch.randn(s, D_MODEL, D_MODEL, generator=gen) * 0.5,
            "b": torch.randn(s, D_MODEL, generator=gen) * 0.1}


def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipeline_input():
    gen = torch.Generator().manual_seed(4)
    return (torch.randn(12, D_MODEL, generator=gen),
            torch.randn(12, D_MODEL, generator=gen))


def _pipeline_rank(rank, world, rdv, out):
    _init(rank, world, rdv)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import pipeline_apply
    mesh = make_mesh((world,), ("stage",), "cpu")
    params = {k: v.requires_grad_(True)
              for k, v in _stage_params(world).items()}
    x, r = _pipeline_input()
    y = pipeline_apply(mesh, _stage_fn, params, x, microbatches=4)
    torch.sum(y * r).backward()
    torch.save({"y": y.detach(), "stage": mesh.coords["stage"],
                "grads": {k: v.grad[rank] for k, v in params.items()}},
               f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_apply_equals_sequential_stages_with_gradients(stages,
                                                                tmp_path):
    out = str(tmp_path / "pipe")
    mp.spawn(_pipeline_rank, args=(stages, str(tmp_path / "rdv"), out),
             nprocs=stages)
    params = {k: v.requires_grad_(True)
              for k, v in _stage_params(stages).items()}
    x, r = _pipeline_input()
    h = x
    for i in range(stages):
        h = _stage_fn({k: v[i] for k, v in params.items()}, h)
    torch.sum(h * r).backward()
    for rank in range(stages):
        got = torch.load(f"{out}.{rank}")
        assert got["stage"] == rank
        torch.testing.assert_close(got["y"], h.detach(), rtol=0, atol=1e-6)
        for k in ("w", "b"):
            want = params[k].grad[rank]
            assert float(want.abs().max()) > 0
            torch.testing.assert_close(got["grads"][k], want, rtol=1e-5,
                                       atol=1e-7)


# ------------------------------------------------------------------ the CLI

CLI = ["--arch", "lm100m", "--smoke", "--device", "cpu", "--seq-len", "16",
       "--global-batch", "4", "--log-every", "100", "--lr", "1e-3",
       "--dtype", "float32"]


def _cli_rank(rank, world, rdv, argv):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch import train
    train.main(argv, init_method=f"file://{rdv}", rank=rank,
               world_size=world)
    dist.destroy_process_group()


def _cli(tmp_path, name, world, argv):
    rdv = tmp_path / f"rdv-{name}"
    mp.spawn(_cli_rank, args=(world, str(rdv), argv), nprocs=world)


def _metrics(path):
    return [json.loads(line) for line in open(path)]


def test_cli_two_data_ranks_agree_with_one_and_resume_elastic(tmp_path):
    """3 steps on 1x1 (in this process) and on 2x1 gloo ranks; then a 2x1
    run stopped at step 2 resumes on 1x2 for steps 3-4, against an
    uninterrupted 2x1 run of 4 steps."""
    from repro_torch.core.shardctx import clear_shard_context
    from repro_torch.launch import train
    one = tmp_path / "one.jsonl"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(CLI + ["--steps", "3", "--mesh", "1x1",
                          "--metrics-out", str(one), "--grad-compress"])
    finally:
        torch.set_num_threads(threads)
        clear_shard_context()
    two = tmp_path / "two.jsonl"
    _cli(tmp_path, "two", 2, CLI + ["--steps", "4", "--mesh", "2x1",
                                     "--metrics-out", str(two),
                                     "--grad-compress"])
    a, b = _metrics(one), _metrics(two)
    assert [m["step"] for m in b] == [1, 2, 3, 4]
    for x, y in zip(a, b):
        assert x["batch"] == y["batch"]
        assert abs(x["loss"] - y["loss"]) <= 1e-5 * abs(x["loss"])

    ckpt = tmp_path / "ckpt"
    first = tmp_path / "first.jsonl"
    _cli(tmp_path, "first", 2, CLI + [
        "--steps", "2", "--mesh", "2x1", "--ckpt-dir", str(ckpt),
        "--ckpt-every", "2", "--metrics-out", str(first), "--grad-compress"])
    resumed = tmp_path / "resumed.jsonl"
    _cli(tmp_path, "resumed", 2, CLI + [
        "--steps", "4", "--mesh", "1x2", "--ckpt-dir", str(ckpt),
        "--ckpt-every", "2", "--metrics-out", str(resumed),
        "--grad-compress"])
    c = _metrics(first) + _metrics(resumed)
    assert [m["step"] for m in c] == [1, 2, 3, 4]
    for x, y in zip(b, c):
        assert x["batch"] == y["batch"]
        assert abs(x["loss"] - y["loss"]) <= 1e-5 * abs(x["loss"])
    from repro_torch.train import checkpoint
    assert checkpoint.latest_step(ckpt) == 4


# ------------------------------------------------------- the combine on ranks

def _combine_rank(rank, world, rdv, out):
    _init(rank, world, rdv)
    import torch.distributed as dist

    from repro_torch.core import shardctx
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    block = torch.full((2, 3), float(rank)) + torch.arange(3.0)
    got = {names: shardctx.combine_partials_exact(block, names, 1, mesh)
           for names in (("model",), ("data",), ("data", "model"))}
    torch.save(got, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()


def test_combine_on_ranks_is_the_pure_combine(tmp_path):
    from repro_torch.core import shardctx
    out = str(tmp_path / "combine")
    mp.spawn(_combine_rank, args=(4, str(tmp_path / "rdv"), out), nprocs=4)
    blocks = [torch.full((2, 3), float(r)) + torch.arange(3.0)
              for r in range(4)]     # rank = data * 2 + model
    for rank in range(4):
        d, m = divmod(rank, 2)
        got = torch.load(f"{out}.{rank}")
        assert torch.equal(got[("model",)], shardctx.combine_blocks(
            [blocks[d * 2 + j] for j in range(2)], 1))
        assert torch.equal(got[("data",)], shardctx.combine_blocks(
            [blocks[i * 2 + m] for i in range(2)], 1))
        assert torch.equal(got[("data", "model")],
                           shardctx.combine_blocks(blocks, 1))
