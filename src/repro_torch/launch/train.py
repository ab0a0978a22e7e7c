"""Training CLI: any ``--arch`` on synthetic tokens, data-parallel over
``torch.distributed`` ranks, with checkpoint/restart, elastic
re-sharding, the crossbar fakequant projections (``--analog``: QAT) and
int8 gradient compression (port of ``repro.launch.train``).

    # one process on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch lm100m \\
        --steps 200 --ckpt-dir build/ckpt
    # D x M ranks (one per card, NCCL), or gloo ranks on the CPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch lm100m --mesh 2x2 [--device cpu]

Rerun a killed command and it resumes from the latest committed
checkpoint, on any mesh (``--mesh`` may change between runs).  Each data
rank trains on its shard of every global batch (``data.pipeline``: a
batch is a function of (seed, step, shard)).  On a mesh of more than one
rank the step follows the sharding policy (``train_loop.make_train_step``
with ``mesh``): each rank holds its block of every numeric leaf, of
adamw's ``m`` and ``v`` and of the error-feedback residuals
(``launch.sharding.state_specs``), each layer is gathered just before it
runs and its gradients are ``reduce_scatter``ed back to the blocks, and
the dense family computes tensor-parallel over ``model`` (QAT with the
fakequant read's split form).  A D x M run agrees with a 1 x 1 run within
float32 rounding, not bit for bit.  Checkpoints hold whole tensors,
gathered leaf by leaf and written by rank 0, and restore onto any mesh.
``--metrics-out`` writes one JSON line a step from rank 0: the loss, the
step's wall seconds, the global batch's digest and the step's fakequant
reads on the card (``kernels.xbar_vmm.LAUNCHES``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.adc import divisor
from repro_torch.core.shardctx import set_shard_context
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import xbar_vmm
from repro_torch.launch import sharding
from repro_torch.launch.mesh import dp_axes, init_distributed, make_mesh
from repro_torch.models import model as M
from repro_torch.train import checkpoint, train_loop
from repro_torch.train.optimizer import adamw


def batch_digest(batch) -> str:
    """sha256 of a batch's tokens and labels (numpy int32)."""
    h = hashlib.sha256()
    for k in ("tokens", "labels"):
        h.update(batch[k].tobytes())
    return h.hexdigest()[:16]


def main(argv=None, *, init_method=None, rank=None, world_size=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL, e.g. 2x2 (one rank each)")
    ap.add_argument("--analog", action="store_true",
                    help="run projections through the crossbar fake-quant")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default=None,
                    help="activation dtype (default: the config's)")
    ap.add_argument("--metrics-out", default=None,
                    help="JSON lines, one a step, written by rank 0")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to train on the "
                         "CPU")
    init_distributed(args.device, init_method, rank, world_size)
    d, m = (int(v) for v in args.mesh.split("x"))
    mesh = make_mesh((d, m), ("data", "model"), args.device)
    set_shard_context(mesh, dp_axes(mesh))
    device = torch.device(args.device, torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device("cpu")
    lead = not dist.is_initialized() or dist.get_rank() == 0

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.analog:
        cfg = cfg.replace(analog=True)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    opt = adamw(args.lr)
    sharded = mesh.size > 1
    step_fn = train_loop.make_train_step(cfg, opt,
                                         grad_compress=args.grad_compress,
                                         mesh=mesh if sharded else None)
    pipe_cfg = PipelineConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                              global_batch=args.global_batch,
                              seed=args.seed)

    if sharded:
        state = train_loop.init_sharded_state(
            args.seed, cfg, opt, mesh, device,
            grad_compress=args.grad_compress)
        like = M.init_params(cfg, None, "meta")
        specs = sharding.state_specs(state, cfg, mesh, like)
        cut = sharding.leaf_cutter(specs, cfg, mesh)
        gather = sharding.leaf_gatherer(specs, {
            "params": like, "opt": {"m": like, "v": like},
            "err_fb": like}, cfg, mesh)
    else:
        state = train_loop.init_state(args.seed, cfg, opt, device,
                                      grad_compress=args.grad_compress)
        cut = gather = None
    start_step = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state = checkpoint.restore(args.ckpt_dir, state, cut=cut)
        start_step = int(state["step"])
        if lead:
            print(f"resumed from step {start_step} (elastic mesh "
                  f"{args.mesh})", flush=True)
    pipe = TokenPipeline(pipe_cfg, shard_id=mesh.coords["data"],
                         num_shards=d, step=start_step)
    whole = TokenPipeline(pipe_cfg) if lead and args.metrics_out else None
    out = open(args.metrics_out, "a") if whole is not None else None

    def save(step):
        if dist.is_initialized():
            dist.barrier()
        if gather is not None:
            checkpoint.save(args.ckpt_dir, state, step, gather=gather,
                            write=lead)
        elif lead:
            checkpoint.save(args.ckpt_dir, state, step)
        if dist.is_initialized():
            dist.barrier()

    t0 = time.time()
    step_s = 0.0    # the steps' own wall time (no checkpoint writes)
    for i in range(start_step, args.steps):
        batch = next(pipe)
        reads = xbar_vmm.LAUNCHES["fakequant"]
        t_step = time.time()
        state, metrics = step_fn(state, {
            k: torch.from_numpy(v).long().to(device)
            for k, v in batch.items()})
        loss = metrics["loss"].detach().reshape(1)
        if d > 1:
            dist.all_reduce(loss, group=mesh.group("data"))
            loss = loss / divisor(d, loss)
        loss = float(loss)       # waits for the step
        seconds = time.time() - t_step
        step_s += seconds
        if out is not None:
            out.write(json.dumps({
                "step": i + 1, "loss": loss, "seconds": seconds,
                "grad_norm": float(metrics["grad_norm"]),
                "batch": batch_digest(whole.batch_at(i)),
                "fakequant_reads": xbar_vmm.LAUNCHES["fakequant"] - reads})
                + "\n")
            out.flush()
        if lead and ((i + 1) % args.log_every == 0 or i == start_step):
            print(f"step {i + 1:5d}  loss {loss:.4f}"
                  f"  gnorm {float(metrics['grad_norm']):.3f}"
                  f"  ({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    took = time.time() - t0
    if args.ckpt_dir and args.steps % args.ckpt_every:
        save(args.steps)
    if out is not None:
        out.close()
    n = args.steps - start_step
    if lead:
        tokens = n * args.global_batch * args.seq_len
        print(f"done: {n} steps in {took:.1f}s ({step_s:.2f}s in the "
              f"steps), {tokens / max(step_s, 1e-9):.1f} tokens/s",
              flush=True)
    return state


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
