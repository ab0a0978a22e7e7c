"""In-situ analog training of a device-mode transformer (port of
``repro.train.analog_lm``, every family, on one device or sharded over a
mesh of ranks).

One ``AnalogTrainStep`` call is the whole training rule:

  1. the parameter tree is split (``core.tiled_analog.split_tapes``): the
     digital leaves become autograd leaves, every container keeps its
     g/ref/w_scale frozen and gains zero tape slots;
  2. forward = VMM, backward = MVM through the same conductances
     (``core.tiled_analog.TapedMatmul``); the backward writes the
     quantised write-driver operands (x_q, d_q) and their scales into the
     tapes, and no (K, N) weight gradient is formed;
  3. every container's update is the paper's rank-k parallel write: its
     (L, T, K) / (L, T, N) tapes go into ONE launch of the layer-batched
     update kernel (``kernels.xbar_update.xbar_outer_update``); an MoE
     expert stack's (L, E, cap, K) / (L, E, cap, N) tapes (capacity-
     sized) go into one launch over (E * L, K, N), flattened by
     ``core.analog_registry.flatten_lead`` with the expert dim outermost
     as the reference flattens it (the counter PRNG seeds each flattened
     layer index, so the order decides the noise field); each with
     ``scale = -lr * w_scale`` and the tapes' scales (which put the write
     on the card's tensor-core instance), write noise from the in-kernel
     counter PRNG keyed by ``_mix32(seed_base ^ crc32(path))``, in the
     config's update mode (``analog_update_mode``: the aggregate
     ``"outer"`` write or ``"pulse_train"``, integer SET/RESET event
     counts); the hybrid's shared-block containers, applied once per
     group, tape one (T, K) / (T, N) slot per application with its own
     code scales, and their write sums the applications' outer products
     over the collapsed (reps * T) rows, handed over as float operands
     without code scales (one scale per application does not make the
     collapsed rows codes times one scale): the FP32 instance on the
     card;
  4. the digital leaves (embedding, norms) take plain SGD;
  5. with periodic carry (``analog_carry``), the writes land on each
     container's ``g_carry`` array at ``carry_base`` times the scale, and
     every ``carry_period`` steps a serial sweep folds the carry arrays
     into their primaries (:meth:`AnalogTrainStep._carry_sweep`).

The conductances are never updated in place: the step returns a new
state.  On its first call the step also records its projected hardware
cost on the paper's accelerator (``step.cost``, from
``hwmodel.arch_cost.train_step_cost``).

Multi-device sharding
---------------------
Pass ``mesh=`` (``launch.mesh.Mesh``; one process per rank, NCCL on cards,
gloo on the CPU) to run the step sharded.  The parallel axis is the
container *tile grid*, not the batch: every rank holds whole-tile blocks
of each container (column tiles over ``model``, row tiles over the FSDP
axes, flipped for row-parallel consumers, the expert dim of an MoE stack
over ``model``: ``launch.sharding.analog_container_pspec``), and the
batch, the activations, the tapes and every digital leaf stay
replicated.  Lay a whole state out with :meth:`AnalogTrainStep.shard_state`
first.  With ``read_mode="local"`` (the default) every read is
shard-local: each rank reads only its own tiles and the ranks exchange
the per-tile ADC partials in pinned order
(``kernels.xbar_vmm.manual_collective_read``; an expert stack's read
takes only its own experts' rows of the replicated capacity buffer).
``read_mode="gather"`` gathers every container's blocks and replays the
whole read (the reference's A/B path).  Each rank's rank-k write updates
only its own block, with the container's tape scales and its tiles'
counter-PRNG streams at their global (layer, row-tile, col-tile)
coordinates (``tile_offsets``).  The rail fraction is the railed cells
counted over the shards (integers, exchanged by ``all_gather``) over the
global cell count.  Every cross-rank exchange on the analog path is an
arithmetic-free ``all_gather`` (``core.shardctx``), so one seed gives
bit-identical conductances, loss and rail fraction on any mesh.

``exact=False`` is the port's counterpart of the reference's GSPMD read:
each shard-local read sums its own reduction tiles, ``all_reduce``s the
ranks' sums over the reduction axes and rescales once
(``kernels.xbar_vmm.manual_collective_read``), so the reads drift from
the exact step's by float reassociation (within ``ranks * 2^-23 *
sum |partial|`` an element) and a write may see a flipped operand code.
The digital leaves stay replicated and the writes are unchanged.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Union

import torch

from repro_torch.configs.base import (AnalogMode, ModelConfig,
                                      resolve_analog_mode)
from repro_torch.core import analog_registry as registry
from repro_torch.core import shardctx
from repro_torch.core.adc import adc_quantize
from repro_torch.core.periodic_carry import carry_fold
from repro_torch.core.tiled_analog import (crossbar_from_model,
                                           is_analog_container, merge_tapes,
                                           split_tapes)
from repro_torch.hwmodel.arch_cost import train_step_cost
from repro_torch.kernels.xbar_update import (_mix32, _u32, xbar_outer_update,
                                             xbar_sharded_update)
from repro_torch.launch import sharding as S
from repro_torch.models import model as M

Tensor = torch.Tensor

#: Cells of ``g`` the rail count takes at once.
RAIL_SLICE = 1 << 24


def init_state(generator: Union[torch.Generator, int], cfg: ModelConfig,
               device="cuda") -> dict:
    """A fresh train state: random parameters from ``generator`` (see
    ``models.model.init_params``) and a step counter."""
    return {"params": M.init_params(cfg, generator, device),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def container_seed(seed_base: int, path) -> int:
    """Per-container write-noise seed, keyed on the tree path as the
    reference keys it: ``_mix32(seed_base ^ crc32("/".join(path)))``."""
    crc = zlib.crc32("/".join(path).encode())
    return int(_mix32(_u32((int(seed_base) ^ crc) & 0xFFFFFFFF)))


def _trainable(diff, frozen):
    """The digital leaves of a split tree as fresh autograd leaves (tape
    slots stay plain buffers)."""
    if frozen is not None and "g" in frozen:
        return diff
    if isinstance(diff, dict):
        return {k: _trainable(diff[k], frozen[k] if frozen else None)
                for k in diff}
    return diff.detach().requires_grad_(True)


class AnalogTrainStep:
    """Analog-SGD step: ``state, metrics = step(state, batch, rng)``.

    ``batch`` holds ``tokens`` and ``labels`` (B, S).  ``rng`` keys the
    step's write noise: a ``torch.Generator`` (``seed_base`` is drawn from
    it), or the integer ``seed_base`` itself (a test feeds the reference's
    ``jax.random.bits`` draw).  Noiseless devices need none.

    ``step.cost`` is the step's projected cost on the paper's accelerator
    at ``bits``-bit I/O (``hwmodel.arch_cost.train_step_cost``), set on
    the first call.

    ``mesh`` (a ``launch.mesh.Mesh`` with ``data``/``model`` axes) runs
    the step sharded over the container tile grid, bit-identical to the
    single-device step (see the module docstring); the state must come
    from :meth:`shard_state`.  ``read_mode`` is ``"local"`` (shard-local
    reads) or ``"gather"`` (gather the blocks, replay the whole read).
    ``exact=False`` reads with the ranks' tile sums ``all_reduce``d (see
    the module docstring; local reads only).
    """

    def __init__(self, cfg: ModelConfig, lr: float, mesh=None,
                 bits: int = 8, exact: bool = True,
                 read_mode: str = "local"):
        if read_mode not in ("local", "gather"):
            raise ValueError("read_mode must be 'local' or 'gather'")
        if resolve_analog_mode(cfg) is not AnalogMode.DEVICE:
            raise ValueError(
                f"AnalogTrainStep needs a device-mode config (resolved "
                f"{resolve_analog_mode(cfg).value!r}); set analog=True, "
                f"analog_mode={AnalogMode.DEVICE.value!r}")
        self.cfg = cfg
        self.lr = lr
        self.xcfg = crossbar_from_model(cfg)
        self.bits = bits
        self.mesh = mesh
        self.read_mode = read_mode
        self.exact = exact
        self.cost = None
        self._validated = False
        self._cspecs = None   # path -> (update specs, global g shape)

    # ------------------------------------------------------- mesh layout

    def state_shardings(self, state: dict) -> dict:
        """Specs of a whole train state on this step's mesh: containers
        tile-sharded by the policy, every other leaf replicated."""
        return {"params": S.analog_params_shardings(state["params"],
                                                    self.cfg, self.mesh),
                "step": ()}

    def shard_state(self, state: dict) -> dict:
        """This rank's part of a whole (unsharded) train state: each
        container's blocks at tile granularity (dims that do not divide
        stay whole), every other leaf as it is.  Records each container's
        specs and global shape for the step."""
        if self.mesh is None:
            return state
        self._cspecs = {}
        for path in registry.container_paths(state["params"]):
            p = state["params"]
            for k in path:
                p = p[k]
            self._cspecs[path] = (S.analog_update_specs(
                path, tuple(p["g"].shape), self.cfg, self.mesh),
                tuple(p["g"].shape))
        specs = self.state_shardings(state)
        params = S.map_specs(lambda t, sp: S.shard_block(t, sp, self.mesh)
                             if sp and any(sp) else t,
                             state["params"], specs["params"])
        return {**state, "params": params}

    def unshard_state(self, state: dict) -> dict:
        """The whole train state from every rank's part (an ordered
        gather of each container's blocks)."""
        if self.mesh is None:
            return state
        params = state["params"]
        out = self._map_containers(
            params, lambda p, path: {
                k: S.unshard(v, self._cspecs[path][0][
                    "w_scale" if k == "w_scale" else "g"], self.mesh)
                if k in ("g", "ref", "g_carry", "w_scale") else v
                for k, v in p.items()})
        return {**state, "params": out}

    def _map_containers(self, p, fn, path=()):
        if is_analog_container(p):
            return fn(p, path)
        if isinstance(p, dict):
            return {k: self._map_containers(v, fn, path + (k,))
                    for k, v in p.items()}
        return p

    def _annotate(self, p, path):
        """``read_mode="local"``: each tile-sharded container gains its
        ``tp_meta``; containers the policy left whole read as on one
        device."""
        specs, shape = self._cspecs[path]
        meta = S.shard_meta(shape, specs["g"], self.mesh)
        if meta is not None and not self.exact:
            meta = dataclasses.replace(meta, exact=False)
        return p if meta is None else {**p, "tp_meta": meta}

    def _gather(self, p, path):
        """``read_mode="gather"``: the container's whole g/ref/w_scale
        (and carry array) from every rank's blocks."""
        specs = self._cspecs[path][0]
        out = dict(p)
        for leaf, key in (("g", "g"), ("ref", "g"), ("w_scale", "w_scale"),
                          ("g_carry", "g")):
            if leaf in p:
                out[leaf] = S.unshard(p[leaf], specs[key], self.mesh)
        return out

    def __call__(self, state: dict, batch: Dict[str, Tensor], rng=None):
        cfg = self.cfg
        params = state["params"]
        if not self._validated:
            registry.validate_device_params(params, cfg)
            self._validated = True
        tokens = batch["tokens"]
        n_tokens = tokens.numel()
        if self.cost is None:
            self.cost = train_step_cost(
                cfg, n_tokens=n_tokens, bits=self.bits,
                ctx_len=tokens.shape[-1],
                n_shards=self.mesh.size if self.mesh is not None else 1)
        read_params = params
        if self.mesh is not None:
            if self._cspecs is None:
                raise ValueError("a sharded step takes a state laid out by "
                                 "its shard_state")
            read_params = self._map_containers(
                params, self._annotate if self.read_mode == "local"
                else self._gather)
        diff, frozen = split_tapes(
            read_params, n_tokens,
            tokens_for=lambda path, shape: registry.tape_lead(
                path, cfg, n_tokens, tuple(tokens.shape)))
        diff = _trainable(diff, frozen)
        loss, metrics = M.loss_fn(merge_tapes(diff, frozen), batch, cfg)
        loss.backward()

        seed_base = None
        if self.xcfg.device.write_noise > 0.0:
            if isinstance(rng, torch.Generator):
                seed_base = int(torch.randint(
                    0, 2 ** 32, (), generator=rng, device=rng.device))
            elif rng is None:
                raise ValueError("a noisy device needs rng: a "
                                 "torch.Generator or an integer seed_base")
            else:
                seed_base = int(rng) & 0xFFFFFFFF
        rail = []
        with torch.no_grad():
            new_params = self._update(params, diff, seed_base, (), rail)
            if self.xcfg.carry and cfg.carry_period > 0 \
                    and (int(state["step"]) + 1) % cfg.carry_period == 0:
                # Periodic carry (paper §VI.B): every carry_period steps a
                # serial closed-loop pass folds each container's carry
                # (LSB) array into its primary one significance level up.
                new_params = self._carry_sweep(new_params)
        if not rail:
            raise ValueError(
                f"no analog containers in params for family {cfg.family!r}; "
                "was the state built with analog_mode='device'?")
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach()}
        # fraction of devices pinned at the conductance rails — the leading
        # indicator of window exhaustion (paper §V.A)
        out["g_rail_frac"] = sum(rail) / len(rail)
        return {"params": new_params, "step": state["step"] + 1}, out

    def _update(self, p, d, seed_base, path, rail):
        if is_analog_container(p):
            return self._update_container(p, d, seed_base, path, rail)
        if isinstance(p, dict):
            return {k: self._update(p[k], d[k], seed_base, path + (k,), rail)
                    for k in p}
        if d.grad is None:  # a leaf the loss does not reach
            return p
        # The gradient is scaled in place and dropped with the walk: the
        # embedding's and the head's are the size of the leaves, and
        # neither a second copy nor a temporary is held (the same float32
        # product and difference as ``p - lr * grad``).
        grad, d.grad = d.grad, None
        return p - grad.mul_(self.lr).to(p.dtype)

    def _update_container(self, p, tapes, seed_base, path, rail):
        """The paper's Fig. 3c parallel write: one kernel launch per
        container over its (L, tiles) grid (an expert stack's (E * L,
        tiles), expert dim outermost), its write noise from the counter
        PRNG, with the tapes' code scales per flattened matrix.  A
        container applied several times a step (the hybrid's shared
        block) is written once over all its applications' rows, without
        code scales: each application's codes have their own scale."""
        kind = registry.classify(path)
        seed = None if seed_base is None else container_seed(seed_base, path)
        mode = "none" if seed is None else "kernel"
        f32 = dict(dtype=torch.float32, device=p["g"].device)
        scale = torch.tensor(-self.lr, **f32) * p["w_scale"].float()
        # Periodic carry: every training write lands on the carry (LSB)
        # array, one significance level below the primary, as a
        # carry_base-times larger conductance move (the effective read
        # divides by carry_base).  The primary moves only in the sweeps.
        leaf = "g_carry" if "g_carry" in p else "g"
        if leaf == "g_carry":
            scale = scale * torch.tensor(self.xcfg.carry_base, **f32)
        code_scales = [tapes[k] for k in ("x_tape_scale", "d_tape_scale")
                       if k in tapes and registry.tape_reps(path,
                                                            self.cfg) == 1]
        if self.mesh is None:
            g3, x3, d3, s1, *code_scales, unflatten = registry.flatten_lead(
                kind, p[leaf], tapes["x_tape"], tapes["d_tape"], scale,
                *code_scales)
            xs, ds = code_scales if code_scales else (None, None)
            g_new = unflatten(xbar_outer_update(
                g3, x3, d3, s1, self.xcfg, seed=seed, noise_mode=mode,
                x_scale=xs, d_scale=ds))
            rail.append(self._railed(g_new).to(torch.float32)
                        / g_new.numel())
            return {**p, leaf: g_new}
        # this rank's block, flattened as a block; its tapes and their code
        # scales are the whole container's (replicated), flattened as the
        # whole container is (zero-stride stand-ins carry the shapes)
        gshape = self._cspecs[path][1]
        one = p[leaf].new_empty(())
        stub = one.expand(*p[leaf].shape[:-2], 1, 1)
        g3, _, _, s1, unflatten = registry.flatten_lead(kind, p[leaf], stub,
                                                        stub, scale)
        _, x3, d3, _, *code_scales, _ = registry.flatten_lead(
            kind, one.expand(gshape), tapes["x_tape"], tapes["d_tape"], 0.0,
            *code_scales)
        xs, ds = code_scales if code_scales else (None, None)
        g_new = unflatten(xbar_sharded_update(
            g3, x3, d3, s1, self.xcfg, self.mesh, self._flat_spec(path, kind),
            seed=seed, noise_mode=mode, x_scale=xs, d_scale=ds))
        railed = self._shard_total(self._railed(g_new), path)
        rail.append(railed.to(torch.float32) / math.prod(gshape))
        return {**p, leaf: g_new}

    def _railed(self, g: Tensor) -> Tensor:
        """Cells of ``g`` within 1e-3 of the window's rails (int64)."""
        dev = self.xcfg.device
        span = dev.gmax - dev.gmin
        lo, hi = dev.gmin + 1e-3 * span, dev.gmax - 1e-3 * span
        # counted a slice at a time: a count of a boolean tensor sums an
        # integer copy of it (8 bytes a cell; 15 GB for a w_upgate stack)
        return sum(torch.count_nonzero(c <= lo) + torch.count_nonzero(c >= hi)
                   for c in g.reshape(-1).split(RAIL_SLICE))

    def _shard_total(self, count: Tensor, path) -> Tensor:
        """An integer count summed over the ranks holding the container's
        blocks: gathered (arithmetic-free), then added in shard order."""
        spec = self._cspecs[path][0]["g"]
        names = tuple(a for e in spec if e for a in e)
        # audit: allow RA103 -- metric-only gather of integer rail counts, added in shard order: integer sums are order-exact, bit-identity unaffected
        return shardctx.combine_partials_exact(
            count.reshape(1), names, 0, self.mesh).sum()

    def _flat_spec(self, path, kind):
        """The spec of a container's flattened (Lflat, K, N) write view:
        the flattened lead dim carries the sharded lead dim's axes (the
        expert dim, which the registry hoists outermost, so a rank's
        experts are a contiguous range of flattened layers; the layer dim
        is never sharded)."""
        spec, gshape = self._cspecs[path][0]["g"], self._cspecs[path][1]
        lead = [e for e in spec[:-2] if e]
        if len(lead) > 1 or (lead and registry.hoist_axis(
                kind, len(gshape)) not in (None, spec.index(lead[0]))):
            raise ValueError(f"{'/'.join(path)}: a sharded lead dim must be "
                             "the registry's hoisted axis")
        if len(gshape) == 2:
            return spec
        return (lead[0] if lead else None, spec[-2], spec[-1])

    def _carry_readout(self, v: Tensor) -> Tensor:
        """Serial readout of a carry cell's signed value through the ADC
        transfer (range ``w_swing``), as the reference's.  The range is a
        tensor on ``v``'s device, so that ``v / lsb`` divides there (torch
        multiplies by the reciprocal of a Python scalar on the card)."""
        sat = torch.tensor(self.xcfg.w_swing, dtype=v.dtype, device=v.device)
        return adc_quantize(v, sat, self.xcfg.adc)

    def _carry_sweep(self, p):
        """One serial carry pass (paper §VI.B): read each carry cell
        through the ADC, fold the transferable amount into the primary
        array one significance level up (closed-loop writes are exact),
        and leave the residual (clamp leftovers and sub-lsb mass) in the
        carry cell, where the effective read still sees it.
        Elementwise."""
        cfg = self.xcfg
        dev = cfg.device

        def sweep(q):
            if is_analog_container(q):
                if "g_carry" not in q:
                    return q
                t, inc = carry_fold(q["g_carry"], q["g"], q["ref"],
                                    cfg.carry_base, cfg,
                                    quantize=self._carry_readout)
                g = torch.clamp(q["g"] + inc, dev.gmin, dev.gmax)
                gc = torch.clamp(q["g_carry"] - t, dev.gmin, dev.gmax)
                return {**q, "g": g, "g_carry": gc}
            if isinstance(q, dict):
                return {k: sweep(v) for k, v in q.items()}
            return q
        return sweep(p)


def make_analog_sgd_step(cfg: ModelConfig, lr: float, mesh=None,
                         bits: int = 8, exact: bool = True,
                         read_mode: str = "local") -> AnalogTrainStep:
    """The analog-SGD training step for a device-mode transformer config
    (see :class:`AnalogTrainStep`): on one device, or with ``mesh``
    sharded over the container tile grid, ``read_mode`` ``"local"``
    (shard-local reads) or ``"gather"``."""
    return AnalogTrainStep(cfg, lr, mesh=mesh, bits=bits, exact=exact,
                           read_mode=read_mode)
