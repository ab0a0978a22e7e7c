"""Tiled-crossbar parameter containers for whole-model analog execution.

Port of ``repro.core.tiled_analog`` (dense and MoE families).  Any
projection matrix of the transformer is *programmed* onto a grid of
physical ``rows x cols`` crossbar tiles and executed with the paper's
three kernels:

    forward   = VMM   (parallel read,   Fig. 3a)
    backward  = MVM   (transpose read of the SAME conductances, Fig. 3b)
    update    = rank-k outer-product write (Fig. 3c)

The container is a plain dict that rides inside the parameter tree,
stacked per layer (and per expert, for an MoE expert stack) or not:

    {"g": (..., K, N) conductances, "ref": (..., K, N) reference,
     "w_scale": (...) weight scale}

In-situ training needs the drive operands of the outer-product write —
the quantised activations x_q and errors d_q — not a (K, N) gradient.
``analog_project`` therefore runs through :class:`TapedMatmul`, an
autograd Function whose backward computes ``dx`` by the transpose read
and writes (x_q, d_q) into the container's tape slots (``x_tape`` /
``d_tape``, see :func:`make_tapes`), with the write drivers' per-call
scales beside them (``x_tape_scale`` / ``d_tape_scale``: ``x_q`` is
integer codes times ``x_tape_scale``); ``g``, ``ref`` and ``w_scale`` never
require grad, so no dense (K, N) gradient is ever formed, not even a
zeros fill.  The train step hands the tapes to the rank-k write kernel
(``kernels.xbar_update``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import torch

from .adc import AdcConfig
from .crossbar import (CrossbarConfig, make_reference, tile_grid,
                       weights_to_conductance)
from .device import IDEAL, LINEARIZED, TAOX, TAOX_NONOISE, DeviceConfig
from .xbar_ops import mvm, quantize_update_codes, vmm

Tensor = torch.Tensor

#: A container's tape slots: the write drivers' operands and their scales.
TAPE_LEAVES = ("x_tape", "d_tape", "x_tape_scale", "d_tape_scale")

#: Device models selectable from a ModelConfig (``analog_device``).
DEVICE_MODELS: Dict[str, DeviceConfig] = {
    "ideal": IDEAL,
    "taox": TAOX,
    "taox-nonoise": TAOX_NONOISE,
    "linearized": LINEARIZED,
}


def device_model(name: str) -> DeviceConfig:
    """Resolve an ``analog_device`` name to a :class:`DeviceConfig`.

    ``<base>:wn<mult>`` scales the base model's write noise by a float
    multiplier (``taox:wn16`` is TaOx with 16x its write noise).
    """
    if ":wn" in name:
        base, mult = name.split(":wn", 1)
        dev = DEVICE_MODELS[base]
        return dev.replace(write_noise=dev.write_noise * float(mult))
    return DEVICE_MODELS[name]


@lru_cache(maxsize=None)
def crossbar_from_model(cfg) -> CrossbarConfig:
    """The physical tile description of a (frozen) ModelConfig."""
    return CrossbarConfig(
        rows=cfg.analog_rows, cols=cfg.analog_cols,
        device=device_model(cfg.analog_device),
        adc=AdcConfig(in_bits=cfg.analog_in_bits,
                      out_bits=cfg.analog_out_bits,
                      sat_sigmas=cfg.analog_sat_sigmas),
        update_mode=cfg.analog_update_mode,
        carry=cfg.analog_carry, carry_base=cfg.analog_carry_base)


def program_linear(w: Tensor, cfg: CrossbarConfig,
                   generator: Optional[torch.Generator] = None,
                   w_max=None) -> dict:
    """Program a digitally initialised (K, N) weight matrix onto the grid.

    ``w_max`` fixes the weight <-> conductance window; the default leaves
    8x-rms headroom, computed from the weights, so programming a digital
    checkpoint round-trips exactly.
    """
    w = w.float()
    if w_max is None:
        w_max = 8.0 * torch.sqrt(torch.mean(w * w) + 1e-12)
    g, w_scale = weights_to_conductance(w, cfg, w_max=w_max)
    ref = make_reference(tuple(w.shape), cfg, generator=generator,
                         device=w.device)
    p = {"g": g, "ref": ref, "w_scale": w_scale}
    if cfg.carry:
        p["g_carry"] = ref.clone()
    return p


def stack_trees(trees, n: int) -> dict:
    """Stack ``n`` identically structured dict trees of tensors leaf by
    leaf (programmed containers, or whole layers).  ``trees`` may be a
    generator: each tree is copied into leaves allocated once and dropped
    before the next is made, so a stack built matrix by matrix never
    holds more than one matrix's temporaries."""
    out = None

    def alloc(src):
        return {k: alloc(v) if isinstance(v, dict)
                else v.new_empty((n, *v.shape)) for k, v in src.items()}

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    for i, t in enumerate(trees):
        if out is None:
            out = alloc(t)
        fill(out, t, i)
    return out


def program_stacked(w: Tensor, cfg: CrossbarConfig, w_max=None) -> dict:
    """Program a stack of weight matrices, (E, K, N) expert stacks,
    (L, K, N) or deeper lead dims, one tile grid and one calibration
    (``w_scale``) per matrix, exactly as if each were programmed alone:
    on the hardware every expert owns its own arrays."""
    if w.ndim == 2:
        return program_linear(w, cfg, w_max=w_max)
    return stack_trees((program_stacked(wi, cfg, w_max=w_max) for wi in w),
                       w.shape[0])


def is_analog_container(p) -> bool:
    return isinstance(p, dict) and {"g", "ref", "w_scale"} <= set(p)


def effective_g(p: dict, cfg: CrossbarConfig) -> Tensor:
    """Conductances the read sees: the primary array plus, with a
    periodic-carry array, its deviation one significance level down."""
    gc = p.get("g_carry")
    if gc is None:
        return p["g"]
    return p["g"] + (gc - p["ref"]) / cfg.carry_base


def readout(p: dict, cfg: CrossbarConfig) -> Tensor:
    """Digital serial read of the programmed weights (stacked or not)."""
    w_scale = torch.as_tensor(p["w_scale"])[..., None, None]
    return (effective_g(p, cfg) - p["ref"]) / w_scale


def tile_info(p: dict, cfg: CrossbarConfig):
    """(tiles_k, tiles_n, fill fraction) of the grid holding this layer."""
    k, n = p["g"].shape[-2:]
    tk, tn = tile_grid(k, n, cfg)
    return tk, tn, (k * n) / (tk * tn * cfg.rows * cfg.cols)


class TapedMatmul(torch.autograd.Function):
    """The in-situ training primitive: ``y = vmm(x)`` forward; backward
    ``dx = mvm(dy)`` through the same conductances, and the write drivers'
    operands ``quantize_update_operands(x, dy)`` written into the tape
    slots, their scales into the scale slots (when the container carries
    them).  Only ``x`` gets a gradient.
    """

    @staticmethod
    def forward(ctx, x, g, ref, w_scale, cfg, x_tape, d_tape, x_tape_scale,
                d_tape_scale, meta=None):
        ctx.save_for_backward(x, g, ref, w_scale)
        ctx.cfg = cfg
        ctx.meta = meta
        ctx.tapes = (x_tape, d_tape, x_tape_scale, d_tape_scale)
        return vmm(x, g, ref, w_scale, cfg, meta=meta)

    @staticmethod
    def backward(ctx, dy):
        x, g, ref, w_scale = ctx.saved_tensors
        cfg = ctx.cfg
        dy32 = dy.float()
        # Error backprop: transpose read of the SAME (quantised, saturated,
        # ADC'd) conductances the forward pass saw.
        dx = mvm(dy32, g, ref, w_scale, cfg, meta=ctx.meta)
        x_tape, d_tape, x_tape_scale, d_tape_scale = ctx.tapes
        if x_tape is not None:
            # one coder calibration per matrix: per expert of a batched
            # container (lead dims of x), one for a plain matrix
            lead = x.ndim - 2
            x_int, x_scale, d_int, d_scale = quantize_update_codes(
                x.float(), dy32, cfg, lead)
            x_tape.copy_(x_int * x_scale[..., None, None])
            d_tape.copy_(d_int * d_scale[..., None, None])
            if x_tape_scale is not None:
                x_tape_scale.copy_(x_scale)
                d_tape_scale.copy_(d_scale)
        return dx.to(x.dtype), *(None,) * 9


def analog_project(p: dict, x: Tensor, cfg: CrossbarConfig) -> Tensor:
    """Apply a programmed container to activations, returned in
    ``x.dtype``: a (K, N) matrix to (..., K), one fused read over all
    tokens; an expert-batched stack (``g``: (E, K, N)) to (E, T, K) ->
    (E, T, N), one read of all E matrices, each its own tile grid reading
    its own dispatch rows with its own DAC full scale.

    If the container carries ``x_tape``/``d_tape`` slots (put there by the
    train step), the backward pass deposits the quantised update operands
    in them; a stack's slots ((E, T, K) / (E, T, N), code scales (E,))
    carry the per-expert write operands, and the stack is written as
    extra layers of the layer-batched rank-k write
    (``analog_registry.flatten_lead``).  Each tape slot takes one
    application per differentiated step: a second application through the
    same slot would overwrite its operands, and the summed outer product
    of two applications is not the outer product of their summed
    operands.  A container applied several times a step (the hybrid's
    shared block, ``analog_registry.tape_reps``) therefore carries
    (reps, T, K) / (reps, T, N) tapes and (reps,) code scales, and its
    caller hands application ``i`` the slot ``[i]`` of each
    (``models.transformer.tape_slot``): each application deposits its own
    operands and its own scales, and the write sums the applications'
    outer products.  Every other container is applied exactly once per
    token batch.

    A container of the sharded train step holds this rank's tile blocks
    and its ``tp_meta`` (``core.shardctx.ShardMeta``): its geometry comes
    from the meta, and both its reads go shard-local.
    """
    for leaf in ("g", "ref", "w_scale"):
        if getattr(p[leaf], "requires_grad", False):
            raise ValueError(f"container leaf {leaf!r} requires grad: the "
                             "conductances are written by the rank-k "
                             "update, never by autograd")
    meta = p.get("tp_meta")
    gshape = meta.view(p["g"].ndim) if meta is not None else p["g"].shape
    lead = tuple(gshape[:-2])
    k, n = gshape[-2:]
    if not lead:
        xb = x.reshape(-1, k).float()
    elif x.ndim == len(lead) + 2 and x.shape[:-2] == lead \
            and x.shape[-1] == k:
        xb = x.float()
    else:
        raise ValueError(f"expert-batched x {tuple(x.shape)} does not "
                         f"match container {tuple(p['g'].shape)}")
    y = TapedMatmul.apply(xb, effective_g(p, cfg), p["ref"],
                          torch.as_tensor(p["w_scale"]), cfg,
                          *(p.get(leaf) for leaf in TAPE_LEAVES), meta)
    return y.reshape(*x.shape[:-1], n).to(x.dtype)


def analog_project_batched(p: dict, x: Tensor,
                           cfg: CrossbarConfig) -> Tensor:
    """Apply an expert-batched container (``g``: (E, K, N)) to
    expert-batched activations ``x``: (E, T, K) -> (E, T, N): the
    reference's name for :func:`analog_project` of a stack, with its shape
    check (a ``ValueError`` on a mismatched E or K)."""
    meta = p.get("tp_meta")
    e, k, _ = meta.view(3) if meta is not None else p["g"].shape
    if x.shape[0] != e or x.shape[-1] != k:
        raise ValueError(f"expert-batched x {tuple(x.shape)} does not match "
                         f"container {tuple(p['g'].shape)}")
    return analog_project(p, x, cfg)


def make_tapes(p: dict, n_tokens) -> dict:
    """Tape slots for one container: zero operands, shapes (lead..., T, K)
    and (lead..., T, N), and their scales, (lead...,) ones.  ``n_tokens``
    may be a tuple: the operand-row shape between the container's lead
    dims and the feature dim (``analog_registry.tape_lead``); a (reps, T)
    one gives one slot per application, (lead..., reps, T, K|N), with a
    scale per application, (lead..., reps).  The backward pass of
    :class:`TapedMatmul` overwrites them with (x_q, d_q) and the write
    drivers' scales, and the rank-k write consumes them: one allocation
    site, one writer per slot, one consumer.
    """
    g = p["g"]
    meta = p.get("tp_meta")
    # tapes are replicated: a sharded container's come in its global shape
    gshape = meta.view(g.ndim) if meta is not None else g.shape
    k, n = gshape[-2:]
    lead = tuple(gshape[:-2])
    rows = n_tokens if isinstance(n_tokens, tuple) else (n_tokens,)
    f32 = dict(dtype=torch.float32, device=g.device)
    return {"x_tape": torch.zeros((*lead, *rows, k), **f32),
            "d_tape": torch.zeros((*lead, *rows, n), **f32),
            "x_tape_scale": torch.ones((*lead, *rows[:-1]), **f32),
            "d_tape_scale": torch.ones((*lead, *rows[:-1]), **f32)}


def with_tapes(params, n_tokens, tokens_for=None, path=()):
    """Recursively inject tape slots (:func:`make_tapes`) next to every
    analog container.  ``tokens_for(path, g_shape)`` optionally resolves
    a container's operand-row shape (``analog_registry.tape_lead``); the
    default is ``n_tokens`` rows everywhere.  Training code takes
    :func:`split_tapes`, which keeps the conductances out of the
    differentiated tree."""
    if is_analog_container(params):
        rows = tokens_for(path, params["g"].shape) if tokens_for \
            else n_tokens
        return {**params, **make_tapes(params, rows)}
    if isinstance(params, dict):
        return {k: with_tapes(v, n_tokens, tokens_for, path + (k,))
                for k, v in params.items()}
    return params


def split_tapes(params, n_tokens, tokens_for=None, path=()):
    """Partition a parameter tree for the hoisted analog gradient.

    Returns ``(diff, frozen)``: ``diff`` carries every digital leaf plus,
    for each analog container, only its tape slots; ``frozen`` mirrors the
    tree with each container's g/ref/w_scale (``None`` elsewhere).
    ``tokens_for(path, g_shape)`` optionally resolves a container's
    operand-row shape (``analog_registry.tape_lead``).
    """
    if is_analog_container(params):
        rows = tokens_for(path, params["g"].shape) if tokens_for \
            else n_tokens
        return (make_tapes(params, rows),
                {k: params[k]
                 for k in ("g", "ref", "w_scale", "g_carry", "tp_meta")
                 if k in params})
    if isinstance(params, dict):
        split = {k: split_tapes(v, n_tokens, tokens_for, path + (k,))
                 for k, v in params.items()}
        return ({k: v[0] for k, v in split.items()},
                {k: v[1] for k, v in split.items()})
    return params, None


def merge_tapes(diff, frozen):
    """Inverse of :func:`split_tapes`: the tree the model consumes (each
    analog container regains its g/ref/w_scale next to its tapes)."""
    if frozen is None:
        return diff
    if isinstance(frozen, dict) and "g" in frozen:
        return {**frozen, **diff}
    return {k: merge_tapes(diff[k], frozen[k]) for k in diff}


def pop_tapes(params):
    """Strip the tape leaves off every container in a (sub)tree.

    Returns ``(clean, tapes, found)``: ``clean`` is the tree without
    the :data:`TAPE_LEAVES`, ``tapes`` mirrors it with dicts of them at
    container sites (empty dicts elsewhere), ``found`` says whether any
    tape leaf existed.
    """
    if is_analog_container(params):
        tapes = {k: params[k] for k in TAPE_LEAVES if k in params}
        clean = {k: v for k, v in params.items() if k not in TAPE_LEAVES}
        return clean, tapes, bool(tapes)
    if isinstance(params, dict):
        out = {k: pop_tapes(v) for k, v in params.items()}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()},
                any(v[2] for v in out.values()))
    return params, {}, False


def push_tapes(params, tapes):
    """Inverse of :func:`pop_tapes`: re-inject tape leaves next to their
    containers."""
    if is_analog_container(params):
        return {**params, **tapes}
    if isinstance(params, dict):
        return {k: push_tapes(v, tapes.get(k, {})) for k, v in params.items()}
    return params
