"""Whole-model projection onto the analog neural training accelerator
(port of ``repro.hwmodel.arch_cost``, every family).

Every weight-stationary projection (attention and cross-attention, FFN,
MoE expert and SSD in/out projections, the audio encoder's; embeddings,
the router and the encoder's positional table excluded) maps onto
1024x1024 differential crossbar tiles; activation-activation compute
(QK^T, PV, the SSD scan, softmax, norms) stays on the digital core and is
charged at the synthesized MAC cost.

The projection inventory is derived from the actual parameter tree via
the analog registry (``core.analog_registry``), so the cost roll-up
cannot drift from the model code; in device mode a matrix the registry
cannot place raises instead of being charged as digital.

Accounting:
  * tile padding waste (a 2560x6912 layer occupies 3x7 tiles),
  * MoE: only the active experts fire (energy, ``top_k / n_experts`` of
    each expert stack), but every expert occupies area,
  * the hybrid shared block: one weight set, ``n_layers // attn_every``
    applications per token,
  * attention and scan digital MACs at 1.46 pJ (paper §IV.J), the audio
    encoder's layers counted with the decoder's,
  * training charges VMM + MVM + OPU per projection; inference VMM only.

The reference enumerates the tree with ``jax.eval_shape``; the port
builds it with ``models.model.init_params`` on the ``meta`` device, which
allocates nothing.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional

from repro_torch.configs.base import AnalogMode, ModelConfig

from . import digital_reram, sram
from .analog import AnalogCore
from .params import TABLE_I


@dataclasses.dataclass(frozen=True)
class Projection:
    """One weight-stationary matmul of the model."""

    name: str
    k: int
    n: int
    count: int = 1          # instances per model (layers folded in)
    active: float = 1.0     # applications per token


@functools.lru_cache(maxsize=None)
def model_projections(cfg: ModelConfig) -> List[Projection]:
    """Every weight-stationary matmul of the model, enumerated from the
    actual parameter tree (``init_params`` on the ``meta`` device: shapes
    only) and classified by the analog registry.

    A matrix the registry can classify neither as a crossbar projection
    nor as a digital-core parameter is an error in device mode; in the
    digital and fakequant modes it is skipped, as in the reference.
    """
    import torch

    from repro_torch.core import analog_registry as registry
    from repro_torch.core.tiled_analog import is_analog_container
    from repro_torch.models import model as M

    params = M.init_params(cfg, torch.Generator(), device="meta")
    ps: List[Projection] = []
    unknown: List[str] = []

    def emit(path, shape):
        kind = registry.classify_param(path)
        if kind == "digital":
            return
        if kind is None:
            unknown.append("/".join(path) + f" {tuple(shape)}")
            return
        k, n = shape[-2:]
        count = int(math.prod(shape[:-2])) if len(shape) > 2 else 1
        if kind == registry.EXPERT_BATCHED and cfg.n_experts:
            active = cfg.top_k / cfg.n_experts
        else:
            active = float(registry.tape_reps(path, cfg))
        ps.append(Projection("/".join(path), int(k), int(n), count,
                             active=active))

    def walk(p, path):
        if is_analog_container(p):
            emit(path, tuple(p["g"].shape))
            return
        if isinstance(p, dict):
            if set(p) == {"w"}:
                emit(path, tuple(p["w"].shape))
                return
            for key, v in p.items():
                walk(v, path + (str(key),))
            return
        if getattr(p, "ndim", 0) >= 2:
            emit(path, tuple(p.shape))

    walk(params, ())
    if unknown and cfg.resolved_analog_mode is AnalogMode.DEVICE:
        raise ValueError(
            "device-mode cost roll-up cannot classify these matrices "
            "(counting them as digital would under-report tiles/energy): "
            f"{unknown}")
    return ps


def digital_macs_per_token(cfg: ModelConfig, ctx_len: int) -> float:
    """Activation-activation MACs (attention QK^T + PV, the SSD scan) that
    stay on the digital core, per generated/processed token at context
    ``ctx_len``: the decoder's layers and, for the audio model, the
    encoder's."""
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * cfg.d_model
        h = d_in // cfg.ssm_head_dim
        macs = cfg.n_layers * (h * cfg.ssm_state * cfg.ssm_head_dim * 2)
        if cfg.attn_every:
            hd = cfg.resolved_head_dim
            macs += 2 * cfg.n_heads * hd * ctx_len
        return float(macs)
    hd = cfg.resolved_head_dim
    layers = cfg.n_layers + cfg.n_encoder_layers
    return float(layers * 2 * cfg.n_heads * hd * ctx_len)


@dataclasses.dataclass
class ArchCost:
    arch: str
    tiles: int
    tiles_active: float
    area_mm2: float
    util: float                     # weight fill fraction of the tiles
    e_inference_token_uj: float     # VMM energy per token (incl. digital)
    e_analog_token_uj: float        # analog-projection share of the above
    e_train_token_uj: float         # VMM+MVM+OPU per token
    fj_per_mac_analog_only: float   # kernel-level figure at arch scale
    t_layer_serial_us: float        # pipelined per-token latency
    fj_per_mac_inference: float
    digital_mac_frac: float         # share of MACs left on the digital core
    e_digital_reram_token_uj: float
    e_sram_token_uj: float


def analyze_arch(cfg: ModelConfig, bits: int = 8,
                 ctx_len: int = 4096) -> ArchCost:
    core = AnalogCore(bits=bits)
    rows, cols = TABLE_I.rows, TABLE_I.cols
    e = core.energy
    lat = core.latency

    tiles = 0
    tiles_active = 0.0
    weights = 0
    macs_token = 0.0
    serial_depth = 0
    for p in model_projections(cfg):
        tk, tn = math.ceil(p.k / rows), math.ceil(p.n / cols)
        tiles += tk * tn * p.count
        tiles_active += tk * tn * p.count * p.active
        weights += p.k * p.n * p.count
        macs_token += p.k * p.n * p.count * p.active
        serial_depth += p.count * p.active  # sequential layer ops

    # Energy: a VMM activates every tile of a projection once per token.
    # Per-tile energies are for full 1024-row drive; scale by utilisation.
    util = weights / (tiles * rows * cols)
    e_vmm_tok = tiles_active * e["vmm"] * util
    e_train_tok = tiles_active * (e["vmm"] + e["mvm"] + e["opu"]) * util
    d_macs = digital_macs_per_token(cfg, ctx_len)
    e_dig = d_macs * 1.46e-12  # synthesized MAC, paper §IV.J
    t_serial = serial_depth * (lat["vmm"])

    # digital comparisons: same MACs through the digital ReRAM / SRAM cores
    dr = digital_reram.kernel_energy(bits)
    sr = sram.kernel_energy(bits)
    per_mac_dr = dr["vmm"] / (rows * cols)
    per_mac_sr = sr["vmm"] / (rows * cols)

    return ArchCost(
        arch=cfg.name,
        tiles=tiles,
        tiles_active=tiles_active,
        area_mm2=tiles * core.area * 1e6,   # m^2 -> mm^2
        util=util,
        e_inference_token_uj=(e_vmm_tok + e_dig) * 1e6,
        e_analog_token_uj=e_vmm_tok * 1e6,
        e_train_token_uj=(e_train_tok + 3 * e_dig) * 1e6,
        fj_per_mac_analog_only=e_vmm_tok / max(macs_token, 1) / 1e-15,
        t_layer_serial_us=t_serial * 1e6,
        fj_per_mac_inference=(e_vmm_tok + e_dig)
        / max(macs_token + d_macs, 1) / 1e-15,
        digital_mac_frac=d_macs / (macs_token + d_macs),
        e_digital_reram_token_uj=(macs_token * per_mac_dr + e_dig) * 1e6,
        e_sram_token_uj=(macs_token * per_mac_sr + e_dig) * 1e6,
    )


def report(cfgs: List[ModelConfig], bits: int = 8) -> List[ArchCost]:
    return [analyze_arch(cfg, bits=bits) for cfg in cfgs]


def serve_energy_per_token(cfg: ModelConfig, ctx_len: int = 4096,
                           bits: int = 8) -> Dict[str, float]:
    """pJ per generated token for the serving backends: one VMM pass per
    projection plus the digital-core remainder, against the same token
    served from a digital-ReRAM or SRAM core."""
    ac = analyze_arch(cfg, bits=bits, ctx_len=ctx_len)
    uj_to_pj = 1e6
    return {
        "analog_pj": ac.e_inference_token_uj * uj_to_pj,
        "analog_projection_pj": ac.e_analog_token_uj * uj_to_pj,
        "digital_reram_pj": ac.e_digital_reram_token_uj * uj_to_pj,
        "sram_pj": ac.e_sram_token_uj * uj_to_pj,
        "digital_mac_frac": ac.digital_mac_frac,
        "fj_per_mac_inference": ac.fj_per_mac_inference,
    }


def train_step_cost(cfg: ModelConfig, n_tokens: int, bits: int = 8,
                    ctx_len: Optional[int] = None,
                    n_shards: int = 1) -> Dict[str, object]:
    """Projected hardware cost of ONE training step of ``n_tokens`` tokens
    on the analog accelerator against a digital-ReRAM or SRAM core, all
    at the paper's Table-I 1024x1024 tile geometry whatever tile the
    simulation ran with.  Digital training is charged 3x the inference
    MACs (forward, activation grad, weight grad); the analog step charges
    VMM + MVM + OPU per projection.

    ``n_shards`` > 1 adds the per-shard roll-up under ``"mesh"`` (tiles,
    area and energy divide across shards; latency does not, since every
    tile of a projection already fires in parallel).
    """
    ctx_len = ctx_len or 4096
    n_shards = max(1, int(n_shards))
    ac = analyze_arch(cfg, bits=bits, ctx_len=ctx_len)
    macs = sum(p.k * p.n * p.count * p.active
               for p in model_projections(cfg))
    d_macs = digital_macs_per_token(cfg, ctx_len)
    train_macs = 3.0 * (macs + d_macs) * n_tokens

    e_uj = {
        "analog": ac.e_train_token_uj * n_tokens,
        "digital_reram": 3.0 * ac.e_digital_reram_token_uj * n_tokens,
        "sram": 3.0 * ac.e_sram_token_uj * n_tokens,
    }
    lat = AnalogCore(bits=bits).latency
    t_token = (lat["vmm"] + lat["mvm"] + lat["opu"]) \
        * sum(p.count * p.active for p in model_projections(cfg))
    out = {
        "n_tokens": n_tokens,
        "bits": bits,
        "tile_geometry": f"{TABLE_I.rows}x{TABLE_I.cols} (paper Table I)",
        "tiles": ac.tiles,
        "area_mm2": ac.area_mm2,
        "tile_util": ac.util,
        "e_step_uj": e_uj,
        # 1 MAC := one multiply-accumulate of one of the 3 training passes.
        "pj_per_mac": {k: v * 1e6 / max(train_macs, 1.0)
                       for k, v in e_uj.items()},
        "fj_per_mac_analog_kernel": ac.fj_per_mac_analog_only,
        "t_step_us": t_token * n_tokens * 1e6,  # serial layer pipeline
        "digital_mac_frac": ac.digital_mac_frac,
    }
    if n_shards > 1:
        out["mesh"] = {
            "n_shards": n_shards,
            "tiles_per_shard": math.ceil(ac.tiles / n_shards),
            "area_mm2_per_shard": ac.area_mm2 / n_shards,
            "e_step_per_shard_uj": {k: v / n_shards
                                    for k, v in e_uj.items()},
        }
    return out
