"""Model configuration schema (the port's copy of ``repro.configs.base``).

One ``ModelConfig`` describes an architecture of any family the registry
carries (dense, MoE with MLA among them, the cross-attention VLM, the
audio encoder-decoder, SSM and hybrid), with the JAX package's fields
under the same names.  Every config file exports ``CONFIG`` (the
published architecture) and ``SMOKE`` (:func:`make_smoke`).  The port
keeps its own copy because it imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class AnalogMode(enum.Enum):
    """Validated execution mode of the analog-crossbar path.

    ``cfg.analog_mode`` stays a plain string field (the config dataclass
    must remain frozen/hashable and trivially serialisable for
    checkpoint metadata); this enum is the *resolution* layer every
    consumer goes through via :func:`resolve_analog_mode` instead of
    comparing raw strings.
    """

    DIGITAL = "digital"      # analog path fully off: plain matmuls
    FAKEQUANT = "fakequant"  # QAT-style I/O quantisation, no device state
    DEVICE = "device"        # projections programmed onto tiled crossbars


def resolve_analog_mode(cfg: "ModelConfig") -> AnalogMode:
    """THE central analog-mode resolution point.

    Raises loudly on unknown strings and on incoherent combinations:

    * ``analog=False`` + ``analog_mode="device"`` — device state exists
      but the flag claims the analog path is off; every historical bug
      in this area came from one of the two fields being stale.  Use
      :meth:`ModelConfig.digital` to switch a device config off.
    * ``analog=True`` + ``analog_mode="digital"`` — the inverse
      contradiction.

    ``analog=False`` with the (default) ``"fakequant"`` string resolves
    to :attr:`AnalogMode.DIGITAL`: the master switch is off and the mode
    string is merely unused, not contradictory.
    """
    try:
        mode = AnalogMode(cfg.analog_mode)
    except ValueError:
        raise ValueError(
            f"unknown analog_mode {cfg.analog_mode!r}; expected one of "
            f"{[m.value for m in AnalogMode]}") from None
    if not cfg.analog:
        if mode is AnalogMode.DEVICE:
            raise ValueError(
                "incoherent config: analog=False but analog_mode='device' "
                "(programmed crossbar state with the analog path switched "
                "off).  Use cfg.digital() to derive a digital view of a "
                "device config.")
        return AnalogMode.DIGITAL
    if mode is AnalogMode.DIGITAL:
        raise ValueError(
            "incoherent config: analog=True but analog_mode='digital'; "
            "pick 'fakequant' or 'device', or set analog=False.")
    return mode


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "silu"              # silu | gelu
    gated: bool = True             # GLU-style FFN (SwiGLU/GeGLU)
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- cross-attention (VLM decoder) --------------------------------------
    cross_attn_every: int = 0      # every Nth layer is a cross-attn layer
    n_vision_tokens: int = 0       # stub frontend tokens per image

    # --- encoder-decoder (audio) ---------------------------------------------
    n_encoder_layers: int = 0
    n_audio_frames: int = 0        # stub conv-frontend output frames

    # --- SSM (Mamba-2 SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- hybrid (Zamba-2): shared attention block every N ssm layers ---------
    attn_every: int = 0

    # --- analog-crossbar execution (the paper's technique) -------------------
    analog: bool = False           # run projections through the crossbar sim
    # Stored as the string value of an AnalogMode member; validated and
    # resolved exclusively through resolve_analog_mode() — do not compare
    # this field against raw strings.
    # "fakequant": QAT-style I/O quantisation inside a fused digital matmul
    #              (scalable LM integration, no device state).
    # "device":    projections are *programmed* onto tiled crossbars —
    #              forward=VMM, backward=MVM through the same conductances,
    #              updates via the nonlinear device model (in-situ training).
    # "digital":   explicit off (equivalent to analog=False; what
    #              cfg.digital() writes so the pair stays coherent).
    analog_mode: str = "fakequant"
    analog_device: str = "taox"    # key into core.DEVICE_MODELS
    analog_rows: int = 1024
    analog_cols: int = 1024
    analog_in_bits: int = 8
    analog_out_bits: int = 8
    analog_sat_sigmas: float = 4.0  # integrator range, sigmas of col charge
    # Periodic carry (paper §V.C / §VI.B): every container gains a second
    # "g_carry" crossbar holding the LSB significance level.  Updates land
    # on the carry array scaled by analog_carry_base (so each requested
    # step is a base-times-larger conductance move far from the rails),
    # the read sees it at 1/analog_carry_base drive
    # (core.tiled_analog.effective_g), and every carry_period steps a
    # serial sweep folds the ADC-quantised carry deviation into the
    # primary array (core.periodic_carry.carry_fold, scheduled by
    # train.analog_lm.AnalogTrainStep).
    analog_carry: bool = False
    carry_period: int = 0          # steps between carry sweeps (0 = never)
    analog_carry_base: float = 4.0
    # Update execution (``kernels.xbar_update.UPDATE_MODES``): "outer" is
    # the rank-k parallel write; "pulse_train" sign-decomposes the outer
    # product into 4-phase SET/RESET pulse trains with integer
    # clock-cycle event counts (Gokmen & Vlasov, arXiv 1603.07341).
    analog_update_mode: str = "outer"

    @property
    def resolved_analog_mode(self) -> AnalogMode:
        return resolve_analog_mode(self)

    @property
    def analog_training(self) -> bool:
        """Whether the config trains in device mode (the in-situ writes)."""
        return resolve_analog_mode(self) is AnalogMode.DEVICE

    def digital(self) -> "ModelConfig":
        """Digital-execution view of this config (analog path fully off).

        Rewrites *both* fields so the result passes resolve_analog_mode
        — a bare ``replace(analog=False)`` on a device config is the
        incoherent combination that resolution rejects.
        """
        return self.replace(analog=False,
                            analog_mode=AnalogMode.DIGITAL.value)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the 500k-token long-context shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_encoder(self) -> bool:
        return self.n_encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of the embedding and the layers (the reference's
        rough count, for roofline reckoning), kept term for term: the
        hybrid's shared block counted once (one weight set); the VLM's
        cross layers' attention added on top of ``n_layers`` full layers
        (so counted twice), the audio decoder's cross-attention not at
        all.  Memory is reckoned from the parameter tree, not from this
        count."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            per = (d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state
                        + d_in // self.ssm_head_dim)
                   + d_in * d)
            n = emb + self.n_layers * per
            if self.attn_every:  # the shared block (one weight set)
                shared_attn = d * hd * (self.n_heads
                                        + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
                ffn_mult = 3 if self.gated else 2
                n += 2 * d * d + shared_attn + ffn_mult * d * ff
            return n
        if self.use_mla:
            q = d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            kv = (d * (self.kv_lora_rank + self.qk_rope_dim)
                  + self.kv_lora_rank * self.n_heads
                  * (self.qk_nope_dim + self.v_head_dim))
            o = self.n_heads * self.v_head_dim * d
            attn = q + kv + o
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        ffn_mult = 3 if self.gated else 2
        if self.n_experts:
            ffe = self.d_ff_expert or ff
            n_ffn = (self.top_k if active_only else self.n_experts) \
                + self.n_shared_experts
            per = attn + n_ffn * ffn_mult * d * ffe \
                + d * self.n_experts  # + router
        else:
            per = attn + ffn_mult * d * ff
        n = self.n_layers * per
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            n += n_cross * (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                            + self.n_heads * hd * d)
        if self.n_encoder_layers:
            n += self.n_encoder_layers * (attn + ffn_mult * d * ff)
        return emb + n


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One cell of the assigned (arch x shape) grid (the reference's
    ``ShapeSpec``): a training step, a prefill or one decode step against
    a ``seq_len`` cache, at ``global_batch`` sequences."""

    name: str                      # train_4k | prefill_32k | decode_32k | ...
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32768, 32),
    ShapeSpec("decode_32k", "decode", 32768, 128),
    ShapeSpec("long_500k", "decode", 524288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ModelConfig):
    """The shape grid minus the reference's skips: the full-attention
    architectures skip ``long_500k``."""
    return [s for s in SHAPES
            if s.name != "long_500k" or cfg.sub_quadratic]


def make_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests (the reference's
    ``make_smoke``): a VLM or hybrid keeps 4 layers, two groups of
    ``cross_attn_every=2`` / ``attn_every=2``; the VLM 16 vision tokens;
    the audio model 2 encoder layers and 32 frames."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if (cfg.cross_attn_every
                                         or cfg.attn_every) else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab=256,
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8),
                  top_k=min(cfg.top_k, 2),
                  d_ff_expert=64 if cfg.d_ff_expert else 0)
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16,
                  v_head_dim=16)
    if cfg.cross_attn_every:
        kw.update(cross_attn_every=2, n_vision_tokens=16)
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2, n_audio_frames=32)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.attn_every:
        kw.update(attn_every=2)
    kw.update(overrides)
    return cfg.replace(**kw)
