"""Mamba-2 SSD (state-space duality) layer, arXiv:2405.21060 (port of
``repro.models.ssm``).

The chunked SSD algorithm: within a chunk the interactions are a masked,
decay-weighted quadratic form (attention-like); across chunks a linear
recurrence carries the (H, N, P) state.  Decode is the O(1) recurrent
step.  Multi-head: a scalar A per head, B and C shared over head groups.
The scan, the causal conv and the gating are plain tensor ops, as in the
reference (no Pallas kernel there, none here); ``in_proj`` and
``out_proj`` go through ``layers.project``, so device mode reads them from
crossbars (the fused read) and fakequant mode through the fakequant read.

Shapes: x (B, S, D); internally (B, S, H, P) with P = ssm_head_dim,
H = expand * D / P; state N = ssm_state; chunk L = ssm_chunk.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import shardctx

from .layers import proj_init, project, rmsnorm, rmsnorm_init

Tensor = torch.Tensor


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    return d_in, h, cfg.ssm_state, cfg.ssm_groups


def _softplus(x: Tensor) -> Tensor:
    """``log(1 + e^x)`` as the reference's ``jax.nn.softplus`` forms it
    (``logaddexp(x, 0)``, no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_init(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> dict:
    """One SSD layer's parameters.  The conv, A, dt and skip parameters
    stay on the digital core: they feed the scan, not a VMM."""
    d = cfg.d_model
    d_in, h, n, g = _dims(cfg)
    conv_dim = d_in + 2 * g * n
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = proj_init(generator, d, 2 * d_in + 2 * g * n + h, cfg, device)
    conv_w = 0.1 * torch.randn((cfg.ssm_conv, conv_dim), generator=generator,
                               **f32)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = lo + (hi - lo) * torch.rand((h,), generator=generator, **f32)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm": rmsnorm_init(d_in, device),
        "out_proj": proj_init(generator, d_in, d, cfg, device),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Depthwise causal conv along the sequence, the reference's shifted
    sum in its order.  x: (B, S, C); w: (K, C).  Returns ``(silu(y + b),
    new_state)``, the state being the last K - 1 inputs (for decode)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        x_pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    y = 0
    for i in range(k):
        y = y + x_pad[:, i:i + s, :] * w[i]
    new_state = x_pad[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y + b.to(x.dtype)), new_state


def _ssd_chunked(xh: Tensor, dt: Tensor, a_log: Tensor, bmat: Tensor,
                 cmat: Tensor, chunk: int,
                 h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan.

    xh: (B, S, H, P); dt: (B, S, H) (after the softplus); bmat/cmat:
    (B, S, G, N); S a multiple of ``chunk``.  Returns (y (B, S, H, P),
    final state (B, H, N, P)).  The decay exponents ``cs_i - cs_j`` are
    masked to -inf above the diagonal before the exp, so the backward
    meets no ``inf * 0``; the inter-chunk recurrence is a loop over the
    chunks (the reference's ``lax.scan``).
    """
    b, s, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    nc = s // chunk
    rep = h // g

    lam = -torch.exp(a_log)[None, None, :] * dt        # (B,S,H) log-decay
    xc = xh.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    lamc = lam.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cc = cmat.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    cs = torch.cumsum(lamc, dim=2)                      # (B,nc,L,H)
    total = cs[:, :, -1, :]                             # (B,nc,H)

    # intra-chunk: decay(i >= j) = exp(cs_i - cs_j);
    # scores_ij = C_i . B_j dt_j decay_ij
    dmat = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,L,L,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    dmat = torch.where(tri[None, None, :, :, None], dmat,
                       torch.tensor(-math.inf, dtype=dmat.dtype,
                                    device=dmat.device))
    cb = torch.einsum("bnihd,bnjhd->bnijh", cc, bc)     # (B,nc,L,L,H)
    w_ij = cb * torch.exp(dmat) * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w_ij, xc)

    # chunk states: sum_j exp(total - cs_j) dt_j B_j (x) x_j  (B,nc,H,N,P)
    wj = torch.exp(total[:, :, None, :] - cs) * dtc     # (B,nc,L,H)
    states = torch.einsum("bnjh,bnjhd,bnjhp->bnhdp", wj, bc, xc)

    # inter-chunk recurrence
    hc = torch.zeros((b, h, n, p), dtype=xh.dtype, device=xh.device) \
        if h0 is None else h0
    befores = []
    for c in range(nc):
        befores.append(hc)
        hc = hc * torch.exp(total[:, c])[..., None, None] + states[:, c]
    h_before = torch.stack(befores, dim=1)              # (B,nc,H,N,P)

    y_inter = torch.einsum("bnihd,bnhdp->bnihp",
                           cc * torch.exp(cs)[..., None], h_before)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, hc


def _rank_layer(p: dict, cfg: ModelConfig, npar):
    """This ``model`` rank's view of an SSD layer under the numeric step's
    ``ssm`` plan: its block of ``in_proj`` (z and x of its heads, B and C
    whole unless the groups split, dt whole) with the whole parts' columns
    through ``copy_to`` (their gradient summed over ``model``), and its
    entries of the replicated leaves a rank uses in part (the conv's x
    channels of its heads and the B / C channels; ``a_log``, ``dt_bias``,
    ``d_skip`` of its heads), each sliced after a ``copy_to``: each rank's
    gradient of such a leaf is 0 outside its slice, and ``reduce_grads``
    sums no replicated leaf over ``model``.  Returns the layer and its
    local ``(d_in, heads, groups)``."""
    mesh, tp, m = npar.mesh, npar.tp, npar.m
    r = mesh.coords["model"]
    d_in, h, n, g = _dims(cfg)
    dr, hr = d_in // m, h // m
    gr = g // m if g % m == 0 else g
    g0 = r * gr if g % m == 0 else 0
    w = p["in_proj"]["w"]
    dev = w.device
    lead = 2 * dr + (2 * gr * n if g % m == 0 else 0)   # the split parts

    def mine(t, idx):
        return shardctx.copy_to(t, mesh, tp).index_select(-1, idx.to(dev))
    gc = torch.arange(g0 * n, (g0 + gr) * n)
    chans = torch.cat([torch.arange(r * dr, (r + 1) * dr), d_in + gc,
                       d_in + g * n + gc])
    out = dict(p)
    out["in_proj"] = {"w": torch.cat(
        [w[..., :lead], shardctx.copy_to(w[..., lead:], mesh, tp)], dim=-1)}
    out["conv_w"], out["conv_b"] = mine(p["conv_w"], chans), \
        mine(p["conv_b"], chans)
    for k in ("a_log", "dt_bias", "d_skip"):
        out[k] = shardctx.copy_to(p[k], mesh, tp).narrow(-1, r * hr, hr)
    return out, (dr, hr, gr)


def ssm_apply(p: dict, x: Tensor, cfg: ModelConfig, *,
              state: Optional[dict] = None
              ) -> Tuple[Tensor, Optional[dict]]:
    """Full-sequence (training, prefill) or one-step (decode) SSD layer.

    ``state`` = {"h": (B, H, N, P), "conv": (B, K - 1, C)}.  A sequence
    longer than one token runs the chunked scan (from ``state`` when
    given: a prefill), padded to a multiple of ``ssm_chunk``; one token
    with a state is the O(1) recurrent step.  Returns ``(y, new_state)``,
    ``new_state`` fresh tensors (None without a conv state).

    Under the numeric step's ``ssm`` plan (training: no state) the layer
    splits over ``model`` by heads (:func:`_rank_layer`): ``in_proj``
    column-parallel (this rank's z and x, B, C and dt whole), the conv on
    the rank's channels, the scan on its heads (serving under the policy,
    ``launch.sharding.ServeParallel``, with this rank's block of the
    state: ``h`` its heads, the conv state its channels); the gated norm
    over the whole ``d_in`` runs whole on every rank, after ``y * silu(z)`` is
    gathered along ``d_in`` (backward the rank's slice), so that its
    forward and backward are one device's; the rank's columns of it then
    feed ``out_proj`` row-parallel (backward gathered).  Under sequence
    parallelism ``x`` is this rank's chunk of the sequence: ``in_proj``'s
    input is gathered along it, so the conv and the scan run over the
    whole sequences, and ``out_proj``'s output is reduce-scattered along
    it back to the chunk.
    """
    b, s, _ = x.shape
    d_in, h, n, g = _dims(cfg)
    npar = shardctx.numeric_context()
    tp = npar is not None and npar.ssm and (state is None or npar.serve)
    col = None
    if tp:
        col = ("col", 2 * d_in + 2 * g * n + h, npar.blocks.get("in_proj"))
        p, (d_in, h, g) = _rank_layer(p, cfg, npar)
        x = npar.col_input(x)       # the whole sequence under ``seq``
        s = x.shape[1]
    zxbcdt = project(p["in_proj"], x, cfg, tp=col)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n,
                                      zxbcdt.shape[-1] - 2 * d_in
                                      - 2 * g * n], dim=-1)
    if tp:      # dt is whole on every rank: this rank's heads
        dt = dt.narrow(-1, npar.mesh.coords["model"] * h, h)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])

    if state is None or s > 1:
        conv_in = None if state is None else state["conv"]
        h0 = None if state is None else state["h"].float()
        xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                       state=conv_in)
        xh = xbc[..., :d_in].reshape(b, s, h, cfg.ssm_head_dim)
        bmat = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
        cmat = xbc[..., d_in + g * n:].reshape(b, s, g, n)
        pad = (-s) % cfg.ssm_chunk
        xh_p, dtp, bm_p, cm_p = xh, dt, bmat, cmat
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            bm_p = F.pad(bmat, (0, 0, 0, 0, 0, pad))
            cm_p = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        y, h_last = _ssd_chunked(xh_p.float(), dtp, p["a_log"],
                                 bm_p.float(), cm_p.float(), cfg.ssm_chunk,
                                 h0=h0)
        y = y[:, :s]
        new_state = None
        if conv_state is not None:
            new_state = {"h": h_last, "conv": conv_state}
    else:
        # decode: the recurrent step
        xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                       state=state["conv"])
        xh = xbc[..., :d_in].reshape(b, 1, h, cfg.ssm_head_dim)
        bmat = xbc[..., d_in:d_in + g * n].reshape(b, 1, g, n)
        cmat = xbc[..., d_in + g * n:].reshape(b, 1, g, n)
        rep = h // g
        bh = bmat[:, 0].repeat_interleave(rep, dim=1).float()
        ch = cmat[:, 0].repeat_interleave(rep, dim=1).float()
        lam = torch.exp(-torch.exp(p["a_log"])[None, :] * dt[:, 0])  # (B,H)
        hx = state["h"] * lam[..., None, None] + torch.einsum(
            "bh,bhd,bhp->bhdp", dt[:, 0], bh, xh[:, 0].float())
        y = torch.einsum("bhd,bhdp->bhp", ch, hx)[:, None]
        new_state = {"h": hx, "conv": conv_state}

    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_in).to(x.dtype) * F.silu(z)
    if not tp:
        y = rmsnorm(p["norm"], y, cfg.norm_eps)
        return project(p["out_proj"], y, cfg), new_state
    y = shardctx.gather(y, npar.mesh, npar.tp, y.ndim - 1, "slice")
    npar.counts["norm_gather_bytes"] += y.numel() * y.element_size()
    y = shardctx.split_to(rmsnorm(p["norm"], y, cfg.norm_eps), npar.mesh,
                          npar.tp, y.ndim - 1)
    return project(p["out_proj"], y, cfg, tp=("row", cfg.d_model)), \
        new_state


def make_ssm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """An SSD layer's zero state for ``batch`` rows; under a serving
    context (``launch.sharding.ServeParallel``, ``model`` > 1) this
    rank's block of it: ``h`` its heads, the conv state the channels its
    conv reads (its heads' x channels, and B and C: its groups', or whole
    where the groups do not divide over ``model``)."""
    d_in, h, n, g = _dims(cfg)
    npar = shardctx.numeric_context()
    if npar is not None and npar.serve and npar.m > 1:
        m = npar.m
        d_in, h = d_in // m, h // m
        g = g // m if g % m == 0 else g
    conv_dim = d_in + 2 * g * n
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, h, n, cfg.ssm_head_dim), **f32),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), **f32)}
