"""The port's dry run (``repro_torch.launch.dryrun``) and what it stands
on: the shape grid and ``ASSIGNED`` against the reference's, the
``meta``-device specs (``models.model.input_specs`` / ``cache_specs``,
``train.train_loop.abstract_state``) leaf for leaf against the
reference's ``jax.eval_shape`` structs at full size, ``launch.
trace_analysis`` on hand-built programs with exact FLOPs and bytes, a
smoke train cell inside the reference's FLOP window and a full-size
decode cell's argument bytes.  Nothing is allocated at full size.
"""
import functools

import jax
import pytest
import torch

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.train import train_loop as JTL
from repro.train.optimizer import adamw as j_adamw
from repro_torch.configs import (ASSIGNED, SHAPE_BY_NAME, SHAPES,
                                 applicable_shapes, get_config)
from repro_torch.launch import dryrun as DR
from repro_torch.launch.trace_analysis import tracing
from repro_torch.models import model as M
from repro_torch.train import train_loop as TL
from repro_torch.train.optimizer import adamw

CELLS = [(a, s.name) for a in ASSIGNED
         for s in applicable_shapes(get_config(a))]


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_leaves(tree):
    out = {}
    for path, leaf in M._leaves(tree):
        assert leaf.device.type == "meta"
        out["/".join(map(str, path))] = (tuple(leaf.shape),
                                         str(leaf.dtype).split(".")[-1])
    return out


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    """The reference's abstract train state, traced once per arch."""
    return _jax_leaves(JTL.abstract_state(j_get_config(arch),
                                          j_adamw(3e-4)))


def test_shape_grid_and_assigned_match_reference():
    assert [tuple(vars(s).values()) for s in SHAPES] == \
        [tuple(vars(s).values()) for s in J_SHAPES]
    assert ASSIGNED == list(J_ASSIGNED)
    for arch in ASSIGNED:
        assert [s.name for s in applicable_shapes(get_config(arch))] == \
            [s.name for s in j_applicable(j_get_config(arch))]
    # 10 archs x 3 shapes + the 2 sub-quadratic archs' long_500k
    assert len(CELLS) == 32
    assert {a for a, s in CELLS if s == "long_500k"} == {"zamba2-1.2b",
                                                         "mamba2-1.3b"}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_and_cache_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for shape in applicable_shapes(cfg):
        jshape = next(s for s in J_SHAPES if s.name == shape.name)
        assert _port_leaves(M.input_specs(cfg, shape)) == \
            _jax_leaves(JM.input_specs(jcfg, jshape)), shape.name
        assert _port_leaves(M.cache_specs(
            cfg, shape.global_batch, shape.seq_len)) == _jax_leaves(
                JM.cache_specs(jcfg, shape.global_batch, shape.seq_len)), \
            shape.name


@pytest.mark.parametrize("arch", ASSIGNED)
def test_abstract_state_matches_reference(arch):
    got = _port_leaves(TL.abstract_state(get_config(arch), adamw(3e-4)))
    assert got == _ref_state(arch)


def test_trace_counts_exact_flops_and_bytes():
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    x = torch.randn(3, 8, 16)
    with tracing() as tr:
        c = a @ b                   # 2*8*16*32 flops; (128+512+256)*4 B
        d = c.t()                   # a view: nothing
        e = d + 1                   # 256*4 in, 256*4 out
        f = torch.bmm(x, b.expand(3, 16, 32))   # expanded b: its storage
        del c, d
    assert tr.flops == 2 * 8 * 16 * 32 + 2 * 3 * 8 * 16 * 32
    assert tr.traffic_bytes == (128 + 512 + 256) * 4 + 2 * 256 * 4 \
        + (384 + 512 + 768) * 4
    assert tr.ops["aten.t"] == 1 and tr.n_ops == 5
    # c (1024 B) freed with d; e and f live: the peak while all three
    assert tr.peak_bytes == 1024 + 1024 + 3072
    assert tr.live_bytes == 1024 + 3072
    assert e.shape == (32, 8) and f.shape == (3, 8, 32)


def test_trace_in_place_ops_and_meta_tensors():
    with tracing() as tr:
        y = torch.zeros(1000, device="meta")
        y.add_(1.0)                  # in place: no new storage
        z = torch.bincount(torch.zeros(50, dtype=torch.long,
                                       device="meta"), minlength=7)
    assert tr.peak_bytes == 4000 + 50 * 8 + 7 * 8
    assert tuple(z.shape) == (7,) and tr.flops == 0


def test_trace_records_collectives_dry():
    import torch.distributed as dist
    with tracing(dry=True, group_size=4) as tr:
        g = torch.ones(100)
        dist.all_reduce(g)
        dist.all_gather_into_tensor(torch.empty(400), torch.ones(100))
    assert tr.count_collectives() == {"all_reduce": 1,
                                      "all_gather_into_tensor": 1,
                                      "total": 2}
    assert tr.collective_byte_volume()["total"] == 800
    assert tr.collective_payloads() == [("all_reduce", 400),
                                        ("all_gather_into_tensor", 400)]
    # ring factors: all-reduce 2(n-1)/n, all-gather n-1 operands received
    assert tr.collective_link_bytes() == 400 * 1.5 + 400 * 3


@pytest.mark.parametrize("arch,smoke", [("mamba2-1.3b", True),
                                        ("gemma-2b", False)],
                         ids=["mamba2-smoke", "gemma-2b-full"])
def test_train_cell_flops_within_reference_window(arch, smoke):
    """The reference's 0.9-3.0 x 6 N D window
    (``tests/test_dryrun_artifacts.py``), the work summed over the data
    ranks: each computes its share of the batch.  A smoke attention model
    at 4096 tokens spends 7-13x 6 N D in attention (d_model 64), so the
    smoke cell is the attention-free SSM's (on 16x16 its 8 smoke SSD heads
    do not split over 16 ``model`` ranks, so its layers run replicated
    there); gemma-2b's at full size on the four-card
    layout 4x1 (FSDP alone: on 16x16 its 8 heads do not split over 16
    ``model`` ranks, so its attention runs replicated there)."""
    mesh = "16x16" if smoke else "4x1"
    rec = DR.run_cell(arch, "train_4k", mesh, smoke=smoke)
    assert rec["ok"], rec.get("error")
    m = rec["model"]
    model_flops = 6 * m["params_active"] * m["seq_len"] * m["global_batch"]
    dp = DR.dp_size(DR.make_mesh(mesh))
    ratio = rec["trace"]["flops"] * dp / model_flops
    assert 0.9 < ratio < 3.0, ratio
    # every leaf's gradient is reduced over the data ranks: a leaf split
    # over them by its gather's reduce_scatter (one a use), the others by
    # an all_reduce; the clip norm adds one all_reduce an axis group
    coll = rec["trace"]["collectives"]
    cfg = get_config(arch, smoke=smoke)
    leaves = list(M._leaves(M.init_params(cfg, None, "meta")))
    assert coll["reduce_scatter_tensor"] + coll["all_reduce"] >= len(leaves)
    if not smoke:
        # gemma-2b: four projections a layer and the tied embedding's
        # two uses reduce-scattered; the three norm scales and the norm's
        # one group all-reduced; the rematted layers gathered twice
        n = cfg.n_layers
        assert coll["reduce_scatter_tensor"] == 4 * n + 2
        assert coll["all_reduce"] == 3 + 1
        assert coll["all_gather_into_tensor"] == 2 * 4 * n + 2
        assert rec["mem"]["replicated_by_port_gb"] == 0.0
    assert rec["local_batch"] == 256 // dp


def test_full_size_decode_cell_argument_bytes():
    """gemma-2b's decode_32k cell on the 1-card mesh at full size: the
    argument bytes are the sum of its meta leaves (params, the 128 x
    32768 cache, the tokens), nothing replicated beyond the policy."""
    cfg = get_config("gemma-2b")
    shape = SHAPE_BY_NAME["decode_32k"]
    rec = DR.run_cell("gemma-2b", "decode_32k", "1x1")
    assert rec["ok"], rec.get("error")
    leaves = [M.init_params(cfg, None, "meta"),
              M.cache_specs(cfg, 128, shape.seq_len),
              M.input_specs(cfg, shape)]
    want = sum(t.numel() * t.element_size()
               for tree in leaves for _, t in M._leaves(tree))
    assert rec["argument_bytes"] == want
    assert rec["mem"]["replicated_by_port_gb"] == 0.0
    assert rec["devices"] == 1 and rec["trace"]["flops"] > 0
    assert set(rec) >= {"ok", "devices", "mem", "model", "trace"}


@pytest.mark.parametrize("mesh", ["4x1", "1x4"])
@pytest.mark.parametrize("arch", ["gemma-2b", "starcoder2-3b",
                                  "mamba2-1.3b"])
def test_serving_cells_hold_the_policy_blocks(arch, mesh):
    """The decode_32k cells served under the policy at full size: the
    dense family's (gemma-2b's cache split along the sequence on 1x4,
    starcoder2-3b's too: 2 kv heads) hold nothing beyond it; mamba2's
    only ``in_proj``'s B, C and dt columns and the conv state's B and C
    channels on ``model`` ranks (one group: whole on every rank); the
    sharded step's collectives are recorded."""
    rec = DR.run_cell(arch, "decode_32k", mesh)
    assert rec["ok"], rec.get("error")
    mem = rec["mem"]
    leaves = mem["replicated_by_port_leaves"]
    if arch == "mamba2-1.3b" and mesh == "1x4":
        assert set(leaves) == {"params/layers/ssm/in_proj/w",
                               "cache/0/conv"}
        assert mem["replicated_by_port_gb"] == pytest.approx(
            sum(leaves.values()), rel=1e-12)
    else:
        assert mem["replicated_by_port_gb"] == 0.0 and not leaves
    assert rec["trace"]["collectives"]["total"] > 0


def test_failed_cell_records_its_error():
    rec = DR.run_cell("gemma-2b", "no_such_shape", "1x1")
    assert rec["ok"] is False and "KeyError" in rec["error"]


def _graph_nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        f = stack.pop()
        if f is not None and type(f).__name__ not in seen:
            seen.add(type(f).__name__)
            stack.extend(n for n, _ in f.next_functions)
    return seen


def test_meta_fakequant_read_keeps_the_cards_autograd_structure():
    """On meta tensors (the dry run) the fakequant read runs under
    ``FakequantRead`` as on the card, so a reckoned step saves x and w and
    not the eager expression's intermediates; a CPU tensor still takes
    the eager expression."""
    from repro_torch.core.adc import AdcConfig
    from repro_torch.kernels import ops
    adc = AdcConfig(in_bits=8, out_bits=8)
    xm = torch.empty(8, 96, device="meta", requires_grad=True)
    wm = torch.empty(96, 40, device="meta", requires_grad=True)
    ym = ops.fakequant_project(xm, wm, adc, 32)
    assert ym.shape == (8, 40) and ym.is_meta
    assert "FakequantReadBackward" in _graph_nodes(ym)
    xc = torch.randn(8, 96, requires_grad=True)
    yc = ops.fakequant_project(xc, torch.randn(96, 40), adc, 32)
    assert "FakequantReadBackward" not in _graph_nodes(yc)
