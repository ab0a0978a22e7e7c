"""Fixture tests for the port's static auditor (``repro_torch.analysis``),
mirroring ``tests/test_static_audit.py`` rule by rule.

Each rule of the catalog is demonstrated by a deliberately broken fixture
that must trip exactly that rule, and a legal case that stays quiet; the
allowlist round-trips (justified comments suppress, silent or mismatched
ones do not); and the repo itself audits clean: the AST layer, the
kernel layer's CPU half and the trace layer with the sharded step on a
2x2 mesh of gloo CPU ranks (the same invariant as ``python -m
repro_torch.analysis --all``).  The kernel layer's card half (RA201,
RA202) runs on the card in ``chip_smoke.py`` phase 25(b); its machinery
is held here to fake launches that write through the same allocation
hook.
"""
import os
import textwrap

import torch
import torch.distributed as dist

from repro_torch.analysis.ast_rules import audit_ast
from repro_torch.configs.registry import ARCHS
from repro_torch.analysis.findings import (NO_COUNTERPART, RULES, Allowlist,
                                           Finding, repo_root)
from repro_torch.analysis import kernel_lint as KL
from repro_torch.analysis import trace_lint as TLI
from repro_torch.kernels import outputs
from repro_torch.launch.trace_analysis import Collective, Trace, tracing


def _rules_hit(findings, rule):
    return [f for f in findings if f.rule == rule]


# --------------------------------------------------------------------------
# Layer 2 fixtures: kernel launch safety
# --------------------------------------------------------------------------

def _launch(write):
    """A fake kernel launch: an output of 4 x 8 float32 allocated through
    the wrappers' hook, then ``write(out)``."""
    def launch():
        out = outputs.empty((4, 8), torch.float32, "cpu")
        write(out)
        return out
    return launch


def test_ra201_unwritten_output_elements():
    findings, row = KL.coverage_check(
        "fixture", _launch(lambda o: o[:3].fill_(1.0)), guard=16)
    hits = _rules_hit(findings, "RA201")
    assert hits and "never written" in hits[0].message
    assert row["unwritten"] == 8


def test_ra201_launches_not_bit_equal():
    gen = torch.Generator().manual_seed(0)
    findings, _ = KL.coverage_check(
        "fixture", _launch(lambda o: o.copy_(torch.rand(o.shape,
                                                        generator=gen))),
        guard=16)
    hits = _rules_hit(findings, "RA201")
    assert hits and "not bit-equal" in hits[0].message


def test_ra201_no_output_through_the_hook():
    findings, _ = KL.coverage_check("fixture", lambda: torch.zeros(3),
                                    guard=16)
    hits = _rules_hit(findings, "RA201")
    assert hits and "did not reach its kernel" in hits[0].message


def test_ra202_write_outside_the_output():
    def past_the_end(o):
        o.fill_(2.0)
        # one element before the output: its storage's guard region
        torch.as_strided(o, (1,), (1,), o.storage_offset() - 1).fill_(0.0)
    findings, row = KL.coverage_check("fixture", _launch(past_the_end),
                                      guard=16)
    assert _rules_hit(findings, "RA202") and row["guard_touched"] == 1
    assert not _rules_hit(findings, "RA201")


def test_ra201_ra202_legal_launch_passes():
    findings, row = KL.coverage_check(
        "fixture", _launch(lambda o: o.copy_(torch.arange(32.).view(4, 8))),
        guard=16)
    assert findings == [] and row["bit_equal"] and row["outputs"] == 1


def test_ra203_shape_not_divisible_by_block():
    hits = _rules_hit(KL.check_divisible("fixture", "out", (10,), (4,)),
                      "RA203")
    assert hits and "not divisible" in hits[0].message
    hits = _rules_hit(KL.check_divisible("fixture", "out", (16,), (4,),
                                         cover=(10,)), "RA203")
    assert hits and "does not cover" in hits[0].message
    assert KL.check_divisible("fixture", "out", (12,), (4,), (10,)) == []


def test_ra204_duplicate_seed_base():
    dup = [("layers/attn/wqkv", (2, 2, 2), 0x1234),
           ("layers/ffn/w_down", (2, 2, 2), 0x1234)]
    hits = _rules_hit(KL.check_seed_uniqueness(dup), "RA204")
    assert hits and "same base seed" in hits[0].message


def test_ra204_unique_seed_grid_passes():
    ok = [("layers/attn/wqkv", (4, 8, 8), 0x1234),
          ("layers/ffn/w_down", (4, 8, 8), 0x5678)]
    assert KL.check_seed_uniqueness(ok) == []


def test_ra204_numpy_twin_against_a_wrong_hash():
    from repro_torch.kernels.xbar_update import _tile_seed
    assert KL.numpy_twin_matches() is None
    hit = KL.numpy_twin_matches(
        lambda s, lyr, k, n: int(_tile_seed(s, lyr, n, k)))
    assert hit is not None and hit.rule == "RA204"
    assert "diverges" in hit.message


def test_ra204_seed_grid_of_every_config():
    """Every config's containers reach the check (the SSM stack has two:
    ``in_proj`` and ``out_proj``)."""
    entries = KL.config_seed_entries()
    assert set(entries) == set(ARCHS)
    assert all(len(v) >= 2 for v in entries.values())
    assert len(entries["lm100m"]) == 4


# --------------------------------------------------------------------------
# Layer 1 fixtures: contracts of the traced step
# --------------------------------------------------------------------------

def test_ra101_f64_leak():
    with tracing() as trace:
        torch.ones(4).double().sum()
    hits = _rules_hit(TLI.check_no_f64(trace, "fixture"), "RA101")
    assert hits and "float64" in hits[0].message
    assert hits[0].file == "tests/test_torch_static_audit.py"
    with tracing() as clean:
        torch.ones(4) * 2
    assert TLI.check_no_f64(clean, "fixture") == []


def test_ra102_tape_in_grad_tree():
    diff = {"layers": {"attn": {"wqkv": {"x_tape": 1, "d_tape": 2,
                                         "g": 3}}}}
    frozen = {"layers": {"attn": {"wqkv": {"g": 3, "ref": 4,
                                           "w_scale": 5}}}}
    hits = _rules_hit(TLI.check_tape_containment(diff, frozen, "fx"),
                      "RA102")
    assert hits and "['g']" in hits[0].message
    hits = _rules_hit(TLI.check_tape_containment(
        {"wqkv": {"x_tape": 1, "d_tape": 2}}, {"wqkv": {"g": 3}}, "fx"),
        "RA102")
    assert hits and "missing" in hits[0].message
    assert TLI.check_tape_containment(
        {"wqkv": {"x_tape": 1, "d_tape": 2, "x_tape_scale": 6,
                  "d_tape_scale": 7}},
        {"wqkv": {"g": 3, "ref": 4, "w_scale": 5}}, "fx") == []


def test_ra102_conductance_in_autograd():
    g = torch.ones(2, 2, requires_grad=True)
    frozen = {"wqkv": {"g": g, "ref": torch.ones(2, 2),
                       "w_scale": torch.ones(())}}
    hits = _rules_hit(TLI.check_conductance_grads(frozen, "fx"), "RA102")
    assert hits and "wqkv/g" in hits[0].message
    frozen["wqkv"]["g"] = torch.ones(2, 2)
    assert TLI.check_conductance_grads(frozen, "fx") == []


def test_ra103_collective_anchors_at_its_caller():
    """A recorded collective is a finding at the first frame outside the
    transport; this fixture's call carries no justification, so the
    repo allowlist must not suppress it."""
    with tracing(dry=True, group_size=2) as trace:
        q = torch.ones(8)
        dist.all_gather_into_tensor(torch.empty(16), q)
    hits = _rules_hit(TLI.check_collectives(trace, "fx"), "RA103")
    assert hits and "all_gather_into_tensor" in hits[0].message
    assert hits[0].file == "tests/test_torch_static_audit.py"
    active, suppressed = Allowlist().split(hits)
    assert active and not suppressed


def test_ra103_bare_conductance_gather_is_a_finding():
    """The gather read's ``launch.sharding.unshard`` of a container block
    reaches the ordered combine too; the combine is transport, so the
    finding lands on ``unshard`` (no justification there), while the
    shard-local read's combine is allowlisted at its call."""
    src = os.path.join(repo_root(), "src", "repro_torch")
    stack = ((os.path.join(src, "launch", "mesh.py"), 77, "gather_blocks"),
             (os.path.join(src, "core", "shardctx.py"), 160,
              "combine_partials_exact"),
             (os.path.join(src, "launch", "sharding.py"), 310, "unshard"))
    trace = Trace(collectives=[Collective("all_gather_into_tensor", 4096, 2,
                                          stack)])
    hits = TLI.check_collectives(trace, "fx")
    assert hits[0].file == "src/repro_torch/launch/sharding.py"
    active, _ = Allowlist().split(hits)
    assert active


def test_ra103_gathered_accounting():
    trace = Trace(collectives=[Collective("all_gather_into_tensor", 100, 4,
                                          ())])
    assert TLI.check_gathered(trace, {"gathers": 1, "bytes": 300}, "fx") \
        == []
    hits = TLI.check_gathered(trace, {"gathers": 2, "bytes": 300}, "fx")
    assert _rules_hit(hits, "RA103") and "disagree" in hits[0].message


def test_ra105_op_budget():
    with tracing() as trace:
        torch.ones(4) * 2 + 1
    hits = _rules_hit(TLI.check_op_budget(trace, "fx", max_ops=1), "RA105")
    assert hits and "budget" in hits[0].message
    assert TLI.check_op_budget(trace, "fx") == []


def test_ra107_parameter_sized_collective():
    big = Trace(collectives=[Collective("all_gather_into_tensor",
                                        64 * 256 * 4, 2, ())])
    hits = _rules_hit(TLI.check_parameter_sized_collectives(
        big, 65536, "fx"), "RA107")
    assert hits and "parameter-sized" in hits[0].message
    small = Trace(collectives=[Collective("all_gather_into_tensor",
                                          4 * 256 * 4, 2, ())])
    assert TLI.check_parameter_sized_collectives(small, 65536, "fx") == []


# --------------------------------------------------------------------------
# Layer 3 fixtures: AST and CUDA-source rules
# --------------------------------------------------------------------------

def _audit_source(tmp_path, source, rel="src/repro_torch/train/bad.py"):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return audit_ast(root=str(tmp_path), files=[str(path)])


def test_ra301_global_numerics(tmp_path):
    findings = _audit_source(tmp_path, """
        import torch
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        torch.set_default_dtype(torch.float64)
        torch.use_deterministic_algorithms(True)
        prev = torch.backends.cuda.matmul.allow_tf32   # reading is fine
    """, rel="src/repro_torch/core/bad.py")
    assert len(_rules_hit(findings, "RA301")) == 4


def test_ra302_library_rng_in_device_code(tmp_path):
    findings = _audit_source(tmp_path, """
        #include <curand_kernel.h>
        // curand_init(0, 0, 0, &s) in a comment draws nothing
        __device__ float draw(unsigned seed) {
            curandState s;
            curand_init(seed, 0, 0, &s);
            return curand_normal(&s);
        }
        __global__ void update_kernel(float* g) {
            g[threadIdx.x] += rand() * 1e-9f;
        }
        void host_setup() { srand(rand()); }
    """, rel="src/repro_torch/kernels/csrc/bad.cu")
    hits = _rules_hit(findings, "RA302")
    assert {h.line for h in hits} == {6, 7, 10}


def test_ra303_container_op_in_loop(tmp_path):
    findings = _audit_source(tmp_path, """
        def forward(params, x, cfg):
            for layer in params:
                x = xbar_fused_read(x, layer["g"], layer["ref"], 1.0, cfg)
            return x
        y = [xbar_fused_read(x, g, r, 1.0, cfg) for g, r in pairs]
    """, rel="src/repro_torch/models/bad.py")
    hits = _rules_hit(findings, "RA303")
    assert len(hits) == 1 and "xbar_fused_read" in hits[0].message


def test_no_counterpart_rules_raised_where_their_premise_breaks(tmp_path):
    findings = _audit_source(tmp_path, """
        import torch
        import torch.distributed._functional_collectives as funcol
        step = torch.compile(lambda s: s)
        g = torch.cuda.CUDAGraph()
        traced = torch.jit.trace(lambda x: x, (torch.ones(1),))
    """)
    assert len(_rules_hit(findings, "RA304")) == 2
    assert len(_rules_hit(findings, "RA104")) == 1
    assert len(_rules_hit(findings, "RA106")) == 1
    quiet = _audit_source(tmp_path, """
        import torch
        y = torch.ones(3) @ torch.ones(3)
    """, rel="src/repro_torch/core/fine.py")
    assert quiet == []


# --------------------------------------------------------------------------
# Allowlist round-trip
# --------------------------------------------------------------------------

def test_allowlist_round_trip(tmp_path):
    src = """
        def forward(params, x, cfg):
            for layer in params:
                # audit: allow RA303 -- fixture: bounded 2-cell loop
                x = xbar_fused_read(x, layer, cfg)
            return x
    """
    findings = _audit_source(tmp_path, src, rel="src/repro_torch/models/ok.py")
    active, suppressed = Allowlist(root=str(tmp_path)).split(findings)
    assert _rules_hit(active, "RA303") == []
    assert any(f.rule == "RA303" and "bounded 2-cell" in why
               for f, why in suppressed)


def test_allowlist_rejects_silent_and_mismatched(tmp_path):
    src = """
        def forward(params, x, cfg):
            for layer in params:
                # audit: allow RA303
                x = xbar_fused_read(x, layer, cfg)
            for layer in params:
                y = fakequant_read(x, layer, cfg)  # audit: allow RA301 -- wrong rule
            return y
    """
    findings = _audit_source(tmp_path, src,
                             rel="src/repro_torch/models/bad.py")
    active, suppressed = Allowlist(root=str(tmp_path)).split(findings)
    assert len(_rules_hit(active, "RA303")) == 2
    assert suppressed == []


def test_unanchored_findings_are_never_suppressible():
    f = Finding("RA101", "f64 deep inside torch", entry="train_step")
    active, suppressed = Allowlist().split([f])
    assert active == [f] and suppressed == []


# --------------------------------------------------------------------------
# Catalog + CLI + repo-clean
# --------------------------------------------------------------------------

def test_rule_catalog_is_stable():
    assert set(RULES) == {
        "RA101", "RA102", "RA103", "RA104", "RA105", "RA106", "RA107",
        "RA201", "RA202", "RA203", "RA204",
        "RA301", "RA302", "RA303", "RA304",
    }
    assert set(NO_COUNTERPART) == {"RA104", "RA106", "RA304"}
    assert all("no counterpart" in RULES[r] for r in NO_COUNTERPART)


def test_cli_list_rules(capsys):
    from repro_torch.analysis.cli import main
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "RA201" in out and "RA304" in out and "no counterpart" in out


def test_cli_ast_layer_exits_zero(capsys):
    from repro_torch.analysis.cli import main
    assert main(["--ast"]) == 0
    assert "static audit: clean" in capsys.readouterr().out


def test_repo_ast_layer_is_clean():
    active, suppressed = Allowlist().split(audit_ast())
    assert active == [], "\n".join(str(f) for f in active)
    # the port's justified exceptions, each at its line
    assert {(f.rule, f.file) for f, _ in suppressed} == {
        ("RA301", "src/repro_torch/models/moe.py"),
        ("RA303", "src/repro_torch/core/periodic_carry.py")}


def test_repo_kernel_layer_is_clean():
    active, _ = Allowlist().split(KL.audit_kernels())
    assert active == [], "\n".join(str(f) for f in active)


def test_repo_trace_layer_is_clean_on_a_2x2_gloo_mesh():
    summary = {}
    findings = TLI.audit_trace(summary=summary)
    active, suppressed = Allowlist().split(findings)
    assert active == [], "\n".join(str(f) for f in active)
    assert {(f.rule, f.file) for f, _ in suppressed} == {
        ("RA103", "src/repro_torch/kernels/xbar_vmm.py"),
        ("RA103", "src/repro_torch/train/analog_lm.py")}
    assert sorted(summary) == [0, 1, 2, 3]
    for s in summary.values():
        assert 0 < s["max_payload_bytes"] < s["min_block_bytes"]
        assert s["ops"] <= TLI.MAX_STEP_OPS
