"""``chip_smoke.read_agrees``, the gate that holds every crossbar read the
card runs against its plain version, at a charge that sums to exactly 0.

The dynamic ADC range is the rms over a tile's non-zero charges, so a
charge that one float32 order sums to 0 and another to a residual moves
the tile's lsb by about 0.2% (256 charges) and every output of that output
tile with it.  The gate takes such a tile's errors against the plain read
recounted at the tie (``tie_recount``).  Here the planted tie is exact in
every order on the plain operands (two equal codes through +e and -e, the
other drives of that token zero), and the "kernel" reads operands where the
-e is one ulp off, so that its count is one higher (or the two swapped,
one lower): that read must pass.
A tile shifted by another factor, with or without a tie, must fail the
share.  All on the CPU, through the plain version.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import CrossbarConfig, TAOX_NONOISE
from repro_torch.kernels import xbar_vmm as K

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CFG = CrossbarConfig(rows=64, cols=64, device=TAOX_NONOISE)
B, KD, N = 4, 128, 128
TOKEN, COL = 0, 5          # the tied charge: token 0, K tile 0, column 5


def _operands(seed=0):
    """x (1, B, K), g/ref (1, K, N), sc (1, 2) with token 0's charge at
    column 5 of K tile 0 exactly 0: only drive rows 0 and 1 of that token
    are non-zero there, with equal codes, through +e and -e."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, B, KD)).astype(np.float32)
    x[0, TOKEN, 2:CFG.rows] = 0.0
    x[0, TOKEN, 1] = x[0, TOKEN, 0]
    g = np.round((0.5 + 0.1 * rng.standard_normal((1, KD, N))) * 2 ** 20) \
        / 2 ** 20
    g[0, 1, COL] = 1.0 - g[0, 0, COL]
    ref = np.full_like(g, 0.5)
    m = np.float32(np.abs(x).max()) / np.float32(CFG.adc.in_levels)
    sc = np.array([[m, 1.0]], np.float32)
    return (torch.from_numpy(x), torch.from_numpy(g.astype(np.float32)),
            torch.from_numpy(ref.astype(np.float32)), torch.from_numpy(sc))


def _agrees(y_k, x, g, ref, sc):
    y_p = chip_smoke.plain_read(K, x, g, ref, sc, CFG, False)
    before = len(chip_smoke.TIE_RECOUNTS)
    out = chip_smoke.read_agrees(y_k, y_p, x, g, ref, sc, CFG)
    return out, chip_smoke.TIE_RECOUNTS[before:]


def test_planted_charge_is_a_tie_in_every_order():
    """The plain charge is exactly 0 and the shifted one is not, so the
    two reads differ in the whole first output tile by over 1%."""
    x, g, ref, sc = _operands()
    d = (g - ref)[0, :CFG.rows, COL].double()
    xi = torch.round(x[0, TOKEN, :CFG.rows] / sc[0, 0]).double()
    assert (xi * d).sum().item() == 0.0 and (xi * d).abs().sum() > 0
    g2 = g.clone()
    g2[0, 1, COL] = torch.nextafter(g[0, 1, COL], torch.tensor(1.0))
    y_p = chip_smoke.plain_read(K, x, g, ref, sc, CFG, False)
    y_k = chip_smoke.plain_read(K, x, g2, ref, sc, CFG, False)
    off = (y_k - y_p).abs() > 1e-5 * y_p.abs().amax()
    assert off[..., :CFG.cols].float().mean() > 0.5
    assert not off[..., CFG.cols:].any()


@pytest.mark.parametrize("kernel_count", ["one_higher", "one_lower"])
def test_read_counted_the_other_way_at_a_tie_passes(kernel_count):
    """The kernel's count one higher at the tie (its charge a residual,
    the plain one 0), or one lower (the operands swapped): the tile's
    errors against the recount leave no element off, every element stays
    within the per-element bound, and the use is recorded."""
    x, g, ref, sc = _operands()
    g2 = g.clone()
    g2[0, 1, COL] = torch.nextafter(g[0, 1, COL], torch.tensor(1.0))
    if kernel_count == "one_lower":
        g, g2 = g2, g
    y_k = chip_smoke.plain_read(K, x, g2, ref, sc, CFG, False)
    (ok, _, over, share), rec = _agrees(y_k, x, g, ref, sc)
    assert ok and over <= 1.0 and share == 0.0
    assert rec == [{"x": [1, B, KD], "tiles_tried": 1, "tiles_recounted": 1,
                    "outputs_recounted": B * CFG.cols,
                    "share_before": rec[0]["share_before"],
                    "share_after": 0.0}]
    assert rec[0]["share_before"] >= 0.01


@pytest.mark.parametrize("case", ["tile_without_tie", "tied_tile_by_0.3%"])
def test_shifted_tile_fails_the_share(case):
    """A tile moved by a factor that no recount gives fails: the second
    output tile scaled by 1 + 2^-9 (it has no tie), or the tied K tile's
    conductance differences scaled by 1.003 (its lsb moves by 0.3%, not
    by the tie's 0.2%)."""
    x, g, ref, sc = _operands()
    y_p = chip_smoke.plain_read(K, x, g, ref, sc, CFG, False)
    if case == "tile_without_tie":
        y_k = y_p.clone()
        y_k[..., CFG.cols:] *= 1.0 + 2.0 ** -9
    else:
        g2 = g.clone()
        d = g2[0, :CFG.rows, :CFG.cols] - 0.5
        g2[0, :CFG.rows, :CFG.cols] = 0.5 + d * 1.003
        y_k = chip_smoke.plain_read(K, x, g2, ref, sc, CFG, False)
    (ok, _, over, share), rec = _agrees(y_k, x, g, ref, sc)
    assert over <= 1.0, "the shift stays within the per-element bound"
    assert not ok and share >= 0.01
    assert rec[0]["tiles_recounted"] == 0
