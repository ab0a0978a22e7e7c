"""Comparative analysis across the three core designs (Tables II-V, §IV.L).

The port's copy of ``repro.hwmodel.compare``: plain Python, equal to the
reference value for value (``tests/test_torch_hwmodel.py``).

``tables()`` returns every paper table as a nested dict; ``headline()``
returns the §VII claims (310x/270x energy, 34x/1040x latency, 11x/1.8x
area, ~11 fJ/MAC) computed from the model.
"""
from __future__ import annotations

from typing import Dict

from . import analog, digital_reram, sram
from .params import NJ, NS, UM, TABLE_I

BITS = (8, 4, 2)


def table_area() -> Dict:
    """Table II (µm²)."""
    out = {}
    for b in BITS:
        a = {k: v / UM ** 2 for k, v in analog.area_breakdown(b).items()}
        out[b] = {
            **{f"analog/{k}": v for k, v in a.items()},
            "digital/reram_1mb": digital_reram.array_area() / UM ** 2,
            "digital/sram_1mb": sram.N_BANKS * TABLE_I.sram_bank_area
            / UM ** 2,
            "digital/mac_256": digital_reram.mac_area(b) / UM ** 2,
            "digital/input_buffers":
                digital_reram.input_buffer_area(b) / UM ** 2,
            "total/analog": analog.total_area(b) / UM ** 2,
            "total/digital_reram": digital_reram.total_area(b) / UM ** 2,
            "total/sram": sram.total_area(b) / UM ** 2,
        }
    return out


def table_latency() -> Dict:
    """Table III (ns)."""
    out = {}
    for b in BITS:
        out[b] = {
            "analog/array_rise": analog.array_rise_time() / NS,
            "analog/read_temporal": analog.read_temporal_time(b) / NS,
            "analog/read_adc": analog.read_adc_time(b) / NS,
            "analog/write_temporal_x4": analog.write_time(b) / NS,
            "digital/sram_read": sram.read_time() / NS,
            "digital/sram_read_transpose": sram.transpose_read_time() / NS,
            "digital/sram_write": sram.write_time() / NS,
            "digital/reram_read": digital_reram.read_time() / NS,
            "digital/reram_write": digital_reram.write_time() / NS,
            "digital/mac_1m": digital_reram.mac_time() / NS,
            "total/analog": analog.total_latency(b) / NS,
            "total/digital_reram": digital_reram.total_latency() / NS,
            "total/sram": sram.total_latency() / NS,
        }
    return out


def table_energy() -> Dict:
    """Table IV (nJ)."""
    out = {}
    for b in BITS:
        e = {k: v / NJ for k, v in analog.energy_breakdown(b).items()}
        out[b] = {
            **{f"analog/{k}": v for k, v in e.items()},
            "digital/sram_read": sram.read_energy() / NJ,
            "digital/sram_read_transpose": sram.transpose_read_energy()
            / NJ,
            "digital/sram_write": sram.write_energy() / NJ,
            "digital/reram_read": digital_reram.read_energy() / NJ,
            "digital/reram_write": digital_reram.write_energy() / NJ,
            "digital/mac_1m": digital_reram.mac_energy_total(b) / NJ,
            "digital/reram_cross_core":
                digital_reram.cross_core_energy(b) / NJ,
            "digital/sram_cross_core": sram.cross_core_energy(b) / NJ,
            "analog/cross_core": analog.cross_core_energy(b) / NJ,
            "total/analog": analog.total_energy(b) / NJ,
            "total/digital_reram": digital_reram.total_energy(b) / NJ,
            "total/sram": sram.total_energy(b) / NJ,
        }
    return out


def table_kernels() -> Dict:
    """Table V: per-kernel energy (nJ) and latency (µs), 8-bit cores."""
    out = {}
    for name, mod_e, mod_l in (
        ("analog", analog.kernel_energy(8), analog.kernel_latency(8)),
        ("digital_reram", digital_reram.kernel_energy(8),
         digital_reram.kernel_latency()),
        ("sram", sram.kernel_energy(8), sram.kernel_latency()),
    ):
        for k in ("vmm", "mvm", "opu"):
            out[f"{name}/{k}/energy_nj"] = mod_e[k] / NJ
            out[f"{name}/{k}/latency_us"] = mod_l[k] / (1e3 * NS)
    return out


def headline() -> Dict[str, float]:
    """§IV.L / §VII comparative claims at 8-bit I/O."""
    e_a, e_r, e_s = (analog.total_energy(8), digital_reram.total_energy(8),
                     sram.total_energy(8))
    l_a, l_r, l_s = (analog.total_latency(8), digital_reram.total_latency(),
                     sram.total_latency())
    a_a, a_r, a_s = (analog.total_area(8), digital_reram.total_area(8),
                     sram.total_area(8))
    return {
        "energy_vs_digital_reram": e_r / e_a,     # paper: 270x
        "energy_vs_sram": e_s / e_a,              # paper: 310x
        "latency_vs_digital_reram": l_r / l_a,    # paper: 1040x
        "latency_vs_sram": l_s / l_a,             # paper: 34x
        "area_vs_digital_reram": a_r / a_a,       # paper: 1.8x
        "area_vs_sram": a_s / a_a,                # paper: 11x
        "analog_fj_per_mac": analog.mac_energy(8) / 1e-15,  # paper: ~11 fJ
    }


def tables() -> Dict[str, Dict]:
    """Tables II-V together: ``{"area", "latency", "energy",
    "kernels"}``, each the function of the same name above."""
    return {"area": table_area(), "latency": table_latency(),
            "energy": table_energy(), "kernels": table_kernels()}
