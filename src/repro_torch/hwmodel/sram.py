"""Digital SRAM (CMOS-only) accelerator core model (paper §IV.H).

The port's copy of ``repro.hwmodel.sram``: plain Python, equal to the
reference value for value (``tests/test_torch_hwmodel.py``).

64 generated 128 kb SRAM macros form the 1 MB weight store; 256 parallel
8-bit MACs; transpose reads cost 8x (row-major layout, §IV.H).
"""
from __future__ import annotations

from typing import Dict

from .params import SYNTH, UM, TABLE_I, TableI

N_BANKS = 64
TRANSPOSE_PENALTY = 8


def _total_bits(p: TableI) -> int:
    return p.rows * p.cols * 8


def total_area(bits: int, p: TableI = TABLE_I) -> float:
    sram = N_BANKS * p.sram_bank_area
    return sram + SYNTH["mac_area_um2"][bits] * UM ** 2 \
        + SYNTH["input_buffer_area_um2"][bits] * UM ** 2


def read_time(p: TableI = TABLE_I) -> float:
    accesses = _total_bits(p) / (N_BANKS * p.sram_access_bits)
    return accesses * p.sram_access_t


def transpose_read_time(p: TableI = TABLE_I) -> float:
    return TRANSPOSE_PENALTY * read_time(p)


def write_time(p: TableI = TABLE_I) -> float:
    return read_time(p)


def kernel_latency(p: TableI = TABLE_I) -> Dict[str, float]:
    """Reads pipeline with the MACs; OPU = read + write-back."""
    return {"vmm": read_time(p), "mvm": transpose_read_time(p),
            "opu": read_time(p) + write_time(p)}


def total_latency(p: TableI = TABLE_I) -> float:
    k = kernel_latency(p)
    return k["vmm"] + k["mvm"] + k["opu"]


def read_energy(p: TableI = TABLE_I) -> float:
    return _total_bits(p) * p.sram_read_e_per_bit


def transpose_read_energy(p: TableI = TABLE_I) -> float:
    return TRANSPOSE_PENALTY * read_energy(p)


def write_energy(p: TableI = TABLE_I) -> float:
    return _total_bits(p) * p.sram_write_e_per_bit


def mac_energy_total(bits: int, p: TableI = TABLE_I) -> float:
    return p.rows * p.cols * SYNTH["mac_e_pj_per_op"][bits] * 1e-12


def cross_core_energy(bits: int, p: TableI = TABLE_I) -> float:
    edge_um = (total_area(bits, p) / UM ** 2) ** 0.5
    c_edge = p.wire_cap_per_um * edge_um
    return _total_bits(p) * c_edge * p.logic_v ** 2


def kernel_energy(bits: int, p: TableI = TABLE_I) -> Dict[str, float]:
    vmm = read_energy(p) + mac_energy_total(bits, p) \
        + cross_core_energy(bits, p)
    mvm = transpose_read_energy(p) + mac_energy_total(bits, p) \
        + cross_core_energy(bits, p)
    opu = (read_energy(p) + write_energy(p) + mac_energy_total(bits, p)
           + 2 * cross_core_energy(bits, p))
    return {"vmm": vmm, "mvm": mvm, "opu": opu}


def total_energy(bits: int, p: TableI = TABLE_I) -> float:
    k = kernel_energy(bits, p)
    return k["vmm"] + k["mvm"] + k["opu"]
