"""Digital (binary) ReRAM accelerator core model (paper §IV.G).

The port's copy of ``repro.hwmodel.digital_reram``: plain Python, equal to the
reference value for value (``tests/test_torch_hwmodel.py``).

8 x 1024x1024 binary arrays hold the 1 MB of 8-bit weights.  Parallelism is
electromigration-limited (~27 µA per line): 32 bits written / 256 bits read
in parallel per array; all 8 arrays operate concurrently.
"""
from __future__ import annotations

from typing import Dict

from .params import SYNTH, UM, TABLE_I, TableI


def _bits_per_array(p: TableI) -> int:
    return p.rows * p.cols


def array_area(p: TableI = TABLE_I) -> float:
    """Per paper: sense amps + drivers ≈ 9,500 µm² per array dominate (the
    ReRAM array itself stacks above them): 8 arrays -> 76,000 µm²."""
    sense_amps = 256 * 60 * p.logic_area          # 60 logic T per sense amp
    drivers = (24 * p.hv_area * p.cols            # 24 HV transistors / col
               + 200 * UM ** 2)                   # decoders (synthesized)
    per_array = max(sense_amps + drivers, p.rows * p.cols * p.m1_pitch ** 2)
    return 8 * per_array


def mac_area(bits: int) -> float:
    return SYNTH["mac_area_um2"][bits] * UM ** 2


def input_buffer_area(bits: int) -> float:
    return SYNTH["input_buffer_area_um2"][bits] * UM ** 2


def total_area(bits: int, p: TableI = TABLE_I) -> float:
    return array_area(p) + mac_area(bits) + input_buffer_area(bits)


# --------------------------------------------------------------------------
# Latency: full-matrix read / write, 8 arrays in parallel.
# --------------------------------------------------------------------------

def read_time(p: TableI = TABLE_I) -> float:
    reads = _bits_per_array(p) / p.binary_read_par
    return reads * p.binary_read_t


def write_time(p: TableI = TABLE_I) -> float:
    writes = _bits_per_array(p) / p.binary_write_par
    return writes * p.binary_write_t


def mac_time(p: TableI = TABLE_I) -> float:
    ops = p.rows * p.cols
    return ops / p.mac_units * 1e-9  # 1 GHz, pipelined


def kernel_latency(p: TableI = TABLE_I) -> Dict[str, float]:
    """Reads are pipelined with the MACs; the OPU must read the full array,
    compute, then write it back."""
    return {"vmm": read_time(p), "mvm": read_time(p),
            "opu": read_time(p) + write_time(p)}


def total_latency(p: TableI = TABLE_I) -> float:
    k = kernel_latency(p)
    return k["vmm"] + k["mvm"] + k["opu"]


# --------------------------------------------------------------------------
# Energy
# --------------------------------------------------------------------------

def read_energy(p: TableI = TABLE_I) -> float:
    """CV² of charging a column once per bit + sense amps (8 M bits)."""
    bits = 8 * _bits_per_array(p)
    cv2 = 0.5 * bits * p.c_line * p.binary_read_v ** 2
    sense = bits * p.sense_amp_e
    return cv2 + sense


def write_energy(p: TableI = TABLE_I) -> float:
    bits = 8 * _bits_per_array(p)
    cv2 = 0.5 * bits * p.c_line * p.binary_write_v ** 2
    # half the bits flip on average and drive write current for 10 ns
    iv = 0.5 * bits * p.binary_write_i * p.binary_write_v * p.binary_write_t
    return cv2 + iv


def mac_energy_total(bits: int, p: TableI = TABLE_I) -> float:
    ops = p.rows * p.cols
    return ops * SYNTH["mac_e_pj_per_op"][bits] * 1e-12


def cross_core_energy(bits: int, p: TableI = TABLE_I) -> float:
    """Every stored bit moves a core-edge length (§IV.K)."""
    edge_um = (total_area(bits, p) / UM ** 2) ** 0.5
    c_edge = p.wire_cap_per_um * edge_um
    n_bits = p.rows * p.cols * 8
    return n_bits * c_edge * p.logic_v ** 2


def kernel_energy(bits: int, p: TableI = TABLE_I) -> Dict[str, float]:
    read = read_energy(p) + mac_energy_total(bits, p) \
        + cross_core_energy(bits, p)
    opu = (read_energy(p) + write_energy(p) + mac_energy_total(bits, p)
           + 2 * cross_core_energy(bits, p))
    return {"vmm": read, "mvm": read, "opu": opu}


def total_energy(bits: int, p: TableI = TABLE_I) -> float:
    k = kernel_energy(bits, p)
    return k["vmm"] + k["mvm"] + k["opu"]
