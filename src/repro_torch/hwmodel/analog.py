"""Analog ReRAM neural-core energy/latency/area model (paper §IV, Eqs. 2-4).

The port's copy of ``repro.hwmodel.analog``: plain Python, equal to the
reference value for value (``tests/test_torch_hwmodel.py``).

All quantities per 1024x1024 differential crossbar core, for I/O precision
``bits`` ∈ {8, 4, 2}.  Energies in joules, times in seconds, areas in m².
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .params import NJ, NS, SYNTH, UM, TABLE_I, TableI


def _pulses(bits: int) -> int:
    """Unit pulses in the temporal code: 2^(bits-1) - 1 (sign is polarity)."""
    return 2 ** (bits - 1) - 1


def _drive_time(bits: int, p: TableI = TABLE_I) -> float:
    """Total static-drive time of the pulse train.  The 2-bit variant
    stretches its single pulse to 7 ns (§IV: 'length of the read pulse and
    write pulses are increased to 7 ns in the 2-bit architecture')."""
    pulse = 7 * NS if bits == 2 else p.min_pulse
    return _pulses(bits) * pulse


# --------------------------------------------------------------------------
# Area (Table II)
# --------------------------------------------------------------------------

def array_area(p: TableI = TABLE_I) -> float:
    """Eq. 2: both (signed + reference) arrays."""
    return 2 * p.rows * p.cols * p.m1_pitch ** 2


def temporal_driver_analog_area(p: TableI = TABLE_I) -> float:
    """20 HV transistors (level shifters + drive) per row."""
    return p.temporal_hv_transistors * p.hv_area * max(p.rows, p.cols)


def temporal_driver_cache_area(bits: int) -> float:
    return SYNTH["temporal_cache_area_um2"][bits] * UM ** 2


def voltage_driver_analog_area(bits: int, p: TableI = TABLE_I) -> float:
    """8 HV transistors per rail; 1 + 2^(vbits-1) rails per column."""
    vbits = SYNTH["voltage_bits"][bits]
    rails = 1 + 2 ** (vbits - 1)
    return 8 * rails * p.hv_area * p.cols


def voltage_driver_cache_area(bits: int) -> float:
    return SYNTH["voltage_cache_area_um2"][bits] * UM ** 2


def integrator_area(p: TableI = TABLE_I) -> float:
    return p.integrator_area * p.cols


def adc_area(p: TableI = TABLE_I) -> float:
    return p.comparator_area * p.cols


def routing_area(p: TableI = TABLE_I) -> float:
    return p.routing_hv_per_col * p.hv_area * p.cols


def area_breakdown(bits: int, p: TableI = TABLE_I) -> Dict[str, float]:
    return {
        "arrays": array_area(p),
        "temporal_driver_analog": temporal_driver_analog_area(p),
        "temporal_driver_cache": temporal_driver_cache_area(bits),
        "voltage_driver_analog": voltage_driver_analog_area(bits, p),
        "voltage_driver_cache": voltage_driver_cache_area(bits),
        "integrators": integrator_area(p),
        "adcs": adc_area(p),
        "routing": routing_area(p),
    }


def total_area(bits: int, p: TableI = TABLE_I) -> float:
    """CMOS footprint; the ReRAM arrays stack monolithically above the
    drivers ("the extra array fits over the required drivers"), so the
    array term is excluded from the total."""
    b = area_breakdown(bits, p)
    return sum(v for k, v in b.items() if k != "arrays")


# --------------------------------------------------------------------------
# Latency (Table III)
# --------------------------------------------------------------------------

def array_rise_time(p: TableI = TABLE_I) -> float:
    """2.2 RC of a row line (90 % settling)."""
    return 2.2 * p.r_line * p.c_line


def read_temporal_time(bits: int) -> float:
    return SYNTH["temporal_read_ns"][bits] * NS


def read_adc_time(bits: int) -> float:
    return SYNTH["adc_ns"][bits] * NS


def write_time(bits: int) -> float:
    """Four sign phases of temporally-coded writes."""
    return 4 * read_temporal_time(bits)


def kernel_latency(bits: int) -> Dict[str, float]:
    read = read_temporal_time(bits) + read_adc_time(bits)
    return {"vmm": read, "mvm": read, "opu": write_time(bits)}


def total_latency(bits: int) -> float:
    k = kernel_latency(bits)
    return k["vmm"] + k["mvm"] + k["opu"]


# --------------------------------------------------------------------------
# Energy (Table IV)
# --------------------------------------------------------------------------

def read_array_energy(bits: int, p: TableI = TABLE_I) -> float:
    """Eq. 3: dynamic CV^2 switching + static I*V drive, both arrays."""
    cv2 = 0.5 * 2 * (bits - 1) * p.rows * p.c_line * p.analog_read_v ** 2
    iv = (2 / 2) * p.rows * p.cols * p.analog_read_i * p.analog_read_v \
        * _drive_time(bits, p)
    return cv2 + iv


def write_array_energy(bits: int, p: TableI = TABLE_I) -> float:
    """Eq. 4(a-c): V/3 scheme setup + transitions + write current."""
    v = p.analog_write_v
    e4a = p.rows * p.c_line * (3 * (v / 3) ** 2 + 0.5 * v ** 2
                               + 0.5 * (v / 3) ** 2)
    e4b = (2 / 2) * p.rows * max(bits - 2, 0) * p.c_line * (
        0.5 * (v / 3) ** 2 + 0.5 * (4 / 9) * v ** 2)
    e4c = 0.5 * p.cols * p.rows * p.analog_write_i * v * _drive_time(bits, p)
    return e4a + e4b + e4c


def integrator_energy(bits: int, p: TableI = TABLE_I) -> float:
    """12 µA per integrator at 1.8 V for the read pulse-train duration."""
    return p.cols * p.integrator_i * p.hv_v * read_temporal_time(bits)


def adc_energy(bits: int, p: TableI = TABLE_I) -> float:
    """1024 continuous-time comparators at 20 µA, 1.8 V for the ramp."""
    return p.cols * p.comparator_i * p.hv_v * read_adc_time(bits)


def cross_core_energy(bits: int, p: TableI = TABLE_I) -> float:
    """Charge a core-edge-length wire once per row+column line (§IV.K)."""
    edge_um = (total_area(bits, p) / UM ** 2) ** 0.5
    c_edge = p.wire_cap_per_um * edge_um
    return (p.rows + p.cols) * c_edge * p.logic_v ** 2


def energy_breakdown(bits: int, p: TableI = TABLE_I) -> Dict[str, float]:
    return {
        "read_array": read_array_energy(bits, p),
        "write_array": write_array_energy(bits, p),
        "temporal_analog": SYNTH["temporal_analog_e_nj"][bits] * NJ,
        "temporal_digital": SYNTH["temporal_digital_e_nj"][bits] * NJ,
        "voltage_analog": SYNTH["voltage_analog_e_nj"][bits] * NJ,
        "voltage_digital": SYNTH["voltage_digital_e_nj"][bits] * NJ,
        "integrator": integrator_energy(bits, p),
        "adc": adc_energy(bits, p),
        "cross_core": cross_core_energy(bits, p),
    }


def kernel_energy(bits: int, p: TableI = TABLE_I) -> Dict[str, float]:
    """Per-kernel totals (Table V).  A read (VMM/MVM) spends the array read,
    temporal drivers, integrator, ADC and cross-core movement; the
    outer-product update spends the 4-phase array write, temporal drivers
    (doubled: two polarity cycles), both voltage-driver terms and
    cross-core."""
    e = energy_breakdown(bits, p)
    read = (e["read_array"] + e["temporal_analog"] + e["temporal_digital"]
            + e["integrator"] + e["adc"] + e["cross_core"])
    opu = (e["write_array"] + 2 * (e["temporal_analog"]
                                   + e["temporal_digital"])
           + e["voltage_analog"] + e["voltage_digital"] + e["cross_core"])
    return {"vmm": read, "mvm": read, "opu": opu}


def total_energy(bits: int, p: TableI = TABLE_I) -> float:
    k = kernel_energy(bits, p)
    return k["vmm"] + k["mvm"] + k["opu"]


def mac_energy(bits: int, p: TableI = TABLE_I) -> float:
    """fJ per multiply-accumulate during a parallel read."""
    return kernel_energy(bits, p)["vmm"] / (p.rows * p.cols)


@dataclasses.dataclass(frozen=True)
class AnalogCore:
    """Convenience bundle for arch_cost / benchmarks."""

    bits: int = 8
    params: TableI = TABLE_I

    @property
    def area(self) -> float:
        return total_area(self.bits, self.params)

    @property
    def latency(self) -> Dict[str, float]:
        return kernel_latency(self.bits)

    @property
    def energy(self) -> Dict[str, float]:
        return kernel_energy(self.bits, self.params)

    @property
    def macs(self) -> int:
        return self.params.rows * self.params.cols
