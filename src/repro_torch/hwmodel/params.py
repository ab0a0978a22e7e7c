"""Table I model properties and assumptions (14/16 nm PDK).

The port's copy of ``repro.hwmodel.params``: plain Python, equal to the
reference value for value (``tests/test_torch_hwmodel.py``).

Where the paper derives a number from first principles (Eqs. 2-5) we
recompute it; where it comes from Verilog synthesis / SPICE (driver logic
energy, MAC energy, SRAM generator) we carry the paper's reported value in
per-bit-width tables, clearly marked ``synthesized``.
"""
from __future__ import annotations

import dataclasses

# Unit helpers (SI).
NM = 1e-9
UM = 1e-6
NS = 1e-9
FF = 1e-15
AF = 1e-18
NA = 1e-9
UA = 1e-6
PJ = 1e-12
FJ = 1e-15
NJ = 1e-9


@dataclasses.dataclass(frozen=True)
class TableI:
    """Paper Table I, plus §IV constants."""

    # Interconnect
    m1_pitch: float = 64 * NM              # full pitch
    wire_cap_per_um: float = 200 * AF      # F/µm
    wire_res_per_um: float = 30.0          # Ω/µm

    # Transistors
    logic_area: float = 0.044 * UM ** 2
    logic_v: float = 0.8
    hv_area: float = 0.35 * UM ** 2
    hv_v: float = 1.8

    # Crossbar
    rows: int = 1024
    cols: int = 1024
    min_pulse: float = 1 * NS

    # ReRAM + select device
    on_off_ratio: float = 10.0
    c_reram: float = 35 * AF

    # Analog ReRAM
    analog_read_i: float = 1 * NA
    analog_write_i: float = 10.3 * NA
    analog_read_v: float = 0.785
    analog_write_v: float = 1.8

    # Binary (digital) ReRAM
    binary_read_i: float = 98 * NA
    binary_write_i: float = 846 * NA
    binary_read_v: float = 0.954
    binary_write_v: float = 1.8
    binary_write_t: float = 10 * NS
    binary_read_t: float = 86 * NS
    binary_write_par: int = 32             # bits written in parallel / array
    binary_read_par: int = 256             # bits read in parallel / array

    # Digital weights
    weight_bits: int = 8

    # §IV.B/D/E periphery constants (SPICE/synthesis-derived)
    level_shifter_e: float = 15 * FJ       # per transition
    integrator_i: float = 12 * UA          # while running
    comparator_i: float = 20 * UA          # per column, while ramping
    integrator_area: float = 6.4 * UM ** 2   # per column (12 long + 4 min T)
    comparator_area: float = 5.7 * UM ** 2   # per column
    temporal_logic_area: float = 8.6 * UM ** 2   # per row, synthesized
    voltage_logic_area_8b: float = 17 * UM ** 2  # per column, synthesized
    temporal_hv_transistors: int = 20      # per row driver
    routing_hv_per_col: int = 8            # §IV.F pass gates
    sense_amp_e: float = 5 * FJ            # per measurement
    sram_read_e_per_bit: float = 0.37 * FJ
    sram_write_e_per_bit: float = 0.40 * FJ
    sram_bank_area: float = 12103 * UM ** 2  # 128 kb generated macro
    sram_access_bits: int = 64
    sram_access_t: float = 2 * NS
    mac_units: int = 256

    # --- wire/line deriveds -------------------------------------------------
    @property
    def cell_wire_len(self) -> float:
        return self.m1_pitch  # one cell pitch of M1 per crossing

    @property
    def c_line(self) -> float:
        """Column/row line capacitance: wire + ReRAM cells."""
        c_wire = self.wire_cap_per_um * (self.cell_wire_len / UM)
        return self.rows * (c_wire + self.c_reram)

    @property
    def r_line(self) -> float:
        return self.wire_res_per_um * (self.rows * self.cell_wire_len / UM)


# Synthesis-derived per-bit-width tables (paper Tables II-IV rows marked
# "synthesized"/SPICE).  Keys are I/O bit widths.
SYNTH = {
    # temporal-coding driver digital logic + register cache, area per core
    "temporal_cache_area_um2": {8: 8900.0, 4: 5100.0, 2: 3100.0},
    # voltage-coding driver cache + control area per core
    "voltage_cache_area_um2": {8: 18000.0, 4: 10000.0, 2: 7100.0},
    # 256-wide MAC block area
    "mac_area_um2": {8: 54000.0, 4: 35000.0, 2: 23000.0},
    # input register (1024 x bits flip-flops)
    "input_buffer_area_um2": {8: 7000.0, 4: 3500.0, 2: 1750.0},
    # temporal driver analog transistor energy, one read cycle
    "temporal_analog_e_nj": {8: 0.16, 4: 0.08, 2: 0.04},
    # temporal driver digital logic energy, one read cycle
    "temporal_digital_e_nj": {8: 0.04, 4: 0.02, 2: 0.01},
    # voltage driver analog transistors, 4-cycle write (80 pJ, bit-indep.)
    "voltage_analog_e_nj": {8: 0.08, 4: 0.08, 2: 0.08},
    # voltage driver digital logic, 4-cycle write
    "voltage_digital_e_nj": {8: 0.02, 4: 0.01, 2: 0.01},
    # MAC energy per 8-bit multiply-add (pJ) — 1.46 pJ synthesized
    "mac_e_pj_per_op": {8: 1.46, 4: 0.88, 2: 0.51},
    # temporal read pulse-train length (ns): 2^(bits-1) pulses of 1 ns;
    # the 2-bit variant stretches its single pulse to 7-8 ns (§IV).
    "temporal_read_ns": {8: 128.0, 4: 8.0, 2: 8.0},
    # ramp-ADC conversion time (ns): one level per ns
    "adc_ns": {8: 256.0, 4: 16.0, 2: 3.0},
    # voltage-coder magnitude bits for the outer-product column drive
    "voltage_bits": {8: 4, 4: 2, 2: 2},
}

TABLE_I = TableI()
