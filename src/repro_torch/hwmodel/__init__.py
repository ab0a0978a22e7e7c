"""Energy/latency/area analytical model (paper §IV, Tables I-V): the
port's copy of ``repro.hwmodel``, plain Python.  ``arch_cost`` projects a
model of the port's registry onto it."""
from . import analog, compare, digital_reram, sram
from .params import SYNTH, TABLE_I, TableI

__all__ = ["analog", "digital_reram", "sram", "compare", "TABLE_I",
           "TableI", "SYNTH"]
