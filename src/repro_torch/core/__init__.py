"""Core analog-crossbar library (torch): the paper's contribution, with
the reference package's exports under the same names."""
from .adc import AdcConfig, adc_quantize, integrator_saturation, quantize_input
from .analog_linear import (analog_linear_apply, analog_linear_init,
                            analog_linear_readout)
from .crossbar import (CrossbarConfig, conductance_to_weights, make_reference,
                       pad_to_tiles, tile_grid, weights_to_conductance)
from . import endurance
from .device import (IDEAL, LINEARIZED, TAOX, TAOX_NONOISE, DeviceConfig,
                     LutDevice, VoltageModel, apply_pulse_train,
                     apply_update, lut_from_analytic, lut_from_pulse_train,
                     pulse_train_counts)
from . import analog_registry
from .tiled_analog import (DEVICE_MODELS, analog_project,
                           analog_project_batched, crossbar_from_model,
                           device_model, effective_g, is_analog_container,
                           merge_tapes, pop_tapes, program_linear,
                           program_stacked, push_tapes, split_tapes,
                           tile_info, with_tapes)
from .periodic_carry import (carry_fold, pc_backward, pc_carry,
                             pc_effective_weights, pc_forward, pc_init,
                             pc_update)
from .xbar_ops import mvm, outer_update, quantize_update_operands, vmm

__all__ = [
    "endurance", "AdcConfig", "CrossbarConfig", "DeviceConfig", "LutDevice",
    "VoltageModel", "IDEAL", "TAOX", "TAOX_NONOISE", "LINEARIZED",
    "adc_quantize", "integrator_saturation", "quantize_input",
    "analog_linear_apply", "analog_linear_init", "analog_linear_readout",
    "conductance_to_weights", "weights_to_conductance", "make_reference",
    "pad_to_tiles", "tile_grid", "apply_update", "apply_pulse_train",
    "pulse_train_counts", "lut_from_analytic",
    "lut_from_pulse_train", "vmm", "mvm", "outer_update",
    "quantize_update_operands", "pc_init", "pc_forward", "pc_backward",
    "pc_update", "pc_carry", "pc_effective_weights", "carry_fold",
    "DEVICE_MODELS", "device_model",
    "analog_project", "analog_project_batched", "analog_registry",
    "crossbar_from_model", "effective_g", "is_analog_container",
    "program_linear",
    "program_stacked", "tile_info", "with_tapes", "split_tapes",
    "merge_tapes", "pop_tapes", "push_tapes",
]
