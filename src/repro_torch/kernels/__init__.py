"""Hand-written Hopper kernels of the port, each beside its plain torch
version: the forward and transpose crossbar reads and the fakequant read
(``xbar_vmm``), the rank-k write (``xbar_update``) and flash attention
(``flash_attention``); ``ops`` holds the kernel-routed entry points
(``vmm``, ``mvm``, ``outer_update``) and the fakequant projection,
``ref`` the plain oracles, and ``_nvcc`` builds the kernels.
``fakequant_read`` is the counterpart of the reference's
``fakequant_read_pallas``."""
from . import ops, ref
from .xbar_update import xbar_outer_update
from .xbar_vmm import fakequant_read, xbar_fused_read

__all__ = ["fakequant_read", "ops", "ref", "xbar_fused_read",
           "xbar_outer_update"]
