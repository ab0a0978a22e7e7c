"""Hand-written Hopper kernels of the port, each beside its plain torch
version (see ``xbar_vmm``)."""
