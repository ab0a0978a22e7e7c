"""Hand-written Hopper kernels of the port, each beside its plain torch
version: the forward and transpose crossbar reads (``xbar_vmm``) and the
rank-k write (``xbar_update``); ``_nvcc`` builds them."""
