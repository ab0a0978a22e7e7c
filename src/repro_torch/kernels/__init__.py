"""Hand-written Hopper kernels of the port, each beside its plain torch
version: the forward and transpose crossbar reads and the fakequant read
(``xbar_vmm``), the rank-k write (``xbar_update``) and flash attention
(``flash_attention``); ``ops`` holds the fakequant projection and
``_nvcc`` builds the kernels."""
