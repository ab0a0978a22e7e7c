"""Model definitions: every family of the registry (dense, MoE with MLA,
VLM, audio encoder-decoder, SSM, hybrid)."""
