"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see ``flash_attention``) and built by ``build``."""
