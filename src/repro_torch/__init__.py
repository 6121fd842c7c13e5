"""PyTorch/CUDA port of the ``repro`` package (FastCLIP), for one NVIDIA
H100.  Same module layout and names as ``repro``; imports ``torch`` and
never ``jax`` or anything of ``repro``.  Entry points run on the card
unless the caller asks for the CPU (``repro_torch.device``)."""
