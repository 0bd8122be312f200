"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``scored_reduce.py``, ``flash_attention.py``), plus the reference
oracles (``ref.py``) and the public wrappers (``ops.py``)."""
