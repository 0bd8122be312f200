"""PyTorch/CUDA port of the OSAFL system.

A second package beside the JAX reference ``src/repro/``: it mirrors the
reference's module paths one to one (``repro_torch/core/osafl.py`` ports
``repro/core/osafl.py``) and imports ``torch``, numpy and the standard
library only. Its entry points run on the CUDA device unless the caller
passes ``device="cpu"``; see ``repro_torch.device.resolve_device``.
"""
