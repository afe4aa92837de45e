"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that launches the kernel
for CUDA tensors and takes the plain version for CPU tensors."""
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.ssd.ops import ssd

__all__ = ["flash_attention", "paged_attention", "ssd"]
