"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that launches the kernel
for CUDA tensors and takes the plain version for CPU tensors."""
