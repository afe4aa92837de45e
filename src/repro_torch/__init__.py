"""PyTorch/CUDA port of the MORI serving system.

The package mirrors ``repro`` (the JAX reference) module for module:
``repro_torch.serving.engine`` is the counterpart of
``repro.serving.engine`` and so on. It imports ``torch``, numpy and the
standard library only; the pure-Python control plane (``core``,
``traces``, ``analysis.kvsan``) is a copy of the reference's, not a
re-export. Decode attention runs in a CUDA kernel written for Hopper
(``kernels/paged_attention/csrc``); the wrapper launches it for CUDA
tensors and uses its plain PyTorch version for CPU tensors.
"""
