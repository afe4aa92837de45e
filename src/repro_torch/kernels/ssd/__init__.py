"""Mamba-2 SSD chunked scan: CUDA kernel (``csrc``), plain version
(``ref``), wrapper and launch counter (``ops``)."""
