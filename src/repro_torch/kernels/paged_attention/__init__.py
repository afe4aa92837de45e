"""Paged decode attention: CUDA kernel (``csrc``), plain version
(``ref``), wrapper and launch counter (``ops``)."""
