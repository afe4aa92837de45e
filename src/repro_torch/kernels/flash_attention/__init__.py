"""Sequence (prefill) attention: CUDA kernel (``csrc``), plain versions
(``ref``), wrappers and launch counter (``ops``)."""
