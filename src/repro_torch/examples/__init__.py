"""The examples of the port, run as ``python -m repro_torch.examples.<name>``:
counterparts of the repo-level ``examples/`` that import no JAX. Each runs
on the card by default and on the CPU with ``--device cpu``."""
