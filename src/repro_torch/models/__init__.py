"""Model zoo of the port: the dense family's blocks and assembly."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.params import load_jax_params, materialize

__all__ = ["Model", "ModelConfig", "load_jax_params", "materialize"]
