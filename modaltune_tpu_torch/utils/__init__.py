from .convert import params_from_jax, projector_from_jax
from .params_io import flatten_params, unflatten_params

__all__ = ["flatten_params", "params_from_jax", "projector_from_jax",
           "unflatten_params"]
