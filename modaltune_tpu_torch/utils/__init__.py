from .convert import params_from_jax, projector_from_jax

__all__ = ["params_from_jax", "projector_from_jax"]
