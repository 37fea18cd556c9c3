from .convert import load_jax_optimizer_state, load_jax_state_dict

__all__ = ["load_jax_optimizer_state", "load_jax_state_dict"]
