from .io import load, load_jax_state, save

__all__ = ['load', 'load_jax_state', 'save']
