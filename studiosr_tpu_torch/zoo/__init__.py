"""Weight bridge from the JAX package's parameters."""

from studiosr_tpu_torch.zoo.translate import jax_params_to_state_dict, load_jax_params

__all__ = ["jax_params_to_state_dict", "load_jax_params"]
