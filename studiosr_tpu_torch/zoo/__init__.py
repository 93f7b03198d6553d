"""Weight bridge from the JAX package's parameters, a flax checkpoint reader
that needs neither flax nor msgpack, and the model registry."""

from studiosr_tpu_torch.zoo.checkpoint import msgpack_restore
from studiosr_tpu_torch.zoo.registry import MODEL_REGISTRY, get_model_class, load_model
from studiosr_tpu_torch.zoo.translate import jax_params_to_state_dict, jax_variables_to_state_dict, load_jax_params

__all__ = [
    "MODEL_REGISTRY", "get_model_class", "jax_params_to_state_dict", "jax_variables_to_state_dict", "load_jax_params",
    "load_model", "msgpack_restore",
]
