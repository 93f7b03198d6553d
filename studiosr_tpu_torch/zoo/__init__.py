"""The published-weight zoo, the weight bridge from the JAX package's
parameters, a flax checkpoint reader that needs neither flax nor msgpack,
and the model registry.

:func:`fetch` resolves a release file under ``./pretrained`` (downloading it
on first use where a source is given); ``from_pretrained`` on each model
class reads it with :func:`load_torch_state_dict` and fills the module with
:func:`translate_state_dict`."""

import os
from typing import Optional

from studiosr_tpu_torch.zoo.checkpoint import msgpack_restore
from studiosr_tpu_torch.zoo.registry import MODEL_REGISTRY, get_model_class, load_model
from studiosr_tpu_torch.zoo.translate import (
    TranslationReport, jax_params_to_state_dict, jax_variables_to_state_dict, load_jax_params, load_torch_state_dict,
    translate_state_dict,
)

__all__ = [
    "MODEL_REGISTRY", "TranslationReport", "fetch", "get_model_class", "jax_params_to_state_dict",
    "jax_variables_to_state_dict", "load_jax_params", "load_model", "load_torch_state_dict", "msgpack_restore",
    "translate_state_dict",
]


def fetch(file_name: str, url: Optional[str] = None, gdrive_id: Optional[str] = None,
          model_dir: str = "pretrained") -> str:
    """The local path of zoo file ``file_name`` under ``model_dir``: the file
    when it is there, else downloaded from ``url`` or the Google-Drive id
    ``gdrive_id`` first; ``FileNotFoundError`` when it has neither."""
    from studiosr_tpu_torch.utils.helpers import download, download_gdrive

    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, file_name)
    if not os.path.exists(path):
        if url is not None:
            download(url, path)
        elif gdrive_id is not None:
            download_gdrive(id=gdrive_id, output=path)
        else:
            raise FileNotFoundError(f"{path} not present and no source given")
    return path
