from studiosr_tpu_torch.parallel.train_step import (
    Adam,
    TrainState,
    build_optimizer,
    make_train_step,
    multistep_schedule,
    prepare_state,
)
from studiosr_tpu_torch.parallel.mesh import Mesh, get_mesh, replicate
from studiosr_tpu_torch.parallel.tiled import tile_grid, tiled_inference

__all__ = ["Adam", "TrainState", "build_optimizer", "make_train_step", "multistep_schedule", "prepare_state",
           "tile_grid", "tiled_inference", "Mesh", "get_mesh", "replicate"]
