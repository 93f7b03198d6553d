from studiosr_tpu_torch.parallel.train_step import (
    Adam,
    TrainState,
    build_optimizer,
    make_train_step,
    multistep_schedule,
    prepare_state,
)

__all__ = ["Adam", "TrainState", "build_optimizer", "make_train_step", "multistep_schedule", "prepare_state"]
