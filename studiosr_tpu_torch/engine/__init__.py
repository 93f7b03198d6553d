from studiosr_tpu_torch.engine.trainer import Trainer

__all__ = ["Trainer"]
