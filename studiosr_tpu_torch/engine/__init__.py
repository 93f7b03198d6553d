from studiosr_tpu_torch.engine.evaluator import Evaluator, Evaluator2, benchmark
from studiosr_tpu_torch.engine.trainer import Trainer

__all__ = ["Evaluator", "Evaluator2", "Trainer", "benchmark"]
