from studiosr_tpu_torch.data.dataset import PairedImageDataset
from studiosr_tpu_torch.data.handler import DataHandler, DataIterator, PrefetchLoader, set_seed

__all__ = ["PairedImageDataset", "DataHandler", "DataIterator", "PrefetchLoader", "set_seed"]
