from studiosr_tpu_torch.data.dataset import DF2K, DIV2K, Flickr2K, PairedImageDataset, extract_subimages, prepare_dataset
from studiosr_tpu_torch.data.handler import DataHandler, DataIterator, PrefetchLoader, set_seed

__all__ = [
    "DF2K",
    "DIV2K",
    "Flickr2K",
    "PairedImageDataset",
    "extract_subimages",
    "prepare_dataset",
    "DataHandler",
    "DataIterator",
    "PrefetchLoader",
    "set_seed",
]
