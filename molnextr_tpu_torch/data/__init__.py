from molnextr_tpu_torch.data.dataset import DataLoader, Sample, TrainDataset, pad_batch
from molnextr_tpu_torch.data.synthetic import generate_synthetic_image
from molnextr_tpu_torch.data.transforms import get_transforms

__all__ = [
    "DataLoader",
    "Sample",
    "TrainDataset",
    "pad_batch",
    "generate_synthetic_image",
    "get_transforms",
]
