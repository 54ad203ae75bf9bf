from .dataloader import NUM_CLASS, SegmentationDataset, datasets, get_segmentation_dataset
from .loader import DataLoader

__all__ = ["NUM_CLASS", "DataLoader", "SegmentationDataset", "datasets",
           "get_segmentation_dataset"]
