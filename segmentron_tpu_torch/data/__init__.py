from .dataloader import NUM_CLASS, SegmentationDataset, datasets, get_segmentation_dataset

__all__ = ["NUM_CLASS", "SegmentationDataset", "datasets", "get_segmentation_dataset"]
