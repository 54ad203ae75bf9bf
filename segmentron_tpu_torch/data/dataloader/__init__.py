"""Dataset registry (counterpart of ``segmentron_tpu/data/dataloader``).

``NUM_CLASS`` gives the class count of every dataset name a config can
carry for the models the port builds; only the synthetic set is
loadable so far."""

from .seg_data_base import SegmentationDataset
from .synthetic import SyntheticSegmentation

NUM_CLASS = {
    "cityscapes": 19,
    "citys": 19,
    "coco": 21,
    "synthetic": SyntheticSegmentation.NUM_CLASS,
}

datasets = {
    "synthetic": SyntheticSegmentation,
}


def get_segmentation_dataset(name: str, **kwargs) -> SegmentationDataset:
    """Instantiate a dataset by registry name."""
    key = name.lower()
    if key not in datasets:
        raise NotImplementedError(f"dataset {name!r} is not ported yet")
    return datasets[key](**kwargs)


__all__ = ["NUM_CLASS", "SegmentationDataset", "datasets", "get_segmentation_dataset"]
