from nkbx_torch.data.datasets import (AnnotatedMultitaskDataset, AnnotatedSingletaskDataset,
                                      AnnotatedYOLODataset, GroupsDataset, ImageFolderDataset,
                                      InferDataset, imread_rgb)
from nkbx_torch.data.loader import DataLoader, get_dataset, get_inference_dataset
from nkbx_torch.data.sampler import ImbalancedDatasetSampler, SequentialSampler, ShuffleSampler

__all__ = ["AnnotatedSingletaskDataset", "AnnotatedMultitaskDataset", "AnnotatedYOLODataset",
           "GroupsDataset", "ImageFolderDataset", "InferDataset", "imread_rgb",
           "ImbalancedDatasetSampler", "SequentialSampler", "ShuffleSampler", "DataLoader",
           "get_dataset", "get_inference_dataset"]
