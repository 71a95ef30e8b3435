from nkbx_torch.transforms.spec import (Compose, HorizontalFlip, Normalize, ToTensorV2,
                                       VerticalFlip)

__all__ = ["Compose", "HorizontalFlip", "Normalize", "ToTensorV2", "VerticalFlip"]
