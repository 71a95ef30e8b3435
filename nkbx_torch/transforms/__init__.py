"""The port's transform pipeline: nkbx's spec names (``import nkbx.transforms
as T`` in a config builds these), a host stage of geometry per sample and a
device stage per batch: every device op of nkbx (the flips,
RandomBrightnessContrast, HueSaturationValue, CoarseDropout, Rotate,
ShiftScaleRotate, RandAugment, TrivialAugmentWide, MotionBlur, RandomShadow,
RandomFog, RandomRain) and Normalize."""

from nkbx_torch.transforms.adapter import Transforms
from nkbx_torch.transforms.spec import (CenterCrop, CoarseDropout, Compose, HorizontalFlip,
                                        HueSaturationValue, LongestMaxSize, MotionBlur,
                                        Normalize, PadIfNeeded, RandAugment,
                                        RandomBrightnessContrast, RandomCrop, RandomFog,
                                        RandomRain, RandomShadow, Resize, Rotate,
                                        ShiftScaleRotate, SmallestMaxSize, ToTensorV2,
                                        Transform, TrivialAugmentWide, VerticalFlip)

__all__ = [
    "Compose", "Transform", "Transforms", "LongestMaxSize", "SmallestMaxSize", "PadIfNeeded",
    "Resize", "CenterCrop", "RandomCrop", "HorizontalFlip", "VerticalFlip",
    "RandomBrightnessContrast", "HueSaturationValue", "CoarseDropout", "Rotate",
    "ShiftScaleRotate", "RandAugment", "TrivialAugmentWide", "MotionBlur", "RandomShadow",
    "RandomFog", "RandomRain", "Normalize", "ToTensorV2",
]
