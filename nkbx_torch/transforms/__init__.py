from nkbx_torch.transforms.spec import Compose, Normalize, ToTensorV2

__all__ = ["Compose", "Normalize", "ToTensorV2"]
