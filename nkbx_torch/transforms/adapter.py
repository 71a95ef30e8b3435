"""nkbx's reference-compatible ``Transforms`` adapter (counterpart of
``nkbx/transforms/adapter.py``): the host stage of a Compose, called
torchvision-style as ``transform(img)``."""

from __future__ import annotations

import numpy as np

from nkbx_torch.transforms.spec import Compose


class Transforms:
    def __init__(self, transforms: Compose) -> None:
        if not isinstance(transforms, Compose):
            raise TypeError("nkbx_torch pipelines must be nkbx_torch.transforms.Compose "
                            f"(got {type(transforms).__name__})")
        self.transforms = transforms

    def __call__(self, img, *args, rng=None, **kwargs) -> np.ndarray:
        """Host stage only: uint8 HWC in, fixed-shape uint8 HWC out."""
        return self.transforms.host_apply(np.asarray(img), rng=rng)
