"""Dump augmented training samples for a visual check (the port's
``save_augs.py``).

    python -m nkbx_torch.save_augs -cfg CONFIG [-n 50] [-o augs_preview] [--device cpu]

Runs the config's train pipeline, the host stage in the loader and the
device stage on the card (the CPU with ``--device cpu``) with its random
ops drawn from a generator seeded 0, un-normalises each batch by the
pipeline's own ``Normalize`` (``(x * std + mean) * max_pixel_value``; a
pipeline without one already gives 0..255), clips to uint8 and writes the
valid rows as ``aug_{i}.png`` until N are written.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def unnormalize_params(pipeline):
    """``(mean, std, max_pixel_value)`` of the pipeline's last device
    Normalize, or ``(0, 1, 1)`` without one."""
    from nkbx_torch.transforms.spec import Normalize

    mean, std, maxv = np.zeros(3), np.ones(3), 1.0
    for t in pipeline.device_transforms:
        if isinstance(t, Normalize):
            mean, std, maxv = np.asarray(t.mean), np.asarray(t.std), t.max_pixel_value
    return mean, std, maxv


def save_augs(cfg, n_samples: int, out, device) -> int:
    """Write up to ``n_samples`` augmented training images under ``out``;
    returns the number written."""
    from nkbx_torch.data import get_dataset
    from nkbx_torch.logging.experiment import write_png

    loader = get_dataset(cfg.train_data, cfg.train_pipeline)
    pipe = loader.pipeline
    mean, std, maxv = unnormalize_params(pipe)
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(0)
    saved = 0
    for epoch in range(1000):
        for batch in loader.epoch(epoch):
            x = torch.from_numpy(np.asarray(batch["image"])).to(device)
            aug = pipe.device_apply(x, generator=generator).cpu().numpy()
            imgs = np.clip((aug * std + mean) * maxv, 0, 255).astype(np.uint8)
            for img, valid in zip(imgs, batch["mask"]):
                if not valid or saved >= n_samples:
                    break
                write_png(out_dir / f"aug_{saved}.png", img)
                saved += 1
            if saved >= n_samples:
                return saved
    return saved


def main(argv=None):
    parser = argparse.ArgumentParser(description="Save augmented samples")
    parser.add_argument("-cfg", "--config", help="Config file path", type=str, required=True)
    parser.add_argument("-n", "--n-samples", type=int, default=50)
    parser.add_argument("-o", "--out", type=str, default="augs_preview")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from nkbx_torch.core.runtime import resolve_device
    from nkbx_torch.utils import load_config

    device = resolve_device(args.device)
    saved = save_augs(load_config(args.config), args.n_samples, args.out, device)
    print(f"Saved {saved} augmented samples to {args.out}")


if __name__ == "__main__":
    main()
