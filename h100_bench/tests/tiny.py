"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the same
files and code paths, narrower registry models, small images and batches."""

import torch

from h100_bench import spec


def tiny_cell(name: str):
    cell = spec.cell(name)
    if cell.config["family"] == "vit":
        cell.config.update(model="vit_tiny_patch16_224", image_size=32, hidden_size=192,
                           num_heads=3, mlp_dim=768, num_classes=10)
    else:
        cell.config.update(image_size=64, num_classes=10)
    cell.config["compute_dtype"] = "float32"
    if cell.mix["kind"] == "train":
        cell.mix.update(batch=8, pool_batches=4, warmup_steps=1, trace_steps=2)
    else:
        cell.mix.update(sizes=[2, 12], buckets=[1, 2, 4, 8], pool_images=32, rate_rps=200,
                        sample_requests=4, warmup_requests=2)
    torch.set_num_threads(2)
    return cell
