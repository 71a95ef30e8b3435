from nkbx_torch.export.serving import ServingModule, default_buckets

__all__ = ["ServingModule", "default_buckets"]
