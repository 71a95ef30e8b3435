from nkbx_torch.core.runtime import resolve_device

__all__ = ["resolve_device"]
