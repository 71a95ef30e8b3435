from nkbx_torch.train.engine import build_predict_fn

__all__ = ["build_predict_fn"]
