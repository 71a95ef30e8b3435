from nkbx_torch.train.engine import build_eval_step, build_predict_fn, build_train_step
from nkbx_torch.train.losses import get_loss
from nkbx_torch.train.optim import (apply_updates, backbone_state_factor, get_optimizer,
                                    get_scheduler)
from nkbx_torch.train.state import TrainState

__all__ = ["TrainState", "apply_updates", "backbone_state_factor", "build_eval_step",
           "build_predict_fn", "build_train_step", "get_loss", "get_optimizer", "get_scheduler"]
