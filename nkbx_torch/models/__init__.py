from nkbx_torch.models.classifier import (ClassificationModel, MultitaskClassifier,
                                          SingletaskClassifier, get_model, is_backbone_param,
                                          param_labels)
from nkbx_torch.models.convert import from_jax_variables
from nkbx_torch.models.registry import create_backbone, list_backbones

__all__ = ["ClassificationModel", "MultitaskClassifier", "SingletaskClassifier",
           "create_backbone", "from_jax_variables", "get_model", "is_backbone_param",
           "list_backbones", "param_labels"]
