from nkbx_torch.utils.classes import get_classes_configs, load_classes, save_classes
from nkbx_torch.utils.config import Config, load_config, read_py_config

__all__ = ["Config", "get_classes_configs", "load_classes", "load_config", "read_py_config",
           "save_classes"]
