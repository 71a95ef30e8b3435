from nkbx_torch.utils.classes import get_classes_configs, load_classes, save_classes
from nkbx_torch.utils.config import Config, load_config, read_py_config
from nkbx_torch.utils.misc import convert_dict_types_recursive

__all__ = ["Config", "convert_dict_types_recursive", "get_classes_configs", "load_classes",
           "load_config", "read_py_config", "save_classes"]
