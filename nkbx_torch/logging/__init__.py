from nkbx_torch.logging.experiment import (LocalExperiment, TrainLogger, get_comet_experiment,
                                           get_local_experiment, log_confusion_matrices,
                                           log_grads, log_images, log_metrics, make_image_grid)

__all__ = ["LocalExperiment", "TrainLogger", "get_comet_experiment", "get_local_experiment",
           "log_confusion_matrices", "log_grads", "log_images", "log_metrics", "make_image_grid"]
