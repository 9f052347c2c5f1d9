"""engine of the PyTorch port (see mspl_tpu_torch/__init__.py): losses,
metrics, lr schedules, the train and eval steps (`train.py`) and
classification pretraining (`train_cls.py`)."""

from mspl_tpu_torch.engine.losses import (compute_class_weights,
                                          segmentation_loss)
from mspl_tpu_torch.engine.metrics import (MIOU, confusion_matrix,
                                           iou_from_confusion)
from mspl_tpu_torch.engine.schedules import build_schedule

__all__ = [
    "segmentation_loss",
    "compute_class_weights",
    "confusion_matrix",
    "iou_from_confusion",
    "MIOU",
    "build_schedule",
]
