"""models of the PyTorch port (see mspl_tpu_torch/__init__.py)."""

from mspl_tpu_torch.models.deeplab import DeepLabV3
from mspl_tpu_torch.models.espnetv2 import EESPNet, ESPNetv2Segmentation
from mspl_tpu_torch.models.factory import build_segmentation_model, init_model

__all__ = ["DeepLabV3", "EESPNet", "ESPNetv2Segmentation",
           "build_segmentation_model", "init_model"]
