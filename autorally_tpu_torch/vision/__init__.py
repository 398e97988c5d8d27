"""Camera subsystem: auto exposure/gain balance, hardware trigger link,
and the image republisher (the ``autorally_core`` camera stack role; the
port's copy of ``autorally_tpu/vision``, numpy on the host)."""

from autorally_tpu_torch.vision.auto_balance import (AutoBalanceConfig,
                                                     CameraAutoBalance,
                                                     SimulatedCamera,
                                                     luminance_histogram,
                                                     msv)
from autorally_tpu_torch.vision.camera_trigger import CameraTrigger
from autorally_tpu_torch.vision.image_republisher import ImageRepublisher
from autorally_tpu_torch.vision.overhead import (OverheadClient,
                                                 OverheadDetection,
                                                 OverheadPoseBridge,
                                                 SyntheticOverheadCamera)

__all__ = ["AutoBalanceConfig", "CameraAutoBalance", "SimulatedCamera",
           "luminance_histogram", "msv", "CameraTrigger",
           "ImageRepublisher", "OverheadClient", "OverheadDetection",
           "OverheadPoseBridge", "SyntheticOverheadCamera"]
