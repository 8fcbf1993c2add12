"""far3d_tpu_torch: the PyTorch and CUDA port of far3d-tpu for NVIDIA Hopper.

Runs Far3D streaming inference (VoVNet-99 + FPN, YOLOX 2D proposals, FarHead
with its temporal memory) with the reference checkpoint's parameter names.
The one TPU kernel on that path, the MSDA forward, is a hand-written CUDA
kernel (``csrc/msda_fwd.cu``). The package imports torch and never jax or
the JAX package ``far3d_tpu``.
"""

from .config import Far3DConfig, tiny_test_config
from .models.detector import Far3D, decode_detections
from .models.farhead import TemporalState, init_state

__all__ = ['Far3DConfig', 'tiny_test_config', 'Far3D', 'decode_detections',
           'TemporalState', 'init_state']
