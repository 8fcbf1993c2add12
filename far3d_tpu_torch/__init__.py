"""far3d_tpu_torch: the PyTorch and CUDA port of far3d-tpu for NVIDIA Hopper.

Runs Far3D streaming inference (VoVNet-99 + FPN, YOLOX 2D proposals, FarHead
with its temporal memory) and training with the reference checkpoint's
parameter names, from synthetic tensors or from an AV2 dataset on disk
(``data/``, ``train/runner.py``, ``eval/``, ``cli/``), and the second model
family, StreamPETR (``models/streampetr.py``), on nuScenes-format data with
its NDS protocol. The TPU kernels are hand-written CUDA kernels
(``csrc/``). The package imports torch and never jax or the JAX package
``far3d_tpu``.
"""

from .config import Far3DConfig, tiny_test_config
from .models.detector import Far3D, decode_detections
from .models.farhead import TemporalState, init_state

__all__ = ['Far3DConfig', 'tiny_test_config', 'Far3D', 'decode_detections',
           'TemporalState', 'init_state']
