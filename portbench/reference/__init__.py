"""The benchmark's plain reference: a frozen copy of the PyTorch modules of
far3d_tpu_torch (config, geometry, models, the plain MSDA, the int8
backbone's plain path, the training step's losses, matching, DN and
optimizer), with every hand-written kernel replaced by its plain version,
the data-parallel reductions at world size 1, and the image side computed
in the dtype the caller hands in (float32 for the comparison).

It imports neither jax, far3d_tpu, nor anything of far3d_tpu_torch, so a
later change to the program cannot move it. Departures from the program's
code, each for the comparison's sake:

- ``ops/msda.py``, ``ops/qconv.py``, ``ops/quant.py:ese_requant``: the plain
  version on every device.
- ``ops/quant.py``: the int8 backbone's stages dequantize to the images'
  dtype (float32 for the comparison); calibration runs the bf16 backbone,
  as the configuration's post-training quantization states;
  ``ops/qconv.py:int_range`` lowers the integer range (the control's
  int4).
- ``models/layers.py``: ``one_step_lower`` rounds every convolution's and
  linear layer's operands one precision below their dtype (the control).
- ``models/detector.py``, ``models/streampetr.py``: uint8 images normalize
  to float32.
- ``train/matching.py``: the auction's chunks run op by op, no CUDA graph.
- ``parallel/mesh.py``: one process, no group.
"""
