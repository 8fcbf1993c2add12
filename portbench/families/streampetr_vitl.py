"""StreamPETR with the EVA-02 ViT-L backbone: ``StreamPETRViTConfig`` and
``StreamPETRViT`` (``models/streampetr_vit.py``) on either side, driven as
the ``streampetr`` family drives StreamPETR; the program's streaming entry
is the same ``train.petr_step.make_petr_infer_step``. There is no int8
path (``ops/quant.py:quantize_petr_backbone`` refuses the ViT)."""

import importlib.util
import pathlib

_path = pathlib.Path(__file__).with_name('streampetr.py')
_spec = importlib.util.spec_from_file_location('portbench_family_streampetr',
                                               _path)
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)


class Family(_base.Family):
    config_module = model_module = 'models.streampetr_vit'
    config_class, model_class = 'StreamPETRViTConfig', 'StreamPETRViT'
