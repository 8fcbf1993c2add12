"""Parallelism of the port (counterpart of ``far3d_tpu/parallel/``): data
parallelism across processes over ``torch.distributed`` (``mesh.py``) and
camera-sharded inference over several devices (``cam_shard.py``)."""
