"""Host data path of the port: image I/O, the per-frame pipeline, the AV2
dataset, its samplers and the threaded loaders."""
