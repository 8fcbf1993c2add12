from setuptools import find_packages, setup

setup(
    name='far3d-tpu',
    version='0.1.0',
    description=('TPU-native (JAX/XLA/Pallas) sparse-query long-range '
                 'surround-view 3D detection'),
    # the JAX package and its PyTorch port; the port ships its CUDA sources,
    # which it compiles with nvcc at first use
    packages=find_packages(include=['far3d_tpu', 'far3d_tpu.*',
                                    'far3d_tpu_torch', 'far3d_tpu_torch.*']),
    package_data={'far3d_tpu_torch': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=['jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy'],
    extras_require={
        'data': ['opencv-python', 'pandas', 'pyarrow'],
        'test': ['pytest', 'scipy'],
        'torch': ['torch'],
    },
)
