"""simplepanorama_tpu_torch — the panorama stitcher in PyTorch and CUDA.

A port of the JAX/XLA/Pallas package simplepanorama_tpu/ to PyTorch
for an NVIDIA Hopper GPU. Module names and public signatures follow the JAX package,
so each counterpart is found by path; the JAX package stays the
reference the port is tested against. The TPU Pallas kernels become
hand-written CUDA kernels under ``csrc/``, each with a plain PyTorch
version beside it that the CPU runs.
"""

from simplepanorama_tpu_torch.config import (
    Blending,
    Config,
    Projection,
    Stretch,
    read_config_file,
    write_config_file,
)
from simplepanorama_tpu_torch.pipeline import Panorama, StitchCancelled
from simplepanorama_tpu_torch.viewer import PanoramaViewer

__version__ = "0.1.0"

__all__ = [
    "Blending",
    "Projection",
    "Stretch",
    "Config",
    "read_config_file",
    "write_config_file",
    "Panorama",
    "PanoramaViewer",
    "StitchCancelled",
]
