"""climate_model_tpu_torch: the PyTorch/CUDA port of climate_model_tpu.

A second package beside the JAX reference, with the same sub-layout
(core, dycore, physics, kernels, dist, io, bench, model, cli). It imports torch and
numpy, never JAX, and nothing of ``climate_model_tpu``. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
