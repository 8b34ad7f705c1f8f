"""koifish_tpu_torch — the PyTorch + CUDA port of koifish_tpu for one H100.

A second package beside ``koifish_tpu`` (the JAX reference, left as it is).
It imports torch and numpy, never JAX and nothing of ``koifish_tpu``. Module
paths mirror the JAX package's, so each counterpart is found by its path.
Its kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use (``ops/kernels/_build.py``). Entry points take
``device=None``, which means ``"cuda"``; tests pass ``device="cpu"`` and run
each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from koifish_tpu_torch.config import (CLIParams, ModelCard, QuantCard,  # noqa: F401
                                      SamplerCard)
from koifish_tpu_torch.dtypes import QFormat  # noqa: F401
