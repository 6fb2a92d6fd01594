"""rerevst_torch — consistent video style transfer in PyTorch, for one NVIDIA H100.

The PyTorch/CUDA counterpart of ``rerevst_tpu``: the same functions under the
same module paths, NHWC at every public function, with the frozen-statistics
normalization and the dynamic-filter pair of the global decoder running as
hand-written CUDA kernels (``rerevst_torch/csrc``).  Entry points run on the
card unless the caller passes ``device="cpu"``; on a CPU tensor each kernel
wrapper computes its plain PyTorch version.

This package imports ``torch`` and ``numpy`` only — never JAX, flax, or the
``rerevst_tpu`` package.
"""

from rerevst_torch.config import InferenceConfig, ModelConfig, resolve_device

__all__ = ["InferenceConfig", "ModelConfig", "resolve_device"]
