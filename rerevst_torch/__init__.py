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

__version__ = "0.1.0"

from rerevst_torch.config import (  # noqa: F401
    InferenceConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
    resolve_device,
)

__all__ = ["InferenceConfig", "LossConfig", "ModelConfig", "TrainConfig",
           "resolve_device", "Stylization", "MultiStylization",
           "TransformerNet"]


def __getattr__(name):
    # The sessions and the network on first use: importing the package
    # loads neither the kernels' wrappers nor the data modules.
    if name == "Stylization":
        from rerevst_torch.api import Stylization

        return Stylization
    if name == "MultiStylization":
        from rerevst_torch.multistyle import MultiStylization

        return MultiStylization
    if name == "TransformerNet":
        from rerevst_torch.models.transformer import TransformerNet

        return TransformerNet
    raise AttributeError(f"module 'rerevst_torch' has no attribute {name!r}")
