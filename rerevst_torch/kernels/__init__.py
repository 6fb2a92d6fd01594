"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

| wrapper | kernel source | TPU kernel it replaces |
|---|---|---|
| ``norm_affine_clamp`` | ``csrc/norm_affine.cu`` | ``rerevst_tpu/kernels/norm_affine.py:norm_affine_clamp`` |
| ``dynamic_filter_pair`` | ``csrc/filter_chain.cu`` | ``rerevst_tpu/kernels/filter_chain.py:dynamic_filter_pair`` |
| ``conv3x3_implicit_gemm`` | ``csrc/conv3x3.cu`` (``rr_conv3x3``) | ``rerevst_tpu/kernels/conv3x3.py:conv3x3_implicit_gemm`` |
| ``conv3x3_pairlane`` | ``csrc/conv3x3.cu`` (``rr_conv3x3_c64``) | ``rerevst_tpu/kernels/conv3x3.py:conv3x3_pairlane`` |
| ``conv3x3_wgrad`` | ``csrc/conv3x3_wgrad.cu`` (``rr_conv3x3_wgrad``) | none: the weight gradient of the fp32 conv (``Conv3x3Fn``'s backward) |

The kernels build at first use (``kernels/_build.py``).  Each wrapper keeps an
integer ``launches`` count of its kernel launches.

Each wrapper checks its arguments and calls its ``torch.library`` op,
``rerevst::<wrapper name>``, registered when this package is imported: the
op's CUDA implementation launches the kernel (and counts the launch), its CPU
implementation is the plain version, and its fake implementation gives the
output's shape, so ``torch.export`` keeps each kernel as one node of an
exported graph (``io/aot.py``).  Every path, eager, tiled or exported, reaches
a kernel through its op.
"""

from rerevst_torch.kernels.conv3x3 import (  # noqa: F401
    conv3x3_implicit_gemm,
    conv3x3_implicit_gemm_plain,
    conv3x3_pairlane,
    conv3x3_pairlane_plain,
    conv3x3_wgrad,
    conv3x3_wgrad_plain,
)
from rerevst_torch.kernels.filter_chain import (  # noqa: F401
    dynamic_filter_pair,
    dynamic_filter_pair_plain,
)
from rerevst_torch.kernels.norm_affine import (  # noqa: F401
    norm_affine_clamp,
    norm_affine_clamp_plain,
)

#: Every kernel wrapper of the port.
WRAPPERS = (norm_affine_clamp, dynamic_filter_pair, conv3x3_implicit_gemm,
            conv3x3_pairlane, conv3x3_wgrad)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0
    conv3x3_implicit_gemm.launches_by_design = dict.fromkeys(
        conv3x3_implicit_gemm.launches_by_design, 0)
    conv3x3_implicit_gemm.launches_by_shape = {}
    conv3x3_wgrad.launches_by_shape = {}


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
