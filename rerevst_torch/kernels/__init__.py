"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

| wrapper | kernel source | TPU kernel it replaces |
|---|---|---|
| ``norm_affine_clamp`` | ``csrc/norm_affine.cu`` | ``rerevst_tpu/kernels/norm_affine.py:norm_affine_clamp`` |
| ``dynamic_filter_pair`` | ``csrc/filter_chain.cu`` | ``rerevst_tpu/kernels/filter_chain.py:dynamic_filter_pair`` |

The kernels build at first use (``kernels/_build.py``).  Each wrapper keeps an
integer ``launches`` count of its kernel launches.
"""

from rerevst_torch.kernels.filter_chain import (  # noqa: F401
    dynamic_filter_pair,
    dynamic_filter_pair_plain,
)
from rerevst_torch.kernels.norm_affine import (  # noqa: F401
    norm_affine_clamp,
    norm_affine_clamp_plain,
)

#: Every kernel wrapper of the port.
WRAPPERS = (norm_affine_clamp, dynamic_filter_pair)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
