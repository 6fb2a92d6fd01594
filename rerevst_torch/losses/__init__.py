"""Training losses — ``rerevst_tpu/losses``."""

from rerevst_torch.losses.gan import gan_loss  # noqa: F401
from rerevst_torch.losses.perceptual import (  # noqa: F401
    content_loss,
    style_loss,
    tv_loss,
)
from rerevst_torch.losses.relaxed import relaxed_style_loss  # noqa: F401
from rerevst_torch.losses.temporal import (  # noqa: F401
    fake_flow_from_noise,
    generate_fake_data,
    generate_fake_flow,
    temporal_loss,
    temporal_loss_mpi,
    temporal_loss_video,
)
