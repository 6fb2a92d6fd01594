"""The multi-device layer — ``rerevst_tpu/parallel`` on ``torch.distributed``.

* ``mesh.py``: the 1-D mesh of shards (``frame_mesh``, ``distributed_init``,
  padding and the local-batch contract of a multi-process mesh);
* ``collectives.py``: ``run_sharded``, the shards in lockstep on the mesh's
  worker threads, with psum/pmin/pmax/pmean and the halo exchange;
* ``stats.py``: Pass 1 with the frame axis sharded;
* ``pipeline.py``: Pass 2 with the frame batch sharded;
* ``spatial.py``: Pass 2 with each frame's H rows sharded (halo exchange);
* ``streaming.py``: the long-clip Pass 1 in chunks, optionally sharded;
* ``dryrun.py``: one sharded train step and sharded two-pass inference at
  small shapes, in one process or several.

Spatial H-tiling on one device is ``ops/tiling.py``.
"""

from rerevst_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    device_mesh,
    distributed_init,
    frame_mesh,
    lift_local,
    local_device_count_in,
    mesh_process_count,
    pad_to_multiple,
)
from rerevst_torch.parallel.collectives import run_sharded  # noqa: F401
from rerevst_torch.parallel.stats import collect_stats_sharded  # noqa: F401
from rerevst_torch.parallel.pipeline import (  # noqa: F401
    stylize_frames_sharded,
)
