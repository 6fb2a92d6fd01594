"""Pass-1 collection beyond one batch — ``rerevst_tpu/parallel``.

Only the single-device streaming collection (``streaming.py``) is ported;
the mesh-sharded paths wait for ROADMAP.md Queue 1 item 7b
(``torch.distributed``).  Spatial H-tiling on one device is
``ops/tiling.py``.
"""
