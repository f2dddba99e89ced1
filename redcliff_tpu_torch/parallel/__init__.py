"""Coefficient-grid execution (port of ``redcliff_tpu/parallel``): the
grid engine (``grid.py``) and its epoch engine (``epoch_engine.py``), its
scheduling policy (``policy.py``), the bucket ladder and compaction
planning (``compaction.py``), the fleet's spatial-packing bookkeeping
(``packing.py``), the device mesh (``mesh.py``), elastic re-meshing
(``remesh.py``), the multi-process runtime (``distributed.py``) and
ring-attention sequence parallelism (``sequence.py``).
"""
