"""Coefficient-grid execution (port of ``redcliff_tpu/parallel``): the
grid engine (``grid.py``), its scheduling policy (``policy.py``), the
bucket ladder and compaction planning (``compaction.py``) and the fleet's
spatial-packing bookkeeping (``packing.py``). Not ported yet: the device
mesh and re-meshing (ROADMAP queue 1, item 15).
"""
