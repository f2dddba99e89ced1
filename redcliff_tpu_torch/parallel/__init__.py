"""Coefficient-grid execution (port of ``redcliff_tpu/parallel``): the
grid engine (``grid.py``), its scheduling policy (``policy.py``) and the
bucket ladder and compaction planning (``compaction.py``). Not ported
yet: the device mesh (ROADMAP queue 1, item 15) and spatial packing
(``packing.py``, with the fleet: item 12).
"""
