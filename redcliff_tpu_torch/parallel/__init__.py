"""Coefficient-grid execution (port of ``redcliff_tpu/parallel``): the
grid engine (``grid.py``), its scheduling policy (``policy.py``) and the
bucket ladder and compaction planning (``compaction.py``). The device mesh
and the packing modules are not ported yet (ROADMAP queue 1, item 15).
"""
