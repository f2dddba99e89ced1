"""Coefficient-grid execution (port of ``redcliff_tpu/parallel``): the grid
core of ``parallel/grid.py``. The mesh, the bucket ladder, compaction and
the packing modules are not ported yet (ROADMAP queue 1, items 9 and 15).
"""
