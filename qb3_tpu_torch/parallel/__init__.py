"""Multi-device QB3: one raster's block-row strips over a group of devices
(sharded.py)."""
