"""MB-row sharding: each band of MB rows one slice, on a device of its own
(parallel/rows.py)."""
