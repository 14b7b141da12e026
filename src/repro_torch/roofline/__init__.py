"""Roofline: the per-device count of a cell's step (``analysis``) and its
HBM-traffic model (``hbm``), read by ``launch.dryrun``."""
