"""Numpy data pipeline: byte-identical copies of ``repro.data`` so both
packages train on the same arrays from the same seed."""
