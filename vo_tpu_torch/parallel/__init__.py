"""Throughput scaling: lockstep multi-sequence VO (multiseq.py)."""
