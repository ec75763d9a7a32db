"""Data: the on-device synthetic-city renderer and ATE/RPE evaluation."""
