"""Config tree (shared with vo_tpu by file path)."""
