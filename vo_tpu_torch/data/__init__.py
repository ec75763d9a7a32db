"""Data: the on-device synthetic-city renderer and ATE/RPE evaluation."""

# What the entry points say for a dataset read from disk.
UNPORTED_DATASET = (
    "--dataset {name} is not ported: the disk loaders (kitti, malaga, parking) "
    "wait for their image data (ROADMAP Queue 1, 'Still to port': disk loaders); "
    "use --dataset synthetic"
)
