"""Pipeline models: fixed-capacity feature table, windowed BA, the VO step,
and the loop-closure back-end (keyframe database, Sim(3) pose graph)."""
