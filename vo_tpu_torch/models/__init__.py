"""Pipeline models: fixed-capacity feature table, windowed BA, the VO step."""
