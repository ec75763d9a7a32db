"""The config tree, checkpoint / resume, and the text HUD."""
