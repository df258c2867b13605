"""2D -> 3D lifting engine (normalize, prune, initialize, FK, 900-cycle filter)."""
