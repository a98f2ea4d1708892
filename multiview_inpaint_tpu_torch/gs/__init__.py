"""Scene state, checkpoint I/O, cameras and scene loading."""
