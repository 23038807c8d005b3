"""Feature layouts and the multiscale extraction of the port."""
