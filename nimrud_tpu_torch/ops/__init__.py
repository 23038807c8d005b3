"""Tensor ops of the port.  Submodules are imported where used."""
