"""Lattice command-line entry points of the port."""
