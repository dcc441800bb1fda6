"""Command-line entry points of the port: the lattice solver's and the LM
serving and training launchers'."""
