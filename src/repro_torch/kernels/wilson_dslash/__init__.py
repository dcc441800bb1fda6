"""K1 wilson_hop (the parity hop kernel) and the Schur operators over it."""
