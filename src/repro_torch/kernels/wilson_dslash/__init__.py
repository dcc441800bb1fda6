"""K1 wilson_hop (the parity hop kernel), K4 wilson_full (the full-lattice
operator) and the Schur and normal operators over them."""
