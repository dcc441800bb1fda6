"""K2 cg_update and K3 cg_xpay (the fused CG vector kernels) and the engine."""
