"""Physics models: the equilibrium protocol, EFIT, cold-plasma dispersion,
ray equations."""
