"""Physics models: the equilibrium protocol, EFIT, VMEC, the dispersion zoo,
ray equations."""
