"""Numeric building blocks: table index, splines, integrators, compensated
accumulation, Newton iteration."""
