"""Device engines (JAX/XLA): batched FM-index ranks, lockstep
exact/inexact backward search, suffix-array resolution."""
