"""base-tpu: Bayesian stellar-evolution inference (BASE-9 capabilities, rebuilt for JAX/XLA/Pallas)."""

__version__ = "0.1.0"
