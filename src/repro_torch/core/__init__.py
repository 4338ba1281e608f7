"""The control plane (a copy of the JAX package's jax-free ``core``): phases,
the shim, the controller, the orchestrators and the OCS switch model."""
