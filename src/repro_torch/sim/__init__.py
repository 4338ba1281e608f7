"""The control-plane simulator: copies of the JAX package's jax-free
``sim`` modules (``workload``, ``opus_sim``, ``traces``, ``network``,
``costmodel``, ``cluster``, ``serving``, ``planner``, ``ops``)."""
