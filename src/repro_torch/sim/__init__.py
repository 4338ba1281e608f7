"""The control-plane simulator (a copy of the JAX package's ``sim.workload``
and ``sim.opus_sim``)."""
