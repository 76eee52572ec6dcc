"""Serving (the JAX package's ``keras/``): the gateway ``KerasServer`` /
``KerasClient`` (``server``), its predict ``BatchScheduler`` with a CUDA
graph per bucket (``batching``), the token-level generation engine
(``generation``), the serving fleet — ``FleetRouter`` over
``FleetReplica`` gateways (``fleet``) — and its ``FleetAutoscaler``
(``autoscale``). The Keras import and its HDF5 reader wait for ROADMAP
A7.1."""
