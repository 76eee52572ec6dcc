"""Serving (the JAX package's ``keras/``): the gateway ``KerasServer`` /
``KerasClient`` (``server``), its predict ``BatchScheduler`` with a CUDA
graph per bucket (``batching``), the token-level generation engine
(``generation``), the serving fleet — ``FleetRouter`` over
``FleetReplica`` gateways (``fleet``) — and its ``FleetAutoscaler``
(``autoscale``), and the Keras model import (``keras_import``) over a
plain-Python HDF5 reader and writer (``hdf5``)."""
