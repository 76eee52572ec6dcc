"""Serving (the JAX package's ``keras/``): the gateway ``KerasServer`` /
``KerasClient`` (``server``), its predict ``BatchScheduler`` with a CUDA
graph per bucket (``batching``) and the token-level generation engine
(``generation``). The fleet waits for ROADMAP A5.3, the Keras import and
its HDF5 reader for A7.1."""
