"""Serving (the JAX package's ``keras/``): so far the token-level
generation engine (``generation``) and the queue and compile-cache
helpers it shares with the predict scheduler (``batching``). The predict
``BatchScheduler``, ``KerasServer`` / ``KerasClient`` and the fleet wait
for ROADMAP A5 (part 2)."""
