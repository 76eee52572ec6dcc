"""Utilities (the JAX package's ``util/``): so far ``math_utils``."""
