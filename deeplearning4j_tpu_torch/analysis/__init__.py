"""Analysis (the JAX package's ``analysis/``): so far the KV page-length
rule of ``memory`` and the pipeline's cut points of ``graphcheck``."""
