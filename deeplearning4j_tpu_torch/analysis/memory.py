"""Memory planning (the JAX package's ``analysis/memory.py``): so far only
``default_kv_page_len``, the rule the serving engine's page pool is
sized by. ``memory_report`` and ``kv_pool_plan`` are not ported yet."""

from __future__ import annotations


def default_kv_page_len(max_len: int) -> int:
    """Default KV page length for a ``max_len``-position decode row:
    the largest divisor of ``max_len`` no bigger than ``max_len // 4``
    (4+ pages per row keeps page-granular eviction meaningful), floor
    1. Pages must DIVIDE ``max_len`` so a row's page chain gathers back
    into the exact dense cache shape."""
    p = max(1, int(max_len) // 4)
    while int(max_len) % p:
        p -= 1
    return p
