"""Where the program keeps what it builds at run time: inside the checkout.

Both directories are listed in ``.gitignore``.  Their paths are fixed
(no temp name, pid or time), so a later process finds what an earlier one
left there: JAX keys its persistent compile cache on the directory.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# native builds (g++ shared libraries of the BVH builder and OBJ scanner)
NATIVE_DIR = os.path.join(CHECKOUT, "build", "native")
# XLA's persistent compile cache, unless JAX_COMPILATION_CACHE_DIR says
COMPILE_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is what JAX already uses and is
    left alone; otherwise the cache goes to ``<checkout>/.jax_cache``.
    Entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call this
    before their first compile.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR
