"""Device building blocks written in plain jnp/lax: top-K selection for
the beam engine (``select``) and the batched glocal DP screen (``sw``).
"""
