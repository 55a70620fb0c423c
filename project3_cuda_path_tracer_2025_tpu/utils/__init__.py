from . import vec, mathutil, prng, image_io, timers, compile_cache

__all__ = ["vec", "mathutil", "prng", "image_io", "timers", "compile_cache"]
