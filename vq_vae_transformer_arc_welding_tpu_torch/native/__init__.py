"""Native (C++) host-side components of the port, loaded via ctypes.

The port's own copies of the JAX package's native sources that its
ported modules use (the CSV parser; the batch gather waits with the
streaming data module). Built at first use (g++ -O3 -shared) into the
git-ignored `_build/` beside `csrc/`; callers fall back to pure-Python
paths, loudly, when no compiler is available.
"""
