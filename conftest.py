"""Repo-root pytest hook: restore ``jax.experimental.enable_x64``.

JAX releases after 0.4 moved the x64 scope to ``jax.enable_x64``; the JAX
reference package still imports it from ``jax.experimental``.  Alias it
before any test imports ``repro``.  (Where JAX is not installed there is
nothing to alias.)
"""
try:
    import jax
    import jax.experimental
except ImportError:
    jax = None

if jax is not None and not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
