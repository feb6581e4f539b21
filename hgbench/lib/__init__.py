"""The benchmark's own code: loading by name, generators' helpers, trace
reduction, statistics. Nothing here imports JAX or the JAX package."""
