"""Meshes over the ranks of a world, counterpart of ``repro.launch``'s
``mesh`` module (the JAX package's other launchers are its CLI shims)."""
