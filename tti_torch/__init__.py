"""PyTorch/CUDA port of the textile inspection step for one NVIDIA H100.

Mirrors ``tti``'s subpackage and function names so each function has a
findable counterpart. Imports nothing of ``tti`` and never imports jax: what
it needs from jax-free ``tti`` modules is copied here. Entry points take a
``device`` argument that defaults to ``"cuda"``.
"""
