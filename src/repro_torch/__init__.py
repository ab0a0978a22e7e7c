"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The layout mirrors ``src/repro/`` module by module (``configs``, ``core``,
``kernels``, ``models``, ``serve``, ``launch``) so each counterpart is
found by its path.  The package imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro`` — and its entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
