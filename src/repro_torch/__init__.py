"""PyTorch + CUDA port of the DeepFFM serving stack (``repro``).

The package mirrors ``repro`` module for module (``repro_torch/core/ffm.py``
is the counterpart of ``repro/core/ffm.py``). Plain tensor code is PyTorch;
every Pallas kernel of the JAX package on this port's path is a CUDA C++
kernel for ``sm_90a`` under ``csrc/``, built at first use by
``kernels/_build.py``. Entry points run on the card unless the caller passes
``device="cpu"``, which selects the kernels' plain PyTorch versions.

The package imports neither ``jax`` nor ``repro``.
"""
