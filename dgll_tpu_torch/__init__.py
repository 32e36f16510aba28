"""dgll_tpu_torch: the PyTorch and CUDA port of ``dgll_tpu``.

It keeps the JAX package's module paths and public names, so each part has an
obvious counterpart there. It imports torch and numpy, never JAX. The kernels it
writes by hand for the GPU live in ``csrc/`` and are built on first use
(``ops/cuda/build.py``).
"""
from dgll_tpu_torch.graph import Graph, pad_graph

__version__ = "0.1.0"

__all__ = ["Graph", "pad_graph", "__version__"]
