"""Runnable examples of the port, counterparts of the JAX package's ``examples/``:
``python -m dgll_tpu_torch.examples.<name> [flags]``. Each has ``main(argv)``,
which returns what it prints, runs on the CUDA device unless ``--device cpu`` is
given, and takes flags that shrink it to a quick run."""
