"""Measurement scripts for the port, run as ``python -m dgll_tpu_torch.tools.<name>``."""
