"""Hand-written CUDA kernels and their wrappers.

Nothing here compiles or touches a GPU when it is imported: ``build.py`` runs
``nvcc`` on the first launch.
"""
