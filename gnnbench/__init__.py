"""The benchmark of ``dgll_tpu_torch`` on one NVIDIA H100.

    python -m gnnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python -m gnnbench.run --list
    python -m gnnbench.run --dry-run --workload <cell>     # tiny, on the CPU

A cell (``workloads/<cell>.json``) names a model configuration (``configs/<name>.json``,
whose ``arch`` names the module of ``arch/`` that builds the port's model and holds its
plain reference) and a traffic mix (``traffic/<name>.json``: the graph's sizes and the
training mode, which names the driver in ``modes/``). Each per-layer metric is a
reader of its own in ``metrics/``. The harness finds every one of them by its name, so
a new cell, configuration, traffic mix or metric is a new file.

The yardstick lives here and nowhere in the program: the graph generator
(``traffic.py``), the weights (``arch/``), the plain references, Adam and the frozen
sampling rule (``reference.py``), the comparison that decides ``correct``
(``check.py``), the peaks and the operation and byte counts (``counts.py``) and the
reduction of the profiler's trace (``trace.py``). Nothing here imports JAX or the JAX
package; the port is driven through its library API only.
"""
