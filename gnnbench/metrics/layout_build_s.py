"""Host seconds the port takes from the cell's edge list to its device layouts:
``DeviceCSR.from_host_arrays`` (minibatch), or ``Graph.from_edges``, ``with_chunked``
where the model reads the kernel layouts, and the move to the card (full batch)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "set-up: graph layouts"
MOVES = "setup_s"


def read(run):
    return run.layout_build_s
