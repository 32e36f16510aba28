"""The examples that are the training CLI with some flags fixed."""
from __future__ import annotations

from typing import List, Optional, Sequence


def run_cli(fixed: Sequence[str], argv: Optional[List[str]]) -> dict:
    """``dgll_tpu_torch.run.main`` on ``fixed`` followed by ``argv`` (default: the
    command line's arguments), so that a later flag overrides a fixed one."""
    import sys

    from dgll_tpu_torch.run import main

    return main(list(fixed) + list(sys.argv[1:] if argv is None else argv))
