"""Minibatch GraphSAGE with uniform neighbour sampling on the host (the reference's
``graphsage.py``):

    python -m dgll_tpu_torch.examples.minibatch_graphsage [--fanouts 10,5 --batch_size 512 ...]

The training CLI with ``--Model GraphSAGE --samp_type neighbor``.
"""
from dgll_tpu_torch.examples._cli import run_cli


def main(argv=None) -> dict:
    return run_cli(["--Model", "GraphSAGE", "--samp_type", "neighbor"], argv)


if __name__ == "__main__":
    main()
