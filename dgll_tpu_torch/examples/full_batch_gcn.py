"""Full-batch GCN training (the reference's ``examples/gcn``):

    python -m dgll_tpu_torch.examples.full_batch_gcn [--dataset synthetic --n_epochs 100 ...]

With a planetoid directory (``--dataset path/to/cora``) this is the
cora/citeseer/pubmed flow; the synthetic default runs the same pipeline without
data files. The training CLI with ``--Model GCN --samp_type full``.
"""
from dgll_tpu_torch.examples._cli import run_cli


def main(argv=None) -> dict:
    return run_cli(["--Model", "GCN", "--samp_type", "full"], argv)


if __name__ == "__main__":
    main()
