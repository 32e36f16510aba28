"""Layer-wise importance-sampled GCN training, FastGCN or LADIES with the flat and
without-replacement variants (the reference's MQFastGCN*/MQLadies* scripts):

    python -m dgll_tpu_torch.examples.layerwise_fastgcn --samp_type fastgcn --n_samp 512
    python -m dgll_tpu_torch.examples.layerwise_fastgcn --samp_type ladies --flatten --wrs

The training CLI with ``--Model GCN`` and ``--samp_type fastgcn`` unless given.
"""
import sys

from dgll_tpu_torch.examples._cli import run_cli


def main(argv=None) -> dict:
    args = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--samp_type") for a in args):
        args = ["--samp_type", "fastgcn"] + args
    return run_cli(["--Model", "GCN"], args)


if __name__ == "__main__":
    main()
