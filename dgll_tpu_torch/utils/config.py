"""Config / flag system. Counterpart of ``dgll_tpu/utils/config.py``: the same flags,
plus ``--device``.

Canonical flag-set parity with the reference CLIs (SURVEY.md §5):
``GPU Accelerator/ReadME.md:14-52`` (--dataset --samp_type --Model --n_samp --nhid
--n_epochs --n_stops --batch_size --n_trial --record_f1 --samp_growth_rate
--batch_num --n_layers), community-trainer flags (``CommGCN.py:5-24``:
--cached_nPercent --fanouts --o_iters --lr --dropout), FeatureCache flags
(``FeatureCache/gcn.py:115-147``). One dataclass and one argparse setup, shared by
every example and CLI instead of per-script copies.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields
from typing import List, Optional


@dataclass
class TrainConfig:
    dataset: str = "synthetic"
    model: str = "GCN"              # GCN | GAT | GraphSAGE | GIN | GCNII
    sampler: str = "neighbor"       # neighbor | fastgcn | ladies | full
    n_samp: int = 512               # layer-wise sample size
    samp_growth_rate: float = 1.0   # geometric layer growth (flat variants)
    flatten: bool = False           # sqrt-flattened probabilities (+f)
    wrs: bool = False               # weighted reservoir sampling (+wrs)
    fanouts: List[int] = field(default_factory=lambda: [10, 5])
    nhid: int = 128
    n_layers: int = 2
    n_heads: int = 8
    dropout: float = 0.5
    lr: float = 1e-2
    weight_decay: float = 0.0
    n_epochs: int = 100
    n_stops: int = 20               # early-stop patience (epochs w/o val improvement)
    batch_size: int = 1024
    n_trial: int = 1
    record_f1: bool = True
    cached_percent: float = 0.0     # fraction of nodes feature-cached in HBM
    n_parts: int = 1                # COG community partitions
    n_devices: int = 1              # data-parallel mesh devices (ref --n_gpus)
    async_dp: bool = False          # one-step-stale gradient application (RaCoM)
    preprocess: bool = False        # offline neigh-feature aggregation (ref gs.py)
    device_sampling: bool = False   # CSR in HBM; epoch = one scanned dispatch
    window_sampling: bool = False   # block-window draws (device_sampling only; opt-in
                                    # speed mode — within-node draws share one 128-lane
                                    # CSR window, so they are correlated, a deviation
                                    # from the reference's i.i.d. uniform sampling)
    sage_aggregator: str = "mean"   # SAGEConv neighbour aggregator (ref
                                    # NeighborAggregator: mean|sum|max)
    sage_combine: str = "concat"    # SAGEConv combine (ref: concat|sum)
    alpha: float = 0.1              # GCNII's initial residual (the authors' --alpha)
    lamda: float = 0.5              # GCNII's identity mapping, beta_l = ln(lamda/l + 1)
    exact_eval: bool = False        # final test metric via full-neighborhood
                                    # inference (train/exact_infer.py) instead
                                    # of the sampled sweep
    seed: int = 0
    dtype: str = "float32"
    checkpoint_dir: Optional[str] = None
    resume: bool = False            # restore latest checkpoint before training
    log_file: Optional[str] = None
    device: str = "cuda"            # torch device the run trains on

    # synthetic dataset knobs
    n_node: int = 10000
    avg_degree: int = 10
    n_class: int = 16
    feat_dim: int = 128


def add_train_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = TrainConfig()
    p.add_argument("--dataset", default=d.dataset)
    p.add_argument("--Model", "--model", dest="model", default=d.model)
    p.add_argument("--samp_type", "--sampler", dest="sampler", default=d.sampler)
    p.add_argument("--n_samp", type=int, default=d.n_samp)
    p.add_argument("--samp_growth_rate", type=float, default=d.samp_growth_rate)
    p.add_argument("--flatten", action="store_true")
    p.add_argument("--wrs", action="store_true")
    p.add_argument("--fanouts", type=lambda s: [int(x) for x in s.split(",")],
                   default=d.fanouts)
    p.add_argument("--nhid", type=int, default=d.nhid)
    p.add_argument("--n_layers", type=int, default=d.n_layers)
    p.add_argument("--n_heads", type=int, default=d.n_heads)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--n_epochs", type=int, default=d.n_epochs)
    p.add_argument("--n_stops", type=int, default=d.n_stops)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--n_trial", type=int, default=d.n_trial)
    p.add_argument("--record_f1", action="store_true", default=d.record_f1)
    p.add_argument("--cached_nPercent", "--cached_percent", dest="cached_percent",
                   type=float, default=d.cached_percent)
    p.add_argument("--n_parts", type=int, default=d.n_parts)
    p.add_argument("--n_gpus", "--n_devices", dest="n_devices", type=int,
                   default=d.n_devices)
    p.add_argument("--async_dp", action="store_true")
    p.add_argument("--preprocess", action="store_true")
    p.add_argument("--device_sampling", action="store_true")
    p.add_argument(
        "--window_sampling", dest="window_sampling", action="store_true",
        default=d.window_sampling,
        help="device-sampling speed mode: draw each node's neighbors from ONE "
             "random 128-lane CSR window (fewer HBM row gathers, ~7%% faster "
             "epochs at products scale). Within-node draws are correlated — a "
             "statistical deviation from exact i.i.d. neighbor sampling; "
             "convergence parity evidence: benchmarks/results/window_ab_r4.json")
    p.add_argument("--sage_aggregator", default=d.sage_aggregator,
                   choices=["mean", "sum", "max"])
    p.add_argument("--sage_combine", default=d.sage_combine,
                   choices=["concat", "sum"])
    p.add_argument("--alpha", type=float, default=d.alpha,
                   help="GCNII: the initial residual's weight")
    p.add_argument("--lamda", type=float, default=d.lamda,
                   help="GCNII: the identity mapping's beta_l = ln(lamda / l + 1)")
    p.add_argument("--exact_eval", action="store_true")
    p.add_argument("--no_window_sampling", dest="window_sampling",
                   action="store_false", help="exact per-slot i.i.d. draws (default)")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--dtype", default=d.dtype)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log_file", default=None)
    p.add_argument("--device", default=d.device,
                   help="torch device to train on (cuda, cuda:N or cpu)")
    p.add_argument("--n_node", type=int, default=d.n_node)
    p.add_argument("--avg_degree", type=int, default=d.avg_degree)
    p.add_argument("--n_class", type=int, default=d.n_class)
    p.add_argument("--feat_dim", type=int, default=d.feat_dim)
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    names = {f.name for f in fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in vars(args).items() if k in names})


def parse_train_config(argv=None) -> TrainConfig:
    p = argparse.ArgumentParser(description="dgll_tpu_torch trainer")
    add_train_flags(p)
    return config_from_args(p.parse_args(argv))
