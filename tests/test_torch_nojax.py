"""The port runs without JAX: the machine with the GPU has none.

A subprocess in which ``jax``, ``flax``, ``optax``, the JAX package and the JAX
benchmarks cannot be imported imports every module of ``dgll_tpu_torch``, trains a
few full-batch epochs through the CLI, runs the full-graph bench on a small
clustered graph through the windowed layout, runs the community pipeline through the
port's own copy of the C++ host kernels, runs both round-4 GAT attention layers,
trains GraphSAGE for two epochs on the CLI's host minibatch path with the feature
cache, fills and fetches from the int8 cache, samples blocks on the device sampler
and runs one epoch of ``DeviceEpochRunner``, one packed epoch in groups of 2, one
epoch of ``PipelinedTrainer``, a ``--preprocess`` run of the CLI, the CLI's device
LADIES and host FastGCN GIN runs and a GIN graph classifier's forward, runs the
probe tool on the CPU, saves and loads a graph, trains bfloat16 GAT on it through
the CLI with a checkpoint and resumes from it, each run inside ``device_trace``, and
runs the GIN graph-classification example, the CLI's ``--n_devices 2`` branch in two
ranks (``--async_dp``), a graph-partition step on one rank, the halo SpMM (plain and
windowed) and the tensor-parallel GCN on one rank, DeepWalk (walks, skip-gram,
classifiers without sklearn) and ``compat.DGraph``. Every module of the package is
imported, ``examples`` included. No source file of the package imports
them either, nor the multi-rank tests' child scripts, and none names a path inside
the JAX package: the port reads no file of it. ``chip_smoke.py`` refuses to run, and prints
no result, without a CUDA device.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import dgll_tpu_torch
from dgll_tpu_torch import native

REPO = Path(__file__).resolve().parents[1]
PACKAGE = Path(dgll_tpu_torch.__file__).resolve().parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dgll_tpu", "benchmarks")

_NO_JAX = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import dgll_tpu_torch
for m in pkgutil.walk_packages(dgll_tpu_torch.__path__, "dgll_tpu_torch."):
    importlib.import_module(m.name)
from dgll_tpu_torch.run import main
out = main(["--samp_type", "full", "--device", "cpu", "--n_node", "300",
            "--n_epochs", "2", "--nhid", "16", "--feat_dim", "8"])
assert out["trials"][0]["epochs"] == 2
import os
os.environ["BENCH_FG_NODES"] = "4096"
from dgll_tpu_torch.bench import clustered_graph, fullgraph_step
r = fullgraph_step("cpu")
assert r["kernel"] == "windowed_hybrid" and r["steps"] == 14, r
from dgll_tpu_torch import native
from dgll_tpu_torch.parallel.community import run_cog
assert native.native_available()
g, book, _ = run_cog(clustered_graph(8192, 4), batch_size=512)
assert g.node_perm is not None and len(book) > 1
import torch
from dgll_tpu_torch.ops import (build_chunked_pair, gat_attention_chunked,
                                gat_attention_chunked_multihead)
c, ct = build_chunked_pair([0, 1, 2, 2], [1, 2, 0, 1], 3, 3)
h = torch.randn(3, 16, requires_grad=True)
a = torch.ones(2, 8)
gat_attention_chunked_multihead(c, ct, h, a, a).sum().backward()
gat_attention_chunked(c, ct, h, torch.ones(16), torch.ones(16)).sum().backward()
assert torch.isfinite(h.grad).all()
out = main(["--Model", "GraphSAGE", "--samp_type", "neighbor", "--device", "cpu",
            "--n_node", "300", "--n_epochs", "2", "--nhid", "16", "--feat_dim", "8",
            "--batch_size", "64", "--cached_nPercent", "50"])
trial = out["trials"][0]
assert trial["epochs"] == 2 and trial["cached_rows"] == 150, trial
import numpy as np
from dgll_tpu_torch.cache import HBMFeatureCache
feats = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
cache = HBMFeatureCache(feats, device="cpu", quantize=True)
cache.fill(np.arange(20))
rows = cache.fetch(np.array([1, 30, 1]))
assert rows.dtype == torch.float32 and torch.equal(rows[1], torch.from_numpy(feats[30]))
from dgll_tpu_torch.nn import GraphSAGE
from dgll_tpu_torch.sampling import DeviceCSR, sample_blocks_device
from dgll_tpu_torch.train import DeviceEpochRunner
g = clustered_graph(2048, 4)
csr = DeviceCSR.from_graph(g, "cpu")
_, _, blocks = sample_blocks_device(csr, torch.arange(16), torch.ones(16, dtype=torch.bool),
                                    [4, 3], torch.Generator().manual_seed(0), window=True)
assert blocks[0].n_src == 16 * 4 * 5 and blocks[-1].n_dst == 16
runner = DeviceEpochRunner(GraphSAGE(128, 16, 128), torch.optim.Adam, csr, [4, 3], 64,
                           np.arange(200))
_, loss = runner.run_epoch(runner.init_state(), g.node_feat, g.labels)
assert runner.n_batches == 4 and torch.isfinite(loss), loss
from dgll_tpu_torch.dataloader import DataLoader
from dgll_tpu_torch.sampling import NeighborSampler
from dgll_tpu_torch.train import MiniBatchTrainer, PipelinedTrainer
tr = MiniBatchTrainer(GraphSAGE(128, 16, 128), torch.optim.Adam, device="cpu")
loader = DataLoader(g, np.arange(96), NeighborSampler([4, 3]), 32, packed=True)
_, loss, _ = tr.run_epoch_packed(tr.init_state(), loader, g.node_feat, g.labels, [4, 3],
                                 group=2)
assert np.isfinite(loss), loss
res = PipelinedTrainer(GraphSAGE(128, 16, 128), torch.optim.Adam, g, NeighborSampler([4, 3]),
                       32, g.node_feat, g.labels, device="cpu").init(np.arange(64)).fit(
                           np.arange(64), epochs=1)
assert np.isfinite(res["history"][0]["loss"]), res
out = main(["--Model", "GraphSAGE", "--samp_type", "neighbor", "--device", "cpu",
            "--n_node", "300", "--n_epochs", "1", "--nhid", "16", "--feat_dim", "8",
            "--batch_size", "64", "--preprocess"])
assert out["trials"][0]["preprocess"] is True
for extra in (["--samp_type", "ladies", "--device_sampling"],
              ["--samp_type", "fastgcn", "--Model", "GIN"]):
    out = main(["--device", "cpu", "--n_node", "300", "--n_epochs", "1", "--nhid", "16",
                "--feat_dim", "8", "--batch_size", "64", "--n_samp", "64", *extra])
    assert np.isfinite(out["trials"][0]["epoch_loss"]).all(), out
from dgll_tpu_torch.data import synthetic_graph_classification
from dgll_tpu_torch.nn import GIN, batch_graphs
gb, gid, y = batch_graphs(synthetic_graph_classification(n_graph=6))
assert GIN(8, 8, 2, pooling=("sum", "max"))(gb, gb.node_feat, gid, 6).shape == (6, 2)
from dgll_tpu_torch.tools import probe
res = probe.main(["--device", "cpu"])
assert res["p4_row_dma"]["ms"] > 0, res
import tempfile
from dgll_tpu_torch.data import load_graph, save_graph, synthetic_classification_graph
from dgll_tpu_torch.examples import graph_classification_gin
from dgll_tpu_torch.utils import device_trace
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "g.graph")
    save_graph(synthetic_classification_graph(n_node=300, feat_dim=8, seed=1), path)
    assert load_graph(path).n_real_node == 300
    ckpt = os.path.join(tmp, "ckpt")
    for resume in ([], ["--resume"]):
        with device_trace(os.path.join(tmp, "trace")):
            out = main(["--Model", "GAT", "--samp_type", "full", "--dtype", "bfloat16",
                        "--dataset", path, "--device", "cpu", "--n_epochs", "1",
                        "--nhid", "4", "--n_heads", "2", "--checkpoint_dir", ckpt,
                        *resume])
    assert out["trials"][0]["resumed_from"] == 1, out
    assert os.listdir(os.path.join(tmp, "trace"))
out = graph_classification_gin.main(["--device", "cpu", "--epochs", "2", "--n_graph", "16"])
assert np.isfinite(out["loss"]), out
os.environ["OMP_NUM_THREADS"] = "1"
out = main(["--Model", "GraphSAGE", "--device", "cpu", "--n_devices", "2", "--n_node", "600",
            "--n_epochs", "1", "--nhid", "8", "--feat_dim", "8", "--batch_size", "32",
            "--async_dp"], timeout=100)
assert out["trials"][0]["n_devices"] == 2, out
from dgll_tpu_torch.parallel import (make_gp_gcn_train_step, make_mesh, partition_graph,
                                     shard_partitioned_graph)
from dgll_tpu_torch.train import create_train_state
mesh = make_mesh()
shard = shard_partitioned_graph(partition_graph(g, 1, strategy="bfs"), mesh,
                                device="cpu")
w = torch.nn.ParameterDict(dict(w=torch.randn(128, int(g.labels.max()) + 1)))
step = make_gp_gcn_train_step(mesh, shard, lambda m, spmm, x, gen: torch.log_softmax(
    spmm(x @ m["w"]), -1))
_, loss = step(create_train_state(w, torch.optim.Adam), shard.node_feat, shard.labels,
               shard.train_mask)
assert torch.isfinite(loss), loss
from dgll_tpu_torch.parallel import (build_halo_plan, build_shard_windowed,
                                     init_tp_gcn_params, make_halo_spmm,
                                     make_halo_spmm_windowed, make_tp_gcn_apply)
pg = partition_graph(g, 1, strategy="bfs")
plan = build_halo_plan(pg)
out = make_halo_spmm(mesh, shard, plan)(shard.node_feat)
win = make_halo_spmm_windowed(mesh, shard, plan, build_shard_windowed(pg))(shard.node_feat)
assert torch.allclose(out, win, atol=1e-5), (out - win).abs().max()
e = g.n_real_edge
tp_out = make_tp_gcn_apply(mesh, g.src[:e].numpy(), g.dst[:e].numpy(), None,
                           g.n_real_node, device="cpu")(
    init_tp_gcn_params(mesh, 128, 16, 4, device="cpu"), g.node_feat[:g.n_real_node])
assert tp_out.shape == (g.n_real_node, 4) and torch.isfinite(tp_out).all()
from dgll_tpu_torch import compat
from dgll_tpu_torch.embedding import DeepWalk, train_all_classifiers
sys.modules["sklearn"] = None  # the card's machine has no sklearn
dw = DeepWalk(synthetic_classification_graph(n_node=100, feat_dim=8, seed=2), walk_length=6,
              num_walks=2, dim=8, device="cpu").train(epochs=1)
labels = np.arange(100) % 3
assert sorted(train_all_classifiers(dw.embeddings, labels)) == sorted([
    "logistic", "tree", "forest", "boosting", "mlp"])
assert compat.DGraph([0, 1], {{0: [1]}}).n_real_edge == 1 and compat.backend is torch
print("NOJAX_OK")
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_and_trains_without_jax():
    proc = _run(["-c", _NO_JAX], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout


def test_no_source_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|dgll_tpu|benchmarks)\b", re.MULTILINE)
    children = sorted((REPO / "tests").glob("_torch_*child.py"))
    assert children  # the multi-rank tests' child scripts import the port only
    offenders = [str(p.relative_to(REPO)) for p in [*PACKAGE.rglob("*.py"), *children]
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert not pattern.search((REPO / "chip_smoke.py").read_text())


def _code_strings(path: Path):
    """The string constants of a Python file that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_no_file_of_the_port_names_a_path_in_the_jax_package():
    """No code string of the package names ``dgll_tpu`` as a path or a path part
    (``Path(...) / "dgll_tpu"``, ``"dgll_tpu/csrc/..."``), no C or C++ source
    includes a file from it, and the host library is built from the package's own
    ``csrc/graph_kernels.cpp``. Docstrings and comments may cite the JAX files."""
    jax_path = re.compile(r"(^|[/\\])dgll_tpu([/\\]|$)")
    offenders = [f"{p.relative_to(REPO)}: {s!r}" for p in PACKAGE.rglob("*.py")
                 for s in _code_strings(p) if jax_path.search(s)]
    include = re.compile(r"^\s*#\s*include\s*[\"<][^\">]*dgll_tpu[/\\]", re.MULTILINE)
    offenders += [str(p.relative_to(REPO)) for p in (PACKAGE / "csrc").iterdir()
                  if include.search(p.read_text())]
    assert offenders == []
    assert native.SOURCE == PACKAGE / "csrc" / "graph_kernels.cpp"
    assert native.SOURCE.exists() and native.BUILD_DIR.parent.parent == REPO
    assert jax_path.search(str(Path("dgll_tpu") / "csrc"))   # the pattern bites
    assert not jax_path.search("dgll_tpu_torch/csrc")


def test_chip_smoke_fails_without_a_card():
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
