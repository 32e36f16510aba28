"""Parity of the port's primitive probes with ``benchmarks/pallas_probe_r4.py``.

The script is loaded from its file (it is not a package module), with its
module-level ``INTERPRET = True`` so that its Pallas kernels run in interpret mode on
the CPU, at its own off-TPU sizes (N 4096, E 8192). The same arrays, made with numpy
from a seed, go through each JAX probe and through ``dgll_tpu_torch.ops.probes`` on
CPU tensors, which run the plain PyTorch versions. Tolerances: P0, P2 and P4 exact;
P2b within rtol 1e-5 (the script's bar) and exact on the CPU; P3 within rtol 1e-4 and
atol 1e-6 (sums in another order). On CPU tensors no launch counter moves, and the
launchers of ``ops/cuda/probes.py`` take CUDA tensors only. The probe tool on the CPU
returns exactly the script's JSON keys.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dgll_tpu_torch.ops import probes
from dgll_tpu_torch.ops.cuda import probes as kernels
from dgll_tpu_torch.tools import probe as tool
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / "pallas_probe_r4.py"
N, E = 4096, 8192
NAMES = ("p0_copy", "p2_dynread", "p2b_onehot", "p3_dynacc", "p4_dma")


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("pallas_probe_r4", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


@pytest.fixture(scope="module")
def data(script):
    """The script's arrays at its interpret sizes, from numpy: ``(inputs of each
    probe, JAX outputs)``."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    nc = E // script.EB
    x32 = rng.normal(size=(N, script.F)).astype(np.float32)
    inputs = {
        "p0_copy": (rng.normal(size=(E, script.F)).astype(np.float32),),
        "p2_dynread": (rng.integers(0, script.WIN, (nc, script.EB)).astype(np.int32),
                       x32[:script.WIN]),
        "p3_dynacc": (rng.integers(0, script.OUT_TILE, (nc, script.EB)).astype(np.int32),
                      rng.normal(size=(E, script.F)).astype(np.float32)),
        "p4_dma": (rng.integers(0, N, (nc, script.EB)).astype(np.int32), x32),
    }
    inputs["p2b_onehot"] = (inputs["p2_dynread"][0].reshape(-1, 1), x32[:script.WIN])
    fns = {"p0_copy": script.p0_copy, "p2_dynread": script.p2_dynread,
           "p2b_onehot": script.p2b_onehot, "p3_dynacc": script.p3_dynacc,
           "p4_dma": script.p4_dma}
    want = {k: np.asarray(fns[k](*map(jnp.asarray, inputs[k]))[0]) for k in NAMES}
    return inputs, want


def _port(name, args):
    return getattr(probes, name)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))


@pytest.mark.parametrize("name", ["p0_copy", "p2_dynread", "p4_dma"])
def test_gathers_and_copy_equal_jax(data, name):
    inputs, want = data
    got = _port(name, inputs[name])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want[name])


def test_onehot_matches_jax(data):
    inputs, want = data
    got = _port("p2b_onehot", inputs["p2b_onehot"]).numpy()
    np.testing.assert_allclose(got, want["p2b_onehot"], rtol=1e-5)
    idx, win = inputs["p2b_onehot"]
    np.testing.assert_array_equal(got, win[idx[:, 0]])   # exact on the CPU


def test_onehot_plain_version_in_blocks(monkeypatch):
    """The plain version builds its one-hot block by block; a block size that does not
    divide E gives the same rows, and an index outside the window gives a zero row."""
    rng = np.random.default_rng(3)
    win = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    idxv = torch.from_numpy(rng.integers(0, 16, (37, 1)).astype(np.int32))
    idxv[5] = 16
    monkeypatch.setattr(probes, "ONEHOT_BYTES", 16 * 4 * 3)
    got = probes.p2b_onehot(idxv, win)
    want = win[idxv[:, 0].clamp(max=15).long()]
    want[5] = 0
    assert torch.equal(got, want)


def test_dynacc_matches_jax(data):
    inputs, want = data
    got = _port("p3_dynacc", inputs["p3_dynacc"])
    assert tuple(got.shape) == (probes.OUT_TILE, 128)
    np.testing.assert_allclose(got.numpy(), want["p3_dynacc"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_counts_no_launch(data, name):
    inputs, _ = data
    before = dict(kernels.launches)
    _port(name, inputs[name])
    assert kernels.launches == before


@pytest.mark.parametrize("name", NAMES)
def test_launchers_take_cuda_tensors_only(data, name):
    inputs, _ = data
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in inputs[name]]
    if name == "p3_dynacc":
        args.append(probes.OUT_TILE)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, f"{name}_cuda")(*args)


def test_other_devices_raise():
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        probes.p0_copy(x)


def test_tool_on_cpu_has_the_scripts_keys(capsys):
    res = tool.main(["--device", "cpu"])
    rows = ("p0_stream_copy", "p1_take_f32", "p1_take_bf16", "p1_take_f32_sorted",
            "p2_dynread", "p2b_onehot", "p3_dynacc", "p4_row_dma")
    assert set(res) == {"device", "N", "F", "E", "EB", "dispatch_overhead_ms", *rows}
    assert (res["device"], res["N"], res["E"], res["EB"], res["F"]) == ("cpu", N, E, 512, 128)
    for row in rows:
        assert set(res[row]) == {"ms", "ns_per_row", "gbps"}
        assert all(np.isfinite(v) and v > 0 for v in res[row].values())
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"device": "cpu"')


def test_tool_data_follow_the_script():
    d = tool.make_data(torch.device("cpu"), seed=1)
    nc = E // 512
    assert tuple(d["x32"].shape) == (N, 128) and d["x16"].dtype == torch.bfloat16
    assert torch.equal(d["win"], d["x32"][:256])
    for key, hi in (("idx_chunk", 256), ("idx_out", probes.OUT_TILE), ("idx_hbm", N)):
        assert d[key].shape == (nc, 512) and d[key].dtype == torch.int32
        assert 0 <= int(d[key].min()) and int(d[key].max()) < hi
    assert torch.equal(d["idx_sorted"], torch.sort(d["idx_flat"]).values)
    assert torch.equal(tool.make_data(torch.device("cpu"), seed=1)["msg"], d["msg"])


@pytest.mark.parametrize("bad", [-1, probes.OUT_TILE])
def test_ids_outside_their_table_raise(bad):
    """The kernels do not check their ids; ``check_index`` does, before the timed
    calls, and the tool's data pass it."""
    d = tool.make_data(torch.device("cpu"), seed=2)
    tool.check_ids(d)
    idx = d["idx_out"].clone()
    idx[1, 3] = bad
    with pytest.raises(ValueError, match="outside a table of 8192 rows"):
        kernels.check_index("idx_out", idx, probes.OUT_TILE)
    with pytest.raises(ValueError, match="idx_out"):
        tool.check_ids({**d, "idx_out": idx})


def test_tool_raises_on_a_wrong_probe():
    want = torch.ones(4, 4)
    with pytest.raises(AssertionError, match="p0_copy"):
        tool.max_error("p0_copy", want + 1e-7, want)
    with pytest.raises(AssertionError, match="p2b_onehot"):
        tool.max_error("p2b_onehot", want * (1 + 2e-5), want)
    assert tool.max_error("p3_dynacc", want * (1 + 5e-5), want) > 0


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--device", "cuda"])
