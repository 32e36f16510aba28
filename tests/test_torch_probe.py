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

P2b's kernel (``csrc/probes.cu`` ``onehot_kernel``) cannot run here, so a plain model
of its arithmetic stands in for it: the window split into three bfloat16 parts cut
toward zero (``split3``), padded to K steps of 16 rows and M tiles of 64 rows, and one
float32 product of the one-hot rows with each part a K step, added in the kernel's
order. It must equal the plain version bitwise (a zero's sign aside) over the range
where the split is exact, 2^-103 <= |x| <= FLT_MAX, and JAX's ``p2b_onehot``
(interpret) within rtol 1e-5. These tests import no ``triton`` and launch nothing.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from dgll_tpu_torch.ops import probes
from dgll_tpu_torch.ops.cuda import probes as kernels
from dgll_tpu_torch.tools import probe as tool
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / "pallas_probe_r4.py"
N, E = 4096, 8192
NAMES = ("p0_copy", "p2_dynread", "p2b_onehot", "p3_dynacc", "p4_dma")


def _load_script(**constants):
    """The script as a fresh module, in interpret mode, with its module-level
    ``constants`` (``WIN``, ``F``) replaced: its functions read them when called."""
    spec = importlib.util.spec_from_file_location("pallas_probe_r4", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    for name, value in constants.items():
        setattr(mod, name, value)
    return mod


@pytest.fixture(scope="module")
def script():
    return _load_script()


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


# ---- P2b's kernel, modelled: csrc/probes.cu split3 and onehot_kernel
SMEM_BYTES = 232_448      # shared memory a block can take on the H100
FLT_MAX = float(np.finfo(np.float32).max)


def _cut(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` cut toward zero to bfloat16 (its low 16 bits cleared), as float32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _split3(x: torch.Tensor):
    """The kernel's ``split3``: hi = x cut, mid = (x - hi) cut, lo = (x - hi - mid) cut,
    each a float32 tensor of bfloat16 values (the kernel keeps their high 16 bits)."""
    hi = _cut(x)
    r = x - hi
    mid = _cut(r)
    return hi, mid, _cut(r - mid)


def _column_slice(win_rows: int, f: int) -> int:
    """``dgll_probe_onehot``'s pass width: the widest of 128, 64, 32, 16 that divides F
    and whose three parts of the padded window fit in shared memory."""
    kp = -(-win_rows // 16) * 16
    ns = 128
    while ns >= 16 and (f % ns or 3 * kp * ns * 2 > SMEM_BYTES):
        ns //= 2
    return ns


def _onehot_model(idxv: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """``onehot_kernel``'s arithmetic on the CPU. The window is padded with zero rows
    to a multiple of 16 and split into its three parts; E is padded to M tiles of 64
    rows whose index is -1. For each column slice and each K step of 16 window rows,
    the step's one-hot A meets hi, mid and lo in that order, each an f32 product of
    (rows, 16) by (16, slice) added to the f32 sums (the first product replaces
    them, as ``scale_d`` 0 does)."""
    e, (win_rows, f) = idxv.shape[0], win.shape
    kp, rows = -(-win_rows // 16) * 16, -(-e // 64) * 64
    ids = torch.full((rows,), -1, dtype=torch.int64)
    ids[:e] = idxv[:, 0].long()
    padded = torch.zeros(kp, f, dtype=torch.float32)
    padded[:win_rows] = win
    parts = _split3(padded)
    ns = _column_slice(win_rows, f)
    out = torch.empty(rows, f, dtype=torch.float32)
    for n0 in range(0, f, ns):
        acc = None
        for k0 in range(0, kp, 16):
            a = (ids[:, None] == torch.arange(k0, k0 + 16)[None, :]).float()
            for part in parts:
                prod = a @ part[k0:k0 + 16, n0:n0 + ns]
                acc = prod if acc is None else acc + prod
        out[:, n0:n0 + ns] = acc
    return out[:e]


def _wide_window(rng, win_rows: int, f: int) -> np.ndarray:
    """Values of either sign whose magnitudes spread log-uniformly over the split's
    exact range, 2^-103 .. FLT_MAX."""
    mag = np.exp2(rng.uniform(-103.0, 127.99, (win_rows, f)))
    return (mag * rng.choice([-1.0, 1.0], (win_rows, f))).astype(np.float32)


def _onehot_ids(rng, e: int, win_rows: int) -> np.ndarray:
    """Ids in and just past the window (in its padding to 16 rows and beyond), the
    first far outside it and, where there is one, the last negative."""
    idx = rng.integers(0, win_rows + 12, (e, 1)).astype(np.int32)
    idx[0] = win_rows + 100
    if e > 1:
        idx[-1] = -3
    return idx


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bitwise equal, a zero's sign aside (adding +0 turns -0 into +0)."""
    return torch.equal((got + 0.0).view(torch.int32), (want + 0.0).view(torch.int32))


@pytest.mark.parametrize("f", [32, 96, 128, 192])
@pytest.mark.parametrize("win_rows", [8, 256, 264])
@pytest.mark.parametrize("e", [1, 63, 64, 65, 1000])
def test_onehot_kernel_model_equals_plain_version(e, win_rows, f):
    rng = np.random.default_rng(e * 1000 + win_rows + f)
    idxv = torch.from_numpy(_onehot_ids(rng, e, win_rows))
    win = torch.from_numpy(_wide_window(rng, win_rows, f))
    got = _onehot_model(idxv, win)
    want = probes.p2b_onehot_reference(idxv, win)
    assert _same_bits(got, want)
    inside = (idxv[:, 0] >= 0) & (idxv[:, 0] < win_rows)
    assert torch.equal(got[inside], win[idxv[inside, 0].long()])
    assert not got[~inside].any()


@pytest.mark.parametrize("win_rows,f", [(8, 32), (256, 128), (264, 96), (264, 192)])
def test_onehot_kernel_model_matches_jax(win_rows, f):
    """Against the script's TPU kernel, at E a multiple of its EB = 512 rows (it cuts E
    into chunks of 512), the window at the script's WIN and F or at others."""
    import jax.numpy as jnp

    mod = _load_script(WIN=win_rows, F=f)
    rng = np.random.default_rng(win_rows + f)
    idxv = _onehot_ids(rng, 2 * mod.EB, win_rows)
    win = rng.normal(size=(win_rows, f)).astype(np.float32)
    want = np.asarray(mod.p2b_onehot(jnp.asarray(idxv), jnp.asarray(win))[0])
    got = _onehot_model(torch.from_numpy(idxv), torch.from_numpy(win)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_onehot_column_slices():
    """The pass width follows F and the window's size: one pass of 128 at the probe's
    shape, slices where 128 does not divide F or the parts would not fit."""
    assert _column_slice(256, 128) == 128
    assert (_column_slice(256, 96), _column_slice(256, 192)) == (32, 64)
    assert (_column_slice(264, 128), _column_slice(1448, 32)) == (128, 16)


ALL_BITS = [
    FLT_MAX, -FLT_MAX,                                  # huge: all 24 bits set
    float(np.float32(2.0 ** -103 * (2 - 2.0 ** -23))),  # tiny: all 24 bits set
    2.0 ** -103, -(2.0 ** 24 - 1), float(np.float32(1.9999999)), 1.0, -0.0, 0.0,
    float(np.float32(3.3961e38)),                       # where rounding to nearest overflows
]


@pytest.mark.parametrize("x", ALL_BITS)
def test_onehot_split_is_exact_at_the_edges(x):
    t = torch.tensor([x], dtype=torch.float32)
    hi, mid, lo = _split3(t)
    r = t - hi
    assert torch.equal(lo, r - mid)                # the last part lost no bit
    assert _same_bits((hi + mid) + lo, t)
    assert bool((hi.abs() <= t.abs()).all()) and bool(torch.isfinite(hi).all())


@settings(max_examples=300, derandomize=True, database=None, deadline=None)
@given(st.floats(min_value=2.0 ** -103, max_value=FLT_MAX, width=32), st.booleans())
@example(FLT_MAX, True)
@example(2.0 ** -103, False)
def test_onehot_split_restores_float32(mag, negative):
    """Over the normal magnitudes the split keeps (2^-103 .. FLT_MAX), every part is a
    bfloat16 value, the last part is exact, and hi + mid + lo, added in the kernel's
    order, gives x back bit for bit."""
    x = torch.tensor([-mag if negative else mag], dtype=torch.float32)
    hi, mid, lo = _split3(x)
    for part in (hi, mid, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    assert torch.equal(lo, (x - hi) - mid)
    assert torch.equal((hi + mid) + lo, x)


@pytest.mark.parametrize("idx_shape,win_shape", [((40,), (256, 128)), ((40, 2), (256, 128)),
                                                  ((40, 1), (12, 128)), ((40, 1), (256, 48)),
                                                  ((40, 1), (256,))])
def test_onehot_launcher_refuses_bad_shapes(idx_shape, win_shape):
    idxv = torch.zeros(idx_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="p2b_onehot: need idxv"):
        kernels.p2b_onehot_cuda(idxv, torch.zeros(win_shape))


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
