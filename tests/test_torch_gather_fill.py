"""P4's bucketed row gather and K8's whole int8 fill, on the CPU.

P4's launcher plan is a pure function of (rows, F, E). The plain emulation of its
bucketed path (the bucket pass's counts, the buckets' first slots, each block's run,
the gather in bucket order and the rows put back) equals the JAX probe's ``p4_dma``
(``benchmarks/pallas_probe_r4.py``, loaded as ``test_torch_probe.py`` loads it, in
interpret mode) exactly: ids spread over the table, ids in one bucket only, ids in
the last, partial bucket, and fewer ids than one 512-id chunk. K8's plain fill, the
column max over row tiles and then over the tiles, equals ``column_scale`` bitwise,
with a column of zeros (scale 1e-12 / 127) and a column with a NaN (scale NaN, values
0), and equals JAX's ``quantize_int8`` and ``quantize_int8_pallas`` (interpret).
Tolerance: none; a NaN scale equals any NaN, since the CPU's reductions give a NaN
other bits from one shape to another (torch's ``amax`` over the columns of a
[3, 256] array gives 0xFFFFFFFF where over one column it gives JAX's 0x7FC00000).
The CUDA-only launchers reject CPU tensors, and the quantizers on the CPU count no
launch.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops import quantize as jq
from dgll_tpu_torch.cache import HBMFeatureCache
from dgll_tpu_torch.ops import probes
from dgll_tpu_torch.ops import quantize as tq
from dgll_tpu_torch.ops.cuda import probes as kp
from dgll_tpu_torch.ops.cuda import quantize as k8
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / "pallas_probe_r4.py"
# (rows, F, E): the probe's own size, GAT's gather, item 1's feature gather, a table
# in L2, 2 and 1.9 draws a row, tables at the limit of the rule, narrow and wide rows
PLAN_SHAPES = [(500_000, 128, 1 << 22), (200_000, 64, 5_369_806), (2_400_000, 100, 169_984),
               (4096, 128, 8192), (500_000, 128, 1_000_000), (500_000, 128, 950_000),
               (62_500, 128, 1 << 20), (62_501, 128, 1 << 20), (1_000_000, 4, 1 << 24),
               (100, 1 << 20, 1000)]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("pallas_probe_r4", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


# ------------------------------------------------------------------ P4's plan
@pytest.mark.parametrize("rows,f,e", PLAN_SHAPES)
def test_p4_plan_is_the_rule(rows, f, e):
    plan = probes.p4_plan(rows, f, e)
    assert plan == probes.p4_plan(rows, f, e)
    table = rows * f * 4
    assert plan.bucketed == (table > probes.P4_DIRECT_TABLE_BYTES
                             and e >= probes.P4_MIN_DRAWS * rows and f % 32 == 0)
    if plan.bucketed:
        assert plan == probes.p4_bucketed_plan(rows, f)
        launch = probes.P4_BUCKETED_LAUNCH
    else:
        assert plan == probes.P4Plan(bucketed=False)
        launch = probes.P4_DIRECT_LAUNCH
    assert (plan.blocks_per_sm, plan.threads, plan.unroll) == launch
    assert plan.threads % 32 == 0 and plan.threads <= 256 and plan.unroll in (4, 8, 16)


def test_p4_plan_paths_at_the_measured_shapes():
    assert probes.p4_plan(500_000, 128, 1 << 22).bucketed          # the probe's
    assert probes.p4_plan(200_000, 64, 5_369_806).bucketed         # GAT's h[src]
    assert not probes.p4_plan(2_400_000, 100, 169_984).bucketed    # item 1's: E < rows
    assert not probes.p4_plan(2_400_000, 100, 7_200_000).bucketed  # 400-byte rows
    assert not probes.p4_plan(4096, 128, 8192).bucketed            # a table in L2


def test_p4_sweep_needs_a_card(monkeypatch):
    from dgll_tpu_torch.tools import p4_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        p4_sweep.main([])


@pytest.mark.parametrize("rows,f,e", PLAN_SHAPES)
def test_p4_bucket_sizes(rows, f, e):
    """Buckets of a power of two of rows, whose bytes fit ``P4_BUCKET_BYTES`` unless
    one row is larger or the count would pass ``P4_MAX_BUCKETS``; they cover the
    table, the last one perhaps in part."""
    plan = probes.p4_bucketed_plan(rows, f)
    size = 1 << plan.shift
    assert plan.buckets == -(-rows // size) <= probes.P4_MAX_BUCKETS
    assert (plan.buckets - 1) * size < rows <= plan.buckets * size
    fit = max(0, (probes.P4_BUCKET_BYTES // (4 * f)).bit_length() - 1)
    assert plan.shift >= fit
    if plan.shift > fit:   # coarser only where the fit would make too many buckets
        assert -(-rows // (size >> 1)) > probes.P4_MAX_BUCKETS
    elif plan.shift > 0:
        assert size * 4 * f <= probes.P4_BUCKET_BYTES < 2 * size * 4 * f


# ------------------------------------------------- P4's bucketed path, emulated
def _bucket_pass_by_loops(ids: np.ndarray, shift: int, buckets: int) -> np.ndarray:
    """The bucket pass as the kernels run it, one step at a time: each block's
    counts, their totals, the buckets' first slots, each block's run reserved from
    its bucket's cursor (blocks in order) and its positions written there."""
    span = probes.P4_SPAN
    blocks = [range(lo, min(lo + span, len(ids))) for lo in range(0, len(ids), span)]
    local = [np.bincount(ids[list(b)] >> shift, minlength=buckets) for b in blocks]
    totals = np.sum(local, axis=0) if local else np.zeros(buckets, np.int64)
    cursor = np.concatenate([[0], np.cumsum(totals)[:-1]])
    order = np.full(len(ids), -1, np.int64)
    for block, counts in zip(blocks, local):
        base = cursor.copy()
        cursor += counts
        for p in block:
            b = ids[p] >> shift
            order[base[b]] = p
            base[b] += 1
    return order


CASES = {  # (table rows, ids' lowest, highest + 1, chunks of EB ids, EB)
    "spread": (4096, 0, 4096, 8, 512),
    "one bucket": (4096, 128, 192, 8, 512),
    "last partial bucket": (4000, 3968, 4000, 8, 512),
    "below one chunk": (4096, 0, 4096, 8, 16),
}


@pytest.mark.parametrize("case", CASES)
def test_p4_bucket_order_follows_the_kernels_steps(case):
    rows, lo, hi, nc, eb = CASES[case]
    ids = np.random.default_rng(1).integers(lo, hi, nc * eb + 3).astype(np.int32)
    plan = probes.p4_bucketed_plan(rows, 128, bucket_bytes=64 * 512)   # 64 rows a bucket
    assert plan.shift == 6 and plan.buckets == -(-rows // 64)
    order = probes.p4_bucket_order(torch.from_numpy(ids), plan)
    np.testing.assert_array_equal(order.numpy(), _bucket_pass_by_loops(ids, 6, plan.buckets))
    assert sorted(order.tolist()) == list(range(len(ids)))


@pytest.mark.parametrize("case", CASES)
def test_p4_bucketed_path_equals_jax(script, monkeypatch, case):
    rows, lo, hi, nc, eb = CASES[case]
    monkeypatch.setattr(script, "EB", eb)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(rows, script.F)).astype(np.float32)
    idx = rng.integers(lo, hi, (nc, eb)).astype(np.int32)
    want = np.asarray(script.p4_dma(jnp.asarray(idx), jnp.asarray(x))[0])
    plan = probes.p4_bucketed_plan(rows, script.F, bucket_bytes=64 * 4 * script.F)
    ti, tx = torch.from_numpy(idx), torch.from_numpy(x)
    np.testing.assert_array_equal(probes.p4_bucketed_reference(ti, tx, plan).numpy(), want)
    np.testing.assert_array_equal(probes.p4_dma(ti, tx).numpy(), want)


def test_p4_cuda_launcher_rejects_cpu_tensors():
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kp.p4_dma_cuda(idx, torch.zeros(8, 4), probes.p4_bucketed_plan(8, 4))


# ------------------------------------------------------------------ K8's fill
def _same_scale(got, want) -> None:
    """Bit-equal float32 scales, where a NaN equals any NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.uint32), want[keep].view(np.uint32))


def _x(shape, seed=0, nan=True):
    x = np.random.default_rng(seed).normal(0, 2.0, size=shape).astype(np.float32)
    if shape[1] > 3:
        x[:, 3] = 0.0               # scale 1e-12 / 127
    if nan and shape[1] > 2:
        x[shape[0] // 2, 2] = np.nan   # scale NaN, values 0
    return x


FILL_SHAPES = [(300, 64), (257, 100), (1, 1), (40, 7), (3, 256), (600, 5)]


@pytest.mark.parametrize("tile_rows", [1, 7, 256])
@pytest.mark.parametrize("shape", FILL_SHAPES)
def test_plain_fill_equals_column_scale_bitwise(shape, tile_rows):
    x = torch.from_numpy(_x(shape))
    values, scale = tq.quantize_int8_fill_reference(x, tile_rows=tile_rows)
    want = tq.column_scale(x)
    _same_scale(scale.numpy(), want.numpy())
    assert torch.equal(values, tq.quantize_int8_reference(x, want))
    if shape[1] > 3:
        assert scale[3].item() == np.float32(1e-12) / np.float32(127)
        assert torch.isnan(scale[2]) and not values[:, 2].any()


@pytest.mark.parametrize("shape", FILL_SHAPES)
def test_fill_matches_jax_with_zero_and_nan_columns(shape):
    x = _x(shape, seed=1)
    want = jq.quantize_int8(x)
    for values, scale in (tq.quantize_int8_fill_reference(torch.from_numpy(x)),
                          (tq.quantize_int8(x).values, tq.quantize_int8(x).scale)):
        np.testing.assert_array_equal(values.numpy(), np.asarray(want.values))
        _same_scale(scale.numpy(), want.scale)


@pytest.mark.parametrize("shape", [(300, 64), (40, 7)])
def test_floor_fill_matches_pallas_interpret_with_a_nan_column(shape):
    x = _x(shape, seed=2)
    n, d = shape
    n_pad = -(-n // 256) * 256
    u = np.array(jax.random.uniform(jax.random.key(3), (n_pad, d), minval=-0.5,
                                    maxval=0.5))[:n]
    want = jq.quantize_int8_pallas(jnp.asarray(x), seed=3, interpret=True)
    values, scale = tq.quantize_int8_fill_reference(torch.from_numpy(x), "floor",
                                                    torch.from_numpy(u))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want.values))
    _same_scale(scale.numpy(), want.scale)


@pytest.mark.parametrize("mode", tq.MODES)
def test_fill_dispatch_on_the_cpu_is_the_plain_fill(mode):
    x = torch.from_numpy(_x((50, 12), seed=4, nan=False))
    before = k8.launches
    values, scale = k8.quantize_int8_fill(x, mode, seed=9)
    noise = torch.from_numpy(tq.philox_uniform(50, 12, 9))
    want_values, want_scale = tq.quantize_int8_fill_reference(x, mode, noise)
    assert torch.equal(values, want_values)
    _same_scale(scale.numpy(), want_scale.numpy())
    assert k8.launches == before


def test_quantizers_and_the_int8_cache_on_the_cpu_count_no_launch():
    x = _x((64, 16), seed=5, nan=False)
    before = k8.launches
    tq.quantize_int8(x)
    tq.quantize_int8(x, stochastic=True, seed=1)
    tq.quantize_int8_stochastic(x, seed=2)
    cache = HBMFeatureCache(x, device="cpu", quantize=True)
    cache.fill(np.arange(32))
    assert cache.cache.values.shape == (32, 16)
    assert k8.launches == before


@pytest.mark.parametrize("launcher", ["fill", "pass"])
def test_k8_cuda_launchers_reject_cpu_tensors(launcher):
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        if launcher == "fill":
            k8.quantize_int8_fill_cuda(x)
        else:
            k8.quantize_int8_cuda(x, torch.ones(8))
