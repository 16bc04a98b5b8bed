"""Kernel B6's wrapper (kzg_tpu_torch.ops.cuda_gather) and the bench path
on the CPU, exact: the plain version and the wrapper's CPU route against
the gather probe's Pallas kernel in interpret mode, widths 24 and 25
against numpy, the wrapper's checks, and the fixed-base MSM's stage split
(kzg_tpu_torch.benches.msm_stages) and the headline bench's native check
at a small table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kzg_tpu_torch import bench, native
from kzg_tpu_torch.benches import common, msm_stages, run_benches
from kzg_tpu_torch.constants import G1_GENERATOR_X, G1_GENERATOR_Y, R_MOD
from kzg_tpu_torch.ops import cuda_gather, g1, launch, msm
from kzg_tpu_torch.ops.field import limbs_to_ints

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once


def _pallas_dg(tab: np.ndarray, src: np.ndarray, n: int, rep: int) -> np.ndarray:
    """The probe's pallas_dg, copied from benches/gather_micro.py:166-193
    (kernel body :168-172, the index layout and BlockSpecs of pdg :176-193)
    at a small slice of n rows, run in interpret mode. Returns (grid, n,
    rep * 24) u32."""

    def kernel(tab_ref, idx_ref, out_ref):
        t = tab_ref[...]  # (N, 24)
        tr = jnp.concatenate([t] * rep, axis=1)  # (N, 120)
        idx = idx_ref[0]  # (N, 120)
        out_ref[0] = jnp.take_along_axis(tr, idx, axis=0)

    grid = src.shape[0] // (n * rep)

    @jax.jit
    def pdg(tab, src):
        idx = jnp.broadcast_to(
            (src % n).reshape(grid, rep, n).transpose(0, 2, 1)[..., None],
            (grid, n, rep, 24),
        ).reshape(grid, n, rep * 24)
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((grid, n, rep * 24), jnp.uint32),
            grid=(grid,),
            in_specs=[
                pl.BlockSpec((n, 24), lambda i: (0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((1, n, rep * 24), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, n, rep * 24), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            interpret=True,
        )(tab[:n], idx)

    return np.asarray(pdg(jnp.asarray(tab), jnp.asarray(src)))


def test_b6_matches_the_pallas_probe_kernel():
    """At N = 64, REP = 5, grid 3: out[g, e, r*24 + l] == G[g*5N + r*N + e, l]
    with G = table[:N][src % N], the rows B6 gathers from the slice."""
    n, rep, grid, rows = 64, 5, 3, 1280
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 2**32, (rows, 24), dtype=np.uint32)
    src = rng.integers(0, rows, grid * rep * n, dtype=np.int32)
    want = _pallas_dg(tab, src, n, rep)
    tab_t = torch.from_numpy(tab.view(np.int32))
    idx = torch.from_numpy(src % n)
    for g_rows in (cuda_gather.gather_rows(tab_t[:n], idx), cuda_gather.gather_rows_ref(tab_t[:n], idx)):
        G = g_rows.numpy().view(np.uint32)
        laid = G.reshape(grid, rep, n, 24).transpose(0, 2, 1, 3).reshape(grid, n, rep * 24)
        np.testing.assert_array_equal(laid, want)


@pytest.mark.parametrize("width", [24, 25])
def test_gather_rows_matches_numpy(width):
    rng = np.random.default_rng(width)
    tab = rng.integers(-(2**31), 2**31, (300, width), dtype=np.int64).astype(np.int32)
    idx = np.concatenate([[0, 299, 299, 0, 7, 7], rng.integers(0, 300, 251)]).astype(np.int32)  # 257 rows
    got = cuda_gather.gather_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), tab[idx])
    empty = cuda_gather.gather_rows(torch.from_numpy(tab), torch.zeros(0, dtype=torch.int32))
    assert tuple(empty.shape) == (0, width)


def test_gather_rows_checks_inputs_and_raises_out_of_range():
    tab = torch.arange(40, dtype=torch.int32).reshape(8, 5)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        cuda_gather.gather_rows(tab.long(), idx)
    with pytest.raises(ValueError, match="dtype"):
        cuda_gather.gather_rows(tab, idx.long())
    with pytest.raises(ValueError, match="shape"):
        cuda_gather.gather_rows(tab, idx[None])
    with pytest.raises(ValueError, match="shape"):
        cuda_gather.gather_rows(tab.reshape(-1), idx)
    with pytest.raises(ValueError, match="width"):
        cuda_gather.gather_rows(torch.zeros((8, 0), dtype=torch.int32), idx)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gather.gather_rows(tab[:, ::2], idx)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_gather.gather_rows(tab.to("meta"), idx.to("meta"))
    for bad in (8, -1):
        with pytest.raises(IndexError, match="out of range"):
            cuda_gather.gather_rows(tab, torch.tensor([0, bad, 3], dtype=torch.int32))
    flag = cuda_gather.new_flag("cpu")
    out = cuda_gather.gather_rows(tab, torch.tensor([1, 8, 2], dtype=torch.int32), flag)
    assert out.tolist() == [tab[1].tolist(), [0] * 5, tab[2].tolist()]
    with pytest.raises(IndexError, match="out of range"):
        cuda_gather.raise_if_flagged(flag)
    assert cuda_gather.gather_rows.launches == 0  # the CPU route launches nothing
    assert "gather_rows" in launch.launches()


def _small_table():
    pts = [native.g1_mul((G1_GENERATOR_X, G1_GENERATOR_Y), 1000003 * (i + 1)) for i in range(31)] + [None]
    return pts, msm.build_fixed_base_table(g1.affine_from_ints(pts, "cpu"), c=9)


def test_stage_split_gives_msm_fixed():
    """The split at n = 32, batch 2 on the CPU: its bucket sums and
    integration give msm_fixed's points, and its gather gives the rows of
    the sorted layout B1 reads."""
    pts, table = _small_table()
    sc = torch.from_numpy(common.random_scalars(np.random.default_rng(3), 64).reshape(16, 2, 32))
    split = msm_stages.stage_split(table, [sc])
    assert g1.xyzz_to_ints(split["result"]) == g1.xyzz_to_ints(msm.msm_fixed(table, sc))
    rows, idx, _ = msm.phase1_inputs(table, sc)
    assert torch.equal(split["gathered"], rows.index_select(0, idx.reshape(-1)))
    assert set(split["stages"]) == set(msm_stages.STAGES)
    assert all("host_ms" in r and "device_ms" not in r for r in split["stages"].values())
    assert "whole_device_ms" not in split  # no device time from a CPU run


def test_headline_bench_checks_against_the_native_sum():
    pts, table = _small_table()
    inputs = bench.make_inputs(32, 2, 2, "cpu")
    assert not torch.equal(inputs[0], inputs[1])
    out = msm.msm_fixed(table, inputs[0])
    bench.check_row0(out, pts, inputs[0])
    with pytest.raises(RuntimeError, match="differs from the native sum"):
        bench.check_row0(out, pts[1:] + pts[:1], inputs[0])
    line = bench.result_line(bench.BLST_1CORE_PTS_PER_S * 2)
    assert line == {"metric": "g1_msm_fixed_4096_points_per_sec_per_chip", "value": round(bench.BLST_1CORE_PTS_PER_S * 2, 1),
                    "unit": "points/s", "vs_baseline": 2.0}


def test_bench_inputs_are_canonical():
    rng = np.random.default_rng(5)
    vals = limbs_to_ints(common.random_scalars(rng, 2000))
    assert all(0 <= v < R_MOD for v in vals) and max(vals) > R_MOD * 9 // 10
    blob = run_benches.random_blob(rng)
    assert len(blob) == 131072
    assert all(int.from_bytes(blob[32 * i : 32 * i + 32], "big") < R_MOD for i in range(4096))
