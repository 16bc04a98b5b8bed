"""kzg_tpu_torch.parallel across processes: one spawn of 4 gloo ranks on
the CPU through the port's dry run (kzg_tpu_torch.parallel.dryrun) on a
2 x 2 blobs x points mesh, at the dry run's toy shapes (c = 4, n = 8 x 2
points, b = 2 x 2 blobs). The ranks write their results into the test's
temporary directory; they are held against the JAX package's oracle, and
the FFT once against its sharded FFT on a CPU mesh. (Its sharded
fixed-base MSM is not compared here: the XLA:CPU compiles of its table
and its program take 45 s.) Tolerance: exact (affine points, Fr values,
Montgomery limbs).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kzg_tpu.constants import R_MOD as R
from kzg_tpu.oracle.fft import fft_fr
from kzg_tpu.oracle.msm import msm as oracle_msm
from kzg_tpu_torch.parallel import dryrun

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once; the ranks pin theirs

N_PROCS, BLOBS = 4, 2
D_BLOBS, D_PTS = dryrun.mesh_shape(N_PROCS, BLOBS)
R_INV = pow(1 << 256, -1, R)  # Montgomery form -> value


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The results of the one spawn of this file, read back from the files
    the ranks wrote."""
    out = tmp_path_factory.mktemp("dryrun")
    dryrun.run(N_PROCS, "cpu", blob_axis_size=BLOBS, out_dir=str(out), timeout=120, references=False)
    results = []
    for r in range(N_PROCS):
        with open(out / f"rank{r}.json") as f:
            results.append(json.load(f))
    return results


@pytest.fixture(scope="module")
def inputs():
    return dryrun.toy_inputs(D_BLOBS, D_PTS)


def _points(res):
    return [None if p is None else tuple(p) for p in res]


def test_mesh_is_two_by_two_and_every_rank_agrees(ranks):
    assert (D_BLOBS, D_PTS) == (2, 2)
    keys = set(ranks[0]) - {"seconds"}
    assert keys == {"msm_fixed_sharded", "msm_sharded", "commit", "eval", "lincomb", "fft", "ifft", "launches"}
    for res in ranks[1:]:
        assert {k: res[k] for k in keys} == {k: ranks[0][k] for k in keys}
    assert not any(ranks[0]["launches"].values())  # on the CPU the plain versions run, no kernel


def test_msm_fixed_sharded_equals_the_oracle(ranks, inputs):
    want = [oracle_msm(inputs["points"], row) for row in inputs["scalars"]]
    assert _points(ranks[0]["msm_fixed_sharded"]) == want


def test_msm_sharded_equals_the_oracle(ranks, inputs):
    assert _points(ranks[0]["msm_sharded"]) == [oracle_msm(inputs["points"], inputs["scalars"][0])]


def test_sharded_commit_equals_the_oracle(ranks, inputs):
    want = [oracle_msm(inputs["points"], row) for row in inputs["commit_scalars"]]
    assert _points(ranks[0]["commit"]) == want


def test_sharded_eval_equals_the_barycentric_formula(ranks, inputs):
    roots = inputs["roots"]
    m = len(roots)

    def evaluate(p, z):
        s = sum(pi * ri % R * pow(z - ri, R - 2, R) for pi, ri in zip(p, roots)) % R
        return s * (pow(z, m, R) - 1) % R * pow(m, R - 2, R) % R

    assert ranks[0]["eval"] == [evaluate(p, z) for p, z in zip(inputs["polys"], inputs["zs"])]


def test_sharded_lincomb_equals_the_oracle(ranks, inputs):
    want = [oracle_msm(inputs["points"], row) for row in inputs["lincomb_scalars"]]
    assert _points(ranks[0]["lincomb"]) == want


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_sharded_equals_the_oracle(ranks, inputs, inverse):
    got = [v * R_INV % R for v in ranks[0]["ifft" if inverse else "fft"]]
    assert got == fft_fr(inputs["fft_values"], inverse=inverse)


def _jax_limbs(values):
    from kzg_tpu.ops.field import ints_to_limbs

    return jnp.asarray(ints_to_limbs(values, 16))


def test_fft_sharded_equals_the_jax_sharded_fft(ranks, inputs):
    """The JAX package's fft_sharded on 4 CPU devices at n = 64, limb for
    limb."""
    from kzg_tpu.ops.field import limbs_to_ints
    from kzg_tpu.parallel.sharded_fft import fft_sharded

    mont = [v * (1 << 256) % R for v in inputs["fft_values"]]
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("points",))
    want = limbs_to_ints(np.asarray(fft_sharded(_jax_limbs(mont), mesh)))
    assert ranks[0]["fft"] == want

