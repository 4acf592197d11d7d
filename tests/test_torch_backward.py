"""The port's fused backward pass (ddo_tpu_torch/engine/backward.py)
against ddo_tpu's: `backward_scans` (and its vmap) and the Pallas
`backward_pallas` / `backward_pallas_batched` kernels in interpret mode,
on random planes from tests/test_backward_pallas.py's generator.  Every
comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from ddo_tpu.engine import backward as jbwd
from ddo_tpu_torch.engine import backward as tbwd
from ddo_tpu_torch.utils.num import INF, NEG_INF

from test_torch_kernels import random_case


def _port(args, bk, extras):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    ex = [torch.from_numpy(np.ascontiguousarray(a)) for a in extras] if extras else []
    return [o.numpy() for o in tbwd.fused_backward(*t, torch.from_numpy(bk), *ex)]


NAMES = ["vb", "mk", "th", "hs"]


@pytest.mark.parametrize("filters", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_single_lane_matches_scans_and_pallas(seed, filters):
    """K=1: the counterpart of `backward_pallas` (single-lane compile)."""
    rng = np.random.default_rng(seed + (100 if filters else 0))
    args, bk, extras = random_case(rng, 7, 16, 3, K=1)
    extras = extras if filters else []
    j = [jnp.asarray(a[0]) for a in args]
    je = [jnp.asarray(a[0]) for a in extras]
    ref = jbwd.backward_scans(*j, int(bk[0]), *je)
    pal = jbwd.backward_pallas(*j, int(bk[0]), *je, interpret=True)
    got = _port(args, bk, extras)
    for r, p, g, name in zip(ref, pal, got, NAMES):
        np.testing.assert_array_equal(np.asarray(r), g[0], err_msg=name)
        np.testing.assert_array_equal(np.asarray(p), g[0], err_msg=name)


@pytest.mark.parametrize("filters", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_batched_matches_vmapped_scans_and_pallas(seed, filters):
    """K=4: the counterpart of `backward_pallas_batched`."""
    rng = np.random.default_rng(200 + seed)
    args, bk, extras = random_case(rng, 6, 8, 3, K=4)
    j = [jnp.asarray(a) for a in args]
    if filters:
        je = [jnp.asarray(a) for a in extras]
        pal = jbwd.backward_pallas_batched(*j, jnp.asarray(bk), *je,
                                           interpret=True)
    else:
        je, extras = [], []
        pal = None
    ref = jax.vmap(jbwd.backward_scans)(*j, jnp.asarray(bk), *je)
    got = _port(args, bk, extras)
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(np.asarray(ref[i]), got[i], err_msg=name)
        if pal is not None:
            np.testing.assert_array_equal(np.asarray(pal[i]), got[i], err_msg=name)


@pytest.mark.parametrize("filters", [False, True])
def test_high_branching_matches_vmapped_scans_and_pallas(filters):
    """D=61 out-edges per node (TSPTW N60's branching), K=2 lanes: the
    port against `jax.vmap(backward_scans)` and `backward_pallas_batched`
    in interpret mode (given neutral filters when they are off)."""
    rng = np.random.default_rng(300 + filters)
    args, bk, extras = random_case(rng, 5, 16, 61, K=2)
    j = [jnp.asarray(a) for a in args]
    if not filters:
        ep, wlp, wlth = extras
        extras = [np.full_like(ep, INF), np.zeros_like(wlp), np.full_like(wlth, INF)]
    je = [jnp.asarray(a) for a in extras]
    pal = jbwd.backward_pallas_batched(*j, jnp.asarray(bk), *je, interpret=True)
    ref = jax.vmap(jbwd.backward_scans)(*j, jnp.asarray(bk), *(je if filters else []))
    got = _port(args, bk, extras if filters else [])
    for i, name in enumerate(NAMES):
        np.testing.assert_array_equal(np.asarray(ref[i]), got[i], err_msg=name)
        np.testing.assert_array_equal(np.asarray(pal[i]), got[i], err_msg=name)


def test_thresh_rules_matches():
    rng = np.random.default_rng(5)
    W = 64
    bk = int(rng.integers(-20, 40))
    cols = [rng.integers(-50, 50, W).astype(np.int32),  # val
            rng.integers(0, 60, W).astype(np.int32),    # rub
            np.where(rng.random(W) < 0.3, NEG_INF, rng.integers(-30, 30, W)).astype(np.int32),
            rng.random(W) < 0.3,                        # cutf
            rng.random(W) < 0.5,                        # exact
            np.where(rng.random(W) < 0.4, INF, rng.integers(-30, 30, W)).astype(np.int32),
            rng.random(W) < 0.5]                        # hs
    alive = rng.random(W) < 0.8
    ref = jbwd.thresh_rules(bk, jnp.asarray(alive), *[jnp.asarray(c) for c in cols])
    got = tbwd.thresh_rules(torch.tensor(bk, dtype=torch.int32), torch.from_numpy(alive),
                            *[torch.from_numpy(c) for c in cols])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
