"""PointNet++'s set abstraction, feature propagation and points sampler of
the port against ``houv_tpu/models/pointnet2.py``, on the CPU.

The modules run on the JAX modules' own parameters (carried across by
``state_from_flax``) and the same numpy clouds. The FPS picks, ball-query
groups and three-NN picks are index for index JAX's (clouds drawn uniform,
no near-ties); the features agree to 1e-5 (f32, both). 'd-fps' and
'f-fps' pick JAX's indices; ``furthest_point_sample_with_dist`` on JAX's
own distance matrix picks JAX's, ties to the lowest index; 'random' gives
distinct in-range indices, the same for one generator seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from houv_tpu.models import pointnet2 as jp2
from houv_tpu.ops.chamfer import pairwise_sqdist as jpairwise
from houv_tpu.ops.sampling import furthest_point_sample_with_dist as jfps_dist
from houv_tpu_torch.models import PointFPModule, PointSAModule, points_sampler
from houv_tpu_torch.ops.sampling import furthest_point_sample_with_dist
from houv_tpu_torch.state import state_from_flax

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(module, variables):
    module.load_state_dict(state_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), module),
        strict=True)
    return module


@pytest.mark.parametrize("radii,nsamples,mlps,use_features", [
    ((0.3,), (8,), ((16, 32),), True),
    ((0.2, None), (8, 4), ((16,), (8, 24)), True),
    ((0.4,), (6,), ((16,),), False),
], ids=["one-radius", "ball-and-knn", "xyz-only"])
def test_sa_module_matches_jax(rng, radii, nsamples, mlps, use_features):
    xyz = rng.uniform(-0.5, 0.5, (2, 96, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 96, 5)).astype(np.float32) \
        if use_features else None
    jm = jp2.PointSAModule(npoint=24, radii=radii, nsamples=nsamples,
                           mlps=mlps)
    jfeats = None if feats is None else jnp.asarray(feats)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jfeats)
    jxyz, jout = jm.apply(variables, jnp.asarray(xyz), jfeats)
    tm = _port(PointSAModule(24, 5 if use_features else 0, radii, nsamples,
                             mlps), variables)
    txyz, tout = tm(torch.as_tensor(xyz),
                    None if feats is None else torch.as_tensor(feats))
    np.testing.assert_array_equal(txyz.numpy(), np.asarray(jxyz))
    assert tout.shape == (2, 24, sum(m[-1] for m in mlps))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)


@pytest.mark.parametrize("with_target_feats", [True, False])
def test_fp_module_matches_jax(rng, with_target_feats):
    target = rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)
    source = rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32)
    sfeats = rng.standard_normal((2, 16, 8)).astype(np.float32)
    tfeats = rng.standard_normal((2, 64, 4)).astype(np.float32) \
        if with_target_feats else None
    jm = jp2.PointFPModule(mlp=(32, 16))
    args = (jnp.asarray(target), jnp.asarray(source),
            None if tfeats is None else jnp.asarray(tfeats),
            jnp.asarray(sfeats))
    variables = jm.init(jax.random.PRNGKey(1), *args)
    ref = jm.apply(variables, *args)
    tm = _port(PointFPModule(8, 4 if with_target_feats else 0, (32, 16)),
               variables)
    out = tm(torch.as_tensor(target), torch.as_tensor(source),
             None if tfeats is None else torch.as_tensor(tfeats),
             torch.as_tensor(sfeats))
    assert out.shape == (2, 64, 16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_points_sampler_strategies_match_jax(rng):
    pts = rng.uniform(-0.5, 0.5, (3, 80, 3)).astype(np.float32)
    feats = rng.standard_normal((3, 80, 4)).astype(np.float32)
    tp, tf = torch.as_tensor(pts), torch.as_tensor(feats)
    for kw, tkw in (({}, {}),
                    (dict(strategy="f-fps"), dict(strategy="f-fps")),
                    (dict(strategy="f-fps", features=jnp.asarray(feats)),
                     dict(strategy="f-fps", features=tf))):
        ref = np.asarray(jp2.points_sampler(jnp.asarray(pts), 20, **kw))
        got = points_sampler(tp, 20, **tkw)
        assert got.dtype == torch.int64 and got[:, 0].eq(0).all()
        np.testing.assert_array_equal(got.numpy(), ref)
    # on JAX's own distance matrix, and with planted ties: the lowest index
    both = jnp.concatenate([jnp.asarray(pts), jnp.asarray(feats)], -1)
    dist = np.array(jpairwise(both, both))
    np.testing.assert_array_equal(
        furthest_point_sample_with_dist(torch.as_tensor(dist), 30).numpy(),
        np.asarray(jfps_dist(jnp.asarray(dist), 30)))
    tied = np.ones((2, 6, 6), np.float32) - np.eye(6, dtype=np.float32)
    np.testing.assert_array_equal(
        furthest_point_sample_with_dist(torch.as_tensor(tied), 4).numpy(),
        np.asarray(jfps_dist(jnp.asarray(tied), 4)))
    assert furthest_point_sample_with_dist(
        torch.as_tensor(tied), 4).tolist() == [[0, 1, 2, 3]] * 2

    draws = [points_sampler(tp, 25, "random",
                            generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (3, 25)
    for row in draws[0]:
        assert len(set(row.tolist())) == 25
        assert 0 <= int(row.min()) and int(row.max()) < 80
    with pytest.raises(ValueError, match="Generator"):
        points_sampler(tp, 4, "random")
    with pytest.raises(ValueError, match="unknown strategy"):
        points_sampler(tp, 4, "grid")
