"""The port's multi-rank solves over torch.distributed, on the CPU: two gloo
ranks (``parallel.distributed.launch``) run the pair-sharded sweep, both
layouts of the (data, restart) split and the sharded rescored solve, each
held to the port's one-process solve on the same restarts (bit for bit;
the rescored logits at the bounds of the JAX package's
``test_sharded_rescore_matches_host``); the pick across restart shards on
planted ties follows the JAX package's rule (``mesh.py:221-229``); the row
gather is exact; the refusals raise. Every job runs under a join timeout,
so a collective that hangs fails its test. The rank functions are in
``torch_parallel_ranks.py`` (no JAX there, so a rank starts quickly)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from houv_tpu.parallel import __all__ as jax_parallel_names
from houv_tpu_torch import parallel
from houv_tpu_torch.data import synthesize_registration_pairs
from houv_tpu_torch.models.alignment import AlignmentClassifier
from houv_tpu_torch.models.common import init_like_flax
from houv_tpu_torch.parallel import distributed
from houv_tpu_torch.models.common import set_batch_group
from houv_tpu_torch.models.vrcnet import VRCNet
from houv_tpu_torch.parallel.mesh import (Mesh, local_mesh, make_mesh,
                                          make_mesh_2d, rank_rows,
                                          sharded_houv_solve,
                                          sharded_houv_solve_2d)
from houv_tpu_torch.solvers.houv import HOUVConfig, houv_solve, init_params
from houv_tpu_torch.solvers.rescore import (houv_solve_rescored,
                                            make_classifier_scorer,
                                            make_sharded_classifier_scorer,
                                            sharded_houv_solve_rescored)

# seconds a two-rank job may take before it is killed: ~10 s alone, and
# under the suite's load several times that
TIMEOUT = 300
# 8 pairs of 64 points, 8 restarts, 60 steps, 2 windows; rotations up to 90°
# put some pairs past the threshold, so the retry window runs for them
CFG = HOUVConfig(kernel=8, steps=60, angle_passes=2, retry_threshold=0.03)
SEED = 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _launch(fn, *args, timeout=TIMEOUT):
    """Two gloo ranks on the CPU, one thread each (the suite runs a
    process per core)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return distributed.launch(fn, 2, "cpu", args=args, timeout=timeout)
    finally:
        torch.set_num_threads(before)


def _pairs(n=8, points=64, seed=3, max_angle=90.0):
    d = synthesize_registration_pairs(
        n, n_points=points, max_angle_deg=max_angle, max_trans=0.5,
        seed=seed, shape_mode="structured", rot_mix=True)
    return d["src"], d["tgt"]


def _planted():
    """Pools (B, W, K) = (3, 2, 8) of losses with ties: pair 0 ties across
    the two restart shards in window 0 (restarts 2 and 5), pair 1 within
    shard 1 (restarts 6 and 7) and against window 1, pair 2 in window 1
    only (restarts 1 and 4), below window 0."""
    loss = np.full((3, 2, 8), 0.5, np.float32)
    loss[0, 0, [2, 5]] = 0.1
    loss[1, 0, [6, 7]] = 0.2
    loss[1, 1, 3] = 0.2
    loss[2, 1, [1, 4]] = 0.05
    loss[2, 0, 0] = 0.3
    return {"loss": loss}


def _jax_rule(loss_w):
    """mesh.py:221-229 on one window's (B, K) losses over 2 restart shards:
    each shard's first least restart, the least over the shards (pmin),
    the lowest shard holding it. Returns the global restart index."""
    shards = np.split(loss_w, 2, axis=1)
    lv = np.stack([s.min(1) for s in shards])            # (R, B)
    li = np.stack([s.argmin(1) for s in shards])
    best = lv.min(0)
    owner = np.where(lv <= best, np.arange(2)[:, None], 2**30).min(0)
    return owner * shards[0].shape[1] + li[owner, np.arange(len(best))]


@pytest.fixture(scope="module")
def solve_job():
    src, tgt = _pairs()
    return _launch(ranks.solves, src, tgt, CFG, SEED, _planted())


@pytest.fixture(scope="module")
def one_process():
    src, tgt = _pairs()
    out = houv_solve(torch.as_tensor(src), torch.as_tensor(tgt), CFG,
                     generator=torch.Generator().manual_seed(SEED),
                     device="cpu")
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}


def test_parallel_exports_the_jax_names_on_the_port():
    assert sorted(parallel.__all__) == sorted(jax_parallel_names)
    for name in parallel.__all__:
        assert callable(getattr(parallel, name))


def test_pair_sharded_sweep_is_bit_equal_on_the_port(solve_job, one_process):
    out = solve_job["1d"]
    assert one_process["n_retry"] > 0          # the retry window ran
    assert one_process["n_retry"] < 8
    assert out["n_retry"] == one_process["n_retry"]
    assert out["transform"].tobytes() == one_process["transform"].tobytes()
    assert out["rmse"].tobytes() == one_process["rmse"].tobytes()


def test_one_process_mesh_solve_is_houv_solve_on_the_port(one_process):
    """The CLI's one path: the sharded solve over ``local_mesh`` (no
    process group) is ``houv_solve``, bit for bit."""
    src, tgt = (torch.as_tensor(a) for a in _pairs())
    mesh = local_mesh("cpu")
    assert mesh.size == 1 and mesh.group() is None
    out = sharded_houv_solve(src, tgt, mesh, CFG,
                             generator=torch.Generator().manual_seed(SEED))
    assert out["n_retry"] == one_process["n_retry"]
    assert out["transform"].numpy().tobytes() \
        == one_process["transform"].tobytes()
    assert out["rmse"].numpy().tobytes() == one_process["rmse"].tobytes()


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)])
def test_restart_split_is_bit_equal_on_the_port(solve_job, one_process,
                                                 layout):
    out = solve_job[layout]
    assert out["transform"].tobytes() == one_process["transform"].tobytes()
    assert out["rmse"].tobytes() == one_process["rmse"].tobytes()
    # JAX's test_sharded_solve_2d_retry_count_matches_1d: the 2-D count is
    # the 1-D one (the mask from the best over every restart shard)
    assert out["n_retry"] == solve_job["1d"]["n_retry"] \
        == one_process["n_retry"]


def test_cross_shard_pick_follows_the_jax_rule_on_the_port(solve_job):
    pick = solve_job["pick"]
    loss = _planted()["loss"]
    r = pick["transform"][:, :3, :3]
    restart = np.rint(np.arctan2(r[:, 1, 0], r[:, 0, 0]) / 0.01).astype(int)
    window = np.rint(pick["transform"][:, 0, 3]).astype(int)
    flat = loss.reshape(3, -1)
    # the unsharded rule: the first least over (window, restart)
    np.testing.assert_array_equal(window * 8 + restart, flat.argmin(1))
    np.testing.assert_array_equal(pick["best"], flat.min(1))
    assert restart.tolist() == [2, 6, 1] and window.tolist() == [0, 0, 1]
    # within the window picked, the JAX package's pmin-then-lowest-shard
    for b in range(3):
        assert restart[b] == _jax_rule(loss[:, window[b]])[b]


def test_row_gathers_are_exact_on_the_port(solve_job):
    out = solve_job["gathers"]
    expect = np.array([[-0.0, np.nan, 1e-45, r] for r in range(2)],
                      np.float32)
    for path in ("all_gather", "broadcasts"):
        assert out[path].tobytes() == expect.tobytes(), path
    assert np.signbit(out["broadcasts"][:, 0]).all()
    assert out["sum_int"] == 3
    # data_parallel_grads: the ranks' mean is the whole batch's
    x = torch.linspace(-1.0, 1.0, 24, dtype=torch.float64).reshape(8, 3)
    w = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64,
                     requires_grad=True)
    loss = ((x @ w) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(out["dp"][0], float(loss.detach()), rtol=1e-14)
    np.testing.assert_allclose(out["dp"][1], w.grad.numpy(), rtol=1e-14)


def test_indivisible_batch_and_kernel_raise_on_the_port():
    src, tgt = (torch.as_tensor(a) for a in _pairs())
    cpu = torch.device("cpu")
    three = Mesh(("data",), (3,), (0,), (None,), cpu)
    with pytest.raises(ValueError, match="divisible"):
        sharded_houv_solve(src, tgt, three, CFG)
    with pytest.raises(ValueError, match="divisible"):
        rank_rows(8, three)
    data3 = Mesh(("data", "restart"), (3, 1), (0, 0), (None, None), cpu)
    with pytest.raises(ValueError, match="batch 8 not divisible"):
        sharded_houv_solve_2d(src, tgt, data3, CFG)
    restart3 = Mesh(("data", "restart"), (1, 3), (0, 0), (None, None), cpu)
    with pytest.raises(ValueError, match="kernel 8 not divisible"):
        sharded_houv_solve_2d(src, tgt, restart3, CFG)
    with pytest.raises(ValueError, match="divisible"):
        parallel.shard_batch({"src": np.zeros((8, 3))}, three)
    # the ablations that read a pair's whole restart axis: the restart
    # split refuses them, as the JAX package's does
    restart2 = Mesh(("data", "restart"), (1, 2), (0, 0), (None, None), cpu)
    with pytest.raises(NotImplementedError, match="two_bracket splits"):
        sharded_houv_solve_2d(src, tgt, restart2,
                              dataclasses.replace(CFG, two_bracket=True))
    with pytest.raises(NotImplementedError, match="FULL restart axis"):
        sharded_houv_solve_2d(src, tgt, restart2, dataclasses.replace(
            CFG, window_select="consensus"))


def test_init_distributed_is_a_no_op_without_the_environment_on_the_port(
        monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.init_distributed(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    mesh = distributed.global_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group() is None and mesh.rank == 0
    with pytest.raises(ValueError, match="job of 1"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="job of 1"):
        make_mesh_2d(1, 2, device="cpu")
    # the backend rule: NCCL refuses the CPU and more ranks than cards
    assert distributed.choose_backend(torch.device("cpu"), 2) == "gloo"
    with pytest.raises(ValueError, match="CUDA devices only"):
        distributed.choose_backend(torch.device("cpu"), 1, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.choose_backend(torch.device("cpu"), 1, "mpi")
    with pytest.raises(ValueError, match="nprocs"):
        distributed.launch(ranks.gathers, 0, "cpu")


def _rank_fails():
    raise RuntimeError("rank failed on purpose")


def _rank_hangs():
    # rank 1 never joins the all-reduce rank 0 waits in
    if dist.get_rank() == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        import time

        time.sleep(600)


def test_a_failed_or_hung_rank_fails_the_launch_on_the_port():
    with pytest.raises(Exception, match="rank failed on purpose"):
        _launch(_rank_fails)
    with pytest.raises(TimeoutError):
        _launch(_rank_hangs, timeout=8)


def _rescore_case():
    """8 pairs of 64 points, 8 restarts, 60 steps, 2 windows, 4
    candidates, a classifier (grid 12, init 4) from a seeded
    initialisation, and the host's rescored solve with micro-batches of
    4."""
    d = synthesize_registration_pairs(8, n_points=64, max_angle_deg=60.0,
                                      seed=41)
    src, tgt = d["rotated_src"], d["rotated_tgt"]
    model = AlignmentClassifier(grid_size=12, init_size=4)
    init_like_flax(model, torch.Generator().manual_seed(0))
    model.eval()
    cfg = HOUVConfig(kernel=8, steps=60, angle_passes=2)
    params0 = init_params(torch.Generator().manual_seed(9), 8, 8,
                          device="cpu")
    kw = dict(n_cand=4, angle_deg=10.0, margin=0.0)
    host = houv_solve_rescored(
        torch.as_tensor(src), torch.as_tensor(tgt), cfg,
        make_classifier_scorer(model, micro_batch=4), params0=params0,
        device="cpu", **kw)
    return src, tgt, model, cfg, params0, kw, host


def test_one_process_mesh_rescored_solve_is_the_host_on_the_port():
    """The CLI's one path with a scorer: the sharded rescored solve and
    scorer over ``local_mesh`` are ``houv_solve_rescored``, bit for
    bit."""
    src, tgt, model, cfg, params0, kw, host = _rescore_case()
    mesh = local_mesh("cpu")
    scorer = make_sharded_classifier_scorer(model, mesh, micro_batch=4)
    out = sharded_houv_solve_rescored(
        torch.as_tensor(src), torch.as_tensor(tgt), mesh, cfg, scorer,
        params0=params0, **kw)
    assert out.keys() == host.keys()
    for key, value in host.items():
        if torch.is_tensor(value):
            assert out[key].numpy().tobytes() == value.numpy().tobytes(), key
        else:
            assert out[key] == value, key
    assert scorer.local.calls == 8          # 32 rows in calls of 4


def test_vrcnet_refuses_a_batch_group_with_mmd_on_the_port():
    """Data-parallel VRCNet takes KLD and MMD alike: MMD couples every pair
    of the batch's rows, and with a process group it gathers the latent
    samples over the ranks (its steps over two ranks against one process:
    ``test_torch_distributed_train.py``, case ``vrcnet_mmd``), so setting
    a group on it no longer raises."""
    small = dict(num_points=64, num_coarse_raw=32, num_fps=64,
                 num_coarse=64, layers=(1, 1, 1, 1), knn_list=(4,), pk=4)
    group = object()
    kld = VRCNet(**small)
    set_batch_group(kld, group)
    assert kld.batch_group is group
    mmd = VRCNet(distribution_loss="MMD", **small)
    set_batch_group(mmd, None)
    assert mmd.batch_group is None
    set_batch_group(mmd, group)
    assert mmd.batch_group is group


def test_sharded_rescored_solve_matches_the_host_on_the_port():
    """JAX's test_sharded_rescore_matches_host on the port
    (``_rescore_case``): the sharded solve over two ranks against the
    host's."""
    src, tgt, model, cfg, params0, kw, host = _rescore_case()
    state = model.state_dict()
    sharded = _launch(
        ranks.rescored, src, tgt, cfg,
        {k: v.numpy() for k, v in params0.items()},
        {k: v.numpy() for k, v in state.items()}, kw, 4)
    host = {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in host.items()}
    np.testing.assert_allclose(sharded["cand_loss"], host["cand_loss"],
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(sharded["cand_logits"], host["cand_logits"],
                               rtol=2e-4, atol=2e-4)
    assert sharded["pick"].tolist() == host["pick"].tolist()
    assert sharded["n_override"] == host["n_override"]
    assert sharded["n_retry"] == host["n_retry"]
    np.testing.assert_allclose(sharded["transform"], host["transform"],
                               rtol=2e-4, atol=2e-5)
    # the sharded scorer on the whole batch's candidates: the same logits,
    # each rank scoring its 4 pairs' 16 rows in 4 calls of 4
    np.testing.assert_allclose(sharded["scorer_logits"],
                               sharded["cand_logits"], rtol=0, atol=0)
    assert sharded["local_calls"] == 4 + 4
