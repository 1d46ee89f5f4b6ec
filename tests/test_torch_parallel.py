"""apex_tpu_torch.parallel's SyncBatchNorm, LARC, convert_syncbn_model,
create_syncbn_process_group and multiproc against the JAX package on the
CPU.

SyncBatchNorm is held against JAX's flax module with ``axis_name=None``
and with the 'dp' axis (the port on a one-rank gloo group, JAX with the
axis bound by ``vmap`` over one replica). LARC's rescaled gradients are
held against JAX's ``_rescale`` and one ``LARC(FusedAdam)`` step against
JAX's. Inputs come from numpy seeds.

Tolerances: SyncBatchNorm rtol 1e-6, with an absolute part of 1e-6 for
outputs near 0: fp32 sums over the batch in another order and rsqrt in
two libraries, one or two fp32 ulps apart. LARC's rescaled gradients
rtol 1e-6: two fp32 norms summed in another order, then the same
operations. The LARC(FusedAdam) step rtol 1e-6 on the parameters: those
gradients through Adam's same fp32 operations (a sqrt and a division).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.parallel import LARC as JaxLARC
from apex_tpu.parallel import SyncBatchNorm as JaxSyncBatchNorm
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import (
    LARC,
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
    multiproc,
)
from torch_threads import one_torch_thread  # noqa: F401

BN_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _x(seed, shape=(4, 5, 6, 8), shift=0.5):
    return (np.random.RandomState(seed).randn(*shape) * 2 + shift).astype(
        np.float32)


# ------------------------------------------------------------ SyncBatchNorm

def _jax_bn(axis_name, fuse_relu, variables, x, train, z=None):
    """JAX's SyncBatchNorm on x; with an axis, inside a one-replica vmap
    that binds it. Returns (y, new batch_stats or None)."""
    model = JaxSyncBatchNorm(axis_name=axis_name, fuse_relu=fuse_relu)

    def run(v, xb, zb):
        if train:
            return model.apply(v, xb, use_running_average=False, z=zb,
                               mutable=["batch_stats"])
        return model.apply(v, xb, use_running_average=True, z=zb), None

    if axis_name is None:
        y, upd = run(variables, jnp.asarray(x), z)
        return np.asarray(y), upd and upd["batch_stats"]
    zb = None if z is None else jnp.asarray(z)[None]
    y, upd = jax.vmap(run, in_axes=(None, 0, 0 if z is not None else None),
                      axis_name=axis_name)(variables, jnp.asarray(x)[None],
                                           zb)
    stats = upd and jax.tree_util.tree_map(lambda a: a[0],
                                           upd["batch_stats"])
    return np.asarray(y)[0], stats


@pytest.mark.parametrize("axis_name", [None, "dp"])
@pytest.mark.parametrize("fuse_relu,with_z", [(False, False), (True, True)])
def test_sync_batchnorm_matches_jax(world1, axis_name, fuse_relu, with_z):
    rng = np.random.RandomState(0)
    scale = rng.randn(8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}
    bn = SyncBatchNorm(8, axis_name=axis_name, fuse_relu=fuse_relu)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    assert [n for n, _ in bn.named_parameters()] == ["scale", "bias"]
    assert [n for n, _ in bn.named_buffers()] == ["mean", "var"]
    for step in range(2):  # two updates of the running statistics
        x = _x(step + 1)
        z = _x(step + 10) if with_z else None
        y_j, stats = _jax_bn(axis_name, fuse_relu, variables, x, True, z)
        y_t = bn(torch.from_numpy(x), use_running_average=False,
                 z=None if z is None else torch.from_numpy(z))
        np.testing.assert_allclose(y_t.detach().numpy(), y_j, **BN_TOL)
        variables = {**variables, "batch_stats": stats}
        np.testing.assert_allclose(bn.mean.numpy(),
                                   np.asarray(stats["mean"]), **BN_TOL)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["var"]),
                                   **BN_TOL)
    x = _x(7)
    y_j, _ = _jax_bn(axis_name, fuse_relu, variables, x, False)
    bn.eval()  # use_running_average follows the mode when not given
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(),
                               y_j, **BN_TOL)
    if fuse_relu:
        assert (y_j >= 0).all()


def test_sync_batchnorm_gradient_matches_jax(world1):
    """Gradients flow through the summed statistics as through JAX's."""
    x = _x(3, (6, 4))
    model = JaxSyncBatchNorm(axis_name="dp")
    variables = {"params": {"scale": jnp.ones(4), "bias": jnp.zeros(4)},
                 "batch_stats": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}
    w = np.random.RandomState(4).randn(6, 4).astype(np.float32)

    def loss(xb):
        y, _ = model.apply(variables, xb, use_running_average=False,
                           mutable=["batch_stats"])
        return jnp.sum(y * w)

    g_j = jax.vmap(jax.grad(loss), axis_name="dp")(jnp.asarray(x)[None])[0]
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(SyncBatchNorm(4)(xt, use_running_average=False)
              * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(g_j)).max())


def test_sync_batchnorm_use_running_average_given_twice():
    bn = SyncBatchNorm(3, use_running_average=True, axis_name=None)
    with pytest.raises(ValueError, match="both"):
        bn(torch.zeros(2, 3), use_running_average=False)


# -------------------------------------------------------------------- LARC

def _larc_inputs():
    rng = np.random.RandomState(11)
    params = {"w": rng.randn(8, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32) * 0.1,
              "zero_p": np.zeros((3,), np.float32),
              "zero_g": rng.randn(5).astype(np.float32)}
    grads = {"w": rng.randn(8, 4).astype(np.float32) * 0.01,
             "b": rng.randn(4).astype(np.float32) * 5,
             "zero_p": rng.randn(3).astype(np.float32),
             "zero_g": np.zeros((5,), np.float32)}
    return params, grads


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_larc_rescale_matches_jax(clip, weight_decay):
    params, grads = _larc_inputs()
    lr = 1e-3
    larc_j = JaxLARC(JaxFusedAdam(lr=lr), clip=clip,
                     weight_decay=weight_decay)
    want = larc_j._rescale({k: jnp.asarray(v) for k, v in grads.items()},
                           {k: jnp.asarray(v) for k, v in params.items()}, lr)
    larc_t = LARC(FusedAdam([torch.zeros(1)], lr=lr), clip=clip,
                  weight_decay=weight_decay)
    for k in params:
        got = larc_t._rescale(torch.from_numpy(grads[k]),
                              torch.from_numpy(params[k]), lr)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_larc_fused_adam_step_matches_jax():
    params, grads = _larc_inputs()
    kw = dict(lr=1e-3, weight_decay=0.01)
    larc_j = JaxLARC(JaxFusedAdam(**kw), trust_coefficient=0.02)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    new_j, _ = larc_j.step({k: jnp.asarray(v) for k, v in grads.items()},
                           larc_j.init(p_j), p_j)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    for k, p in ps.items():
        p.grad = torch.from_numpy(grads[k].copy())
    opt = LARC(FusedAdam(list(ps.values()), **kw), trust_coefficient=0.02)
    opt.step()
    for k, p in ps.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(new_j[k]),
                                   rtol=1e-6, err_msg=k)
    assert opt.lr == 1e-3 and opt.param_groups[0]["step"] == 1
    # found_inf passes through to the wrapped optimizer, as JAX's LARC
    # passes it: the step is skipped, its count kept
    after = {k: p.detach().clone() for k, p in ps.items()}
    opt.step(found_inf=torch.ones(1))
    for k, p in ps.items():
        assert torch.equal(p.detach(), after[k]), k
    assert int(opt.param_groups[0]["step"]) == 1


# ---------------------------------------------------- convert_syncbn_model

def test_convert_syncbn_model_swaps_torch_batchnorm():
    bn = torch.nn.BatchNorm1d(4, eps=1e-3, momentum=0.2)
    with torch.no_grad():
        bn.weight.copy_(torch.arange(4.0))
        bn.running_mean.copy_(torch.full((4,), 0.5))
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), bn)
    with pytest.raises(ValueError, match="channel_last"):
        convert_syncbn_model(model)
    out = convert_syncbn_model(model, channel_last=True)
    assert out is model and isinstance(model[1], SyncBatchNorm)
    new = model[1]
    assert new.momentum == pytest.approx(0.8) and new.epsilon == 1e-3
    assert torch.equal(new.scale.detach(), torch.arange(4.0))
    assert torch.equal(new.mean, torch.full((4,), 0.5))
    with pytest.raises(TypeError, match="BatchNorm"):
        convert_syncbn_model(torch.nn.Linear(2, 2))


def test_convert_syncbn_model_sets_norm_fields():
    class WithNorm:
        norm_cls = torch.nn.LayerNorm

    class WithAxis:
        bn_axis_name = None

    m = WithNorm()
    assert convert_syncbn_model(m).norm_cls is SyncBatchNorm
    assert m.norm_cls is torch.nn.LayerNorm  # a copy, as JAX's replace
    assert convert_syncbn_model(WithAxis()).bn_axis_name == "dp"
    assert convert_syncbn_model(WithAxis(), "dp_bn").bn_axis_name == "dp_bn"


def test_create_syncbn_process_group(world1):
    assert create_syncbn_process_group(0) is None
    group = create_syncbn_process_group(1)
    assert dist.get_world_size(group) == 1
    bn = SyncBatchNorm(3, axis_name=group)
    x = torch.from_numpy(_x(5, (6, 3)))
    ref = SyncBatchNorm(3, axis_name=None)
    assert torch.equal(bn(x, use_running_average=False),
                       ref(x, use_running_average=False))


# -------------------------------------------------------------- multiproc

@pytest.fixture
def clean_env(monkeypatch):
    for name in ("APEX_TPU_COORDINATOR", "APEX_TPU_NUM_PROCESSES",
                 "APEX_TPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_distributed_alone_makes_a_one_process_group(clean_env):
    assert multiproc.initialize_distributed(device="cpu") == "gloo"
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        x = torch.ones(3)
        dist.all_reduce(x)
        assert torch.equal(x, torch.ones(3))
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_reads_the_launcher_env(clean_env):
    clean_env.setenv("APEX_TPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    clean_env.setenv("APEX_TPU_NUM_PROCESSES", "1")
    clean_env.setenv("APEX_TPU_PROCESS_ID", "5")
    # an explicit rank 0 wins over the env's
    multiproc.initialize_distributed(process_id=0, device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_refuses_what_it_cannot_do(clean_env):
    with pytest.raises(ValueError, match="num_processes and process_id"):
        multiproc.initialize_distributed("127.0.0.1:1", device="cpu")
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multiproc.initialize_distributed()
    assert not dist.is_initialized()


def test_launcher_sets_the_env_and_runs_the_script(tmp_path, clean_env):
    out = tmp_path / "env.txt"
    script = tmp_path / "show.py"
    script.write_text(
        "import os, sys\n"
        "open(sys.argv[1], 'w').write(' '.join(os.environ[k] for k in (\n"
        "    'APEX_TPU_COORDINATOR', 'APEX_TPU_NUM_PROCESSES',\n"
        "    'APEX_TPU_PROCESS_ID')))\n")
    with pytest.raises(SystemExit) as done:
        multiproc.main(["--nnodes", "3", "--node_rank", "2", "--coordinator",
                        "host0:1234", str(script), str(out)])
    assert done.value.code == 0
    assert out.read_text() == "host0:1234 3 2"
    for argv, msg in ((["--nnodes"], "requires a value"),
                      (["--bogus", "x.py"], "unknown flag"),
                      ([], "usage")):
        with pytest.raises(SystemExit, match=msg):
            multiproc.main(argv)
