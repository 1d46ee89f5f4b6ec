"""apex_tpu_torch.transformer.parallel_state, the tensor_parallel helpers
and models.tp_split against the JAX package on the CPU, at world size 1
(a one-rank gloo group); world 2 is tests/test_torch_tp_world2.py.

- The (pp, dp, tp) grid: the port's rank layout is JAX's mesh of devices
  (tests/L0/test_transformer_tp.py's grid, tp = 2 x pp = 2 over 8), a
  world that does not divide raises as JAX's does, the getters answer for
  one rank with no grid, pipeline / context / expert parallelism raise
  naming ROADMAP item 6, and the unsharded models refuse tp > 1.
- ``split_params_for_tp`` on the port's ``state_dict`` (carried from the
  JAX tree by ``from_jax_params``) against JAX's on the flax tree, for an
  MHA / GELU and a GQA / SwiGLU GPT: bit for bit.
- ``split_tensor_along_last_dim``, ``VocabUtility``, the random streams,
  ``checkpoint`` and ``broadcast_data`` at world 1.
- Importing every module of apex_tpu_torch brings in neither jax nor
  apex_tpu (in a fresh interpreter).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu.models import GPTModel as JaxGPTModel
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models import tp_split as jax_tp_split
from apex_tpu.transformer import parallel_state as jax_ps
from apex_tpu.transformer.tensor_parallel import utils as jax_tp_utils
from apex_tpu_torch.models import (
    GPTModel,
    TransformerConfig,
    from_jax_params,
)
from apex_tpu_torch.models.tp_split import split_params_for_tp
from apex_tpu_torch.parallel import groups
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    ps.destroy_model_parallel()
    dist.destroy_process_group()


def test_rank_grid_is_jax_mesh_layout():
    mesh = jax_ps.initialize_model_parallel(
        tensor_model_parallel_size_=2, pipeline_model_parallel_size_=2,
        devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(ps.rank_grid(8, 2, 2), ids)
    assert mesh.axis_names == ("pp", "dp", "tp")
    for tp_size in (1, 2, 4, 8):
        jax_ps.destroy_model_parallel()
        mesh = jax_ps.initialize_model_parallel(
            tensor_model_parallel_size_=tp_size, devices=jax.devices()[:8])
        np.testing.assert_array_equal(
            ps.rank_grid(8, tp_size), np.vectorize(lambda d: d.id)(
                mesh.devices))
    with pytest.raises(RuntimeError):
        jax_ps.initialize_model_parallel(tensor_model_parallel_size_=3,
                                         devices=jax.devices()[:8])
    with pytest.raises(RuntimeError, match="not divisible"):
        ps.rank_grid(8, 3)


def test_getters_without_a_grid():
    assert not ps.model_parallel_is_initialized()
    assert ps.get_tensor_model_parallel_world_size() == 1
    assert ps.get_data_parallel_world_size() == 1
    assert ps.get_model_parallel_world_size() == 1
    assert ps.get_tensor_model_parallel_rank() == 0
    assert ps.get_tensor_model_parallel_src_rank() == 0
    assert groups.axis_size("tp") == 1 and groups.axis_rank("tp") == 0
    x = torch.arange(6.0)
    assert tp.copy_to_tensor_model_parallel_region(x) is x
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        ps.initialize_model_parallel(1)


def test_grid_at_world1(world1):
    grid = ps.initialize_model_parallel(1)
    assert grid.shape == (1, 1, 1) and ps.model_parallel_is_initialized()
    assert ps.get_tensor_model_parallel_world_size() == 1
    assert ps.get_data_parallel_world_size() == 1
    assert ps.get_pipeline_model_parallel_world_size() == 1
    assert groups.axis_group("tp") is ps.get_tensor_model_parallel_group()
    assert groups.axis_group("dp") is ps.get_data_parallel_group()
    assert ps.get_pipeline_model_parallel_rank() == 0
    ps.destroy_model_parallel()
    assert not ps.model_parallel_is_initialized()
    assert groups.axis_group("dp") is dist.group.WORLD
    with pytest.raises(RuntimeError, match="not divisible"):
        ps.initialize_model_parallel(2)
    with pytest.raises(RuntimeError, match="interleaved"):
        ps.initialize_model_parallel(
            1, virtual_pipeline_model_parallel_size_=2)
    for kw in (dict(pipeline_model_parallel_size_=2),
               dict(context_parallel_size_=2),
               dict(expert_model_parallel_size_=2),
               dict(pipeline_model_parallel_size_=2,
                    virtual_pipeline_model_parallel_size_=2)):
        with pytest.raises(NotImplementedError, match="item 6"):
            ps.initialize_model_parallel(1, **kw)


REFUSAL_WORKER = r"""
import sys

import pytest
import torch.distributed as dist

from apex_tpu_torch.models import (
    BertModel,
    DeepseekModel,
    GPTModel,
    MLAConfig,
    TransformerConfig,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.enums import AttnMaskType

rank = int(sys.argv[2])
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 2),
                        rank=rank, world_size=2)
ps.initialize_model_parallel(2)
assert ps.get_tensor_model_parallel_world_size() == 2
cfg = dict(hidden_size=32, num_layers=1, num_attention_heads=4,
           vocab_size=64, max_position_embeddings=16)
# the decoder models and BERT shard at tp = 2 (their vocabulary too);
# a mixture-of-experts layer still lays its experts out unsharded
gpt = GPTModel(TransformerConfig(**cfg), device="cpu")
assert tuple(gpt.lm_head.shape) == (32, 32)
bert = BertModel(TransformerConfig(**cfg, attn_mask_type=AttnMaskType.padding),
                 device="cpu")
assert tuple(bert.lm_head.shape) == (32, 32)
moe = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
           v_head_dim=8, ffn_hidden_size=48, max_decode_length=32,
           n_routed_experts=4, moe_intermediate_size=8,
           first_k_dense_replace=1)
with pytest.raises(NotImplementedError, match="item 6"):
    DeepseekModel(MLAConfig(**moe), device="cpu")
# the layers take their local shapes from the grid, as JAX's do
col = tp.ColumnParallelLinear(8, 16, device="cpu")
row = tp.RowParallelLinear(16, 8, device="cpu")
emb = tp.VocabParallelEmbedding(64, 8, device="cpu")
assert tuple(col.weight.shape) == (8, 8)
assert tuple(row.weight.shape) == (8, 8)
assert tuple(emb.weight.shape) == (32, 8)
# gloo's connectFullMesh can return on one rank before the other has read
# the handshake: no rank leaves (closing its sockets) before both are here
dist.barrier()
ps.destroy_model_parallel()
dist.destroy_process_group()
print(f"RANK{rank}_OK")
"""


def test_unsharded_models_refuse_tp_above_one(tmp_path):
    # a real tp = 2 grid: two gloo ranks, each in its own interpreter
    script = tmp_path / "worker.py"
    script.write_text(REFUSAL_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "store"), str(r)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(timeout=120)
            assert p.returncode == 0 and f"RANK{r}_OK" in log, (
                f"rank {r} failed:\n{log}")
    finally:
        for p in procs:
            p.kill()


GPT_CONFIGS = {
    "mha_gelu": dict(hidden_size=32, num_layers=2, num_attention_heads=4,
                     vocab_size=64, max_position_embeddings=16),
    "gqa_swiglu": dict(hidden_size=32, num_layers=2, num_attention_heads=8,
                       num_query_groups=4, ffn_hidden_size=48,
                       vocab_size=64, max_position_embeddings=16,
                       activation="swiglu", normalization="rmsnorm",
                       position_embedding_type="rope"),
}


@pytest.mark.parametrize("name", sorted(GPT_CONFIGS))
@pytest.mark.parametrize("tp_size", [1, 2, 4])
def test_split_params_for_tp_matches_jax(name, tp_size):
    kw = dict(GPT_CONFIGS[name], use_flash_attention=False)
    cfg_j = JaxConfig(**kw, compute_dtype=jnp.float32)
    params = JaxGPTModel(cfg_j).init(jax.random.PRNGKey(3),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    want = from_jax_params(jax.tree.map(np.asarray, jax_tp_split.
                                        split_params_for_tp(cfg_j, params,
                                                            tp_size)))
    cfg = TransformerConfig(**kw, compute_dtype=torch.float32)
    state = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    assert state.keys() == GPTModel(cfg, device="cpu").state_dict().keys()
    got = split_params_for_tp(cfg, state, tp_size)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape[0] == tp_size, k
        assert torch.equal(got[k], want[k]), k


def test_split_params_for_tp_refuses_what_jax_refuses():
    cfg = TransformerConfig(**GPT_CONFIGS["gqa_swiglu"])
    state = GPTModel(cfg, device="cpu").state_dict()
    with pytest.raises(ValueError, match="query_groups"):
        split_params_for_tp(cfg, state, 8)
    with pytest.raises(ValueError, match="unrecognized weight matrix"):
        split_params_for_tp(cfg, {"mystery.weight": torch.zeros(4, 4)}, 2)


def test_utils_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    want = jax_tp_utils.split_tensor_along_last_dim(jnp.asarray(x), 3)
    for contiguous in (False, True):
        got = tp.split_tensor_along_last_dim(torch.from_numpy(x), 3,
                                             contiguous)
        assert len(got) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for args in ((64, 1, 4), (64, 3, 4)):
        assert (tp.VocabUtility.vocab_range_from_global_vocab_size(*args)
                == jax_tp_utils.VocabUtility
                .vocab_range_from_global_vocab_size(*args))
    assert tp.divide(12, 4) == 3
    with pytest.raises(AssertionError):
        tp.divide(12, 5)


def test_random_streams_and_checkpoint(world1):
    ps.initialize_model_parallel(1)
    tp.model_parallel_seed(1234, device="cpu")
    tracker = tp.get_rng_state_tracker()
    name = tp.model_parallel_rng_tracker_name()
    states = tracker.get_states()
    want = torch.Generator().manual_seed(1234 + 2718)  # tp rank 0
    assert torch.equal(states[name], want.get_state())
    with tracker.fork() as g1:
        a = torch.rand(3, generator=g1)
    with tracker.fork() as g2:
        b = torch.rand(3, generator=g2)
    assert not torch.equal(a, b)  # the stream advanced
    tracker.set_states(states)
    with tracker.fork() as g3:
        assert torch.equal(torch.rand(3, generator=g3), a)
    with pytest.raises(Exception, match="already exists"):
        tracker.add(name, 1, device="cpu")

    w = torch.randn(5, 5, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(1))

    def f(a):
        return torch.tanh(a @ w) @ w

    y = tp.checkpoint(f, False, x)
    (gw,) = torch.autograd.grad(y.sum(), [w])
    (want_gw,) = torch.autograd.grad(f(x).sum(), [w])
    torch.testing.assert_close(gw, want_gw, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        tp.checkpoint(f, True, x)
    out = tp.broadcast_data(["a", "b"], {"a": x, "b": x.long()},
                            torch.float32)
    assert torch.equal(out["a"], x) and out["b"].dtype == torch.float32


def test_port_imports_neither_jax_nor_the_jax_package():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import apex_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    apex_tpu_torch.__path__, 'apex_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'apex_tpu'\n"
        "             or m.startswith('apex_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'apex_tpu_torch.parallel.mesh2d' in names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 40
