"""Data parallelism in the port's train step against the JAX package's
step on the whole batch, on the CPU.

Gloo ranks started by ``launch.mesh.spawn_ranks`` on a (2, 1) and a
(2, 2) ``("data", "model")`` mesh each take their rows of the batch
(``shard_params`` by the batch's logical axes) and their shards of the
parameters (``storage_pspecs``: heads, MLP, vocabulary and experts over
`model` where they divide), and run one ``train_step_fn``; the reference's ``train_step_fn`` runs the whole batch
on one device.  The qwen1.5 and qwen3-moe smoke configurations in fp32
(in bf16 the frameworks round at other places), plain, with
``grad_compress`` and with ``microbatches=2``; the labels are masked
unevenly over the ranks (``tests/test_torch_train.py``'s batch), so a
mean of the ranks' means would differ from the whole batch's mean.

qwen3-moe runs the expert-parallel route on the (2, 2) mesh, which drops
the tokens an expert's capacity buffer cannot hold; the reference on one
device runs the dense route, which drops none.  Its capacity factor is
set to ``n_experts / experts_per_token``, where the buffer holds every
token, so that both routes compute the same function.

Tolerances are ``tests/test_torch_train.py``'s: the loss rtol 1e-5, the
parameters atol 1e-5 after a step at lr = 1e-3 with AdamW's eps = 1e-3,
where a gradient error ``e`` moves a parameter by at most
``lr * e / eps``.  With ``grad_compress`` the ranks sum bf16 gradients
("bf16 on the wire") where the reference rounds the whole batch's sum
once: where two ranks' parts nearly cancel, the two differ by a bf16
rounding of the parts (measured up to 1.6e-5 at lr = 1e-3), so those
cases step at lr = 1e-4, which bounds that at about 2e-6.  Every rank's
gathered parameters must be bitwise alike.  The spawned ranks import this
module, so it imports ``repro`` (and JAX) only inside tests.
"""
import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import param_specs
from repro_torch.models.params import ParamSpec, tree_map

CPU = "cpu"
TIMEOUT = 120
LOSS_RTOL = 1e-5
STEP_ATOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=4, eps=1e-3)
#: the learning rate of the grad_compress cases (module docstring)
COMPRESSED_LR = 1e-4
B, S = 4, 16
#: (arch, grad_compress, microbatches)
CASES = [(arch, gc, mb) for arch in ("qwen1_5_4b", "qwen3_moe_30b_a3b")
         for gc, mb in ((False, 1), (True, 1), (False, 2))]


def _cfg(arch, grad_compress):
    cfg = get_smoke_config(arch).derive(dtype="float32",
                                        grad_compress=grad_compress)
    if cfg.is_moe:
        cfg = cfg.derive(capacity_factor=cfg.n_experts /
                         cfg.experts_per_token)
    return cfg


def _opt(grad_compress):
    return dict(OPT, lr=COMPRESSED_LR) if grad_compress else OPT


def _weights(cfg, seed=0):
    """The parameters by the specs' laws, drawn by numpy."""
    rng = np.random.default_rng(seed)

    def draw(s: ParamSpec):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, s.init == "ones", np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * s.scale
                / np.sqrt(max(1, fan_in))).astype(np.float32)

    return tree_map(draw, param_specs(cfg))


def _batch(cfg, seed=1):
    """Tokens and next-token labels, a few masked (-1), all in row 0."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    return {"tokens": tok, "labels": labels}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _dp_rank(rank, world, device, shape):
    """Every case's step on this rank: its loss and the whole parameters,
    gathered."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import gather_params, shard_params
    from repro_torch.parallel.sharding import (MeshPolicy, param_pspecs,
                                               storage_pspecs)
    from repro_torch.train import OptConfig, adamw_init, train_step_fn
    mesh = init_device_mesh(CPU, shape, mesh_dim_names=("data", "model"))
    out = {}
    for arch, gc, mb in CASES:
        cfg = _cfg(arch, gc)
        pspecs = storage_pspecs(param_specs(cfg), MeshPolicy(), mesh)
        params = shard_params(_weights(cfg), pspecs, mesh, CPU)
        axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        rows = shard_params(_batch(cfg), param_pspecs(axes, MeshPolicy(),
                                                      mesh), mesh, CPU)
        _, _, loss = train_step_fn(params, adamw_init(params), rows,
                                   cfg=cfg, policy=MeshPolicy(), mesh=mesh,
                                   opt=OptConfig(**_opt(gc)),
                                   microbatches=mb, device=CPU)
        full = gather_params(params, pspecs, mesh)
        out[(arch, gc, mb)] = (float(loss), _flat(tree_map(
            lambda t: t.numpy(), full)))
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's step on the whole batch, one device: case ->
    (loss, flat parameters)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as r_smoke
    from repro.parallel.sharding import MeshPolicy as RPolicy
    from repro.train.optimizer import OptConfig as ROpt
    from repro.train.optimizer import adamw_init as r_adamw_init
    from repro.train.step import train_step_fn as r_train_step
    out = {}
    for arch, gc, mb in CASES:
        cfg = _cfg(arch, gc)
        rcfg = r_smoke(arch).derive(**{k: getattr(cfg, k) for k in (
            "dtype", "grad_compress", "capacity_factor")})
        p = jax.tree.map(jnp.asarray, _weights(cfg))
        step = jax.jit(lambda p, s, b, rcfg=rcfg, mb=mb, gc=gc:
                       r_train_step(p, s, b, cfg=rcfg, policy=RPolicy(),
                                    opt=ROpt(**_opt(gc)), microbatches=mb))
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        p2, _, loss = step(p, r_adamw_init(p), batch)
        out[(arch, gc, mb)] = (float(loss), _flat(jax.tree.map(np.asarray,
                                                               p2)))
    return out


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_data_parallel_step_matches_the_whole_batch(tmp_path, reference,
                                                    shape):
    got = spawn_ranks(_dp_rank, shape[0] * shape[1], shape,
                      store_dir=str(tmp_path), device_type=CPU,
                      timeout=TIMEOUT)
    for case in CASES:
        want_loss, want = reference[case]
        loss, params = got[0][case]
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL,
                                   err_msg=str(case))
        assert params.keys() == want.keys()
        for k, v in params.items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=STEP_ATOL,
                                       err_msg=f"{case} {k}")
        for r in got[1:]:
            assert r[case][0] == loss, case
            for k, v in r[case][1].items():
                assert np.array_equal(v, params[k]), (case, k)


def _fail_while_others_wait(rank, world, device):
    """Rank 1 fails while rank 0 waits for it in an all-reduce."""
    import torch
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.all_reduce(torch.ones(1))


def test_a_failed_rank_ends_the_spawn_at_once(tmp_path):
    """A rank that raises leaves at once (it does not tear its group
    down, which could wait on the others' collective): ``spawn_ranks``
    sees its exit code, kills the rank still waiting and raises, well
    inside its timeout."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"exit codes \[.*1.*\]"):
        spawn_ranks(_fail_while_others_wait, 2, store_dir=str(tmp_path),
                    device_type=CPU, timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2
