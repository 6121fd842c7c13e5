"""Subprocess helper: the JAX package's side of the port's mesh parity
tests (tests/test_torch_mesh*.py), on 4 forced host devices.

    python tests/helpers/torch_mesh_jax.py loss IN.npz OUT.npz
        the sharded loss ops of repro.core.distributed under shard_map on
        a (data=2, fsdp=2) mesh, over the inputs in IN.npz (the cases of
        tests/helpers/torch_mesh_check.py): loss, per-row aux and the
        gradients of the global mean loss, written to OUT.npz
    python tests/helpers/torch_mesh_jax.py ckpt DIR
        one fsdp=4 step of a reduced clip-vitb32-cc12m v3 state, then
        repro.checkpoint.save_sharded at step 1 into DIR, and the host
        state (flat paths) as DIR/ref.npz
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import distributed as D  # noqa: E402
from repro.core import shard_state as SS  # noqa: E402

AXES = ("data", "fsdp")
EPS = 1e-14


def loss_case(mesh, x, kind, impl, reduce, rows):
    """(loss per device, aux dict, (de1, de2)) of one case."""
    spec = P(AXES)
    e1, e2 = jnp.asarray(x["e1"]), jnp.asarray(x["e2"])
    tau = x["tau_rows"] if rows else x["tau"]
    t = jnp.asarray(tau)

    def body(e1l, e2l, lu1l, lu2l, lw1l, lw2l, t1l, t2l):
        t1 = t1l if rows else t
        if kind == "fcco":
            op = D.make_fcco_loss_op(AXES, EPS, True, loss_impl=impl,
                                     interpret=True, reduce=reduce)
            loss, (lu1n, lu2n, stats, sat) = op(
                e1l, e2l, lu1l, lu2l, t1, t1, float(x["gamma"]))
            aux = (lu1n, lu2n, *stats, sat)
        elif kind == "allgather_ad":
            f = D.make_allgather_ad_pair_loss(AXES, reduce=reduce)
            ones = jnp.ones_like(lw1l)
            loss, stats = f(e1l, e2l, lw1l, lw2l, t1 * ones, t1 * ones)
            aux = tuple(stats)
        else:
            loss = D.make_mbcl_loss(AXES, reduce=reduce)(e1l, e2l, t1)
            aux = ()
        return (loss if reduce == "mean" else jnp.reshape(loss, (1,))), aux

    args = [x[k] for k in ("lu1", "lu2", "lw1", "lw2")]
    n_aux = {"fcco": 9, "allgather_ad": 6, "mbcl": 0}[kind]

    def run(a, b):
        fn = D.shard_map(body, mesh=mesh, in_specs=(spec,) * 6 + (
            (spec, spec) if rows else (P(), P())),
            out_specs=(P() if reduce == "mean" else spec, (spec,) * n_aux))
        targ = t if rows else jnp.zeros(())
        return fn(a, b, *map(jnp.asarray, args), targ, targ)

    def total(a, b):
        # mean: the replicated global loss; local: the devices' shares,
        # which sum to it
        losses, aux = run(a, b)
        return jnp.sum(losses), (losses, aux)

    (_, (losses, aux)), g = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(e1, e2)
    return np.asarray(losses), [np.asarray(a) for a in aux], \
        [np.asarray(v) for v in g]


def cmd_loss(inp, out):
    x = dict(np.load(inp))
    mesh = SS.make_train_mesh(2, 2)
    res = {}
    for case in [str(c) for c in x["cases"]]:
        kind, impl, reduce, tau = case.split("-")
        losses, aux, grads = loss_case(mesh, x, kind, impl, reduce,
                                       tau == "rows")
        res[f"{case}/loss"] = losses
        for i, a in enumerate(aux):
            res[f"{case}/aux{i}"] = a
        res[f"{case}/de1"], res[f"{case}/de2"] = grads
    np.savez(out, **res)


def cmd_ckpt(directory):
    from repro import checkpoint as CK
    from repro.checkpoint.checkpoint import _path_str
    from repro.configs import get_arch
    from repro.core import fastclip as FC
    from repro.core import train_step as TS
    from repro.core.schedules import lr_warmup_cosine
    from repro.data import ContrastiveDataset, ShardedLoader
    from repro.launch.steps import donated_jit
    from repro.optim import adamw
    cfg = get_arch("clip-vitb32-cc12m").reduced()
    fc = FC.FastCLIPConfig(version="v3", n_samples=64, steps_per_epoch=2,
                           gamma_decay_epochs=2)
    mesh = SS.make_train_mesh(1, 4)
    TS.set_mesh(mesh)
    tc = TS.TrainStepConfig(arch=cfg, fc=fc, optimizer=adamw(),
                            lr_fn=lr_warmup_cosine(1e-3, 2, 10), wd=0.1,
                            mesh_axes=SS.TRAIN_AXES, fsdp=True)
    state = jax.device_get(TS.init_train_state(jax.random.PRNGKey(1), tc))
    st, _ = SS.shard_train_state(state, mesh)
    ds = ContrastiveDataset(n=64, image_size=cfg.clip.image_size,
                            context_length=cfg.clip.context_length,
                            vocab_size=cfg.vocab_size, n_classes=8)
    _, _, idx, batch = next(ShardedLoader(ds, global_batch=32,
                                          n_shards=4).steps(1))
    st, _ = donated_jit(TS.make_train_step(tc))(
        st, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(idx))
    CK.save_sharded(directory, st, 1, metadata={"mesh": "1x4"})
    host = jax.device_get(st)
    np.savez(os.path.join(directory, "ref.npz"), **{
        _path_str(p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(host)[0]})


if __name__ == "__main__":
    if sys.argv[1] == "loss":
        cmd_loss(sys.argv[2], sys.argv[3])
    else:
        cmd_ckpt(sys.argv[2])
