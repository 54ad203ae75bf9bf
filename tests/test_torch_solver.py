"""The port's solver (segmentron_tpu_torch/solver) against the JAX package's,
on the CPU: the losses on the same numpy logits and targets (CE, mixed CE
with aux outputs, OHEM with the threshold binding and with ``min_kept``
binding, the per-output weighted CE, an all-ignore batch) to rtol 1e-5;
the dispatch of ``get_segmentation_loss`` and the losses not ported yet;
the three LR schedules at a few steps to rtol 1e-6 (and 1e-6 of the base
LR absolute: the JAX schedules run in f32); and the optimizer:
two SGD steps, one Adam and one AdamW step, with the backbone/decoder LR
split, against ``get_optimizer``'s optax chain on the same small tree and
the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentron_tpu.config import cfg as jax_cfg
from segmentron_tpu.solver import get_lr_scheduler as jax_lr
from segmentron_tpu.solver import get_optimizer as jax_optimizer
from segmentron_tpu.solver import loss as jax_loss
from segmentron_tpu_torch.config import cfg as port_cfg
from segmentron_tpu_torch.solver import get_lr_scheduler, get_optimizer, loss

torch.set_num_threads(2)

LOSS_RTOL = 1e-5


def _restore(cfg, snapshot):
    cfg.defrost()
    cfg.clear()
    for k, v in type(cfg)(snapshot).items():
        dict.__setitem__(cfg, k, v)


@pytest.fixture()
def cfgs():
    snapshots = jax_cfg.to_dict(), port_cfg.to_dict()
    yield jax_cfg, port_cfg
    _restore(jax_cfg, snapshots[0])
    _restore(port_cfg, snapshots[1])


def _outputs(n_out=3, seed=0, shape=(2, 12, 10), nclass=7, ignore=0.2):
    rng = np.random.RandomState(seed)
    outs = [(rng.randn(*shape, nclass) * 2).astype(np.float32) for _ in range(n_out)]
    target = rng.randint(0, nclass, shape).astype(np.int32)
    target[rng.rand(*shape) < ignore] = -1
    return outs, target


def _both(port_fn, jax_fn, outs, target, **kw):
    got = port_fn([torch.from_numpy(o) for o in outs], torch.from_numpy(target), **kw)
    want = jax_fn([jnp.asarray(o) for o in outs], jnp.asarray(target), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    return float(got), float(want)


def test_cross_entropy():
    outs, target = _outputs(1)
    got = loss.cross_entropy(torch.from_numpy(outs[0]), torch.from_numpy(target))
    want = jax_loss.cross_entropy(jnp.asarray(outs[0]), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_cross_entropy_of_bf16_logits_in_f32():
    outs, target = _outputs(1, seed=5)
    half = torch.from_numpy(outs[0]).to(torch.bfloat16)
    got = loss.cross_entropy(half, torch.from_numpy(target))
    want = jax_loss.cross_entropy(jnp.asarray(outs[0], jnp.bfloat16), jnp.asarray(target))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("n_out", [1, 3])
def test_mix_softmax_ce(n_out):
    outs, target = _outputs(n_out, seed=1)
    got, want = _both(loss.mix_softmax_ce_loss, jax_loss.mix_softmax_ce_loss, outs, target,
                      aux_weight=0.4)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("thresh,min_kept", [
    (0.7, 10),      # the threshold binds: more than min_kept pixels below it
    (0.05, 150),    # min_kept binds: the cutoff rises to the 150th smallest prob
])
def test_ohem(thresh, min_kept):
    outs, target = _outputs(2, seed=2)
    got, want = _both(loss.ohem_ce_loss, jax_loss.ohem_ce_loss, outs, target, aux_weight=0.4,
                      thresh=thresh, min_kept=min_kept)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    p_t = torch.softmax(torch.from_numpy(outs[0]), -1).gather(
        -1, torch.from_numpy(target).long().clamp(min=0)[..., None])[..., 0]
    below = int(((p_t <= thresh) & torch.from_numpy(target >= 0)).sum())
    assert (below > min_kept) == (thresh == 0.7)


def test_multi_weight_loss():
    outs, target = _outputs(3, seed=3)
    got, want = _both(loss.multi_weight_loss, jax_loss.multi_weight_loss, outs, target,
                      weights=[1.0, 0.5])  # the third output takes the last weight
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("fn", ["mix", "ohem", "multi"])
def test_all_ignore_batch_is_zero(fn):
    outs, target = _outputs(3, seed=4)
    target[...] = -1
    kw = {"mix": {}, "ohem": dict(min_kept=20), "multi": dict(weights=[1.0, 0.5, 0.5])}[fn]
    name = {"mix": "mix_softmax_ce_loss", "ohem": "ohem_ce_loss", "multi": "multi_weight_loss"}
    got, want = _both(getattr(loss, name[fn]), getattr(jax_loss, name[fn]), outs, target, **kw)
    assert got == 0.0 and want == 0.0


def test_dispatch_and_not_ported():
    get = loss.get_segmentation_loss
    assert get("DANet").func is loss.mix_softmax_ce_loss
    assert get("DANet", multi_loss_weight=[1.0, 0.5, 0.5]).func is loss.multi_weight_loss
    ohem = get("OCNet", use_ohem=True, ohem_thresh=0.6, ohem_min_kept=5,
               multi_loss_weight=[1.0, 0.5])
    assert ohem.func is loss.ohem_ce_loss and ohem.keywords["thresh"] == 0.6
    for model, kw in (("ICNet", {}), ("EncNet", {}), ("PointRend", {}), ("TransLab", {}),
                      ("DANet", dict(loss_name="focal")), ("DANet", dict(loss_name="lovasz")),
                      ("DANet", dict(loss_name="dice"))):
        with pytest.raises(NotImplementedError):
            get(model, **kw)


@pytest.mark.parametrize("opts", [
    ["SOLVER.LR_SCHEDULER", "poly", "SOLVER.WARMUP.EPOCHS", "1.5"],
    ["SOLVER.LR_SCHEDULER", "cosine", "SOLVER.WARMUP.EPOCHS", "1",
     "SOLVER.WARMUP.METHOD", "constant"],
    ["SOLVER.LR_SCHEDULER", "step", "SOLVER.STEP.DECAY_EPOCH", "[2, 4]"],
])
def test_schedules(cfgs, opts):
    for cfg in cfgs:
        cfg.update_from_list(["SOLVER.LR", "0.02", "TRAIN.EPOCHS", "6", *opts])
    want, got = jax_lr(cfgs[0], 10), get_lr_scheduler(cfgs[1], 10)
    for step in (0, 1, 7, 15, 20, 33, 45, 59, 60, 70):
        # the JAX schedules compute in f32: near the end of the cosine,
        # 1e-6 of the base LR absolute
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0.02 * 1e-6,
                                   err_msg=f"step {step}")


class _Tiny(torch.nn.Module):
    """A backbone and a head, named as the flax tree below."""

    def __init__(self, tree):
        super().__init__()
        self.backbone = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree["backbone"].items()})
        self.head = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree["head"].items()})
        self.gamma = torch.nn.Parameter(torch.from_numpy(tree["gamma"].copy()))


@pytest.mark.parametrize("name,steps", [("sgd", 2), ("adam", 1), ("adamw", 1)])
def test_optimizer_matches_optax(cfgs, name, steps):
    """Same params, same gradients: the port's param groups (backbone at
    LR, the rest at LR x DECODER_LR_FACTOR, decay on every leaf) with the
    group LRs set from the schedule before each update, as
    ``make_train_step`` does, against the optax multi-transform."""
    for cfg in cfgs:
        cfg.update_from_list(["SOLVER.OPTIMIZER", name, "SOLVER.LR", "0.05",
                              "SOLVER.WEIGHT_DECAY", "0.01", "TRAIN.EPOCHS", "1"])
    rng = np.random.RandomState(6)
    tree = {"backbone": {"w": rng.randn(4, 3).astype(np.float32),
                         "b": rng.randn(3).astype(np.float32)},
            "head": {"w": rng.randn(3, 2).astype(np.float32)},
            "gamma": np.asarray(0.5, np.float32)}
    grads = [jax.tree_util.tree_map(lambda a: np.asarray(rng.randn(*a.shape), np.float32), tree)
             for _ in range(steps)]
    schedule_j = jax_lr(cfgs[0], 4)
    tx = jax_optimizer(cfgs[0], tree, schedule_j)
    params, state = tree, tx.init(tree)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    model = _Tiny(tree)
    schedule = get_lr_scheduler(cfgs[1], 4)
    opt = get_optimizer(cfgs[1], model, schedule)
    assert [len(g["params"]) for g in opt.param_groups] == [2, 2]
    for k, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = schedule(k) * group["lr_factor"]
        for pname, p in model.named_parameters():
            path = pname.split(".")
            leaf = g[path[0]] if len(path) == 1 else g[path[0]][path[1]]
            p.grad = torch.from_numpy(np.array(leaf))
        opt.step()
    # atol: optax takes Adam's bias correction 1 - b2^t in f32 (1 - 0.999f
    # = 9.99987e-4, 1.3e-5 off), which moves its first update (~LR, 0.5
    # for the head) by ~6e-6 relative
    for pname, p in model.named_parameters():
        path = pname.split(".")
        want = params[path[0]] if len(path) == 1 else params[path[0]][path[1]]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=pname)
