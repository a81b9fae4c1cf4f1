"""Port parity: the ResNet train step (``apex_tpu_torch.models.resnet``,
``parallel.SyncBatchNorm``, amp's staged and pipeline routes with
``fused_sgd`` / ``fused_adam``) against ``apex_tpu``'s, on the CPU.

``resnet_tiny`` (stages (1, 1), width 16) with 10 classes at 32x32,
batch 4: the same seeded weights (the port's, carried to a flax tree by
name) and the same numpy batch go through ``apex_tpu.models.resnet`` and
``amp.initialize(..., fused_sgd(0.1, momentum=0.9, weight_decay=1e-4,
use_pallas=True), "O5", pipeline=...)`` and through the port
(``main_amp.run_steps``); the JAX optimizer bodies run in interpret
mode.

Tolerances, each set with room over the gap measured on this CPU:
- the forward, fp32 compute: logits and running statistics within 1e-5
  (measured ~1e-6: other summation orders in the convolutions and the
  batch-norm sums); bf16 compute: logits within 0.02 (measured 0.0033;
  each framework's bf16 logits are 0.010 from its own fp32 ones, as bf16
  rounds every activation at other places) and statistics within 1e-3
  (2.5e-5);
- training, 4 steps at lr 0.1 on one batch.  Under O5 the model copy is
  the bf16 rounding of the master, so a one-ulp master difference can
  move a weight by a bf16 ulp, and the gap grows about tenfold a step
  (fp32 compute: losses 0, 2.4e-7, 3.5e-6, 3.5e-5): losses within 1e-4,
  the masters' distance from JAX's within 1e-2 of how far JAX's moved
  (measured 2.5e-3), statistics within 1e-3 (3.4e-4).  bf16 compute:
  losses within 0.03 (0.015), masters within 0.5 of the move (0.25),
  statistics within 0.1 (0.033).  Adam, fp32: losses within 1e-5 (1.4e-6),
  masters within 5e-2 of the move (1.4e-2: where a stem channel is
  positive at every position the next batch norm removes its bias's
  effect, so that bias's exact gradient is 0 and both frameworks return
  rounding noise, ~1e-8, which Adam turns into a full +-lr step).  O2
  (fp16 weights, dynamic scale from 2^16): the same (finite, scale,
  skipped) a step as JAX's; fp32 compute losses within 1e-5 (3.6e-6),
  masters 1e-3 of the move (6.7e-5), statistics 1e-4 (1.2e-5); fp16
  compute losses within 5e-3 (1.5e-3), masters 0.2 of the move (0.055),
  statistics 0.05 (0.0095).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jax_amp
from apex_tpu.contrib.xentropy import softmax_cross_entropy_loss as jax_xent
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.models.resnet import ResNet50 as JaxResNet50
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu_torch import amp
from apex_tpu_torch.amp.cast import cast_dtype
from apex_tpu_torch.examples.imagenet import main_amp
from apex_tpu_torch.models import resnet as port_resnet
from apex_tpu_torch.models.resnet import (ResNet50, resnet_state_from_numpy,
                                          resnet_tiny)
from apex_tpu_torch.optimizers import fused_adam, fused_sgd
from apex_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model

CLASSES, SIZE, BATCH, STEPS = 10, 32, 4, 4
F32_TOL = 1e-5
BF16_LOGIT_TOL, BF16_STATS_TOL = 0.02, 1e-3
# (losses, masters relative to JAX's move, running statistics)
TRAIN_TOL = {("O5", torch.float32): (1e-4, 1e-2, 1e-3),
             ("O5", torch.bfloat16): (0.03, 0.5, 0.1),
             ("adam", torch.float32): (1e-5, 5e-2, 1e-3),
             ("O2", torch.float32): (1e-5, 1e-3, 1e-4),
             ("O2", torch.float16): (5e-3, 0.2, 0.05)}
JAXD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


def _port_weights(seed=0):
    """The port's seeded tiny ResNet state, with the batch norms'
    affine and running statistics drawn too (so eval mode and the fp32
    BN leaves are exercised)."""
    net = resnet_tiny(num_classes=CLASSES).reset_parameters(
        torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    for k, v in sd.items():
        if k.endswith((".weight", ".bias")) and v.dim() == 1 and \
                "SyncBatchNorm" in k:
            base = 1.0 if k.endswith("weight") else 0.0
            v.copy_(torch.from_numpy(base + 0.1 * rng.randn(v.numel())))
        elif k.endswith(".mean"):
            v.copy_(torch.from_numpy(0.1 * rng.randn(v.numel())))
        elif k.endswith(".var"):
            v.copy_(torch.from_numpy(1.0 + 0.2 * rng.rand(v.numel())))
    return sd


def _to_flax(sd):
    """A port state dict as flax ``params`` / ``batch_stats`` trees
    (the inverse of ``resnet_state_from_numpy``)."""
    params, stats = {}, {}
    for key, v in sd.items():
        *path, leaf = key.split(".")
        a = v.numpy()
        if leaf in ("mean", "var"):
            tree = stats
        else:
            tree = params
            if leaf == "weight" and a.ndim == 4:
                a, leaf = a.transpose(2, 3, 1, 0), "kernel"
            elif leaf == "weight" and a.ndim == 2:
                a, leaf = a.T, "kernel"
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = jnp.asarray(np.ascontiguousarray(a))
    return params, stats


@pytest.fixture(scope="module")
def weights():
    return _port_weights(0)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(3)
    return (rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
            rng.randint(0, CLASSES, BATCH).astype(np.int32))


def _jax_model(dtype):
    return JaxResNet(stage_sizes=(1, 1), width=16, num_classes=CLASSES,
                     dtype=JAXD[dtype])


def _port_model(dtype, sd):
    net = resnet_tiny(num_classes=CLASSES, dtype=dtype)
    net.load_state_dict(sd)
    return net


@pytest.mark.parametrize("dtype,tol,stats_tol", [
    (torch.float32, F32_TOL, F32_TOL),
    (torch.bfloat16, BF16_LOGIT_TOL, BF16_STATS_TOL)])
def test_forward_train_and_eval_match_jax(weights, batch, dtype, tol,
                                          stats_tol):
    x, _ = batch
    params, stats = _to_flax(weights)
    model = _jax_model(dtype)
    xj = jnp.asarray(x).astype(JAXD[dtype])
    lj, mut = model.apply({"params": params, "batch_stats": stats}, xj,
                          train=True, mutable=["batch_stats"])
    ej = model.apply({"params": params, "batch_stats": mut["batch_stats"]},
                     xj, train=False)
    net = _port_model(dtype, weights)
    xt = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        lt = net(xt, train=True)
        et = net(xt, train=False)            # on the updated statistics
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=tol)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=tol)
    moved = resnet_state_from_numpy({}, jax.tree.map(np.asarray,
                                                     mut["batch_stats"]))
    buffers = dict(net.named_buffers())
    for k, v in moved.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=0,
                                   atol=stats_tol)
    assert not torch.equal(buffers["SyncBatchNorm_0.mean"],
                           weights["SyncBatchNorm_0.mean"])


def test_padding_fault_fails_the_logits_check(weights, batch, monkeypatch):
    # torch's symmetric padding at the 7x7/2 stem gives the same output
    # size over windows shifted by one: the logits check must see it
    x, _ = batch
    params, stats = _to_flax(weights)
    lj = _jax_model(torch.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False)
    sound = port_resnet.same_pads

    def symmetric_stem(size, k, stride):
        lo, hi = sound(size, k, stride)
        return (hi, hi) if k == 7 else (lo, hi)

    monkeypatch.setattr(port_resnet, "same_pads", symmetric_stem)
    with torch.no_grad():
        lt = _port_model(torch.float32, weights)(torch.from_numpy(x),
                                                  train=False)
    assert lt.shape == (BATCH, CLASSES)
    assert float(np.abs(lt.numpy() - np.asarray(lj)).max()) > 100 * F32_TOL


def _jax_train(dtype, sd, batch, tx, opt_level, pipeline, steps=STEPS):
    """``steps`` JAX amp steps from ``sd``: losses, (finite, scale,
    skipped) a step, the fp32 masters and the running statistics, both
    as port state dicts."""
    x, labels = batch
    model = _jax_model(dtype)
    params, stats = _to_flax(sd)
    params, aopt, state = jax_amp.initialize(params, tx,
                                             opt_level=opt_level,
                                             pipeline=pipeline)
    xj, lab = jnp.asarray(x).astype(JAXD[dtype]), jnp.asarray(labels)

    def step(params, stats, state):
        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": stats},
                                      xj, train=True,
                                      mutable=["batch_stats"])
            loss = jnp.mean(jax_xent(logits, lab, half_to_float=True))
            return aopt.scale_loss(loss, state), (loss, mut)

        grads, (loss, mut) = jax.grad(loss_fn, has_aux=True)(params)
        params, state, info = aopt.apply_gradients(grads, state, params)
        return params, mut["batch_stats"], state, loss, info

    step = jax.jit(step)
    losses, infos = [], []
    for _ in range(steps):
        params, stats, state, loss, info = step(params, stats, state)
        losses.append(float(loss))
        infos.append((bool(info.grads_finite), float(info.loss_scale),
                      int(info.steps_skipped)))
    masters = state.master_params
    if isinstance(masters, jax_amp.mixed_precision._pipeline.PackedMasters):
        masters = masters.to_model(
            jax.tree.map(lambda a: a.astype(jnp.float32), params))
    return (losses, infos,
            resnet_state_from_numpy(jax.tree.map(np.asarray, masters)),
            resnet_state_from_numpy({}, jax.tree.map(np.asarray, stats)))


def _port_train(dtype, sd, batch, tx, opt_level, pipeline, steps=STEPS):
    x, labels = batch
    net = _port_model(dtype, sd)
    net, aopt = amp.initialize(net, tx, opt_level=opt_level,
                               pipeline=pipeline)
    setup = main_amp.TrainSetup(
        net, aopt, torch.Generator(), torch.from_numpy(x).to(dtype),
        torch.from_numpy(labels).long(), 0, None)
    r = main_amp.run_steps(setup, steps)
    return r, aopt, dict(net.named_buffers())


def _hold(r, aopt, buffers, jax_run, start, key):
    """Losses, masters (their distance from JAX's relative to how far
    JAX's moved from ``start``) and running statistics within
    ``TRAIN_TOL[key]``; the (finite, scale, skipped) sequence equal."""
    jl, ji, jm, js = jax_run
    loss_tol, move_tol, stats_tol = TRAIN_TOL[key]
    assert r.steps == ji
    np.testing.assert_allclose(r.losses, jl, rtol=0, atol=loss_tol)
    got = aopt.masters()
    assert set(got) == set(jm)
    assert {v.dtype for v in got.values()} == {torch.float32}
    off = sum(float(((got[k] - v) ** 2).sum()) for k, v in jm.items())
    moved = sum(float(((v - start[k]) ** 2).sum()) for k, v in jm.items())
    assert moved > 0 and (off / moved) ** 0.5 <= move_tol
    for k, v in js.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=0,
                                   atol=stats_tol, err_msg=k)


SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)


def _jax_sgd():
    return jax_fused_sgd(0.1, momentum=0.9, weight_decay=1e-4,
                         use_pallas=True)


@pytest.mark.parametrize("pipeline", [None, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_o5_sgd_steps_match_jax(weights, batch, dtype, pipeline):
    # the default route (staged at this size, as JAX's) and pipeline=True
    jax_run = _jax_train(dtype, weights, batch, _jax_sgd(), "O5", pipeline)
    r, aopt, buffers = _port_train(dtype, weights, batch, fused_sgd(**SGD),
                                   "O5", pipeline)
    assert aopt.use_pipeline is bool(pipeline)
    assert len(aopt.groups) == (2 if pipeline else 0)
    assert r.losses[-1] < r.losses[0]
    _hold(r, aopt, buffers, jax_run, weights, ("O5", dtype))


def test_o5_adam_staged_steps_match_jax(weights, batch):
    jax_run = _jax_train(
        torch.float32, weights, batch,
        jax_fused_adam(1e-3, weight_decay=1e-4, use_pallas=True), "O5",
        None)
    r, aopt, buffers = _port_train(torch.float32, weights, batch,
                                   fused_adam(1e-3, weight_decay=1e-4),
                                   "O5", None)
    assert not aopt.use_pipeline
    _hold(r, aopt, buffers, jax_run, weights, ("adam", torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_o2_staged_steps_match_jax(weights, batch, dtype):
    # fp16 weights, fp32 batch norm, a dynamic scale from 2^16: the finite
    # check reads one flag a step; skips and scales equal JAX's
    jax_run = _jax_train(dtype, weights, batch, _jax_sgd(), "O2", None)
    r, aopt, buffers = _port_train(dtype, weights, batch, fused_sgd(**SGD),
                                   "O2", None)
    assert not aopt.use_pipeline
    assert r.steps[-1][1] == 2.0 ** 16
    _hold(r, aopt, buffers, jax_run, weights, ("O2", dtype))


def test_staged_skip_holds_everything_bitwise(weights, batch):
    # a non-finite gradient under a dynamic scale: masters, momentum and
    # the model copy unchanged, the count held, the scale halved
    x, labels = batch
    net, aopt = amp.initialize(_port_model(torch.float32, weights),
                               fused_sgd(**SGD), opt_level="O2")
    setup = main_amp.TrainSetup(net, aopt, torch.Generator(),
                                torch.from_numpy(x),
                                torch.from_numpy(labels).long(), 0, None)
    main_amp.run_steps(setup, 1)
    before = ({k: v.clone() for k, v in aopt.masters().items()},
              [m.clone() for m in aopt.state.momentum],
              {k: v.clone() for k, v in net.named_parameters()},
              aopt.state.count, aopt.scaler.loss_scale)
    aopt.zero_grad()
    logits = net(setup.images, train=True)
    aopt.scale_loss(logits.sum() * float("inf")).backward()
    info = aopt.apply_gradients()
    assert not info.grads_finite and info.grads_checked
    assert info.loss_scale == before[4] / 2 and info.steps_skipped == 1
    assert aopt.state.count == before[3] == 1
    assert all(torch.equal(v, before[0][k])
               for k, v in aopt.masters().items())
    assert all(torch.equal(a, b)
               for a, b in zip(aopt.state.momentum, before[1]))
    assert all(torch.equal(v, before[2][k])
               for k, v in net.named_parameters())


def _jax_resnet50_params():
    model = JaxResNet50(num_classes=1000, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 32, 3), jnp.bfloat16),
                           train=True))
    return shapes["params"]


def test_resnet50_structure_matches_jax():
    # the parameter tree bench_resnet50 steps: 161 leaves, 25,557,032
    # elements, 106 batch-norm leaves kept fp32 under O5
    jparams = _jax_resnet50_params()
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    jshapes = {".".join(k.key for k in path): tuple(l.shape)
               for path, l in leaves}
    net = ResNet50(device="meta")
    named = list(net.named_parameters())
    o5 = amp.get_policy("O5")
    fp32 = [n for n, p in named if cast_dtype(n, p, o5) == torch.float32]
    assert len(named) == len(jshapes) == 161
    assert sum(p.numel() for _, p in named) == 25_557_032
    assert len(fp32) == 106 and all("SyncBatchNorm" in n for n in fp32)
    for name, p in named:
        jname = name.replace(".weight", ".kernel") \
            if "SyncBatchNorm" not in name else name
        want = jshapes[jname]
        got = tuple(p.shape)
        if len(got) == 4:
            got = (got[2], got[3], got[1], got[0])     # OIHW -> HWIO
        elif len(got) == 2:
            got = got[::-1]                            # (out, in) -> (in, out)
        assert got == want, name
    jcast = jax.eval_shape(lambda p: jax_amp.cast_params(
        p, jax_amp.get_policy("O5")), jparams)
    from apex_tpu.ops.fused_pipeline import packed_nbytes as jax_nbytes
    assert amp.packed_nbytes(named, o5) == jax_nbytes(jcast) == 51_220_304


def _routes(tx_jax, template, named):
    """(JAX's, the port's) default routing decision, from shapes only."""
    jaopt = jax_amp.AmpOptimizer(tx_jax, jax_amp.get_policy("O5"))
    port = amp.AmpOptimizer(fused_sgd(**SGD), amp.get_policy("O5"))
    return jaopt._route_pipeline(template), port.route_pipeline(named)


def test_routing_matches_jax_from_shapes():
    from apex_tpu.testing.standalone_gpt import GPTModel as JaxGPT
    from apex_tpu_torch.testing.standalone_gpt import MODELS, GPTModel

    tx = jax_fused_sgd(0.1, momentum=0.9, weight_decay=1e-4)
    assert _routes(tx, _jax_resnet50_params(),
                   list(ResNet50(device="meta").named_parameters())) \
        == (False, False)
    geo = MODELS["gpt345m"]
    jgpt = JaxGPT(vocab_size=geo["vocab_size"],
                  hidden_size=geo["hidden_size"],
                  num_layers=geo["num_layers"],
                  num_attention_heads=geo["num_heads"],
                  max_sequence_length=geo["max_seq"])
    template = jax.eval_shape(lambda: jgpt.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    net = GPTModel(geo["vocab_size"], geo["hidden_size"], geo["num_layers"],
                   geo["num_heads"], geo["max_seq"], device="meta")
    assert _routes(tx, template, list(net.named_parameters())) \
        == (True, True)


def test_routing_cutoff_and_explicit_choices():
    from apex_tpu.analysis.flags import FLAGS

    assert amp.PIPELINE_PACK_MIN_BYTES \
        == FLAGS["APEX_TPU_PIPELINE_PACK_MIN_BYTES"].default
    named = list(ResNet50(device="meta").named_parameters())
    port = amp.AmpOptimizer(fused_sgd(**SGD), amp.get_policy("O5"))
    assert not port.route_pipeline(named)
    forced = amp.AmpOptimizer(fused_sgd(**SGD), amp.get_policy("O5"),
                              pipeline=True)
    assert forced.route_pipeline(named)
    # fused_lamb has a staged form: pipeline=False takes the staged
    # route, one moment pair a parameter
    from apex_tpu_torch.optimizers import fused_lamb
    net = resnet_tiny(num_classes=CLASSES).reset_parameters(
        torch.Generator().manual_seed(0))
    _, staged = amp.initialize(net, fused_lamb(1e-3), opt_level="O5",
                               pipeline=False)
    assert not staged.use_pipeline
    assert len(staged.state.m) == len(list(net.parameters()))


def test_syncbn_one_rank_only_and_its_backward():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        SyncBatchNorm(8, axis_name="data")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        convert_syncbn_model(axis_name="data")
    bn = convert_syncbn_model()(6)
    assert bn.weight.dtype == torch.float32 and bn.mean.dtype == torch.float32
    # the Function's backward against autograd through the plain formula
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 6, 5, 4, generator=g, dtype=torch.float64).float()
    x.requires_grad_(True)
    w = (1 + 0.1 * torch.randn(6, generator=g)).requires_grad_(True)
    b = (0.1 * torch.randn(6, generator=g)).requires_grad_(True)
    bn.weight.data.copy_(w.detach())
    bn.bias.data.copy_(b.detach())
    dy = torch.randn(3, 6, 5, 4, generator=g)
    y = bn(x)
    gx, gw, gb = torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)
    mean = x.mean((0, 2, 3), keepdim=True)
    var = (x * x).mean((0, 2, 3), keepdim=True) - mean * mean
    ref = (x - mean) * torch.rsqrt(var + 1e-5) * w.view(1, 6, 1, 1) \
        + b.view(1, 6, 1, 1)
    rx, rw, rb = torch.autograd.grad(ref, (x, w, b), dy)
    for got, want in ((y, ref), (gx, rx), (gw, rw), (gb, rb)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the running update: unbiased variance, momentum 0.1
    n = 3 * 5 * 4
    torch.testing.assert_close(
        bn.var, 0.9 + 0.1 * var.flatten().detach() * n / (n - 1))


def test_main_amp_cli_on_the_cpu():
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "apex_tpu_torch.examples.imagenet.main_amp",
           "--synthetic", "--arch", "resnet_tiny", "-b", "4",
           "--image-size", "32", "--iters", "3", "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         check=True).stdout
    last = out.strip().splitlines()[-1]
    assert last.startswith("TRAIN_DONE arch=resnet_tiny opt_level=O5 "
                           "optimizer=sgd route=staged steps=3")
    assert "device=cpu" in last
    # the card is the default: no card here, so it must raise
    run = subprocess.run(cmd[:-2], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0 and "CUDA" in run.stderr


def test_train_setup_is_seeded():
    a = main_amp.make_train_setup("resnet_tiny", batch=2, image_size=32,
                                  num_classes=CLASSES, device="cpu")
    b = main_amp.make_train_setup("resnet_tiny", batch=2, image_size=32,
                                  num_classes=CLASSES, device="cpu")
    assert torch.equal(a.images, b.images)
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                 b.model.parameters()))
    assert dataclasses.is_dataclass(a) and a.flops_per_step is None
