"""Port parity for ``apex_tpu_torch.contrib.multihead_attn``:
``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` on the weights of the
JAX package's flax modules (carried by ``multihead_params_from_numpy``)
against those modules, on the same numpy inputs, fp32, the JAX side's
matmuls at HIGHEST precision (its Pallas kernels in CPU interpret mode;
the port runs the kernels' plain versions on the CPU).

* Every option and route at dropout 0 with ``is_training`` False: bias,
  ``include_norm_add``, ``separate_qkv_params``, ``mask_additive``,
  ``impl`` "fast" and "default"; no mask, a key-padding mask with an
  all-pad row, the causal time mask, another time mask, an additive
  mask.  The self module's flash route is ``flash_attention_e``, the
  encdec module's the (b, h, s, d) kv_mask lane at tq != tk.
* Gradients (the input's, the key's and every parameter's) on the flash
  routes and one default route.
* The flash route's in-kernel dropout at JAX's own int seed
  (``dropout_seed_from_key`` of the key the module drew): the outputs
  agree, since the keep bits are JAX's counter hash.  The other routes'
  Bernoulli masks come from a torch generator (a departure: JAX draws
  them from threefry), so they are held by their law: the kept fraction
  and the 1 / (1 - p) scale.

Tolerances: outputs 1e-4 and gradients 2e-4, absolute and relative
(fp32 through 256-wide projections, sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import apex_tpu.contrib.multihead_attn.self_multihead_attn as jax_self_mod
from apex_tpu.contrib.multihead_attn import \
    EncdecMultiheadAttn as JaxEncdec
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JaxSelf
from apex_tpu.ops.flash_attention import dropout_seed_from_key
from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                   SelfMultiheadAttn,
                                                   mask_softmax_dropout,
                                                   multihead_params_from_numpy)
from apex_tpu_torch.ops import launch_counts, reset_launch_counts
from apex_tpu_torch.transformer.layers import DropoutRNG

E, H = 256, 4          # d = 64, a head dim the flash kernels take
OUT_TOL = 1e-4
GRAD_TOL = 2e-4


def _masks(kind, b, sq, sk, rng):
    """``(key_padding_mask, attn_mask)`` as numpy, 1 / True = masked."""
    if kind == "none":
        return None, None
    if kind == "kpm":
        kpm = np.zeros((b, sk), bool)
        kpm[1, sk // 2:] = True
        kpm[-1] = True                       # an all-pad row
        return kpm, None
    if kind == "additive":
        return (rng.randn(b, sk) * 2).astype(np.float32), None
    if kind == "causal":
        return None, ~np.tri(sq, sk, dtype=bool)
    if kind == "time":                       # a time mask, not causal
        m = rng.rand(sq, sk) < 0.3
        m[:, 0] = False
        return None, m
    raise ValueError(kind)


def _to_t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _module_pair(jax_cls, torch_cls, kw, args, seed):
    jm = jax_cls(embed_dim=E, num_heads=H, **kw)
    params = jm.init(jax.random.PRNGKey(seed), *args, is_training=False)
    # the zero-initialized biases and unit LayerNorm would hide a wrong
    # route: give every parameter seeded values
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.randn(*a.shape))
        .astype(np.float32), params["params"])
    tm = torch_cls(E, H, **kw)
    tm.load_state_dict(multihead_params_from_numpy(params))
    return jm, params, tm


SELF_CASES = [
    (dict(), "none"),
    (dict(), "kpm"),
    (dict(), "causal"),
    (dict(), "time"),
    (dict(bias=True, include_norm_add=True), "kpm"),
    (dict(bias=True, separate_qkv_params=True), "causal"),
    (dict(mask_additive=True, bias=True), "additive"),
    (dict(impl="default"), "kpm"),
    (dict(impl="default", include_norm_add=True), "causal"),
    (dict(impl="default", separate_qkv_params=True), "none"),
]


@pytest.mark.parametrize("kw,mask", SELF_CASES)
def test_self_module_matches_jax(kw, mask):
    sq, b = 64, 3
    rng = np.random.RandomState(len(mask) + len(kw))
    x = rng.randn(sq, b, E).astype(np.float32)
    kpm, am = _masks(mask, b, sq, sq, rng)
    jm, params, tm = _module_pair(JaxSelf, SelfMultiheadAttn, kw,
                                  (jnp.asarray(x),), seed=3)
    with jax.default_matmul_precision("highest"):
        want, _ = jm.apply({"params": params}, jnp.asarray(x),
                           key_padding_mask=kpm, attn_mask=am,
                           is_training=False)
    got, none = tm(torch.from_numpy(x), key_padding_mask=_to_t(kpm),
                   attn_mask=_to_t(am), is_training=False)
    assert none is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=OUT_TOL, atol=OUT_TOL)


ENCDEC_CASES = [
    (dict(), "none"),
    (dict(), "kpm"),
    (dict(bias=True, include_norm_add=True), "kpm"),
    (dict(), "time"),
    (dict(impl="default"), "kpm"),
    (dict(impl="default", bias=True), "time"),
]


@pytest.mark.parametrize("kw,mask", ENCDEC_CASES)
def test_encdec_module_matches_jax(kw, mask):
    tq, tk, b = 48, 96, 3
    rng = np.random.RandomState(len(mask) + 7 * len(kw))
    x = rng.randn(tq, b, E).astype(np.float32)
    mem = rng.randn(tk, b, E).astype(np.float32)
    kpm, am = _masks(mask, b, tq, tk, rng)
    jm, params, tm = _module_pair(JaxEncdec, EncdecMultiheadAttn, kw,
                                  (jnp.asarray(x), jnp.asarray(mem)), seed=4)
    with jax.default_matmul_precision("highest"):
        want, _ = jm.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(mem), key_padding_mask=kpm,
                           attn_mask=am, is_training=False)
    got, _ = tm(torch.from_numpy(x), torch.from_numpy(mem),
                key_padding_mask=_to_t(kpm), attn_mask=_to_t(am),
                is_training=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=OUT_TOL, atol=OUT_TOL)


def _grads_match(jm, params, tm, inputs, masks):
    """Gradients of sum(out * ct) in the inputs and every parameter."""
    kpm, am = masks
    rng = np.random.RandomState(0)
    x0 = inputs[0]
    ct = rng.randn(*x0.shape).astype(np.float32)

    def loss(params, *xs):
        out, _ = jm.apply({"params": params}, *xs, key_padding_mask=kpm,
                          attn_mask=am, is_training=False)
        return jnp.sum(out * ct)

    with jax.default_matmul_precision("highest"):
        gj = jax.grad(loss, argnums=tuple(range(1 + len(inputs))))(
            params, *map(jnp.asarray, inputs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out, _ = tm(*ts, key_padding_mask=_to_t(kpm), attn_mask=_to_t(am),
                is_training=False)
    (out * torch.from_numpy(ct)).sum().backward()
    for t, g in zip(ts, gj[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    want = multihead_params_from_numpy(gj[0])
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kw,mask", [
    (dict(bias=True, include_norm_add=True), "kpm"),
    (dict(separate_qkv_params=True), "causal"),
    (dict(impl="default", bias=True), "kpm"),
])
def test_self_module_grads_match_jax(kw, mask):
    sq, b = 64, 3
    rng = np.random.RandomState(11)
    x = rng.randn(sq, b, E).astype(np.float32)
    jm, params, tm = _module_pair(JaxSelf, SelfMultiheadAttn, kw,
                                  (jnp.asarray(x),), seed=5)
    _grads_match(jm, params, tm, (x,), _masks(mask, b, sq, sq, rng))


@pytest.mark.parametrize("kw", [dict(bias=True, include_norm_add=True),
                                dict(impl="default")])
def test_encdec_module_grads_match_jax(kw):
    tq, tk, b = 48, 96, 3
    rng = np.random.RandomState(12)
    x = rng.randn(tq, b, E).astype(np.float32)
    mem = rng.randn(tk, b, E).astype(np.float32)
    jm, params, tm = _module_pair(JaxEncdec, EncdecMultiheadAttn, kw,
                                  (jnp.asarray(x), jnp.asarray(mem)), seed=6)
    _grads_match(jm, params, tm, (x, mem), _masks("kpm", b, tq, tk, rng))


class _SeededRNG(DropoutRNG):
    """A DropoutRNG whose flash seed is JAX's (the Bernoulli masks stay
    the torch generator's)."""

    def __init__(self, seed_value):
        super().__init__(0)
        self.value = seed_value

    def seed(self) -> int:
        return self.value


@pytest.mark.parametrize("mask", ["kpm", "causal", "none"])
def test_flash_dropout_matches_jax_at_its_seed(mask, monkeypatch):
    sq, b, rate = 64, 3, 0.3
    rng = np.random.RandomState(21)
    x = rng.randn(sq, b, E).astype(np.float32)
    kpm, am = _masks(mask, b, sq, sq, rng)
    kw = dict(dropout=rate, bias=True)
    jm, params, tm = _module_pair(JaxSelf, SelfMultiheadAttn, kw,
                                  (jnp.asarray(x),), seed=8)
    seen = {}
    core = jax_self_mod.attn_core_qkv

    def spy(*a, **k):
        seen["rng"] = k["rng"]
        return core(*a, **k)

    monkeypatch.setattr(jax_self_mod, "attn_core_qkv", spy)
    with jax.default_matmul_precision("highest"):
        want, _ = jm.apply({"params": params}, jnp.asarray(x),
                           key_padding_mask=kpm, attn_mask=am,
                           is_training=True,
                           rngs={"dropout": jax.random.PRNGKey(99)})
    seed = int(dropout_seed_from_key(seen["rng"]))
    got, _ = tm(torch.from_numpy(x), key_padding_mask=_to_t(kpm),
                attn_mask=_to_t(am), is_training=True, rng=_SeededRNG(seed))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=OUT_TOL, atol=OUT_TOL)
    plain, _ = tm(torch.from_numpy(x), key_padding_mask=_to_t(kpm),
                  attn_mask=_to_t(am), is_training=False)
    assert float((plain - got).detach().abs().max()) > 1e-2   # dropout acted


def test_bernoulli_dropout_keeps_its_law():
    p = 0.3
    scores = torch.randn(4, 4, 128, 128)
    rng = DropoutRNG(5)
    probs = mask_softmax_dropout(scores, dropout_prob=p, rng=rng)
    plain = mask_softmax_dropout(scores)
    kept = probs != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    torch.testing.assert_close(probs[kept], plain[kept] / (1 - p))
    # the hidden dropout of include_norm_add and the default route's
    # attention dropout, through the module
    m = SelfMultiheadAttn(E, H, dropout=p, include_norm_add=True,
                          impl="default")
    x = torch.randn(32, 2, E)
    out, _ = m(x, is_training=True, rng=DropoutRNG(1))
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="rng"):
        m(x, is_training=True)
    out0, _ = m(x, is_training=False)
    assert not torch.equal(out, out0)


def test_no_launch_on_cpu_and_eval_mode():
    m = EncdecMultiheadAttn(E, H, dropout=0.2, include_norm_add=True)
    x, mem = torch.randn(8, 2, E), torch.randn(16, 2, E)
    reset_launch_counts()
    m.eval()
    a, _ = m(x, mem, key_padding_mask=torch.zeros(2, 16, dtype=torch.bool))
    b, _ = m(x, mem, key_padding_mask=torch.zeros(2, 16, dtype=torch.bool))
    assert torch.equal(a, b)                 # eval: no dropout, no rng
    assert not any(launch_counts().values())
