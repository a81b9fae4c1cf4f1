"""Megatron's arguments in the port: ``apex_tpu_torch.testing.arguments.
parse_args``, ``testing.global_vars`` and ``standalone_bert.
bert_model_provider`` against the JAX package's.

* ``parse_args`` on the same argv gives the JAX namespace key for key,
  ``params_dtype`` mapped (jnp -> torch), with ``--world-size`` given
  (JAX counts its devices, the port its cards); the one other
  difference is ``--distributed-backend``'s default, an unused flag
  (``nccl`` in the port where JAX says ``xla``).  Megatron's defaults:
  dropout 0.1, ``--clip-grad 1.0``, ``--weight-decay 0.01``.
* Without ``--world-size`` the port counts the cards: 1 on the CPU.
* ``set_global_variables`` / ``get_args`` / the microbatch calculator /
  ``destroy_global_vars``, the counts JAX's give.
* ``bert_model_provider`` on the same args (a 2-layer, hidden 128
  BERT, dropout 0, with and without ``--checkpoint-activations``), the
  JAX model's weights carried across, gives JAX's loss on a padded
  batch within ``tests/test_torch_bert.py``'s 2e-5, on the
  materialized route (the provider's default) and with
  ``use_flash=True`` passed through ``overrides``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.contrib.xentropy import \
    softmax_cross_entropy_loss as jax_xentropy
from apex_tpu.testing import arguments as jax_arguments
from apex_tpu.testing import global_vars as jax_global_vars
from apex_tpu.testing.standalone_bert import \
    bert_model_provider as jax_provider
from apex_tpu.testing.standalone_gpt import unbox
from apex_tpu_torch.testing import arguments, global_vars
from apex_tpu_torch.testing.standalone_bert import (bert_loss,
                                                    bert_model_provider,
                                                    bert_params_from_numpy)

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.float16: torch.float16}
BERT_LARGE = ["--num-layers", "24", "--hidden-size", "1024",
              "--num-attention-heads", "16", "--seq-length", "512",
              "--max-position-embeddings", "512", "--micro-batch-size", "16",
              "--vocab-size", "30528", "--lr", "1e-4", "--bf16",
              "--checkpoint-activations", "--world-size", "1"]
TINY = ["--num-layers", "2", "--hidden-size", "128",
        "--num-attention-heads", "2", "--seq-length", "64",
        "--max-position-embeddings", "64", "--vocab-size", "256",
        "--attention-dropout", "0", "--hidden-dropout", "0",
        "--world-size", "1"]
FWD_TOL = 2e-5


def _same_namespace(argv, **kw):
    j = vars(jax_arguments.parse_args(args=argv, **kw))
    t = vars(arguments.parse_args(args=argv, **kw))
    assert set(j) == set(t)
    for k in j:
        if k == "params_dtype":
            assert DTYPES[j[k]] == t[k]
        elif k == "distributed_backend":
            assert (j[k], t[k]) == ("xla", "nccl")
        else:
            assert j[k] == t[k], k
    return t


@pytest.mark.parametrize("argv", [BERT_LARGE, TINY,
                                  BERT_LARGE[:-4] + ["--fp16"]
                                  + BERT_LARGE[-3:],
                                  ["--world-size", "8",
                                   "--tensor-model-parallel-size", "2",
                                   "--micro-batch-size", "2",
                                   "--global-batch-size", "16"]],
                         ids=["bert_large", "tiny", "fp16", "dp4"])
def test_parse_args_matches_jax(argv):
    t = _same_namespace(argv)
    assert t["clip_grad"] == 1.0 and t["weight_decay"] == 0.01
    assert t["lr_decay_style"] == "linear"


def test_parse_args_hooks_match_jax():
    def extra(parser):
        parser.add_argument("--extra-flag", type=int, default=3)
        return parser

    _same_namespace(TINY + ["--unknown", "1"], extra_args_provider=extra,
                    defaults={"lr": 5e-4, "train_iters": 10},
                    ignore_unknown_args=True)
    t = arguments.parse_args(args=TINY, defaults={"lr": 5e-4})
    assert t.lr == 5e-4
    assert t.params_dtype == torch.float32 and t.ffn_hidden_size == 512
    with pytest.raises(SystemExit):
        arguments.parse_args(args=TINY + ["--unknown", "1"])


def test_world_size_is_the_card_count():
    t = arguments.parse_args(args=TINY[:-2])
    assert t.world_size == max(1, torch.cuda.device_count())
    assert t.data_parallel_size == t.world_size


def test_global_vars_match_jax():
    argv = ["--world-size", "4", "--micro-batch-size", "2",
            "--global-batch-size", "32"]
    global_vars.destroy_global_vars()
    jax_global_vars.destroy_global_vars()
    from apex_tpu.transformer.pipeline_parallel import utils as jpp
    jpp.destroy_microbatch_calculator()
    try:
        t = global_vars.set_global_variables(args=argv)
        j = jax_global_vars.set_global_variables(args=argv)
        assert global_vars.get_args() is t
        assert global_vars.get_num_microbatches() \
            == jax_global_vars.get_num_microbatches() == 4
        assert global_vars.get_current_global_batch_size() \
            == jax_global_vars.get_current_global_batch_size() == 32
        assert t.data_parallel_size == j.data_parallel_size == 4
        with pytest.raises(RuntimeError, match="already"):
            global_vars.set_global_variables(args=argv)
    finally:
        global_vars.destroy_global_vars()
        jax_global_vars.destroy_global_vars()
        jpp.destroy_microbatch_calculator()
    with pytest.raises(RuntimeError, match="not initialized"):
        global_vars.get_args()


def _batch():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 256, (2, 64)).astype(np.int32)
    mask = (np.arange(64)[None] < np.array([[64], [41]])).astype(np.int32)
    nsp = rng.randint(0, 2, 2).astype(np.int32)
    return toks, mask, np.roll(toks, -1, -1), nsp


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["materialized", "flash"])
@pytest.mark.parametrize("ckpt", [False, True], ids=["plain", "ckpt"])
def test_bert_model_provider_matches_jax(ckpt, use_flash):
    argv = TINY + (["--checkpoint-activations"] if ckpt else [])
    jargs = jax_arguments.parse_args(args=argv)
    targs = arguments.parse_args(args=argv)
    over = {"use_flash": True} if use_flash else {}
    jmodel = jax_provider(jargs, **over)
    assert jmodel.checkpoint_activations == ckpt
    assert jmodel.attention_dropout == 0.0
    toks, mask, labels, nsp = (jnp.asarray(a) for a in _batch())
    variables = jmodel.init(jax.random.PRNGKey(0), toks, mask)
    params = unbox(variables["params"])
    with jax.default_matmul_precision("highest"):
        lm, bl = jmodel.apply({"params": params}, toks, mask,
                              lm_labels=labels)
        jloss = float(jnp.mean(lm) + jnp.mean(jax_xentropy(
            bl, nsp, half_to_float=True)))
    # JAX's tree has no token-type table (initialized without token
    # types), so the port's model is built with none
    net = bert_model_provider(targs, device="cpu", num_tokentypes=0, **over)
    assert net.use_flash == use_flash
    assert net.transformer.checkpoint_activations == ckpt
    net.load_state_dict(bert_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    t = [torch.from_numpy(np.asarray(a)).long() for a in
         (toks, mask, labels, nsp)]
    loss = bert_loss(net, *t)
    loss.backward()                        # through the checkpoint too
    assert abs(float(loss) - jloss) <= FWD_TOL
    assert all(p.grad is not None for p in net.parameters())


def test_bert_model_provider_seeds_its_weights():
    targs = arguments.parse_args(args=TINY)
    a = bert_model_provider(targs, device="cpu")
    b = bert_model_provider(targs, device="cpu")
    assert a.transformer.layer_0.mlp.dense_h_to_4h.kernel.dtype \
        == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    targs.seed = 7
    c = bert_model_provider(targs, device="cpu")
    assert not torch.equal(a.embedding.word_embeddings.embedding,
                           c.embedding.word_embeddings.embedding)
