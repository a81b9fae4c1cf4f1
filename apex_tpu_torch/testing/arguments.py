"""Megatron-style arguments for the port's test stack.

Port of ``apex_tpu/testing/arguments.py`` (``parse_args``, its flag
groups and its post-parse derivations), itself the surface of
``apex/transformer/testing/arguments.py``: the flag groups (network
size, logging, regularization, training, initialization, learning
rate, checkpointing, mixed precision, distributed, validation, data,
autoresume) with Megatron's defaults — attention and hidden dropout
0.1, ``--weight-decay 0.01``, ``--clip-grad 1.0``, ``--lr-decay-style
linear`` — and the ``extra_args_provider`` / ``defaults`` hooks.  After
parsing: the world size (the card count, 1 without a card, unless
``--world-size`` is given), the data-parallel size, the batch sizes,
``params_dtype`` as a torch dtype (fp16 or bf16 by ``--fp16`` /
``--bf16``, else fp32), ``ffn_hidden_size`` (4h) and ``kv_channels``.
Flags with no meaning on one card are accepted and unused, so
Megatron launch lines parse unchanged.
"""
from __future__ import annotations

import argparse

import torch

__all__ = ["parse_args"]


def parse_args(extra_args_provider=None, defaults=None,
               ignore_unknown_args=False, args=None):
    """Parse ``args`` (None: ``sys.argv[1:]``) into Megatron's namespace
    (ref: ``apex_tpu/testing/arguments.py:19-110``)."""
    parser = argparse.ArgumentParser(
        description="apex_tpu_torch Megatron-style arguments",
        allow_abbrev=False)

    for add in (_add_network_size_args, _add_logging_args,
                _add_regularization_args, _add_training_args,
                _add_initialization_args, _add_learning_rate_args,
                _add_checkpointing_args, _add_mixed_precision_args,
                _add_distributed_args, _add_validation_args,
                _add_data_args, _add_autoresume_args):
        parser = add(parser)
    if extra_args_provider is not None:
        parser = extra_args_provider(parser)

    if ignore_unknown_args:
        parsed, _ = parser.parse_known_args(args)
    else:
        parsed = parser.parse_args(args)

    # defaults fill only values left unset
    for key, value in (defaults or {}).items():
        if getattr(parsed, key, None) is None:
            setattr(parsed, key, value)

    # the world: the card count unless given; dp = world / (tp * pp)
    if parsed.world_size is None:
        parsed.world_size = max(1, torch.cuda.device_count())
    parsed.tensor_model_parallel_size = min(
        parsed.tensor_model_parallel_size, parsed.world_size)
    model_parallel = (parsed.tensor_model_parallel_size
                      * parsed.pipeline_model_parallel_size)
    if parsed.world_size % model_parallel:
        raise ValueError(
            f"world size {parsed.world_size} not divisible by "
            f"tp*pp {model_parallel}")
    parsed.data_parallel_size = parsed.world_size // model_parallel

    # batch sizes: --batch-size is the legacy alias of the micro batch
    if parsed.micro_batch_size is None:
        parsed.micro_batch_size = parsed.batch_size
    if parsed.global_batch_size is None and parsed.micro_batch_size:
        parsed.global_batch_size = (parsed.micro_batch_size
                                    * parsed.data_parallel_size)

    # precision
    if parsed.fp16 and parsed.bf16:
        raise ValueError("--fp16 and --bf16 are exclusive")
    parsed.params_dtype = torch.float16 if parsed.fp16 else \
        torch.bfloat16 if parsed.bf16 else torch.float32

    # consistency
    if parsed.ffn_hidden_size is None and parsed.hidden_size:
        parsed.ffn_hidden_size = 4 * parsed.hidden_size
    if parsed.kv_channels is None and parsed.hidden_size \
            and parsed.num_attention_heads:
        if parsed.hidden_size % parsed.num_attention_heads:
            raise ValueError("hidden size not divisible by the heads")
        parsed.kv_channels = (parsed.hidden_size
                              // parsed.num_attention_heads)
    if parsed.seq_length is not None \
            and parsed.max_position_embeddings is not None \
            and parsed.max_position_embeddings < parsed.seq_length:
        raise ValueError("max position embeddings below the sequence "
                         "length")
    return parsed


def _add_network_size_args(parser):
    group = parser.add_argument_group(title="network size")
    group.add_argument("--num-layers", type=int, default=None)
    group.add_argument("--hidden-size", type=int, default=None)
    group.add_argument("--ffn-hidden-size", type=int, default=None)
    group.add_argument("--num-attention-heads", type=int, default=None)
    group.add_argument("--kv-channels", type=int, default=None)
    group.add_argument("--max-position-embeddings", type=int, default=None)
    group.add_argument("--layernorm-epsilon", type=float, default=1e-5)
    group.add_argument("--make-vocab-size-divisible-by", type=int,
                       default=128)
    return parser


def _add_logging_args(parser):
    group = parser.add_argument_group(title="logging")
    group.add_argument("--log-interval", type=int, default=100)
    group.add_argument("--tensorboard-dir", type=str, default=None)
    group.add_argument("--log-timers-to-tensorboard", action="store_true")
    return parser


def _add_regularization_args(parser):
    group = parser.add_argument_group(title="regularization")
    group.add_argument("--attention-dropout", type=float, default=0.1)
    group.add_argument("--hidden-dropout", type=float, default=0.1)
    group.add_argument("--weight-decay", type=float, default=0.01)
    group.add_argument("--clip-grad", type=float, default=1.0)
    group.add_argument("--adam-beta1", type=float, default=0.9)
    group.add_argument("--adam-beta2", type=float, default=0.999)
    group.add_argument("--adam-eps", type=float, default=1e-8)
    return parser


def _add_training_args(parser):
    group = parser.add_argument_group(title="training")
    group.add_argument("--batch-size", type=int, default=None,
                       help="legacy alias of --micro-batch-size")
    group.add_argument("--micro-batch-size", type=int, default=None)
    group.add_argument("--global-batch-size", type=int, default=None)
    group.add_argument("--rampup-batch-size", nargs="*", default=None)
    group.add_argument("--train-iters", type=int, default=None)
    group.add_argument("--optimizer", type=str, default="adam",
                       choices=["adam", "sgd", "lamb"])
    group.add_argument("--use-checkpoint-activations", "--checkpoint-activations",
                       dest="checkpoint_activations", action="store_true")
    return parser


def _add_initialization_args(parser):
    group = parser.add_argument_group(title="initialization")
    group.add_argument("--seed", type=int, default=1234)
    group.add_argument("--init-method-std", type=float, default=0.02)
    return parser


def _add_learning_rate_args(parser):
    group = parser.add_argument_group(title="learning rate")
    group.add_argument("--lr", type=float, default=None)
    group.add_argument("--lr-decay-style", type=str, default="linear",
                       choices=["constant", "linear", "cosine"])
    group.add_argument("--lr-decay-iters", type=int, default=None)
    group.add_argument("--lr-warmup-fraction", type=float, default=None)
    group.add_argument("--min-lr", type=float, default=0.0)
    return parser


def _add_checkpointing_args(parser):
    group = parser.add_argument_group(title="checkpointing")
    group.add_argument("--save", type=str, default=None)
    group.add_argument("--save-interval", type=int, default=None)
    group.add_argument("--load", type=str, default=None)
    group.add_argument("--no-save-optim", action="store_true")
    group.add_argument("--no-load-optim", action="store_true")
    return parser


def _add_mixed_precision_args(parser):
    group = parser.add_argument_group(title="mixed precision")
    group.add_argument("--fp16", action="store_true")
    group.add_argument("--bf16", action="store_true")
    group.add_argument("--loss-scale", type=float, default=None)
    group.add_argument("--initial-loss-scale", type=float, default=2 ** 32)
    group.add_argument("--min-loss-scale", type=float, default=1.0)
    group.add_argument("--loss-scale-window", type=float, default=1000)
    group.add_argument("--hysteresis", type=int, default=2)
    return parser


def _add_distributed_args(parser):
    group = parser.add_argument_group(title="distributed")
    group.add_argument("--tensor-model-parallel-size", type=int, default=1)
    group.add_argument("--pipeline-model-parallel-size", type=int,
                       default=1)
    group.add_argument("--virtual-pipeline-model-parallel-size", type=int,
                       default=None)
    group.add_argument("--world-size", type=int, default=None,
                       help="override the card count (dry runs)")
    group.add_argument("--local_rank", type=int, default=None,
                       help="accepted for launcher parity; unused")
    group.add_argument("--distributed-backend", default="nccl",
                       help="accepted for parity (nccl or gloo); unused")
    return parser


def _add_validation_args(parser):
    group = parser.add_argument_group(title="validation")
    group.add_argument("--eval-iters", type=int, default=100)
    group.add_argument("--eval-interval", type=int, default=1000)
    return parser


def _add_data_args(parser):
    group = parser.add_argument_group(title="data and dataloader")
    group.add_argument("--data-path", nargs="*", default=None)
    group.add_argument("--vocab-size", type=int, default=None)
    group.add_argument("--seq-length", type=int, default=None)
    group.add_argument("--num-workers", type=int, default=2)
    return parser


def _add_autoresume_args(parser):
    group = parser.add_argument_group(title="autoresume")
    group.add_argument("--adlr-autoresume", action="store_true")
    group.add_argument("--adlr-autoresume-interval", type=int, default=1000)
    return parser
