"""Stage-pipelined per-client training: the ``pp > 1`` round. The port of
the JAX package's ``engine/pp_rounds.py``.

Every client's local SGD runs with its forward and backward streamed
through the plan's ``pp`` stages as microbatches (the GPipe graph of
:class:`~olearning_sim_tpu_torch.parallel.pipeline.PipelinedBody`, here
under the round's ``vmap(grad_and_value(...))`` over a block of clients).
The round is :meth:`FedCore.round_step`'s resident path with the
per-client carry in that class's stage layout: the replicated leaves
(``rest/<name>``) whole and this stage's slice of the block stack
(``stack/<leaf>``, ``[depth/pp, ...]``). So::

    round_step = for each block of this rank's clients:
                     vmap over clients: masked local SGD, each step's
                     forward and backward pipelined over pp; the replicated
                     leaves' stage partials summed over pp
                     finiteness gate (agreed over pp), weighted delta sum
                 -> psum of the sums over dp
                 -> the block stack gathered over pp, unstacked
                 -> dense server update on the negative mean delta

The server update runs dense on every rank, so ``ServerState`` keeps the
model's layout and checkpoints, evaluation, export and warm starts do not
see pp; nor does ``evaluate``, which runs the dense model on the whole
params, as the JAX engine's does. As in the JAX engine, the pipelined round supports the plain FedOpt
families only: deadline, attack, defense and async are refused at launch,
personalized and control-variate algorithms and the sharded server update
at build (:func:`validate_pp_build`).

FedProx's pull is the whole model's ``||p - w||^2``: the stage-local block
terms and stage 0's term of the replicated leaves summed over pp (a sum
that differentiates as the identity), so every stage reports the same loss
and each leaf's pull is counted once.

This module holds the checks; the layout and the pipelined step are
:mod:`~olearning_sim_tpu_torch.parallel.pipeline`'s, shared with
``pp_train_step``.
"""

from __future__ import annotations


def validate_pp_build(model, plan, config, algorithm, microbatches) -> int:
    """Build-time checks for a pipelined core, with the JAX engine's
    messages. Returns the resolved microbatch count M."""
    if plan.pp <= 1:
        raise ValueError("validate_pp_build needs a mesh with pp > 1")
    depth = getattr(model, "depth", None)
    if depth is None:
        raise ValueError(
            f"pipeline parallelism needs a block-structured text model "
            f"(TextTransformer family); {type(model).__name__} has no depth"
        )
    if depth % plan.pp:
        raise ValueError(
            f"parallel.pp={plan.pp} must divide the model depth {depth}"
        )
    impl = getattr(model, "attention_impl", "dense")
    if impl != "dense":
        raise ValueError(
            f"pipeline parallelism requires attention_impl='dense', the "
            f"model was built with {impl!r}"
        )
    if algorithm.personalized or algorithm.control_variates:
        raise ValueError(
            f"pipeline parallelism (pp>1) does not support the "
            f"personalized/control-variate algorithm {algorithm.name!r}"
        )
    if config.shard_server_update:
        raise ValueError(
            "pp>1 does not compose with fedcore.shard_server_update (the "
            "flat dp coordinate shards would cut across the stage "
            "partition); docs/performance.md has the composition matrix"
        )
    M = int(microbatches) if microbatches is not None else plan.pp
    if M < 1:
        raise ValueError(f"parallel.microbatches must be >= 1, got {M}")
    if config.batch_size % M:
        raise ValueError(
            f"parallel.microbatches={M} must divide "
            f"fedcore.batch_size={config.batch_size} (each local-SGD "
            f"minibatch is streamed through the stages in M microbatches)"
        )
    return M


def check_launch(deadline, completion_time, attack_scale, defense, async_plan) -> None:
    """What a pipelined round refuses at launch, with the JAX engine's
    message."""
    if (deadline is not None or completion_time is not None
            or attack_scale is not None or defense is not None
            or async_plan is not None):
        raise ValueError(
            "pipeline-parallel (pp>1) rounds support the plain "
            "program only: deadline/attack/defense/async do not "
            "compose with the stage-pipelined per-client body "
            "(docs/performance.md has the composition matrix)"
        )
