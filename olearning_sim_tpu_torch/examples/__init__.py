"""Runnable tours of the port, one module per example of the JAX package's
``examples/`` directory, under the same names and at the same sizes, seeds
and rounds::

    python -m olearning_sim_tpu_torch.examples.library_quickstart [--device cpu]

Each runs on the card (``cuda``) unless given ``--device cpu``, and never
falls back to the CPU on its own. Each exposes its work as ``run(device)``,
which holds the JAX example's own checks and returns what the example
prints (``report(result)`` gives the lines); ``main()`` only parses the
arguments and prints.

- ``library_quickstart``: the engine as a library, mlp2 FedAvg rounds and
  the central eval.
- ``custom_operator``: a user ``OperatorABC`` run after the built-in
  operators, with exit-code accounting.
- ``queue_submit``: a task JSON pushed onto the SQLite intake queue and
  drained by the platform's scheduler.
- ``platform_submit``: a session built from a config, a task submitted and
  polled to its end.
- ``tensor_pipeline_parallel``, ``moe_expert_parallel``,
  ``long_context_training``, ``elastic_rescale``: worlds of one process per
  rank (``clustermgr/launcher.py``) at the JAX example's world.
"""
