"""Port twins of the JAX package's accuracy studies (``experiments/``):
the same flows, command lines and cached-args, run by
``redcliff_tpu_torch`` on the card. Each writes its JSON into its own
work directory."""
