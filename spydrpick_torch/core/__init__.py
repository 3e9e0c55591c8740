"""Device-side data preparation (sample weights).  The alignment model,
alphabet, filter and distance helpers are reused from
``spydrpick_tpu.core``, which imports without jax."""
