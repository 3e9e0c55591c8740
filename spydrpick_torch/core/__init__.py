"""The alignment model, alphabet, position filter and genome distance
(copies of ``spydrpick_tpu.core``'s host modules) and the device-side
sample weights."""
