"""Simulation (the VOPR).  So far the batched protocol-model VOPR
(``vopr_tpu``), its random numbers (``prng``) and its scale run
(``vopr_scale``); the cluster simulator on the real consensus code comes
with the serving path."""
