"""Test oracles: ``model.ReferenceStateMachine`` (a copy of the JAX package's)."""
