"""Sharding over ``torch.distributed``: the layout rules
(``sharding.py``, pure functions over a mesh's axis names and sizes) and
the collectives the sharded paths write out by hand (``collectives.py``).
Import the modules themselves: this package imports nothing, so that the
model and shuffle layers can use the collectives without importing the
model zoo the layout rules read."""
