"""Data parallelism over several cards: one process a card,
``torch.distributed`` for the collectives (``mesh.py``, ``distributed.py``,
and the multi-process dry run ``dryrun.py``)."""
