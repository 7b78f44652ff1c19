"""Dataset containers: ``create_pack`` (packed shards) and
``create_lmdb``."""
