"""Bundle adjustment across devices (parallel/sharded_ba.py)."""
