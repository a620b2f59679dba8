"""Metrics and checkpoint loading (the train loop itself is not ported yet)."""
