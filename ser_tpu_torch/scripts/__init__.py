"""The port's user-level scripts, run with ``python -m``; each mirrors the
file of the same name in the repository's ``scripts/``."""
