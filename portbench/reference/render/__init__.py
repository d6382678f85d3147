"""Part of the frozen reference (see portbench/reference/__init__.py)."""
