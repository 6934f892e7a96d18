"""Entry-path drivers: how each cell calls the program (see harness.py)."""
