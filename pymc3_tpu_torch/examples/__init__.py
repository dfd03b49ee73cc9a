"""Model builders shared by the tests and ``chip_smoke.py``."""
