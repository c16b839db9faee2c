"""Tests of the sketcher and comparator (a package, so that chip_smoke.py
and the tests can import its helpers ahead of any other `tests`)."""
