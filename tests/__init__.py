"""Test suite (a regular package, so no other `tests` package on the
path can shadow it)."""
