"""Parity harness against the reference C toolkit."""
