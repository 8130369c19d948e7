"""Verification of the port against the reference: the parity harness."""
