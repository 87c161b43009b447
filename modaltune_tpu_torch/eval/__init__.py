"""Readout heads of the port (numpy only)."""
