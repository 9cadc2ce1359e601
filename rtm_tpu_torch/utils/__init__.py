"""Logging, timing and numeric guards."""
