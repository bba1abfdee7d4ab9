"""Measurement scripts of the port that need a card (run as modules)."""
