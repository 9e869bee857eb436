"""Serving engines and the fleet round loop."""
