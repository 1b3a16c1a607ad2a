"""Serve-shape step builders of the port."""
