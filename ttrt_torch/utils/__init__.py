"""Utilities: logging, frame metrics."""
