"""Serving engine, its scheduler and the serving CLI."""
