"""Passive tracers with their own source terms (ideal age)."""
