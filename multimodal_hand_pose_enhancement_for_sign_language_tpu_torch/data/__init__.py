"""Pickle persistence, windowing and standardization (numpy only)."""
