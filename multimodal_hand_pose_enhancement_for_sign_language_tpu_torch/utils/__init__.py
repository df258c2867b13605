"""Shared constants and device selection."""
