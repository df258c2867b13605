"""Checkpoint loading."""
