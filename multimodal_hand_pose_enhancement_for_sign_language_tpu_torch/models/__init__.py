"""Generators, their building blocks and the weights bridge from the JAX package."""
