"""Evaluation: alignment accuracy."""
