"""Execution layer: batches, expressions, operators, kernels."""
