"""Tensor ops of the port (NHWC at their public face)."""
