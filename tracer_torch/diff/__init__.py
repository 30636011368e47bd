"""Gradient checking (the port of `tracer/diff`)."""
