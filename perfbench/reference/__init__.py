"""The plain float32 reference the benchmark holds the port to."""

from perfbench.reference import model  # noqa: F401
