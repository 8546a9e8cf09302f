"""Model FLOPs and kernel bounds from shapes."""
