"""Generator-matrix constructions of the erasure codes."""
