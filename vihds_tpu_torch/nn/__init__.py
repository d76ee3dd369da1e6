"""Layer primitives and the amortised encoder."""
